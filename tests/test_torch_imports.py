"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
CURVE_FIXTURE = ROOT / "tests" / "curve_fixture.py"     # chip_smoke.py imports it
MP_RANKS = ROOT / "tests" / "model_parallel_ranks.py"   # and this (phase 21's bodies)
FORBIDDEN = ("jax", "repro", "jaxlib")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES + [CURVE_FIXTURE, MP_RANKS],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_resolve_device_cpu_only_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_plan_run_without_cuda_raises(monkeypatch):
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = featureplan.compile(get_spec("dlrm"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan.run(gen_views(8, seed=0))


# modules copied from the JAX package (jax-free there), imports renamed
COPIED = ["check/annotations.py", "obs/metrics.py", "obs/trace.py", "train/fault.py",
          "io/shardfmt.py", "io/dataset.py", "io/chaos.py", "io/stream.py", "io/convert.py",
          "fe/colstore.py", "fe/datagen.py", "core/opgraph.py", "core/scheduler.py",
          "check/findings.py", "check/lockset.py", "embedding/hierarchy.py",
          "fe/specs/ads_ctr.py", "fe/specs/bst.py", "obs/validate.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_keeps_the_jax_packages_code(rel):
    """Every copied module is in the port and, apart from the renamed
    imports, names nothing of the JAX package."""
    port = ROOT / "src" / "repro_torch" / rel
    assert (ROOT / "src" / "repro" / rel).is_file() and port in PORT_FILES
    src = port.read_text()
    assert "from repro." not in src and "import repro." not in src


def test_every_port_module_imports_without_jax():
    """A fresh interpreter imports every module of the port (and the smoke
    script's module, the curve fixture's and the model-parallel ranks') and
    has loaded neither JAX nor the JAX package."""
    import subprocess
    import sys

    modules = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                     .removesuffix(".__init__")
                     for p in PORT_FILES if p.name != "chip_smoke.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import runpy; runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
            "sys.path.insert(0, 'tests'); import curve_fixture, model_parallel_ranks\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
