"""The benchmark imports neither JAX nor the JAX package nor the JAX
benchmarks, and its reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE = [HERE / "reference.py", HERE / "judge.py", HERE / "weights.py", HERE / "traffic.py",
             *sorted((HERE / "models").glob("*.py"))]


def imported(path: Path):
    """Top-level names of every module that ``path`` imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported(path))


def test_the_guard_reads_whole_names():
    src = "import repro_torch.models\nfrom repro.fe import x\nimport jaxtyping\n"
    tmp = HERE / "tests" / "_guard_probe.txt"
    try:
        tmp.write_text(src)
        assert set(imported(tmp)) & FORBIDDEN == {"repro"}
    finally:
        tmp.unlink()


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("repro_torch_probe"))
    assert run.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()
