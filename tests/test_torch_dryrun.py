"""The port's dry run (``launch/dryrun.py``) on the CPU, kept cheap.

JAX's ``test_dryrun_cells_lower_on_small_mesh`` on the port (a 2x4 mesh,
the records' state bytes and model FLOPs equal to JAX's there), the peak
tracker on a hand-counted chain, its prediction against a real CPU run of
materialised cells, the CLI's records and exit codes, and the reuse of a
cell's step figures across meshes. The LM cells' cost passes take tens of
seconds each on the CPU and stay out of these tests.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.hlo_stats import PeakMode, step_cost  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = Mesh({"data": 1, "model": 1})


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tests", "jax_cells.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


@pytest.mark.parametrize("arch,shape", [
    ("dlrm-mlperf", "serve_p99"),
    ("bst", "serve_p99"),
    ("pna", "molecule"),
])
def test_dryrun_cells_on_small_mesh(jax_side, monkeypatch, arch, shape):
    """The production cell builders on an 8-device (2x4) mesh, patched in as
    JAX's test patches it: ``ok``, and the JAX dry run's state bytes and
    model FLOPs on that mesh."""
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False: Mesh({"data": 2, "model": 4}))
    rec = D.run_cell(arch, shape, verbose=False)
    assert rec["status"] == "ok", rec
    want = jax_side["cells"]["2x4"][f"{arch}|{shape}|base"]
    assert rec["memory"]["state_bytes_exact"] == want["state_bytes_exact"]
    assert rec["model_flops"] == want["model_flops"]
    assert rec["n_devices"] == 8
    assert rec["step_flops"] > 0 and rec["step_op_bytes"] > 0
    assert rec["step_peak_bytes"] > 0 and rec["step_max_live"] >= rec["step_peak_live"] > 0


def test_peak_tracker_hand_counted():
    """A chain of ops, views and in-place ops whose live bytes are counted by
    hand: x (40 B) is the argument."""
    def chain(x):
        y = x * 2                  # x, y: 80
        z = y.view(2, 5)           # a view: 80
        z.add_(1)                  # in place: 80
        w = torch.exp(y)           # x, y, w: 120 (the peak, 3 storages)
        del y, z                   # y dies: 80
        u = w[:4].sum()            # a view, then u (4 B): 84
        v = torch.cat([w, w])      # x, w, u, v (80 B): 164 (the new peak, 4 storages)
        del v                      # 84
        return u

    peak = PeakMode("meta")
    step_cost(chain, torch.zeros(10), peak=peak)
    assert peak.peak_bytes == 164
    assert peak.live_at_peak == 4 and peak.max_live == 4
    assert peak.live_bytes == 0 and peak.live == 0          # every storage died
    assert peak.max_live_large == 0


def test_peak_tracker_counts_autograd_and_large():
    """Saved tensors live until the backward frees them; storages over 1 MiB
    are counted apart."""
    def f(w):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            y = torch.exp(w)       # saved for the backward: w, y = 2 x 4 MiB
            loss = y.sum()
            (g,) = torch.autograd.grad(loss, [w])
        return g

    peak = PeakMode("meta")
    step_cost(f, torch.zeros(1 << 20), peak=peak)
    mib4 = 4 << 20
    # w, y, loss, then the backward's grad_output expanded (a view), the
    # gradient (y * grad_output): w + y + g + two 4-byte scalars
    assert peak.peak_bytes == 3 * mib4 + 8
    assert peak.max_live_large == 3


@pytest.mark.parametrize("cell", [
    ("pna", "molecule"),
    ("pna", "full_graph_sm"),
    ("dcn-v2", "serve_p99"),
    ("bst", "train_batch"),
], ids=lambda c: "x".join(c))
def test_meta_peak_equals_cpu_run(cell):
    """The meta prediction against a real run of the materialised cell on the
    CPU, whose storages the same tracker follows: the state bytes equal
    the materialised arguments' and the peaks are equal to the byte
    (recsys cells at their smoke widths on a 1x1 mesh; DLRM is left out: its
    CPU path runs the plain interaction, which allocates otherwise than
    the kernel and its meta branch)."""
    arch, shape = cell
    spec = get_arch(arch)
    c = (spec.build_cell(shape, ONE) if spec.family == "gnn"
         else B.recsys_cell(spec.smoke(), shape, ONE))
    figures = D.step_figures(c)
    args = D.materialize(c, "cpu", seed=3)
    nbytes = sum(t.numel() * t.element_size() for a in args
                 for t in B.leaves_by_path(a).values())
    assert nbytes == D.state_bytes_exact(c)
    peak = PeakMode("cpu").track(args)
    with peak:
        out = c.fn(*args)
    del out
    assert peak.peak_bytes == figures["step_peak_bytes"]
    assert figures["step_workspace"] >= 1 << 20
    assert D.transient_bound(figures) > 0


def test_materialize_draws_ids_in_range():
    c = B.recsys_cell(get_arch("bst").smoke(), "retrieval_cand", ONE)
    params, user, cands = D.materialize(c, "cpu")
    cfg = c.config
    for f, v in enumerate(cfg.vocab_sizes):
        col = user["sparse"][:, f]
        assert 0 <= int(col.min()) and int(col.max()) < v
    assert int(cands.max()) < cfg.vocab_sizes[cfg.item_field]
    g = get_arch("pna").build_cell("molecule", ONE)
    _, st, batch = D.materialize(g, "cpu")
    n = batch["features"].shape[0]
    assert int(batch["src"].max()) < n and int(batch["dst"].max()) < n
    assert int(batch["graph_ids"].max()) == batch["labels"].shape[0] - 1
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    with pytest.raises(ValueError, match="recsys and gnn"):
        D.materialize(get_arch("yi-9b").build_cell("prefill_32k", ONE), "cpu")


def test_step_figures_reused_across_meshes(monkeypatch):
    """A cell whose program and inputs are the same on both meshes is costed
    once (pna x molecule: 8,192 edges divide both device counts)."""
    calls = []
    real = D.step_figures
    monkeypatch.setattr(D, "_STEP_CACHE", {})
    monkeypatch.setattr(D, "step_figures", lambda cell: calls.append(1) or real(cell))
    a = D.run_cell("pna", "molecule", multi_pod=False, verbose=False)
    b = D.run_cell("pna", "molecule", multi_pod=True, verbose=False)
    assert len(calls) == 1 and a["step_flops"] == b["step_flops"]
    assert a["mesh"] == "16x16" and b["mesh"] == "2x16x16" and b["n_devices"] == 512
    # bst x serve_p99 rounds its dedup capacity up to each device count
    # (12,544 on 256 devices, 12,800 on 512): costed per mesh
    D.run_cell("bst", "serve_p99", multi_pod=False, verbose=False)
    D.run_cell("bst", "serve_p99", multi_pod=True, verbose=False)
    assert len(calls) == 3


def test_main_writes_record(tmp_path, capsys):
    out = tmp_path / "d" / "pna.json"
    D.main(["--arch", "pna", "--shape", "molecule", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok"]
    assert recs[0]["memory"]["state_bytes_exact"] == 4_531_336
    assert "1 ok, 0 skipped, 0 failed" in capsys.readouterr().out


def test_main_records_errors_and_exits_1(tmp_path):
    out = tmp_path / "bogus.json"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "pna", "--shape", "molecule", "--both-meshes",
                "--variant", "bogus", "--out", str(out)])
    assert e.value.code == 1
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["error", "error"]
    assert recs[0]["error"] == "ValueError: unknown gnn variant 'bogus'"
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}


def test_main_default_output_under_build(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    D.main(["--arch", "pna", "--shape", "molecule"])
    assert (tmp_path / "build" / "dryrun" / "dryrun_single_base.json").is_file()


def test_skipped_cell_record():
    rec = D.run_cell("yi-9b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["skip_reason"]
