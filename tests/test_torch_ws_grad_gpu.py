"""The working-set gradient kernels (``csrc/ws_grad.cu``) on the card.

Marked ``gpu``: each test skips without a CUDA device. JAX-free, so it runs
on a machine with the card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_ws_grad_gpu.py

The kernels add each slot's terms in chunks of ``CHUNK`` sorted positions
and then the chunks' partials in chunk order. Against the float64 segment
sum, slot s and column j of c terms err by at most
(min(c, CHUNK) + ceil(c / CHUNK) + 1) 2^-24 S_sj, S_sj the sum of |g| over
the terms: recursive summation of m terms errs by at most (m - 1) 2^-24
times their absolute sum, a chunk holds at most min(c, CHUNK) of the
slot's terms, and the slot's terms touch at most ceil(c / CHUNK) + 1
chunks. A slot no position references is exactly 0.
"""

import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.embedding.dedup import dedup, take_rows  # noqa: E402
from repro_torch.kernels.ws_grad import ops as ws_ops  # noqa: E402
from repro_torch.kernels.ws_grad.ops import CHUNK, gather_rows, ws_grad  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN_CELL = "dlrm-mlperf.train-zipf"   # the benchmark's training cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _train_cell_ids(seed, dev):
    """int64[rows, n_sparse] packed-table ids of one batch of the training
    cell, drawn by the benchmark's own traffic generator from its config
    and mix files."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import spec, traffic, weights

    cell = spec.load_cell(TRAIN_CELL, spec.load_benchmark(ROOT))
    sparse = traffic.make_batches(cell.config, dict(cell.mix, batches=1), seed, dev)[0]["sparse"]
    return traffic.global_ids(cell.config, sparse.to(dev), weights.offsets(cell.config))


def _case(name, d, dev):
    """(g f32[N, d], inverse int32[N], cap) for a named case."""
    gen = torch.Generator(device=dev).manual_seed(d)
    if name == "singletons":          # every run of length 1, slots left empty between
        n, cap = 5000, 7919
        inverse = torch.randperm(cap, generator=gen, device=dev)[:n]
    elif name == "one_run":           # one run of 40,000 across many chunks, short ones around
        n, cap = 41_000, 300
        inverse = torch.randint(0, cap, (n,), generator=gen, device=dev)
        inverse[torch.randperm(n, generator=gen, device=dev)[:40_000]] = 7
    elif name == "out_of_range":      # wrapped, past the end, dropped (-2**31)
        n, cap = 20_000, 500
        inverse = torch.randint(-cap, cap + 50, (n,), generator=gen, device=dev)
        inverse[::97] = -(2**31)
    elif name == "train_cell":        # the training cell's ids, a vocabulary-3 field among them
        ids = _train_cell_ids(d, dev)
        n = cap = ids.numel()
        _, inverse, _ = dedup(ids.reshape(-1), capacity=cap)
    else:
        raise ValueError(name)
    g = torch.randn(n, d, generator=gen, device=dev)
    return g, inverse.to(torch.int32), cap


def _check_against_float64(got, g, inverse, cap):
    """Every element within its bound of the float64 segment sum; slots
    with no term exactly 0. Returns the worst error over its bound."""
    idx = inverse.to(torch.int64)
    valid = (idx >= -cap) & (idx < cap)
    seg = torch.where(valid, torch.where(idx < 0, idx + cap, idx), cap)
    d = g.shape[1]
    want = torch.zeros(cap + 1, d, dtype=torch.float64, device=g.device).index_add_(
        0, seg, g.double())[:cap]
    s = torch.zeros(cap + 1, d, dtype=torch.float64, device=g.device).index_add_(
        0, seg, g.double().abs())[:cap]
    c = torch.bincount(seg, minlength=cap + 1)[:cap].to(torch.float64)[:, None]
    bound = (c.clamp_max(CHUNK) + torch.ceil(c / CHUNK) + 1) * 2.0**-24 * s
    err = (got.double() - want).abs()
    assert bool((got[c[:, 0] == 0] == 0).all()), "an unreferenced slot is not 0"
    assert bool((err <= bound).all()), f"worst error {float((err / bound.clamp_min(1e-300)).max())}x its bound"
    return float((err / bound.clamp_min(1e-300)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 39, 128])
@pytest.mark.parametrize("name", ["singletons", "one_run", "out_of_range"])
def test_ws_grad_kernel_against_float64(cuda_device, name, d):
    """The float4 path (d = 16, 128) and the scalar one (d = 39), within
    the stated bound of the float64 segment sum, with the output's memory
    left NaN by an earlier tensor so that every row must be written."""
    g, inverse, cap = _case(name, d, cuda_device)
    junk = torch.full((4 * cap * d,), math.nan, device=cuda_device)
    del junk
    before = ws_ops.gather_rows.launches
    got = ws_grad(g, inverse, cap)
    torch.cuda.synchronize()
    assert ws_ops.gather_rows.launches == before + 1
    _check_against_float64(got, g, inverse, cap)


@pytest.mark.gpu
def test_ws_grad_kernel_at_the_train_cells_shape(cuda_device):
    """65,536 rows x 26 fields of the training cell's vocabularies under
    the power law, D = 128: runs of up to some 33,000 on the vocabulary-3
    field's first id; bit for bit the same in two calls."""
    g, inverse, cap = _case("train_cell", 128, cuda_device)
    got = ws_grad(g, inverse, cap)
    counts = torch.bincount(inverse.to(torch.int64), minlength=cap)
    assert int(counts.max()) > 30_000
    _check_against_float64(got, g, inverse, cap)
    assert torch.equal(got, ws_grad(g, inverse, cap))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["int64", "unaligned"])
def test_ws_grad_kernel_other_layouts(cuda_device, layout):
    """An int64 inverse; a gradient 4 bytes past a 16-byte boundary (the
    scalar path at d = 128)."""
    g, inverse, cap = _case("one_run", 128, cuda_device)
    if layout == "int64":
        inverse = inverse.to(torch.int64)
    else:
        buf = torch.empty(g.numel() + 1, device=cuda_device)
        buf[1:].copy_(g.reshape(-1))
        g = buf[1:].view(g.shape)
    got = ws_grad(g, inverse, cap)
    _check_against_float64(got, g, inverse, cap)
    assert torch.equal(got, ws_grad(g.contiguous(), inverse, cap))


@pytest.mark.gpu
def test_gather_rows_on_card_never_takes_the_plain_version(cuda_device, monkeypatch):
    """The forward is take_rows' on the card; the backward launches the
    kernels and never calls ref.py."""
    def plain(*a):
        raise AssertionError("a CUDA call took the plain version")

    monkeypatch.setattr(ws_ops, "ws_grad_ref", plain)
    g, inverse, cap = _case("out_of_range", 16, cuda_device)
    rows = torch.randn(cap, 16, device=cuda_device, requires_grad=True)
    out = gather_rows(rows, inverse)
    torch.testing.assert_close(out, take_rows(rows.detach(), inverse), rtol=0, atol=0,
                               equal_nan=True)
    before = gather_rows.launches
    (grad,) = torch.autograd.grad(out, rows, g)
    assert gather_rows.launches == before + 1
    _check_against_float64(grad, g, inverse, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "bst"])
def test_sparse_step_launches_gather_rows_once_a_step(cuda_device, arch):
    """One backward a step, one site (DLRM) or two (BST) alike."""
    cfg = get_arch(arch).smoke()
    params = R.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    step, init = R.make_sparse_train_step(cfg, adamw(1e-3))
    state = init(params)
    before = gather_rows.launches
    for i in range(3):
        params, state, m = step(params, state, synthetic_batch("recsys", cfg, 32, i,
                                                                device=cuda_device))
    torch.cuda.synchronize()
    assert math.isfinite(float(m["loss"]))
    assert gather_rows.launches == before + 3
