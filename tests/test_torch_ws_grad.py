"""The working-set gather (``kernels/ws_grad``) on the CPU: ``gather_rows``
against autograd through ``take_rows``, its meta branch, and the sparse
step's ``working_set_grads`` through it against the per-site gathers it
replaced. JAX-free; the kernels themselves are held to a float64 segment
sum on the card in ``test_torch_ws_grad_gpu.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.embedding.dedup import FILL, dedup, take_rows  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.ws_grad import ops as ws_ops  # noqa: E402
from repro_torch.kernels.ws_grad.ops import CHUNK, gather_rows, ws_grad  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models.common import sigmoid_bce  # noqa: E402

N_ROWS = 11


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the CPU's threaded accumulating index ops add a
    row's terms in an order that changes from run to run (ROADMAP C16), so
    bit for bit holds single-threaded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inverse(kind, n, seed):
    """int32[n] indices into N_ROWS rows: in range, wrapping negative,
    past the end, or int32's least (the dropped ids of the two-stage dedup)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_ROWS, n)
    if kind == "wrap":
        idx = idx - N_ROWS * rng.integers(0, 2, n)          # [-n, 0) wraps
    elif kind == "past":
        idx = np.where(rng.random(n) < 0.3, N_ROWS + rng.integers(0, 5, n), idx)
        idx[:2] = (-N_ROWS - 1, N_ROWS)
    elif kind == "dropped":
        idx = np.where(rng.random(n) < 0.3, -(2**31), idx)
    return torch.from_numpy(idx.astype(np.int32))


def _autograd_take_rows(rows, inverse, dy):
    r = rows.detach().requires_grad_(True)
    out = take_rows(r, inverse)
    (g,) = torch.autograd.grad(out, r, dy)
    return out.detach(), g


def _gather(rows, inverse, dy):
    r = rows.detach().requires_grad_(True)
    out = gather_rows(r, inverse)
    (g,) = torch.autograd.grad(out, r, dy)
    return out.detach(), g


@pytest.mark.parametrize("d", [1, 16, 39, 128])
@pytest.mark.parametrize("kind", ["in_range", "wrap", "past", "dropped"])
def test_gather_rows_equals_take_rows_on_cpu(kind, d):
    """The forward is take_rows' (NaN rows outside [-n, n)) and the gradient
    autograd's through take_rows, bit for bit: both add a row's terms in
    increasing position, and an index outside [-n, n) adds nothing."""
    n = 3 * CHUNK + 7
    inverse = _inverse(kind, n, seed=d)
    gen = torch.Generator().manual_seed(d)
    rows = torch.randn(N_ROWS, d, generator=gen)
    dy = torch.randn(n, d, generator=gen)
    out, g = _gather(rows, inverse, dy)
    want_out, want_g = _autograd_take_rows(rows, inverse, dy)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(g, want_g)
    assert out.isnan().any() == (kind in ("past", "dropped"))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_empty_inverse_gives_zero_gradient(dtype):
    rows = torch.randn(N_ROWS, 16)
    inverse = torch.zeros(0, dtype=dtype)
    out, g = _gather(rows, inverse, torch.zeros(0, 16))
    assert out.shape == (0, 16)
    assert torch.equal(g, torch.zeros(N_ROWS, 16))


def test_two_sites_as_views_of_one_call():
    """Two sites' rows taken as views of one gather: one backward, bit for
    bit take_rows' over the flat inverse, and within rounding of the sum of
    two per-site gradients (another order of the same terms)."""
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn(N_ROWS, 8, generator=gen)
    a, b = _inverse("wrap", 40, 1).reshape(8, 5), _inverse("past", 24, 2).reshape(4, 6)
    dy_a, dy_b = torch.randn(8, 5, 8, generator=gen), torch.randn(4, 6, 8, generator=gen)
    flat_inv = torch.cat([a.reshape(-1), b.reshape(-1)])

    r = rows.clone().requires_grad_(True)
    pa, pb = gather_rows(r, flat_inv).split([40, 24])
    loss = (pa.reshape(8, 5, 8) * dy_a).nansum() + (pb.reshape(4, 6, 8) * dy_b).nansum()
    (g,) = torch.autograd.grad(loss, r)

    dy = torch.cat([dy_a.reshape(-1, 8), dy_b.reshape(-1, 8)])
    dy = torch.where(take_rows(rows, flat_inv).isnan(), 0.0, dy)
    assert torch.equal(g, _autograd_take_rows(rows, flat_inv, dy)[1])
    per_site = sum(_autograd_take_rows(rows, inv, dy_s.reshape(-1, 8))[1]
                   for inv, dy_s in ((a.reshape(-1), dy[:40]), (b.reshape(-1), dy[40:])))
    torch.testing.assert_close(g, per_site, rtol=1e-6, atol=1e-6)


def test_meta_backward_allocates_and_charges():
    """On meta the backward allocates the card's buffers and charges the
    kernels' bytes: each gradient row read once, each output row written
    once, a key and a sorted position for each gathered row."""
    n, cap, d = 1000, 300, 128
    seen = []
    with cost.counting(lambda *a: seen.append(a)):
        out = ws_grad(torch.empty(n, d, device="meta"),
                      torch.empty(n, dtype=torch.int32, device="meta"), cap)
    assert out.shape == (cap, d) and out.device.type == "meta"
    assert seen == [("ws_grad", 0.0, float(4 * (n * d + cap * d + 2 * n)))]


def test_ws_grad_checks_its_inputs():
    with pytest.raises(ValueError, match="does not match"):
        ws_grad(torch.zeros(4, 2), torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(TypeError, match="int32 or int64"):
        ws_grad(torch.zeros(4, 2), torch.zeros(4), 3)
    with pytest.raises(TypeError, match="float32"):
        ws_grad(torch.zeros(4, 2, dtype=torch.float64, device="meta"),
                torch.zeros(4, dtype=torch.int32, device="meta"), 3)
    with pytest.raises(ValueError, match="rows"):
        gather_rows(torch.zeros(4), torch.zeros(4, dtype=torch.int32))


def _per_site_ws_grads(params, c, batch, working, inverse, shapes):
    """The sparse step's gradient as it was before ``gather_rows``: each
    site's rows taken by its own ``take_rows``, autograd summing the
    per-site gradients of the working rows."""
    sites = sorted(shapes)
    names = sorted(k for k in params if k != "embed")
    dense = {k: params[k].detach().requires_grad_(True) for k in names}
    rows = working.detach().requires_grad_(True)
    b2, p2, off = dict(batch), dict(dense), 0
    p2["embed"] = params["embed"]
    with torch.enable_grad():
        for s in sites:
            n = int(np.prod(shapes[s]))
            b2[f"_rows_{s}"] = take_rows(rows, inverse[off: off + n].reshape(shapes[s]))
            off += n
        loss = sigmoid_bce(R.forward(p2, c, b2), batch["label"]).mean()
        grads = torch.autograd.grad(loss, [dense[k] for k in names] + [rows])
    return loss.detach(), dict(zip(names, grads[:-1])), grads[-1]


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2", "bst"])
def test_working_set_grads_match_the_per_site_gathers(arch):
    """One site (DLRM, DCN-v2): the loss and every gradient bit for bit the
    per-site form's. Two sites (BST: ``seq`` and ``other``): the loss and
    the dense gradients bit for bit, the working rows' gradient within
    rounding, since the two sites' terms are now one sum."""
    c = dataclasses.replace(get_arch(arch).smoke(), dedup_capacity=0)
    params = R.init_params(c, torch.Generator().manual_seed(0))
    batch = synthetic_batch("recsys", c, 16, 0, device=torch.device("cpu"))
    gids = R.collect_gids(c, batch)
    sites = sorted(gids)
    flat = torch.cat([gids[s].reshape(-1) for s in sites])
    unique, inverse, n_unique = dedup(flat, capacity=int(flat.shape[0]))
    working = take_rows(params["embed"], torch.where(unique == FILL, 0, unique))
    shapes = {s: tuple(gids[s].shape) for s in sites}

    ws = R.working_set_grads(params, c, batch, working, unique, n_unique, inverse, shapes)
    loss, dense, g = _per_site_ws_grads(params, c, batch, working, inverse, shapes)
    assert len(sites) == (2 if arch == "bst" else 1)
    assert torch.equal(ws.loss, loss)
    assert all(torch.equal(ws.dense_grads[k], v) for k, v in dense.items())
    if len(sites) == 1:
        assert torch.equal(ws.working_grad, g)
    else:
        torch.testing.assert_close(ws.working_grad, g, rtol=1e-5, atol=1e-9)
    assert int((ws.working_grad[int(n_unique):] != 0).sum()) == 0


def test_gather_rows_is_not_launched_on_cpu(monkeypatch):
    """A CPU call takes the plain version and counts no launch."""
    calls = []
    monkeypatch.setattr(ws_ops, "ws_grad_ref",
                        lambda *a: calls.append(1) or torch.zeros(N_ROWS, 4))
    before = gather_rows.launches
    _gather(torch.randn(N_ROWS, 4), _inverse("in_range", 9, 0), torch.randn(9, 4))
    assert calls == [1] and gather_rows.launches == before
