"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.devicefeed import DeviceFeeder  # noqa: E402
from repro_torch.core.mempool import ArenaPool  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe import ops as F  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402
from repro_torch.kernels.feature_hash.ops import OPS_PER_LAUNCH, run_hash_layer  # noqa: E402
from repro_torch.kernels.feature_hash.ref import hash_layer_ref  # noqa: E402
from repro_torch.kernels.interaction_dot.ops import (  # noqa: E402
    pairwise_dots,
    pairwise_dots_backward,
)
from repro_torch.kernels.interaction_dot.ref import (  # noqa: E402
    dot_interaction_bwd_ref,
    dot_interaction_ref,
)
from repro_torch.kernels.mempool_alloc.ops import alloc_offsets, plan_block  # noqa: E402
from repro_torch.kernels.mempool_alloc.ops import tile as alloc_tile  # noqa: E402
from repro_torch.kernels.mempool_alloc.ref import alloc_offsets_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


# int32 extremes and the ids that part the readings of `mod` (ROADMAP C3)
HASH_EDGE_IDS = [-(2**31), -1, 0, 2**31 - 1, 5, -7, 2**31 + 5, 2**32 + 3]
HASH_OPS = (("cross", 0, 1), ("cross", 7, 2), ("hash", 3, 0), ("mod", 4, 0), ("mod", 9, 0))


def _hash_cols(n, device, offset=0, seed=None):
    """int32[10, n] ids narrowed from int64, the edge ids in the first and
    last rows of every column, as a contiguous view ``offset`` elements into
    its storage."""
    rng = np.random.default_rng(n if seed is None else seed)
    ids = rng.integers(-(2**33), 2**33, (10, n)).astype(np.int64)
    k = min(n, len(HASH_EDGE_IDS))
    ids[:, :k] = HASH_EDGE_IDS[:k]
    ids[:, n - k:] = HASH_EDGE_IDS[:k]
    buf = torch.empty(offset + ids.size, dtype=torch.int32, device=device)
    cols = buf[offset:].view(10, n)
    cols.copy_(F.narrow_int32(torch.from_numpy(ids)))
    assert cols.is_contiguous() and cols.storage_offset() == offset
    return cols


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 512, 8191, 8192, 262_144 + 3])
@pytest.mark.parametrize("field_size", [1, 1000, 1 << 20, 2**31 - 1])
def test_feature_hash_kernel_equals_plain_on_card(cuda_device, n, field_size, offset):
    """Every kind, bit for bit, on the int4 path (n % 4 == 0 and the column
    block 16-byte aligned: offset 0 or 4) and the scalar one (other n, or
    offset 1)."""
    cols = _hash_cols(n, cuda_device, offset)
    prog = tuple(op + (field_size,) for op in HASH_OPS)
    before = run_hash_layer.launches
    got = run_hash_layer(cols, prog)
    torch.cuda.synchronize()
    assert run_hash_layer.launches == before + 1
    assert torch.equal(got, hash_layer_ref(cols, program=prog))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["cross_features", "sparse_ids"])
def test_feature_hash_kernel_is_deterministic_on_card(cuda_device, op):
    slots, prog = featureplan.compile(get_spec("dlrm")).graph.ops[op].fn.hash_layer
    cols = _hash_cols(8192, cuda_device, seed=1)[:len(slots)].contiguous()
    first, second = run_hash_layer(cols, prog), run_hash_layer(cols, prog)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, hash_layer_ref(cols, program=prog))


@pytest.mark.gpu
def test_feature_hash_kernel_max_ops_on_card(cuda_device):
    """One launch takes ``OPS_PER_LAUNCH`` ops; a longer program runs as
    consecutive launches, each writing its own rows, equal to the plain
    version bit for bit (N = 40 and 8,193 take the scalar path, 8,192 the
    vector one). An empty program is refused as on every device."""
    gen = torch.Generator().manual_seed(3)
    kinds = ("cross", "hash", "mod")
    for k, n in ((2, 40), (3, 8192), (3, 8193)):
        cols = torch.randint(-2**31, 2**31 - 1, (k, n), generator=gen,
                             dtype=torch.int64).to(torch.int32).to(cuda_device)
        for n_ops in (OPS_PER_LAUNCH, OPS_PER_LAUNCH + 1, 130):
            prog = tuple((kinds[i % 3], i % k, (i + 1) % k, 7 + 13 * i) for i in range(n_ops))
            before = run_hash_layer.launches
            got = run_hash_layer(cols, prog)
            assert run_hash_layer.launches - before == -(-n_ops // OPS_PER_LAUNCH)
            assert torch.equal(got, hash_layer_ref(cols, program=prog))
    with pytest.raises(ValueError):
        run_hash_layer(cols, ())


@pytest.mark.gpu
def test_wrappers_refuse_on_the_card_what_they_refuse_elsewhere(cuda_device):
    """The checks that the CPU and meta tests hold (``test_torch_kernels``)
    refuse the same inputs on the card, before any launch."""
    cols = torch.zeros((16, 2), dtype=torch.int32, device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        run_hash_layer(cols, (("hash", 0, 0, 7),))
    with pytest.raises(ValueError, match="at least one op"):
        run_hash_layer(cols.contiguous(), ())
    x = torch.zeros((4, 8, 3), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="x must be contiguous"):
        pairwise_dots(x)
    x = x.contiguous()
    with pytest.raises(ValueError, match="dy must be contiguous"):
        pairwise_dots_backward(x, torch.zeros((3, 4), device=cuda_device).t())
    with pytest.raises(ValueError, match="dy shape"):
        pairwise_dots_backward(x, torch.zeros((4, 2), device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (512, 27, 128), (7, 2, 16), (130, 27, 128), (3, 60, 256),
    # F at the edges of the 4-field padding and of the 32 fields held in
    # registers: F = 33 goes in blocks of 16 fields
    (5, 28, 128), (5, 29, 128), (5, 32, 128), (5, 33, 128),
    (9, 27, 130),                      # D not a multiple of 4 or 32: scalar loads, 2 chunks
    (0, 27, 128), (1, 27, 128),
    (131, 27, 128),                    # an odd B: the last block's warps run past B
    (2, 120, 128),                     # a row of 60 KB, past the default 48 KB of shared memory
    # rows that fit in shared memory only unpadded (F = 450) or 4 columns at a time
    (1, 450, 128), (1, 8000, 5),
])
def test_interaction_dot_kernel_matches_plain_on_card(cuda_device, shape):
    assert not torch.backends.cuda.matmul.allow_tf32   # fp32 matmuls, the default
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    x = x.to(cuda_device)
    before = pairwise_dots.launches
    got = pairwise_dots(x)
    torch.cuda.synchronize()
    assert pairwise_dots.launches == before + (shape[0] > 0)   # B = 0 launches nothing
    want = dot_interaction_ref(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 27, 128), (3, 60, 256)])
def test_interaction_dot_kernel_is_deterministic_on_card(cuda_device, shape):
    """Each output is summed in one fixed order: two calls, the same bits."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=shape).astype(np.float32))
    x = x.to(cuda_device)
    assert torch.equal(pairwise_dots(x), pairwise_dots(x))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (512, 27, 128), (7, 2, 16), (130, 27, 128), (3, 60, 256),
    # the register chunk's edge: F = 32 fills it, F = 33 walks chunks of 4 fields
    (5, 32, 128), (5, 33, 128), (5, 33, 200),
    (9, 27, 200),                      # D not a multiple of 32: the tail is masked
    (0, 27, 128), (1, 27, 128),
    (131, 27, 128),                    # an odd B
    (2, 120, 16),                      # G past the default 48 KB of shared memory
])
def test_interaction_dot_backward_kernel_matches_plain_on_card(cuda_device, shape):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    b, f, _ = shape
    dy = torch.from_numpy(rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32))
    dy = dy.to(cuda_device)
    before = pairwise_dots_backward.launches
    got = pairwise_dots_backward(x, dy)
    torch.cuda.synchronize()
    assert pairwise_dots_backward.launches == before + (b > 0)   # B = 0 launches nothing
    want = dot_interaction_bwd_ref(x, dy)
    assert got.shape == want.shape
    scale = float(want.abs().max()) if b else 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
def test_pairwise_dots_is_differentiable_on_card(cuda_device):
    """The kernel path's gradient equals autograd of the plain forward and
    is not zero (a launch into a fresh tensor would carry no grad_fn)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 27, 128)).astype(np.float32))
    x = x.to(cuda_device).requires_grad_(True)
    dy = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 351)).astype(np.float32))
    dy = dy.to(cuda_device)
    (got,) = torch.autograd.grad(pairwise_dots(x), x, dy)
    (want,) = torch.autograd.grad(dot_interaction_ref(x), x, dy)
    assert float(got.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# request counts as (tiles, extra): tiles x the kernel's tile (the requests
# one block scans) + extra. One block below and at a tile, the look-back
# above it, and at 2**23 a grid of more than one wave of resident blocks.
ALLOC_NS = [(0, 0), (0, 1), (0, 5), (0, 1023), (0, 1024), (0, 1025), (1, -1), (1, 0),
            (1, 1), (2, -1), (2, 3), (0, 1_000_000), (0, 2**23)]


@pytest.mark.gpu
@pytest.mark.parametrize("align", [128, 1, 4096, 1000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tiles_extra", ALLOC_NS, ids=lambda te: f"{te[0]}tile{te[1]:+d}")
def test_alloc_offsets_kernel_equals_plain_on_card(cuda_device, tiles_extra, offset, align):
    n = tiles_extra[0] * alloc_tile() + tiles_extra[1]
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 5000, n).astype(np.int32)
    sizes[::7] = 0
    # a contiguous view `offset` elements into its storage: 1 is misaligned
    buf = torch.empty(offset + n, dtype=torch.int32, device=cuda_device)
    d = buf[offset:]
    d.copy_(torch.from_numpy(sizes))
    before = alloc_offsets.launches
    offsets, head = alloc_offsets(d, align=align)
    torch.cuda.synchronize()
    assert alloc_offsets.launches == before + 1
    want_offsets, want_head = alloc_offsets_ref(torch.from_numpy(sizes), align=align)
    assert torch.equal(offsets.cpu(), want_offsets)
    assert torch.equal(head.cpu(), want_head)


@pytest.mark.gpu
@pytest.mark.parametrize("align", [128, 1000])
@pytest.mark.parametrize("layout", ["one tile", "across tiles", "random int32"])
def test_alloc_offsets_kernel_wraps_like_int32_on_card(cuda_device, layout, align):
    edges = np.array([2**31 - 1, -5, -200, 2**30, 2**30, -(2**31), 77], np.int32)
    if layout == "one tile":
        sizes = edges
    elif layout == "random int32":
        sizes = np.random.default_rng(7).integers(-(2**31), 2**31, 3 * alloc_tile() + 5,
                                                  dtype=np.int64).astype(np.int32)
    else:  # large and negative sizes in different tiles, each sum wrapping
        t = alloc_tile()
        sizes = np.random.default_rng(8).integers(0, 5000, 3 * t + 5).astype(np.int32)
        sizes[[t - 1, t, 2 * t - 1, 2 * t, 2 * t + 1, 3 * t, 3 * t + 4]] = edges
    offsets, head = alloc_offsets(torch.from_numpy(sizes).to(cuda_device), align=align)
    want_offsets, want_head = alloc_offsets_ref(torch.from_numpy(sizes), align=align)
    assert torch.equal(offsets.cpu(), want_offsets) and torch.equal(head.cpu(), want_head)


@pytest.mark.gpu
def test_alloc_offsets_kernel_on_two_streams_at_once_on_card(cuda_device):
    n = 64 * alloc_tile() + 3
    rng = np.random.default_rng(9)
    hosts = [rng.integers(0, 5000, n).astype(np.int32) for _ in range(2)]
    inputs = [torch.from_numpy(h).to(cuda_device) for h in hosts]
    wants = [alloc_offsets_ref(torch.from_numpy(h)) for h in hosts]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    results = []
    for _ in range(5):  # both streams' launches queued before either is waited for
        for d, stream in zip(inputs, streams):
            with torch.cuda.stream(stream):
                results.append(alloc_offsets(d))
    torch.cuda.synchronize()
    for k, (offsets, head) in enumerate(results):
        want_offsets, want_head = wants[k % 2]
        assert torch.equal(offsets.cpu(), want_offsets) and torch.equal(head.cpu(), want_head)


@pytest.mark.gpu
def test_alloc_offsets_kernel_is_deterministic_on_card(cuda_device):
    sizes = np.random.default_rng(10).integers(0, 1 << 16, 300 * alloc_tile() + 1
                                               ).astype(np.int32)
    d = torch.from_numpy(sizes).to(cuda_device)
    results = [alloc_offsets(d) for _ in range(10)]
    want_offsets, want_head = alloc_offsets_ref(torch.from_numpy(sizes))
    for offsets, head in results:
        assert torch.equal(offsets.cpu(), want_offsets) and torch.equal(head.cpu(), want_head)


@pytest.mark.gpu
def test_plan_block_on_card_equals_arena_pool(cuda_device):
    sizes = [4, 8192 * 13 * 4, 8192 * 26 * 4, 0, 129]
    before = alloc_offsets.launches
    offsets, total = plan_block(sizes, device=cuda_device, stream=torch.cuda.Stream(cuda_device))
    assert alloc_offsets.launches == before + 1
    pool = ArenaPool(1 << 24)
    want = pool.alloc_block(sizes)
    assert offsets.tolist() == [a.offset for a in want] and total == pool.head


def _feed_env(layout, rows, seed):
    """Host numpy slots shaped by ``layout``, random bits per seed."""
    rng = np.random.default_rng(seed)
    return {s.name: rng.integers(-(2**20), 2**20, s.shape(rows)).astype(s.dtype)
            for s in layout.slots}


@pytest.mark.gpu
def test_feeder_ring_reuse_never_changes_a_staged_batch_on_card(cuda_device):
    """A ring of 2: four batches staged before any is consumed, then eight
    staged one at a time, each consumer step sitting behind a sleep kernel
    so its reads run late. Every read must see its own batch: an arena whose
    batch has no fence yet is replaced, not rewritten, and a fenced arena is
    rewritten only after the fenced step's reads."""
    layout = featureplan.compile(get_spec("dlrm")).feed_layout()
    feeder = DeviceFeeder(layout, rows_hint=4096, buffers=2, device=cuda_device)
    envs = [_feed_env(layout, 4096, seed) for seed in range(12)]

    def consume(staged):
        torch.cuda._sleep(40_000_000)    # ~20 ms of device time before the reads
        out = {k: staged[k].clone() for k in layout.slot_names}
        feeder.donation_fence()          # an event behind this step's reads
        return out

    ahead = [feeder.stage(e) for e in envs[:4]]
    assert feeder.stats.fresh_arenas == 2
    results = [consume(s) for s in ahead]
    arenas = [a.data_ptr() for a in feeder._dev]
    results += [consume(feeder.stage(e)) for e in envs[4:]]
    torch.cuda.synchronize()
    feeder.flush()
    for env, got in zip(envs, results):
        for k in layout.slot_names:
            np.testing.assert_array_equal(got[k].cpu().numpy(), env[k], err_msg=k)
    assert feeder.stats.fresh_arenas == 2        # the one-ahead phase reused its arenas
    assert [a.data_ptr() for a in feeder._dev] == arenas
    assert feeder.stats.batches == len(envs) and feeder.stats.rewinds == len(envs)


@pytest.mark.gpu
def test_feeder_stages_plan_output_bitwise_on_card(cuda_device):
    plan = featureplan.compile(get_spec("dlrm"))
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=512, device=cuda_device)
    before = alloc_offsets.launches
    for seed in range(3):
        env = plan.run(gen_views(512, seed=seed), device=cuda_device)
        staged = feeder.stage(env)
        for k in plan.output_slots:
            assert staged[k].device.type == "cuda" and torch.equal(staged[k], env[k]), k
        offsets, total = plan.feed_layout().plan(512, use_kernel=True, device="cpu")
        assert [a.offset for a in feeder.last_allocs] == offsets.tolist()
    assert alloc_offsets.launches == before + 3   # one placement per staged batch
    assert feeder.stats.d2h_seconds > 0           # the round trip of CUDA slots


@pytest.mark.gpu
def test_sparse_train_step_kernel_path_equals_plain_on_card(cuda_device):
    """Working-row gradients through the interaction kernels equal autograd
    of the plain forward (within 1e-5 of the largest) and are not zero; the
    training step runs one backward launch."""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.models import recsys as R

    cfg = get_arch("dlrm-mlperf").smoke()
    params = R.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"sparse": np.stack([rng.integers(0, v, 256) for v in cfg.vocab_sizes], 1),
             "dense": rng.exponential(1.0, (256, cfg.n_dense)),
             "label": (rng.random(256) < 0.3)}
    batch = {"sparse": torch.from_numpy(batch["sparse"].astype(np.int32)).to(cuda_device),
             "dense": torch.from_numpy(batch["dense"].astype(np.float32)).to(cuda_device),
             "label": torch.from_numpy(batch["label"].astype(np.float32)).to(cuda_device)}
    before = pairwise_dots_backward.launches
    ws = R.sparse_grads(params, cfg, batch)
    assert pairwise_dots_backward.launches == before + 1
    with mock.patch.object(interaction_ops, "pairwise_dots", dot_interaction_ref):
        plain = R.sparse_grads(params, cfg, batch)
    n = int(ws.n_unique)
    g, want = ws.working_grad[:n], plain.working_grad[:n]
    assert torch.equal(ws.unique, plain.unique)
    assert bool((g.abs().amax(dim=1) > 0).all())
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(ws.loss, plain.loss, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_stage_does_not_wait_for_the_default_stream_on_card(cuda_device):
    """Placement and the copy run on the feeder's own stream: staging a
    batch must not wait behind work already queued on the caller's stream
    (the step in flight)."""
    import time

    layout = featureplan.compile(get_spec("dlrm")).feed_layout()
    feeder = DeviceFeeder(layout, rows_hint=4096, device=cuda_device)
    env = _feed_env(layout, 4096, 0)
    for _ in range(3):                   # warm the pinned and device caches
        feeder.stage(env)
        feeder.donation_fence()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)       # ~200 ms on the current stream
    t0 = time.perf_counter()
    staged = feeder.stage(env)
    seconds = time.perf_counter() - t0
    feeder.donation_fence()
    torch.cuda.synchronize()
    assert seconds < 0.1, f"stage waited {seconds:.3f} s behind the current stream"
    for k in layout.slot_names:
        np.testing.assert_array_equal(staged[k].cpu().numpy(), env[k], err_msg=k)


# ------------------------------------------------------------ embedding_bag
def _bag_inputs(b, l, u, d, device, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, u, (b, l)).astype(np.int32)
    w = ((rng.random((b, l)) < 0.8) * rng.random((b, l))).astype(np.float32)
    table = rng.normal(size=(u, d)).astype(np.float32)
    return (torch.from_numpy(ids).to(device), torch.from_numpy(w).to(device),
            torch.from_numpy(table).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 3, 10, 8), (300, 16, 700, 64), (256, 48, 512, 128),
                                   (33, 5, 1, 16), (1, 1, 2, 8), (1024, 4, 2000, 32),
                                   (8192, 16, 60_000, 128), (70, 6, 90, 10), (9, 1, 40, 128)])
def test_embedding_bag_kernel_matches_plain_on_card(cuda_device, shape):
    """The JAX package's six test shapes, the training batch's interest bag
    (B = 8,192, L = 16, D = 128), a D that is not a multiple of 4 (the
    strided path) and L = 1 (exact)."""
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    b, l, _, _ = shape
    ids, w, table = _bag_inputs(*shape, cuda_device, seed=b)
    before = bag_lookup.launches
    got = bag_lookup(ids, w, table)
    torch.cuda.synchronize()
    assert bag_lookup.launches == before + 1
    want = embedding_bag_ref(ids, w, table)
    if l == 1:
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(scale, 1.0))


@pytest.mark.gpu
def test_embedding_bag_kernel_never_reads_disabled_or_outside_rows_on_card(cuda_device):
    """Zero-weight slots with garbage ids and non-zero weights on ids
    outside [0, U) add nothing and touch no memory outside the table."""
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    table = torch.randn(6, 128, device=cuda_device)
    ids = torch.tensor([[0, 5, 2**31 - 1, -(2**31)], [7, -1, 3, 1_000_000_000]],
                       dtype=torch.int32, device=cuda_device)
    w = torch.tensor([[1.0, 0.0, 0.0, 0.0], [1.0, 2.0, 0.5, 3.0]], device=cuda_device)
    got = bag_lookup(ids, w, table)
    torch.cuda.synchronize()
    assert torch.equal(got, embedding_bag_ref(ids, w, table))
    assert torch.equal(got[0], table[0]) and torch.equal(got[1], 0.5 * table[3])


@pytest.mark.gpu
def test_bag_lookup_raises_without_a_backward_on_card(cuda_device):
    from repro_torch.kernels.embedding_bag.ops import bag_lookup

    ids, w, table = _bag_inputs(8, 4, 20, 16, cuda_device)
    table.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP B4"):
        bag_lookup(ids, w, table)
    with torch.no_grad():
        assert bag_lookup(ids, w, table).grad_fn is None


# ------------------------------------------------------- pipelined runner
def _threaded_runner(plan, step, device, **kw):
    from repro_torch.core.pipeline import PipelinedRunner

    return PipelinedRunner.from_plan(plan, step, device=device, feed="arena",
                                     split_sparse_fields=True, **kw)


def _want_slots(plan, views, device):
    """The copy path's batch for ``views``, in the split layout."""
    out = plan.outputs(plan.run(views, device=device))
    out.update({f"batch_field_{i:02d}": out["batch_sparse"][:, i]
                for i in range(out["batch_sparse"].shape[1])})
    return out


@pytest.mark.gpu
def test_fe_worker_does_not_wait_for_the_callers_stream_on_card(cuda_device):
    """FE runs on the worker's own stream and the arena binding's copies on
    the feeder's: while a ~1 s sleep kernel holds the train thread's stream,
    every later batch is extracted, staged and handed over. An event
    recorded right behind the sleep is still pending when batches 2-4
    arrive, however fast the host is."""
    plan = featureplan.compile(get_spec("dlrm"))
    views = [gen_views(512, seed=300 + i) for i in range(4)]
    slept = torch.cuda.Event()
    pending = []                                 # per batch: the sleep still running?

    def step(state, env):
        if not pending:
            torch.cuda._sleep(2_000_000_000)     # ~1 s on this thread's stream
            slept.record()
        pending.append(not slept.query())
        return state

    _threaded_runner(plan, lambda s, env: s, cuda_device, rows_hint=512).run(0, views)  # warm
    torch.cuda.synchronize()
    runner = _threaded_runner(plan, step, cuda_device, rows_hint=512)
    runner.run(0, views)
    assert len(pending) == 4 and pending[0], "the sleep kernel was not running"
    assert all(pending[1:]), f"batches 2-4 waited behind the caller's stream: {pending}"
    torch.cuda.synchronize()
    assert slept.query()


@pytest.mark.gpu
def test_runner_ring_reuse_never_changes_a_staged_batch_on_card(cuda_device):
    """The feeder thread stages ahead on the default ring of 3 while each
    step reads its batch behind a ~20 ms sleep kernel (longer than the FE of
    a 512-row batch, so the device falls behind the host), then fences it:
    the feeder rewrites each arena in place, and every read still sees its
    own batch, bit for bit the copy path's."""
    plan = featureplan.compile(get_spec("dlrm"))
    views = [gen_views(512, seed=400 + i) for i in range(12)]
    results = []
    runner = None

    def consume(state, env):
        torch.cuda._sleep(40_000_000)
        results.append({k: env[k].clone() for k in runner.device_feed.layout.slot_names})
        runner.device_feed.donation_fence()
        return state

    runner = _threaded_runner(plan, consume, cuda_device, rows_hint=512)
    runner.run(0, views)
    torch.cuda.synchronize()
    assert len(results) == len(views)
    for v, got in zip(views, results):
        want = _want_slots(plan, v, cuda_device)
        for k, t in got.items():
            assert torch.equal(t, want[k]), k
    s = runner.stats.feed
    assert s.batches == len(views) and s.copies_elided == len(views) * len(results[0])
    assert s.fresh_arenas < len(views) // 2      # the ring reused its arenas


@pytest.mark.gpu
def test_pipelined_losses_equal_the_plain_loop_on_card(cuda_device):
    """Four steps of the smoke config through the pipelined arena feed and
    through the plain loop (plan.run -> stage -> make_step) on the
    same batches and params: equal losses (rtol 1e-6)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = get_arch("dlrm-mlperf").smoke()
    plan = featureplan.compile(get_spec("dlrm"))
    views = [gen_views(256, seed=600 + i) for i in range(4)]

    def fresh(split):
        mf = plan.model_feed(cfg, split_sparse_fields=split)
        raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
        params = R.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
        return mf, raw, {"params": params, "opt": init(params)}

    mf, raw, state = fresh(False)
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=256, device=cuda_device)
    step = mf.make_step(raw, fence_cb=feeder.donation_fence)
    plain = []
    for v in views:
        p, o, m = step(state["params"], state["opt"], feeder.stage(plan.run(v, device=cuda_device)))
        state = {"params": p, "opt": o}
        plain.append(float(m["loss"]))

    mf, raw, state = fresh(True)
    ab = plan.arena_binding(split_sparse_fields=True)
    feeder = ab.make_feeder(rows_hint=256, device=cuda_device)
    fused = mf.make_step(raw, fence_cb=feeder.donation_fence)
    piped = []

    def train(state, env):
        p, o, m = fused(state["params"], state["opt"], env)
        piped.append(float(m["loss"]))
        return {"params": p, "opt": o}

    PipelinedRunner(ab.layers, train, device=cuda_device, device_feed=feeder).run(state, views)
    assert all(np.isfinite(plain))
    np.testing.assert_allclose(piped, plain, rtol=1e-6)


# ------------------------------------------------- hierarchical PS feed
def _ps_feed_setup(tmp_path, device, *, host_cache_rows=64, cls=None):
    """A smoke-config HierarchyFeed on the card over a random PS file, its
    ModelFeed, the file's rows, and packed envs on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.embedding.hierarchy import HierarchicalPS
    from repro_torch.embedding.psfeed import HierarchyFeed
    from repro_torch.fe.modelfeed import ModelFeed

    cfg = get_arch("dlrm-mlperf").smoke()
    rows = int(cfg.multi_table().total_rows)
    rng = np.random.default_rng(0)
    init = rng.uniform(-0.25, 0.25, (rows, cfg.embed_dim + 1)).astype(np.float32)
    init[:, -1] = 0.1
    init.tofile(tmp_path / "ps.bin")
    ps = HierarchicalPS(str(tmp_path / "ps.bin"), total_rows=rows, dim=cfg.embed_dim + 1,
                        host_cache_rows=host_cache_rows)
    mf = ModelFeed(config=cfg, slots=("batch_label", "batch_sparse"), split=False,
                   n_spec_fields=cfg.n_sparse, field_sources=np.arange(cfg.n_sparse),
                   vocab=np.asarray(cfg.vocab_sizes, np.int32), dense_from="sparse",
                   seq_from=None, dedup_capacity=cfg.dedup_capacity)
    hier = (cls or HierarchyFeed)(ps, mf, device=device)
    envs = []
    for seed in range(8):
        r = np.random.default_rng(100 + seed)
        envs.append({"batch_sparse": torch.from_numpy(
                         r.integers(0, 1 << 30, (64, cfg.n_sparse))).to(device),
                     "batch_label": torch.from_numpy(
                         (r.random(64) < 0.25).astype(np.float32)).to(device)})
    return cfg, mf, hier, init, envs


def _pulled_rows(cfg, mf, init, envs):
    """What each batch must see when every step pushes its rows + 1 and its
    accumulators + 0.5: the serial pull-train-push on a host mirror."""
    from repro_torch.embedding.dedup import dedup_np
    from repro_torch.embedding.psfeed import collect_gids_np

    mirror, want = init.copy(), []
    for env in envs:
        sparse, _ = mf.model_ids_np(env)
        unique, _ = dedup_np(collect_gids_np(cfg, sparse)["sparse"])
        want.append((unique, mirror[unique].copy()))
        mirror[unique, :-1] += np.float32(1.0)
        mirror[unique, -1] += np.float32(0.5)
    return want, mirror


@pytest.mark.gpu
def test_ps_feed_working_set_is_the_pulled_rows_on_card(cuda_device, tmp_path):
    """The runner's ps-feeder thread pulls ahead while every pack's copies
    queue behind a ~50 ms sleep kernel on its stream, and each step reads
    its working set behind a ~10 ms one on the train stream, then pushes
    rows + 1: every step sees exactly the rows a serial pull-train-push
    gives (the train stream waits for the pack's event; a pinned buffer is
    reused only after its copy; fixups see the pushes), and the file ends
    as the host mirror."""
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.embedding.psfeed import WS_META, HierarchyFeed

    class LateCopies(HierarchyFeed):
        def _pack(self, *args):
            torch.cuda._sleep(100_000_000)       # the copies land ~50 ms late
            return super()._pack(*args)

    cfg, mf, hier, init, envs = _ps_feed_setup(tmp_path, cuda_device, cls=LateCopies)
    want, mirror = _pulled_rows(cfg, mf, init, envs)
    seen = []

    def step(state, env):
        torch.cuda._sleep(20_000_000)            # the train stream is busy
        seq, unique = env[WS_META]
        n = len(unique)
        seen.append((unique, env["_ws_rows"][:n].clone(), env["_ws_accum"][:n].clone(),
                     env["_ws_unique"].clone()))
        hier.complete(env[WS_META], env["_ws_rows"] + 1.0, env["_ws_accum"] + 0.5)
        return state + 1

    torch.cuda.synchronize()
    runner = PipelinedRunner([], step, ps_feed=hier, device=cuda_device)
    assert runner.run(0, envs) == len(envs)
    hier.drain()
    torch.cuda.synchronize()
    assert hier.error is None and hier.stats.fixups > 0
    for (unique, rows, accum, ws_unique), (want_u, want_rows) in zip(seen, want):
        np.testing.assert_array_equal(unique, want_u)
        np.testing.assert_array_equal(rows.cpu().numpy(), want_rows[:, :-1])
        np.testing.assert_array_equal(accum.cpu().numpy(), want_rows[:, -1])
        np.testing.assert_array_equal(ws_unique.cpu().numpy()[:len(unique)], want_u)
        assert bool((ws_unique[len(unique):] == 2**31 - 1).all())
    np.testing.assert_array_equal(np.asarray(hier.ps._ssd), mirror)


@pytest.mark.gpu
def test_write_back_pushes_the_steps_rows_without_a_sync_on_card(cuda_device, tmp_path):
    """``complete`` returns at once while the step that computes the rows
    is still queued behind a ~200 ms sleep kernel; the writer pushes the
    step's rows (not the pulled ones) only once that step and its copy are
    done, and while a ~1 s sleep of the next step still runs."""
    import time

    from repro_torch.embedding.psfeed import WS_META

    cfg, mf, hier, init, envs = _ps_feed_setup(tmp_path, cuda_device)
    # Warm the caches (pinned host, device) and load every kernel used below:
    # loading a kernel's module at its first launch waits for the device to
    # be idle, which would hold the host until the sleep kernel is done.
    for _ in range(2):
        env = hier.prepare(envs[0])
        hier.complete(env[WS_META], env["_ws_rows"] * 2.0 + 1.0, env["_ws_accum"] + 0.25)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    env = hier.prepare(envs[0])
    unique = env[WS_META][1]
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)                # ~200 ms: the step
    new_rows, new_accum = env["_ws_rows"] * 2.0 + 1.0, env["_ws_accum"] + 0.25
    step_done = torch.cuda.Event()
    step_done.record()
    t0 = time.perf_counter()
    hier.complete(env[WS_META], new_rows, new_accum)
    returned = time.perf_counter() - t0
    del new_rows, new_accum                       # the copy stream keeps them alive
    torch.cuda._sleep(2_000_000_000)              # ~1 s: the next step
    next_done = torch.cuda.Event()
    next_done.record()
    assert returned < 0.1, f"complete waited {returned:.3f} s for the device"
    deadline = time.perf_counter() + 10
    while hier.ps.stats.pushes < 3:
        assert time.perf_counter() < deadline and hier.error is None
        time.sleep(0.002)
    assert step_done.query(), "the writer pushed before the step was done"
    assert not next_done.query(), "the writer waited for the next step too"
    n = len(unique)
    want = env["_ws_rows"][:n].cpu().numpy() * 2.0 + 1.0
    got = hier.ps.read_rows(unique)
    np.testing.assert_array_equal(got[:, :-1], want)
    np.testing.assert_array_equal(got[:, -1], env["_ws_accum"][:n].cpu().numpy() + 0.25)
    hier.drain()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_ps_runner_equals_the_serial_loop_on_card(cuda_device, tmp_path):
    """The hierarchy step (smoke config) through the runner's ps_feed stage
    and through a serial prepare / step / complete loop on the same batches
    and params: losses within rtol 1e-6, PS rows within 1e-6 (the working
    set gather's index backward may add in another order, ROADMAP C14)."""
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.embedding.psfeed import WS_META, WS_SLOTS
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    def run(threaded):
        d = tmp_path / ("t" if threaded else "s")
        d.mkdir()
        cfg, mf, hier, _, envs = _ps_feed_setup(d, cuda_device, host_cache_rows=32)
        raw, init = R.make_hierarchy_train_step(cfg, adamw(1e-3))
        params = R.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                               include_embed=False)
        fused = mf.make_step(raw, extra_slots=WS_SLOTS)
        losses = []

        def step_fn(state, env):
            p, o, m = fused(state["params"], state["opt"], env)
            hier.complete(env[WS_META], m["ws_rows"], m["ws_accum"])
            losses.append(float(m["loss"]))
            return {"params": p, "opt": o}

        state = {"params": params, "opt": init(params)}
        torch.cuda.synchronize()
        if threaded:
            PipelinedRunner([], step_fn, ps_feed=hier, device=cuda_device).run(state, envs)
        else:
            for env in envs:
                state = step_fn(state, hier.prepare(env))
        hier.drain()
        assert hier.error is None and hier.stats.completed == len(envs)
        return losses, np.asarray(hier.ps._ssd).copy()

    losses_t, table_t = run(True)
    losses_s, table_s = run(False)
    assert all(np.isfinite(losses_t))
    np.testing.assert_allclose(losses_t, losses_s, rtol=1e-6)
    np.testing.assert_allclose(table_t, table_s, rtol=0, atol=1e-6)


# ------------------------------------------------- the in-memory smoke chains
# Card against CPU, every loss of a 24-step chain (PERF.md §6, written before
# the first chip run): fp32 sums in another order, compounded over the steps.
CARD_CHAIN_RTOL = 1e-4


def _card_params(np_params, device):
    """The chain's params on the card: JAX's init params from the fixture."""
    from repro_torch.models.recsys import params_from_jax
    return params_from_jax(np_params, device)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", ["loop/dlrm-mlperf", "loop/dcn-v2", "loop/autoint",
                                   "loop/bst"])
def test_in_memory_smoke_chain_on_card_matches_the_cpu(cuda_device, curve):
    """The in-memory driver's smoke chain (``run_in_memory``, 24 steps of 64
    rows) from the JAX curve fixture's params, on the card and on the CPU.
    The same chain: the card's params are the CPU chain's bit for bit (a
    dense param one ulp off moves a loss by about as much as the summation
    order does, so only this catches it), and the batches come from the
    same numpy draws. Every loss within ``CARD_CHAIN_RTOL``, which the card's
    chain with its dense params 1e-3 (relative) off fails (as on the CPU,
    ``test_torch_curves.py``); the kernels of the path launch once per step
    in each direction (dlrm) or never."""
    import curve_fixture
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots, pairwise_dots_backward

    entry = curve_fixture.load()[curve]
    cpu = curve_fixture.port_losses(curve, entry, torch.device("cpu"))
    params = _card_params(entry["params"], cuda_device)
    for k, v in entry["params"].items():
        got = params[k].cpu().numpy()
        assert got.dtype == v.dtype and np.array_equal(got.view(np.uint32), v.view(np.uint32)), k
    before = pairwise_dots.launches, pairwise_dots_backward.launches
    card = curve_fixture.port_losses(curve, entry, cuda_device, params=params)
    torch.cuda.synchronize()
    steps = int(entry["steps"]) if curve == "loop/dlrm-mlperf" else 0
    assert (pairwise_dots.launches - before[0], pairwise_dots_backward.launches - before[1]) \
        == (steps, steps)
    assert len(card) == len(cpu) == int(entry["steps"]) and all(np.isfinite(card))
    np.testing.assert_allclose(card, cpu, rtol=CARD_CHAIN_RTOL)


@pytest.mark.gpu
def test_bst_stream_smoke_chain_on_card_matches_the_cpu(cuda_device):
    """The streaming driver's BST smoke chain (``--spec bst --device-feed
    arena --fault-tolerant``, 24 steps of 128-row shards) from the JAX
    curve fixture's params, on the card and on the CPU, as the in-memory
    chains above: params bit-equal, every loss within ``CARD_CHAIN_RTOL``
    (which the chain with one dense param 1e-3 off fails, as on the CPU,
    ``test_torch_curves.py``), and the ``bst`` spec's one ``feature_hash``
    layer and the arena's ``mempool_alloc`` launched once per batch."""
    import curve_fixture

    curve = "stream/bst"
    entry = curve_fixture.load()[curve]
    cpu = curve_fixture.port_losses(curve, entry, torch.device("cpu"))
    params = _card_params(entry["params"], cuda_device)
    for k, v in entry["params"].items():
        got = params[k].cpu().numpy()
        assert got.dtype == v.dtype and np.array_equal(got.view(np.uint32), v.view(np.uint32)), k
    before = run_hash_layer.launches, alloc_offsets.launches
    card = curve_fixture.port_losses(curve, entry, cuda_device, params=params)
    torch.cuda.synchronize()
    steps = int(entry["steps"])
    assert (run_hash_layer.launches - before[0], alloc_offsets.launches - before[1]) == \
        (steps, steps)
    assert len(card) == len(cpu) == steps and all(np.isfinite(card))
    np.testing.assert_allclose(card, cpu, rtol=CARD_CHAIN_RTOL)


# ------------------------------------------------------------ mesh (slice 11)
MESH_CFG = dict(name="t", kind="dlrm", n_dense=13, n_sparse=6, embed_dim=16,
                vocab_sizes=(64, 32, 128, 16, 8, 40), bot_mlp=(32, 16), top_mlp=(64, 32, 1),
                dedup_capacity=256, row_align=8)


def _mesh_batch(i, device):
    r = np.random.default_rng(i)
    b = {"dense": r.normal(size=(64, 13)).astype(np.float32),
         "sparse": np.stack([r.integers(0, v, 64) for v in MESH_CFG["vocab_sizes"]],
                            1).astype(np.int32),
         "label": r.integers(0, 2, 64).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@pytest.mark.gpu
def test_mesh_1x1_nccl_step_equals_the_sparse_step_on_card(cuda_device):
    """A 1x1 mesh on an NCCL group of one: five steps bit for bit the sparse
    step's (losses, params, Adam state, accumulators)."""
    import torch.distributed as dist

    import repro_torch.models.recsys as R
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.optimizer import adamw

    cfg = R.RecsysConfig(**MESH_CFG)
    mesh = make_train_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        _mesh_steps_equal_the_sparse_steps(R, cfg, mesh, adamw(1e-3), cuda_device)
    finally:
        dist.destroy_process_group()


def _mesh_steps_equal_the_sparse_steps(R, cfg, mesh, opt, cuda_device):
    p0 = R.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    step_s, init_s = R.make_sparse_train_step(cfg, opt)
    step_m, init_m = R.make_mesh_train_step(cfg, opt, mesh=mesh, compress=None)
    ps = {k: v.clone() for k, v in p0.items()}
    pm = {k: v.clone() for k, v in p0.items()}
    os_, om = init_s(ps), init_m(pm)
    pm, om = R.shard_train_state(mesh, pm, om)
    for i in range(5):
        b = _mesh_batch(i, cuda_device)
        ps, os_, ms = step_s(ps, os_, b)
        pm, om, mm = step_m(pm, om, b)
        assert float(ms["loss"]) == float(mm["loss"]), i
        assert int(ms["unique"]) == int(mm["unique"])
    for k in ps:
        assert torch.equal(ps[k], pm[k]), k
    assert torch.equal(os_["embed_accum"], om["embed_accum"])
    for m in ("m", "v"):
        for k in os_["dense"][m]:
            assert torch.equal(os_["dense"][m][k], om["dense"][m][k]), (m, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 257, 1 << 20])
def test_codecs_on_card_equal_their_cpu_results(cuda_device, n):
    from repro_torch.train import compression as PC

    rng = np.random.default_rng(n)
    for _ in range(4):
        g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 3)).astype(np.float32)
        r = (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, -1)).astype(np.float32)
        cpu = (torch.from_numpy(g), torch.from_numpy(r))
        card = tuple(t.to(cuda_device) for t in cpu)
        w, res = PC.bf16_compress(*cpu)
        wc, resc = PC.bf16_compress(*card)
        assert torch.equal(w.view(torch.int16), wc.cpu().view(torch.int16))
        assert torch.equal(res.view(torch.int32), resc.cpu().view(torch.int32))
        q, s, res = PC.int8_compress(*cpu)
        qc, sc, resc = PC.int8_compress(*card)
        assert torch.equal(q, qc.cpu())
        assert torch.equal(s.view(torch.int32), sc.cpu().view(torch.int32))
        assert torch.equal(res.view(torch.int32), resc.cpu().view(torch.int32))


@pytest.mark.gpu
def test_traced_smoke_run_has_fe_layer_spans_on_the_fe_worker(cuda_device, tmp_path):
    import json

    from repro_torch.launch import train as T
    from repro_torch.obs.trace import get_tracer, set_tracer
    from repro_torch.obs.validate import validate_trace

    trace = tmp_path / "trace.json"
    prev = get_tracer()
    try:
        T.main(["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path / "d"), "--gen-shards", "3",
                "--batch", "64", "--spec", "dlrm", "--device-feed", "arena", "--steps", "3",
                "--fault-tolerant", "--trace", str(trace)])
    finally:
        set_tracer(prev)
    summary = validate_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    fe = [t for t, name in summary["tracks"].items() if name == "fe-worker"]
    layers = [e for e in events if e["ph"] == "B" and e["name"] == "fe.layer" and e["tid"] in fe]
    assert fe and len(layers) == 3 * 4   # 4 super-layers of the arena-bound dlrm plan
    assert {e["args"]["layer"] for e in layers} == {0, 1, 2, 3}


# ------------------------------------------------------ static checks, cost
@pytest.mark.gpu
@pytest.mark.parametrize("preset,arch", [("ads_ctr", "dlrm-mlperf"), ("dlrm", "dlrm-mlperf"),
                                         ("bst", "bst")])
def test_run_check_on_card_equals_the_cpu(cuda_device, preset, arch):
    """The kernel planner runs on the card (2 launches: packed and split
    layouts) and the report is the CPU's, finding for finding."""
    from repro_torch.check import run_check

    def findings(r):
        return sorted((f.rule, f.severity, f.location, f.message) for f in r.findings)

    before = alloc_offsets.launches
    card = run_check(preset, arch, device="cuda")
    assert alloc_offsets.launches == before + 2
    cpu = run_check(preset, arch, device="cpu")
    assert card.exit_code == 0 and not card.crashed, card.render()
    assert findings(card) == findings(cpu) and card.analyzers_run == cpu.analyzers_run
    assert not torch.distributed.is_initialized()


@pytest.mark.gpu
def test_kernel_plan_mutant_and_multi_tile_layout_on_card(cuda_device):
    """One offset of the kernel's plan moved by 128 is AL204; a layout of
    20,000 slots (the kernel's multi-block form) is clean."""
    from unittest import mock

    from repro_torch.check import aliasing
    from repro_torch.core.devicefeed import FeedLayout, SlotSpec

    layout = featureplan.compile(get_spec("dlrm")).feed_layout(split_sparse_fields=True)
    real = aliasing.plan_block

    def moved(sizes, **kw):
        offsets, total = real(sizes, **kw)
        offsets = offsets.copy()
        offsets[1] += 128
        return offsets, total

    assert aliasing.check_feed_layout(layout, 8192, device=cuda_device) == []
    with mock.patch.object(aliasing, "plan_block", moved):
        assert "AL204" in {f.rule for f in aliasing.check_feed_layout(layout, 8192,
                                                                      device=cuda_device)}
    big = FeedLayout(slots=tuple(SlotSpec(f"s{i:05d}", 1 + i % 7, "float32", rank1=i % 7 == 0)
                                 for i in range(20_000)))
    assert 20_000 > alloc_tile()
    assert aliasing.check_feed_layout(big, 3, device=cuda_device) == []


@pytest.mark.gpu
def test_step_cost_of_card_tensors_equals_the_cpus_and_allocates_nothing(cuda_device):
    from repro_torch.configs import get_arch
    from repro_torch.launch.hlo_stats import step_cost
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = get_arch("dlrm-mlperf").smoke()
    totals = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        raw, init = R.make_sparse_train_step(cfg, adamw(1e-3))
        opt = init(params)
        batch = synthetic_batch("recsys", cfg, 256, 0, device=dev)
        before = {k: v.clone() for k, v in params.items()}
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated(cuda_device)
        launches = (pairwise_dots.launches, pairwise_dots_backward.launches)
        totals[dev.type] = step_cost(raw, params, opt, batch)
        assert torch.cuda.memory_allocated(cuda_device) == mem
        assert (pairwise_dots.launches, pairwise_dots_backward.launches) == launches
        assert all(torch.equal(params[k], before[k]) for k in params)
    assert totals["cuda"] == totals["cpu"] and totals["cuda"].flops > 0


@pytest.mark.gpu
def test_scan_preset_on_card_allocates_nothing(cuda_device):
    """The effects scan (the 1x1 mesh step on an NCCL group of one
    included) runs on meta tensors: no device memory, no group left."""
    from repro_torch.check import effects
    from repro_torch.configs import get_arch

    plan = featureplan.compile(get_spec("dlrm"))
    mf = plan.model_feed(get_arch("dlrm-mlperf").config, split_sparse_fields=True,
                         rows_hint=8192)
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated(cuda_device)
    assert effects.scan_preset(plan, mf, rows=8192, device=cuda_device) == []
    assert torch.cuda.memory_allocated(cuda_device) == mem
    assert not torch.distributed.is_initialized()


@pytest.mark.gpu
def test_driver_check_metrics_on_card_preflights_once_and_keeps_the_losses(cuda_device,
                                                                          tmp_path, capsys):
    """``main`` with ``--check --metrics`` on the card: the preflight runs
    once (its two kernel-planner launches), the registry has its ``check``
    and ``hlo`` tiers, and the losses are the unflagged run's bit for bit."""
    import json

    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train as T

    write_log_shards(str(tmp_path), n_shards=3, rows_per_shard=64, seed=0)
    argv = ["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path), "--spec", "dlrm",
            "--device-feed", "arena", "--steps", "3", "--fault-tolerant", "--device", "cuda"]
    runs = []
    for flags in ([], ["--check", "--metrics"]):
        before = alloc_offsets.launches
        _, losses = T.main(argv + flags)
        runs.append((losses, alloc_offsets.launches - before, capsys.readouterr().out))
    (plain, plain_n, _), (flagged, flagged_n, out) = runs
    assert flagged == plain and len(plain) == 3
    assert flagged_n == plain_n + 2 and out.count("check: 4 analyzers") == 1
    reg = json.loads(out.partition("metrics:\n")[2])
    assert {"check", "hlo", "pipeline"} <= {k.split(".")[0] for k in reg}
    assert reg["check.exit_code"] == 0 and reg["hlo.flops"] > 0


# ------------------------------------------------------------- the LM family
def _flash_inputs(b, s, h, hk, dh, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g) for shape in
                   ((b, s, h, dh), (b, s, hk, dh), (b, s, hk, dh), (b, s, h, dh)))
    return [t.to(device) for t in (q, k, v, do)]


def _flash_vjp(q, k, v, do, **kw):
    from repro_torch.models.attention import flash_attention

    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, **kw)
    out.backward(do)
    return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,hk,causal,qb,kb", [
    (40, 4, 2, True, 16, 16), (40, 4, 2, False, 16, 16), (100, 8, 1, True, 32, 16),
    (64, 8, 8, True, 16, 32)])
def test_flash_attention_on_card_matches_the_cpu(cuda_device, s, h, hk, causal, qb, kb):
    """Forward and the three gradients at smoke shapes (GQA groups 1, 2 and
    8; padded last blocks), card against CPU: fp32 both (no TF32), each
    within 1e-5 of its largest |value| (sums in another order)."""
    kw = dict(causal=causal, q_block=qb, kv_block=kb)
    cpu = _flash_vjp(*_flash_inputs(2, s, h, hk, 16, "cpu"), **kw)
    card = _flash_vjp(*_flash_inputs(2, s, h, hk, 16, cuda_device), **kw)
    for c, g in zip(card, cpu):
        assert float((c - g).abs().max()) <= 1e-5 * float(g.abs().max())


@pytest.mark.gpu
def test_flash_attention_memory_is_linear_in_s_on_card(cuda_device):
    """At S = 4,096 (yi-9b's heads: 32 over 4 KV heads of 128) the forward
    and backward of flash attention peak at under a quarter of the
    quadratic reference's (its (S, S) scores alone are 2 GiB in fp32)."""
    from repro_torch.models.attention import attention_ref

    q, k, v, do = _flash_inputs(1, 4096, 32, 4, 128, cuda_device)
    peaks = []
    for fn in (lambda q, k, v: _flash_vjp(q, k, v, do),
               lambda q, k, v: attention_ref(q.requires_grad_(True), k.requires_grad_(True),
                                             v.requires_grad_(True)).backward(do)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        fn(*(t.detach().clone() for t in (q, k, v)))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(cuda_device) - base)
    assert peaks[1] > 4 * 2**30 and peaks[0] < peaks[1] / 4, peaks


def _lm_params(curve, device):
    import curve_fixture
    return curve_fixture.start_params(curve, curve_fixture.load()[curve], device)


LM_CURVES = ["loop/yi-9b", "loop/qwen2.5-14b", "loop/deepseek-moe-16b", "loop/deepseek-v2-236b"]


@pytest.mark.gpu
@pytest.mark.parametrize("curve", LM_CURVES)
def test_decode_equals_prefill_on_card(cuda_device, curve):
    """``serve_step`` token by token from an empty cache against ``prefill``
    of the prefix at its last position, fp32 at the smoke config (the
    fixture's numpy-drawn params; the MoE archs at the capacity factor where
    no pair drops, ``n_experts / top_k``, ROADMAP C25): within rtol/atol
    1e-5 (the CPU test's bound), and the card's logits against the CPU's
    the same."""
    import dataclasses

    import curve_fixture
    from repro_torch.models import transformer as T

    cfg = curve_fixture.curve_config(curve)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 40))
                            .astype(np.int32))
    runs = []
    for dev in (torch.device("cpu"), cuda_device):
        params = _lm_params(curve, dev)
        cache = T.make_cache(cfg, 4, 48, device=dev)
        logits = []
        for t in range(40):
            lg, cache = T.serve_step(params, toks[:, t:t + 1].to(dev), cache, t, cfg)
            if t in (0, 15, 16, 39):       # one block, its edge, past it, the last
                pf = T.prefill(params, toks[:, :t + 1].to(dev), cfg)
                torch.testing.assert_close(lg, pf, rtol=1e-5, atol=1e-5)
            logits.append(lg.cpu())
        runs.append(torch.stack(logits))
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", LM_CURVES)
def test_lm_smoke_chain_on_card_matches_the_cpu(cuda_device, curve):
    """The lm driver's in-memory chain (24 steps of 64 sequences of 64
    tokens, AdamW, the transformer's ``make_train_step``) from the fixture's
    params, on the card and on the CPU: the same params bit for bit, every
    loss within ``CARD_CHAIN_RTOL``, the loss falling, and no kernel of the
    TPU ports launched (none lies on the LM path)."""
    import curve_fixture
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots
    from repro_torch.train.optimizer import flatten

    entry = curve_fixture.load()[curve]
    cpu_params, params = _lm_params(curve, torch.device("cpu")), _lm_params(curve, cuda_device)
    for k, v in flatten(cpu_params).items():
        assert torch.equal(flatten(params)[k].cpu(), v), k
    cpu = curve_fixture.port_losses(curve, entry, torch.device("cpu"))
    before = pairwise_dots.launches, alloc_offsets.launches, run_hash_layer.launches
    card = curve_fixture.port_losses(curve, entry, cuda_device, params=params)
    torch.cuda.synchronize()
    assert (pairwise_dots.launches, alloc_offsets.launches, run_hash_layer.launches) == before
    assert len(card) == len(cpu) == int(entry["steps"]) and card[-1] < card[0]
    np.testing.assert_allclose(card, cpu, rtol=CARD_CHAIN_RTOL)


@pytest.mark.gpu
def test_lm_driver_trains_on_the_card(cuda_device, capsys):
    """``python -m repro_torch.launch.train --arch yi-9b`` without
    ``--device``: on the card, the loss falling, ``--metrics`` costing the
    step on meta copies."""
    from repro_torch.launch import train as T

    stats, losses = T.main(["--arch", "yi-9b", "--steps", "4", "--batch", "8", "--metrics"])
    out = capsys.readouterr().out
    assert stats.steps == 4 and losses[-1] < losses[0] and "hlo/step:" in out


# ------------------------------------------------------------ MoE and PNA
MOE_PLAN_CASES = [(32, 2, 4, 64, "random"), (40, 3, 8, 9, "random"), (16, 2, 8, 1, "random"),
                  (16, 1, 2, 8, "one"), (4096, 6, 64, 480, "random")]


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,e,cap,routes", MOE_PLAN_CASES)
def test_moe_dispatch_plan_on_card_is_the_cpus(cuda_device, t, k, e, cap, routes):
    """The sort-based dispatch plan (``order``, ``sorted_e``, ``pos``,
    ``keep``, ``token``) on the card, bit for bit the CPU's (itself JAX's,
    ``tests/test_torch_moe.py``): random routes with and without drops, a
    capacity of 1, every pair on one expert, and deepseek-moe-16b's top 6
    of 64 at a train_4k microbatch's capacity."""
    from repro_torch.models import moe as M

    c = M.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8)
    rng = np.random.default_rng(t)
    top_e = (np.stack([rng.permutation(e)[:k] for _ in range(t)]) if routes == "random"
             else np.zeros((t, k), np.int64)).astype(np.int32)
    cpu = M._dispatch_indices(torch.from_numpy(top_e), c, cap)
    card = M._dispatch_indices(torch.from_numpy(top_e).to(cuda_device), c, cap)
    for g, w in zip(card, cpu):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _moe_inputs(device, t=512, d=64, seed=0):
    from repro_torch.models import moe as M

    c = M.MoEConfig(n_experts=16, top_k=4, d_ff_expert=32, n_shared=2, capacity_factor=1.25)
    rng = np.random.default_rng(seed)
    p = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32)).to(device)
         for k, s in M.moe_params_shape(d, c).items()}
    x = torch.from_numpy((rng.normal(size=(t, d)) * 0.5).astype(np.float32)).to(device)
    return c, p, x


@pytest.mark.gpu
def test_moe_ffn_on_card_repeats_and_matches_the_cpu(cuda_device):
    """``moe_ffn`` in fp32 with drops (capacity factor 1.25): the card's
    routes and dropped pairs the CPU's, its output within 1e-5 of the
    largest |value| of the CPU's (GEMM sums in another order), the aux to
    rtol 1e-5, and a second call on the card bit for bit the first (the
    combine adds each token's rows in a fixed order, no atomics)."""
    from repro_torch.models import moe as M

    c, p, x = _moe_inputs("cpu")
    out, aux = M.moe_ffn(p, x, c)
    cp = {k: v.to(cuda_device) for k, v in p.items()}
    cx = x.to(cuda_device)
    got, gaux = M.moe_ffn(cp, cx, c)
    again, _ = M.moe_ffn(cp, cx, c)
    assert torch.equal(got, again)
    assert torch.equal(M._route(cx, cp["router"], c)[0].cpu(), M._route(x, p["router"], c)[0])
    keep = [M._dispatch_indices(M._route(t, r, c)[0], c, M.capacity(t.shape[0], c))[3]
            for t, r in ((cx, cp["router"]), (x, p["router"]))]
    assert torch.equal(keep[0].cpu(), keep[1]) and not bool(keep[1].all())
    assert float((got.cpu() - out).abs().max()) <= 1e-5 * float(out.abs().max())
    torch.testing.assert_close(gaux.cpu(), aux, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_pna_segment_ops_on_card_match_the_cpu(cuda_device):
    """PNA's segment ops on a random graph (isolated nodes among them): the
    max and min bit for bit the CPU's; a sum (``index_add_``, atomics on
    the card) within n eps of the sum of |terms| of each segment, n its
    terms; ``pna_layer``'s output within 1e-5 of its largest |value|."""
    from repro_torch.models import gnn as G

    rng = np.random.default_rng(0)
    n, e, d = 300, 2000, 24
    m = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, n - 10, e))
    for reduce in ("amax", "amin"):
        assert torch.equal(G._segment_extreme(m.to(cuda_device), dst.to(cuda_device), n,
                                              reduce).cpu(), G._segment_extreme(m, dst, n, reduce))
    s_cpu = G.segment_sum(m, dst, n)
    s_card = G.segment_sum(m.to(cuda_device), dst.to(cuda_device), n).cpu()
    count = G.segment_sum(torch.ones(e), dst, n)[:, None]
    bound = count * torch.finfo(torch.float32).eps * G.segment_sum(m.abs(), dst, n)
    assert bool(((s_card - s_cpu).abs() <= bound).all())
    cfg = G.PNAConfig(name="t", n_layers=1, d_in=d, d_hidden=d, n_classes=3)
    params = G.init_params(cfg, torch.Generator().manual_seed(0))
    h = torch.relu(m[:n])
    src = torch.from_numpy(rng.integers(0, n, e))
    want = G.pna_layer(params, 0, h, src, dst, cfg, n)
    got = G.pna_layer({k: v.to(cuda_device) for k, v in params.items()}, 0, h.to(cuda_device),
                      src.to(cuda_device), dst.to(cuda_device), cfg, n).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("curve", ["loop/pna", "full/pna"])
def test_pna_chain_on_card_matches_the_cpu(cuda_device, curve):
    """PNA's chains (the driver's 24 smoke steps; published PNA on the
    Cora-size graph, 5 steps) from the fixture's params on the card and on
    the CPU: the params bit for bit, the first loss within rtol 1e-5, every
    loss within ``curve_fixture.PNA_RTOL`` (a chaotic trajectory,
    ``tests/rehearse_pna.py``), no kernel of the TPU ports launched."""
    import curve_fixture
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots

    entry = curve_fixture.load()[curve]
    cpu_params = curve_fixture.start_params(curve, entry, torch.device("cpu"))
    params = curve_fixture.start_params(curve, entry, cuda_device)
    for k, v in cpu_params.items():
        assert torch.equal(params[k].cpu(), v), k
    cpu = curve_fixture.port_losses(curve, entry, torch.device("cpu"))
    before = pairwise_dots.launches, alloc_offsets.launches, run_hash_layer.launches
    card = curve_fixture.port_losses(curve, entry, cuda_device, params=params)
    torch.cuda.synchronize()
    assert (pairwise_dots.launches, alloc_offsets.launches, run_hash_layer.launches) == before
    assert len(card) == len(cpu) == int(entry["steps"]) and card[-1] < card[0]
    np.testing.assert_allclose(card[0], cpu[0], rtol=curve_fixture.PNA_FIRST_RTOL)
    np.testing.assert_allclose(card, cpu, rtol=curve_fixture.PNA_RTOL[curve])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["pna", "deepseek-moe-16b"])
def test_moe_and_pna_driver_trains_on_the_card(cuda_device, arch, capsys):
    """``python -m repro_torch.launch.train --arch pna|deepseek-moe-16b``
    without ``--device``: on the card, ``--metrics`` costing the step on
    meta copies; the loss falls over 8 steps."""
    from repro_torch.launch import train as T

    stats, losses = T.main(["--arch", arch, "--steps", "8", "--batch", "8", "--metrics"])
    out = capsys.readouterr().out
    assert stats.steps == 8 and losses[-1] < losses[0] and "hlo/step:" in out


@pytest.fixture(scope="module")
def pna_molecule_on_card():
    """``pna x molecule`` at a 1x1 mesh: its dry-run figures and one
    ``measure_on_device`` of it (phase 20(c) of ``chip_smoke.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import Mesh
    from repro_torch.launch import dryrun as D

    cell = get_arch("pna").build_cell("molecule", Mesh({"data": 1, "model": 1}))
    return cell, D.step_figures(cell), D.measure_on_device(cell, torch.device("cuda"))


@pytest.mark.gpu
def test_dryrun_state_bytes_on_card(pna_molecule_on_card):
    """The materialised arguments' bytes are the dry run's exact state
    bytes, and allocating them adds those bytes within the allocator's
    slack (512 B a leaf, 1 MiB more a leaf over 1 MiB)."""
    from repro_torch.launch import dryrun as D

    cell, _, m = pna_molecule_on_card
    assert m["arg_bytes"] == D.state_bytes_exact(cell)
    assert 0 <= m["arg_allocated"] - m["arg_bytes"] <= m["arg_slack"]


@pytest.mark.gpu
def test_dryrun_transient_peak_on_card(pna_molecule_on_card):
    """The measured call's transient peak is at or above the meta
    prediction (``step_peak_bytes`` less the arguments) by at most
    ``transient_bound``."""
    from repro_torch.launch import dryrun as D

    _, fig, m = pna_molecule_on_card
    excess = m["transient"] - (fig["step_peak_bytes"] - m["arg_bytes"])
    assert 0 <= excess <= D.transient_bound(fig), (excess, D.transient_bound(fig))
    assert m["ms"] > 0


# ------------------------------------------------------ model-parallel forms
# Small widths of chip_smoke.py phase 21's checks, fp32 unless said (TF32 is
# off by default), with phase 21's bounds (tests/rehearse_model_parallel.py).
MP_STEP_TOL, MP_DECODE_TOL, MP_EP_TOL, MP_TP_TOL = 5e-6, 5e-6, 5e-6, 1.98e-5
MP_PNA64_TOL, MP_PNA64_GRAD_TOL = 1e-11, 1e-9
MP_DECODE_BODY_TOL, MP_DECODE_CACHE_TOL = 5e-6, 5e-6   # chip_smoke.py phase 21(b)'s


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _mp_smoke(arch):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch).smoke(), grad_accum=1)
    if arch == "deepseek-v2-236b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shard_ff_over_data=True))
    return cfg


@pytest.fixture
def model_mesh_1x1(cuda_device):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_model_mesh

    mesh = make_model_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b", "deepseek-v2-236b"])
def test_lm_mesh_step_1x1_nccl_equals_the_global_step_on_card(cuda_device, model_mesh_1x1,
                                                               arch):
    """``make_train_step(mesh=)`` on an NCCL group of one against
    ``mesh=None`` from the same params: the loss and every gradient."""
    import model_parallel_ranks as MR
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import flatten

    cfg = _mp_smoke(arch)
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (4, 40), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    g_want, _, m_want = T.make_train_step(cfg, MR.Capture())(
        {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}, {}, batch)
    specs = T.param_specs(cfg)
    g_got, _, m_got = T.make_train_step(cfg, MR.Capture(), mesh=model_mesh_1x1)(
        M.shard_params(params, specs, model_mesh_1x1), {}, batch)
    assert (abs(float(m_got["loss"]) - float(m_want["loss"]))
            <= MP_STEP_TOL * float(m_want["loss"]))
    want, got = flatten(g_want), flatten(M.unshard_params(g_got, specs, model_mesh_1x1))
    for k in want:
        assert _rel(got[k], want[k]) <= MP_STEP_TOL, k


@pytest.mark.gpu
def test_lm_mesh_decode_1x1_nccl_equals_the_plain_decode_on_card(cuda_device, model_mesh_1x1):
    """``serve_step(mesh=)`` against the plain decode at the no-drop
    capacity factor (ROADMAP C25), six steps of deepseek-v2-236b's MLA with
    ``shard_ff_over_data``."""
    import dataclasses

    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    cfg = _mp_smoke("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    local = M.shard_params(params, T.param_specs(cfg), model_mesh_1x1)
    tok = torch.randint(0, cfg.vocab, (4, 6), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    cache = T.make_cache(cfg, 4, 8)
    mcache = T.make_cache(cfg, 4, 8, mesh=model_mesh_1x1)
    for t in range(6):
        want, cache = T.serve_step(params, tok[:, t:t + 1], cache, t, cfg)
        got, mcache = T.serve_step(local, tok[:, t:t + 1], mcache, t, cfg, mesh=model_mesh_1x1)
        assert _rel(got, want) <= MP_DECODE_TOL, t


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-32b", "deepseek-v2-236b"])
def test_lm_split_decode_1x1_nccl_is_the_plain_decode_on_card(cuda_device, model_mesh_1x1, arch):
    """``serve_step(mesh=)`` against its ``cache_specs`` block on an NCCL
    group of one (the gathers and psums over one rank) and the plain decode
    from the same params, five steps: the logits and the cache bit for bit.
    GQA (yi), GQA with biases (qwen) and MLA (deepseek-v2-236b's smoke at
    its dense layer)."""
    import dataclasses

    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    cfg = _mp_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, n_layers=cfg.first_k_dense)
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    local = M.shard_params(params, T.param_specs(cfg), model_mesh_1x1)
    tok = torch.randint(0, cfg.vocab, (4, 5), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    cache = T.make_cache(cfg, 4, 8)
    mcache = T.make_cache(cfg, 4, 8, mesh=model_mesh_1x1)
    for t in range(5):
        want, cache = T.serve_step(params, tok[:, t:t + 1], cache, t, cfg)
        got, mcache = T.serve_step(local, tok[:, t:t + 1], mcache, t, cfg, mesh=model_mesh_1x1)
        assert torch.equal(got, want), t
    assert all(torch.equal(mcache[k], v) for k, v in cache.items())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw,n_tp", [("yi-9b", {}, 2), ("yi-9b", {"n_kv": 1}, 4),
                                          ("yi-9b", {"n_heads": 3, "n_kv": 1}, 2),
                                          ("deepseek-v2-236b", {}, 2)],
                         ids=["gqa", "kv1-tp4", "heads-unsplit", "mla"])
def test_split_decode_bodies_in_turn_on_card(cuda_device, arch, kw, n_tp):
    """One dense layer's decode as ``n_tp`` attention bodies in turn
    (``model_parallel_ranks.tp_decode_in_turn``) against the global decode
    of the layer, at the smoke's width: the update ``y - x`` within phase
    21(b)'s bound, the slot each body wrote within its cache bound of the
    global cache's, cut by ``cache_specs``, and every other slot
    untouched."""
    import dataclasses

    import model_parallel_ranks as MR
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(_mp_smoke(arch), n_layers=1, **kw)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    layer = {k: (torch.ones(s[1:], device=cuda_device) if "norm" in k else
                 torch.randn(s[1:], generator=gen, device=cuda_device) * 0.1)
             for k, s in T.param_shapes(cfg)["dense_layers"].items()}
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device=cuda_device)
    cache = {k: torch.randn(v.shape, generator=gen, device=cuda_device)
             for k, v in T.make_cache(cfg, 4, 16, abstract=True).items()}
    before = MR.cache_blocks(cache, cfg, n_tp)
    blocks = MR.cache_blocks(cache, cfg, n_tp)
    with torch.no_grad():
        got = MR.tp_decode_in_turn(layer, x, blocks, 9, cfg, n_tp)
        want = T._decode_layer(layer, x, cache, 0, 9, cfg)
    assert _rel(got - x, want - x) <= MP_DECODE_BODY_TOL
    for b, w, old in zip(blocks, MR.cache_blocks(cache, cfg, n_tp), before):
        for k in w:
            assert _rel(b[k][:, :, 9], w[k][:, :, 9]) <= MP_DECODE_CACHE_TOL, k
            assert torch.equal(torch.cat([b[k][:, :, :9], b[k][:, :, 10:]], 2),
                               torch.cat([old[k][:, :, :9], old[k][:, :, 10:]], 2)), k


@pytest.mark.gpu
def test_pna_forward_sharded_1x1_nccl_equals_forward_on_card(cuda_device, model_mesh_1x1):
    """``forward_sharded`` and the node-sharded step on an NCCL group of
    one against ``forward`` and the plain step, in float64."""
    import dataclasses

    import model_parallel_ranks as MR
    from repro_torch.models import gnn as G

    cfg = dataclasses.replace(G.PNAConfig(**MR.PNA), dtype=torch.float64)
    g = G.random_graph(64, 256, 8, 3, seed=0)
    src, dst, _ = G.partition_edges(g["src"], g["dst"], 64, 1)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in g.items()}
    batch["features"] = batch["features"].double()
    sharded = dict(batch, src=torch.from_numpy(src).to(cuda_device),
                   dst=torch.from_numpy(dst).to(cuda_device))
    params = {k: v.to(cuda_device) for k, v in
              G.init_params(cfg, torch.Generator().manual_seed(0)).items()}
    axes = MR.NODE_AXES
    with torch.no_grad():
        assert _rel(G.forward_sharded(params, cfg, sharded, mesh=model_mesh_1x1, node_axes=axes),
                    G.forward(params, cfg, batch)) <= MP_PNA64_TOL
    want, _, _ = G.make_train_step(cfg, MR.Capture())(dict(params), {}, batch)
    got, _, _ = G.make_train_step(cfg, MR.Capture(), mesh=model_mesh_1x1, node_axes=axes)(
        dict(params), {}, sharded)
    for k in want:
        assert _rel(got[k], want[k]) <= MP_PNA64_GRAD_TOL, k


@pytest.mark.gpu
def test_rank_bodies_in_turn_equal_the_global_forms_on_card(cuda_device):
    """The 2x4 mesh's EP bodies of deepseek-v2-236b's smoke MoE
    (``shard_ff_over_data``) against ``moe_ffn`` on each data shard; yi's
    layer as tp=2 bodies against the layer (on ``y - x``); PNA's 8
    node-shard bodies against ``forward`` in float64."""
    import dataclasses

    import model_parallel_ranks as MR
    from repro_torch.models import gnn as G
    from repro_torch.models import moe as MO
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cfg = _mp_smoke("deepseek-v2-236b")
    c = dataclasses.replace(cfg.moe, capacity_factor=1.25)
    params = {k: torch.randn(s, generator=gen, device=cuda_device) * 0.1
              for k, s in MO.moe_params_shape(cfg.d_model, c).items()}
    x = torch.randn((128, cfg.d_model), generator=gen, device=cuda_device)
    outs, _ = MR.moe_in_turn(params, x, c, {"data": 2, "model": 4})
    for d, o in enumerate(outs):
        assert _rel(o, MO.moe_ffn(params, x[d * 64:(d + 1) * 64], c)[0]) <= MP_EP_TOL, d
    yi = _mp_smoke("yi-9b")
    layer = {k: v[0] for k, v in
             T.init_params(yi, torch.Generator(device=cuda_device).manual_seed(0))[
                 "dense_layers"].items()}
    h = torch.randn((2, 40, yi.d_model), generator=gen, device=cuda_device)
    with torch.no_grad():
        got = MR.tp_layer_in_turn(layer, h, yi, 2)
        want, _ = T._dense_block(layer, h, yi)
    assert _rel(got - h, want - h) <= MP_TP_TOL
    pcfg = dataclasses.replace(G.PNAConfig(**MR.PNA), dtype=torch.float64)
    g = G.random_graph(64, 256, 8, 3, seed=0)
    src, dst, _ = G.partition_edges(g["src"], g["dst"], 64, 8)
    pparams = {k: v.to(cuda_device) for k, v in
               G.init_params(pcfg, torch.Generator().manual_seed(0)).items()}
    feats = torch.from_numpy(g["features"]).double().to(cuda_device)
    with torch.no_grad():
        got = MR.pna_in_turn(pparams, pcfg, {"features": feats,
                                             "src": torch.from_numpy(src).to(cuda_device),
                                             "dst": torch.from_numpy(dst).to(cuda_device)}, 8)
        want = G.forward(pparams, pcfg, {"features": feats,
                                         "src": torch.from_numpy(g["src"]).to(cuda_device),
                                         "dst": torch.from_numpy(g["dst"]).to(cuda_device)})
    assert _rel(got, want) <= MP_PNA64_TOL


# ------------------------------------------------- the dry run per device
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16}],
                         ids=["16x16", "2x16x16"])
def test_fake_group_on_card(cuda_device, shape):
    """Rank 0 of the production mesh under the fake group on ``cuda``: the
    mesh has its shape, every collective of the mesh forms returns its
    output shape on the card (values left as allocated), and the group is
    gone after the block."""
    import math

    from repro_torch.launch import mesh as M

    axes = tuple(a for a in shape if a != "model") + ("model",)
    with M.fake_mesh(shape, "cuda") as mesh:
        assert tuple(mesh.shape) == tuple(shape.values())
        assert M.dist.get_world_size() == math.prod(shape.values())
        x = torch.ones(8, 4, device=cuda_device)
        y = M.all_gather(x, mesh, axes, 0)
        assert y.shape == (8 * math.prod(shape.values()), 4) and y.is_cuda
        assert M.psum(x, mesh, "model").shape == x.shape
        r = M._scatter_sum(y, M._group(mesh, axes), 0)
        assert r.shape == x.shape and r.is_cuda
    assert not M.dist.is_initialized()


@pytest.mark.gpu
def test_lm_rank_peak_on_card_within_its_prediction(cuda_device, monkeypatch):
    """Rank 0 of the yi smoke's train step on a 2x2 mesh (the cell's
    per-device call, 4 x 24 tokens, ``grad_accum`` 2), its shards drawn on
    the card, under the fake group on ``cuda``: the arguments' bytes are
    the prediction's, and the transient peak is within ``transient_bound``
    above the meta prediction and ``step_functional_per_device`` below it
    (the tracker's dispatch mode turns the index and gather backwards'
    in-place writes into new outputs)."""
    import dataclasses

    from repro_torch.configs import base as B
    from repro_torch.configs import get_arch
    from repro_torch.core.sharding import Mesh
    from repro_torch.launch import dryrun as D

    monkeypatch.setitem(B.LM_SHAPES, "train_4k", {"kind": "train", "seq": 24, "batch": 4})
    two = {"data": 2, "model": 2}
    cell = B.lm_cell(dataclasses.replace(get_arch("yi-9b").smoke(), grad_accum=2), "train_4k",
                     Mesh(two))
    fig = D.per_device_figures(cell, two)
    m = D.measure_rank_on_device(cell, two, cuda_device)
    assert m["arg_bytes"] == fig["per_device_arg_bytes"]
    excess = m["transient"] - (fig["step_peak_bytes_per_device"] - m["arg_bytes"])
    assert -fig["step_functional_per_device"] <= excess <= D.transient_bound(fig, "_per_device")
    assert fig["collective_bytes_per_device"]["reduce-scatter"] > 0


@pytest.mark.gpu
def test_stream_flags_on_card_are_the_default_bit_for_bit(cuda_device, tmp_path, capsys):
    """The streaming driver on the card with ``--adapt eager`` and with
    ``--no-donate``: the default run's losses bit for bit; eager adaptation
    counts its dispatches, and without donation no staged batch is given
    back."""
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train as T

    write_log_shards(str(tmp_path), n_shards=4, rows_per_shard=256, seed=0)
    argv = ["--arch", "dlrm-mlperf", "--data-dir", str(tmp_path), "--spec", "dlrm",
            "--device-feed", "arena", "--fault-tolerant", "--steps", "4", "--metrics"]
    runs = {}
    for flags in ((), ("--adapt", "eager"), ("--no-donate",)):
        capsys.readouterr()
        runs[flags] = T.main(argv + list(flags))
        out = capsys.readouterr().out
        runs[flags] += (out[out.index("metrics:\n") + len("metrics:\n"):],)
    import json

    (_, base, _), (_, eager, em), (_, kept, km) = runs.values()
    assert len(base) == 4 and eager == base and kept == base
    em, km = json.loads(em), json.loads(km)
    assert em["train_feed.adapt_dispatches_per_step"] > 0 and em["train_feed.fused_steps"] == 0
    assert em["train_feed.dispatches_per_step"] == em["train_feed.adapt_dispatches_per_step"] + 1
    assert km["feed.donated"] == 0 and km["feed.fresh_arenas"] > 0


# ------------------------------------------------------- the port's examples
def _launch_counts():
    from repro_torch.kernels.embedding_bag.ops import bag_lookup

    return {"feature_hash": run_hash_layer.launches, "interaction_dot": pairwise_dots.launches,
            "interaction_dot_backward": pairwise_dots_backward.launches,
            "mempool_alloc": alloc_offsets.launches, "embedding_bag": bag_lookup.launches}


@pytest.mark.gpu
def test_bag_lookup_at_serve_ctrs_shape_on_card(cuda_device):
    """``serve_ctr``'s scoring pooling (B = 256 requests, L = 48, the
    ``ads_ctr`` sequence; U = 65,536 rows of D = 16) through the kernel
    against its plain version, within the two-orders bound."""
    from repro_torch.examples import serve_ctr as S
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref, sum_order_bound

    plan = featureplan.compile(get_spec("ads_ctr"))
    req = plan.outputs(plan.run(gen_views(256, seed=100), device=cuda_device))
    embed = S.make_model(torch.Generator(device=cuda_device).manual_seed(0),
                         plan.layout)["embed"].detach()
    ids = torch.remainder(req["batch_seq_ids"], S.TABLE).to(torch.int32)
    mask = req["batch_seq_mask"]
    assert tuple(ids.shape) == (256, 48) and tuple(embed.shape) == (S.TABLE, S.DIM)
    before = bag_lookup.launches
    got = S.bag_pool(embed, ids, mask)
    torch.cuda.synchronize()
    assert bag_lookup.launches == before + 1
    want = embedding_bag_ref(ids, mask, embed)
    assert bool(((got - want).abs() <= sum_order_bound(ids, mask, embed)).all())
    assert float(want.abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,argv,want", [
    ("quickstart", [], {"feature_hash"}),
    ("serve_ctr", ["--requests", "512"], {"feature_hash", "embedding_bag"}),
    ("stream_train", ["--shards", "2", "--rows", "256", "--device-feed", "on"],
     {"feature_hash", "mempool_alloc"}),
    ("stream_train", ["--shards", "2", "--rows", "256", "--device-feed", "off",
                      "--spec", "dlrm"], {"feature_hash"}),
    ("train_ctr_e2e", ["--steps", "24", "--instances", "2048", "--batch", "256"],
     {"feature_hash"}),
    ("mesh_train", ["--mesh", "1x1", "--steps", "2"],
     {"feature_hash", "interaction_dot", "interaction_dot_backward"}),
], ids=["quickstart", "serve_ctr", "stream_train-on", "stream_train-off-dlrm", "train_ctr_e2e",
        "mesh_train-1x1"])
def test_example_launches_its_kernels_on_card(cuda_device, name, argv, want, tmp_path,
                                              monkeypatch, capsys):
    """Each example's ``main`` on the card, at a small argument set: its
    ``OK`` line, and a launch of every kernel its path runs (the wrappers'
    counters; ``serve_ctr``: one ``embedding_bag`` launch a request batch)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = list(argv)
    if name == "train_ctr_e2e":
        monkeypatch.setattr(mod, "TABLE_ROWS", 50_000)
        argv += ["--workdir", str(tmp_path)]
    if name == "stream_train":
        argv += ["--data-dir", str(tmp_path)]
    before = _launch_counts()
    mod.main(argv)
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in _launch_counts().items()}
    assert f"{name} OK" in capsys.readouterr().out
    assert all(n[k] >= 1 for k in want), n
    assert all(n[k] == 0 for k in n if k not in want), n
    if name == "serve_ctr":
        assert n["embedding_bag"] == 2
