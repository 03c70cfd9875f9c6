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
from repro_torch.kernels.feature_hash.ops import MAX_OPS, run_hash_layer  # noqa: E402
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
from repro_torch.kernels.mempool_alloc.ref import alloc_offsets_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 512, 262_144 + 3])
@pytest.mark.parametrize("field_size", [1000, 1 << 20])
def test_feature_hash_kernel_equals_plain_on_card(cuda_device, n, field_size):
    rng = np.random.default_rng(n)
    ids = rng.integers(-(2**33), 2**33, (10, n)).astype(np.int64)
    cols = F.narrow_int32(torch.from_numpy(ids)).to(cuda_device)
    prog = (("cross", 0, 1, field_size), ("cross", 7, 2, field_size),
            ("hash", 3, 0, field_size), ("mod", 4, 0, field_size), ("mod", 9, 0, field_size))
    before = run_hash_layer.launches
    got = run_hash_layer(cols, prog)
    torch.cuda.synchronize()
    assert run_hash_layer.launches == before + 1
    assert torch.equal(got, hash_layer_ref(cols, program=prog))


@pytest.mark.gpu
def test_feature_hash_kernel_max_ops_on_card(cuda_device):
    cols = torch.arange(-40, 40, dtype=torch.int32, device=cuda_device).reshape(2, 40)
    prog = tuple(("mod", i % 2, 0, 7 + i) for i in range(MAX_OPS))
    assert torch.equal(run_hash_layer(cols, prog), hash_layer_ref(cols, program=prog))
    with pytest.raises(ValueError):
        run_hash_layer(cols, prog + (("mod", 0, 0, 3),))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 27, 128), (7, 2, 16), (130, 27, 128), (3, 60, 256)])
def test_interaction_dot_kernel_matches_plain_on_card(cuda_device, shape):
    assert not torch.backends.cuda.matmul.allow_tf32   # fp32 matmuls, the default
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    x = x.to(cuda_device)
    before = pairwise_dots.launches
    got = pairwise_dots(x)
    torch.cuda.synchronize()
    assert pairwise_dots.launches == before + 1
    torch.testing.assert_close(got, dot_interaction_ref(x), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 27, 128), (7, 2, 16), (130, 27, 128), (3, 60, 256)])
def test_interaction_dot_backward_kernel_matches_plain_on_card(cuda_device, shape):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    b, f, _ = shape
    dy = torch.from_numpy(rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32))
    dy = dy.to(cuda_device)
    before = pairwise_dots_backward.launches
    got = pairwise_dots_backward(x, dy)
    torch.cuda.synchronize()
    assert pairwise_dots_backward.launches == before + 1
    want = dot_interaction_bwd_ref(x, dy)
    scale = float(want.abs().max())
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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 5, 1023, 1024, 1025, 8192, 8193, 1_000_000])
def test_alloc_offsets_kernel_equals_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 5000, n).astype(np.int32)
    sizes[::7] = 0
    d = torch.from_numpy(sizes).to(cuda_device)
    before = alloc_offsets.launches
    offsets, head = alloc_offsets(d)
    torch.cuda.synchronize()
    assert alloc_offsets.launches == before + 1
    want_offsets, want_head = alloc_offsets_ref(torch.from_numpy(sizes))
    assert torch.equal(offsets.cpu(), want_offsets)
    assert torch.equal(head.cpu(), want_head)


@pytest.mark.gpu
def test_alloc_offsets_kernel_wraps_like_int32_on_card(cuda_device):
    sizes = torch.tensor([2**31 - 1, -5, -200, 2**30, 2**30, -(2**31), 77], dtype=torch.int32)
    offsets, head = alloc_offsets(sizes.to(cuda_device))
    want_offsets, want_head = alloc_offsets_ref(sizes)
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
    the feeder's: while a ~200 ms sleep kernel holds the train thread's
    stream, every later batch is extracted, staged and handed over."""
    import time

    plan = featureplan.compile(get_spec("dlrm"))
    views = [gen_views(512, seed=300 + i) for i in range(4)]
    arrivals = []

    def step(state, env):
        arrivals.append(time.perf_counter())
        if len(arrivals) == 1:
            torch.cuda._sleep(400_000_000)       # ~200 ms on this thread's stream
        return state

    _threaded_runner(plan, lambda s, env: s, cuda_device, rows_hint=512).run(0, views)  # warm
    torch.cuda.synchronize()
    runner = _threaded_runner(plan, step, cuda_device, rows_hint=512)
    t0 = time.perf_counter()
    runner.run(0, views)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    assert len(arrivals) == 4 and total > 0.15, f"the sleep ran {total:.3f} s"
    spread = arrivals[-1] - arrivals[0]
    assert spread < 0.1, f"batches 2-4 waited {spread:.3f} s behind the caller's stream"


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
