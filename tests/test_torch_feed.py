"""The port's device feed against the JAX package, on the CPU.

``FeedLayout`` sizes and placements must equal the JAX layout's, the
``mempool_alloc`` placement must equal ``ArenaPool.alloc_block``, staged
tensors must be bit-equal to the environment, and the ``FeedStats`` counts
must equal the JAX feeder's on the same batches. The ring-reuse rules
(pinned buffer after its copy, device arena after its step's fence, a fresh
arena for a batch staged ahead of its consumer) are held here with the CPU
path's bookkeeping and on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ArenaPool as JaxArenaPool  # noqa: E402
from repro.core import DeviceFeeder as JaxDeviceFeeder  # noqa: E402
from repro.core.devicefeed import FeedLayout as JaxFeedLayout  # noqa: E402
from repro.core.devicefeed import SlotSpec as JaxSlotSpec  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402

from repro_torch.core.devicefeed import DeviceFeeder, FeedError, FeedLayout, SlotSpec  # noqa: E402
from repro_torch.core.metakernel import run_layers  # noqa: E402
from repro_torch.core.mempool import ALIGN, ArenaPool, align_up, required_capacity  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402

CPU = torch.device("cpu")
STAT_FIELDS = ("batches", "bytes_staged", "rewinds", "buffers", "reallocs", "arena_capacity")


def _plans():
    return featureplan.compile(get_spec("dlrm")), jax_featureplan.compile(jax_get_spec("dlrm"))


def _fields(layout):
    return [(s.name, s.width, s.dtype, s.rank1) for s in layout.slots]


@pytest.mark.parametrize("split", [False, True])
def test_feed_layout_matches_jax(split):
    plan, jplan = _plans()
    layout = plan.feed_layout(split_sparse_fields=split)
    jlayout = jplan.feed_layout(split_sparse_fields=split)
    assert _fields(layout) == _fields(jlayout)
    assert layout.align == jlayout.align == ALIGN
    for rows in (0, 1, 64, 97, 8192):
        assert layout.sizes(rows) == jlayout.sizes(rows)
        assert layout.bytes_per_batch(rows) == jlayout.bytes_per_batch(rows)
        assert layout.arena_bytes(rows) == jlayout.arena_bytes(rows)
    if not split:
        # the device feed's block on dlrm: 5 slots, 2,359,296 bytes at 8,192 rows
        assert layout.slot_names == ("batch_label", "batch_dense", "batch_sparse",
                                     "batch_seq_ids", "batch_seq_mask")
        assert layout.arena_bytes(8192) == 2_359_296


@pytest.mark.parametrize("rows", [1, 64, 97, 8192])
def test_feed_layout_plan_matches_jax_and_arena_pool(rows):
    plan, jplan = _plans()
    layout, jlayout = plan.feed_layout(), jplan.feed_layout()
    off_host, total_host = layout.plan(rows)
    off_kernel, total_kernel = layout.plan(rows, use_kernel=True, device="cpu")
    for want_off, want_total in (jlayout.plan(rows), jlayout.plan(rows, use_kernel=True)):
        np.testing.assert_array_equal(off_host, want_off)
        np.testing.assert_array_equal(off_kernel, want_off)
        assert total_host == total_kernel == want_total == layout.arena_bytes(rows)
    for pool in (ArenaPool(layout.arena_bytes(rows)), JaxArenaPool(layout.arena_bytes(rows))):
        assert [a.offset for a in pool.alloc_block(layout.sizes(rows))] == off_host.tolist()


def test_plan_rejects_int32_overflow_like_jax():
    fat = FeedLayout(slots=(SlotSpec("batch_huge", width=2**29, dtype="float32"),))
    jfat = JaxFeedLayout(slots=(JaxSlotSpec("batch_huge", width=2**29, dtype="float32"),))
    for layout in (fat, jfat):
        with pytest.raises(OverflowError, match="int32"):
            layout.plan(2)
    with pytest.raises(OverflowError, match="int32"):
        fat.plan(2, use_kernel=True, device="cpu")


def test_arena_pool_commit_block_and_helpers_match_jax():
    pool, jpool = ArenaPool(4096), JaxArenaPool(4096)
    for sizes in ([5, 200, 0], [129], [1000, 1000]):
        assert [(a.offset, a.size) for a in pool.alloc_block(sizes)] == \
            [(a.offset, a.size) for a in jpool.alloc_block(sizes)]
        assert (pool.head, pool.high_water, pool.n_allocs) == \
            (jpool.head, jpool.high_water, jpool.n_allocs)
    with pytest.raises(MemoryError):
        pool.commit_block([0], [4096], 4096)
    pool.reset()
    assert pool.head == 0 and pool.n_resets == 1
    allocs = pool.commit_block([0, 128], [5, 100], 256)
    assert [(a.offset, a.size) for a in allocs] == [(0, 5), (128, 100)] and pool.head == 256
    with pytest.raises(ValueError, match="negative"):
        pool.alloc_block([3, -1])
    with pytest.raises(ValueError):
        ArenaPool(100)
    assert required_capacity([[5, 200], [], [1000]]) == align_up(1000) == 1024


def test_feeder_stage_matches_jax_counts_and_placement():
    """Same batches through both feeders (a regrow included): FeedStats
    counts and placements equal, staged tensors bit-equal to the env."""
    plan, jplan = _plans()
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=32, buffers=2, device=CPU)
    jfeeder = JaxDeviceFeeder(jplan.feed_layout(), rows_hint=32, buffers=2)
    assert feeder.stats.arena_capacity == jfeeder.stats.arena_capacity
    for i, rows in enumerate([32, 32, 48, 16, 48]):
        env = plan.run(gen_views(rows, seed=40 + i), device=CPU)
        staged = feeder.stage(env)
        jfeeder.stage(jplan.run(jax_gen_views(rows, seed=40 + i)))
        for k in plan.output_slots:
            assert staged[k].dtype == env[k].dtype and torch.equal(staged[k], env[k]), k
        for k in env:
            if k not in plan.output_slots:
                assert staged[k] is env[k]  # non-layout slots pass through
        assert [(a.offset, a.size) for a in feeder.last_allocs] == \
            [(a.offset, a.size) for a in jfeeder.last_allocs]
    for field in STAT_FIELDS:
        assert getattr(feeder.stats, field) == getattr(jfeeder.stats, field), field
    assert feeder.stats.reallocs == 1 and feeder.stats.rewinds == 5
    # no step fences these batches, so the fifth re-claims an unfenced slot
    assert "rewinds=5 reallocs=1 fresh_arenas=1" in feeder.stats.summary()
    assert (feeder.pool.head, feeder.pool.high_water, feeder.pool.n_allocs) == \
        (jfeeder.pool.head, jfeeder.pool.high_water, jfeeder.pool.n_allocs)
    assert feeder.stats.bytes_staged == sum(plan.feed_layout().bytes_per_batch(r)
                                            for r in [32, 32, 48, 16, 48])


def test_feeder_split_layout_derives_fields_from_packed_sparse():
    plan, _ = _plans()
    split, packed = plan.feed_layout(split_sparse_fields=True), plan.feed_layout()
    env = plan.run(gen_views(40, seed=11), device=CPU)
    feeder = DeviceFeeder(split, rows_hint=40, device=CPU)
    staged = feeder.stage(env)
    for i in range(plan.layout.n_sparse_fields):
        assert torch.equal(staged[f"batch_field_{i:02d}"], env["batch_sparse"][:, i])
    assert feeder.stats.bytes_staged == packed.bytes_per_batch(40)


def test_host_buffers_and_arenas_are_layout_aligned():
    plan, _ = _plans()
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=33, device=CPU)
    for buf in feeder._host + feeder._dev:
        assert buf.data_ptr() % feeder.layout.align == 0
        assert buf.numel() == feeder.layout.arena_bytes(33)


def test_stage_rejects_layout_violations_before_claiming():
    plan, _ = _plans()
    feeder = DeviceFeeder(plan.feed_layout(), device=CPU)
    env = plan.run(gen_views(16, seed=0), device=CPU)
    feeder.stage(env)
    rewinds = feeder.stats.rewinds
    bad = dict(env)
    bad["batch_sparse"] = env["batch_sparse"][:, :-1]
    with pytest.raises(FeedError, match="shape"):
        feeder.stage(bad)
    bad = dict(env)
    bad["batch_dense"] = env["batch_dense"].to(torch.float64)
    with pytest.raises(FeedError, match="dtype"):
        feeder.stage(bad)
    bad = dict(env)
    bad["batch_dense"] = env["batch_dense"].numpy().astype(np.float64)
    with pytest.raises(FeedError, match="dtype"):
        feeder.stage(bad)
    with pytest.raises(FeedError, match="missing"):
        feeder.stage({"impressions": None})
    with pytest.raises(FeedError, match="missing"):
        feeder.stage({"batch_label": env["batch_label"]})
    with pytest.raises(FeedError, match="rows"):
        feeder.claim_views(-1)
    assert feeder.stats.batches == 1 and feeder.stats.rewinds == rewinds


def test_stage_takes_numpy_slots():
    plan, _ = _plans()
    env = plan.run(gen_views(24, seed=8), device=CPU)
    host = {k: v.numpy() for k, v in plan.outputs(env).items()}
    staged = DeviceFeeder(plan.feed_layout(), device=CPU).stage(host)
    for k in plan.output_slots:
        assert torch.equal(staged[k], env[k])


def test_unfenced_arena_is_never_rewritten():
    """Four batches staged on a ring of two before any is consumed: every
    staged batch keeps its values (fresh arenas for the two re-claimed
    slots). Once each step fences its batch, the ring reuses its arenas."""
    plan, _ = _plans()
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=16, buffers=2, device=CPU)
    envs = [plan.run(gen_views(16, seed=60 + i), device=CPU) for i in range(8)]
    staged = [feeder.stage(e) for e in envs[:4]]
    assert feeder.stats.fresh_arenas == 2
    for s, e in zip(staged, envs):
        for k in plan.output_slots:
            assert torch.equal(s[k], e[k]), k
    for _ in staged:
        feeder.donation_fence(None)
    arenas = [a.data_ptr() for a in feeder._dev]
    for e in envs[4:]:
        s = feeder.stage(e)
        for k in plan.output_slots:
            assert torch.equal(s[k], e[k]), k
        feeder.donation_fence(None)   # the step that read it is done
    assert feeder.stats.fresh_arenas == 2
    assert [a.data_ptr() for a in feeder._dev] == arenas  # reused in place
    assert len(feeder._fences) <= feeder.buffers
    feeder.flush()


def test_feeder_defaults_to_the_card(monkeypatch):
    plan, _ = _plans()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeeder(plan.feed_layout())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan.feed_layout().plan(8, use_kernel=True)
    with pytest.raises(ValueError):
        DeviceFeeder(plan.feed_layout(), buffers=0, device=CPU)


# ------------------------------------------------------------- arena form
def _pre_final(layers, rows, seed):
    env = dict(gen_views(rows, seed=seed))
    run_layers(layers, env, device=CPU)
    return env


def test_arena_binding_layers_match_jax():
    """The sans-final layer build: the same groups, ops and dispatches as
    the JAX package's, with final_batch dropped and nothing else."""
    plan, jplan = _plans()
    ab = plan.arena_binding()
    jab = jplan.arena_binding()

    def shape(layers):
        return [(l.layer_indices, [p.op.name for p in l.host_ops],
                 [p.op.name for p in l.device_ops], l.device_input_slots, l.n_dispatches)
                for l in layers]

    assert shape(ab.layers) == shape(jab.layers)
    names = [p.op.name for l in ab.layers for p in l.device_ops]
    assert "final_batch" not in names and "sparse_ids" in names
    assert ab.binding.input_slots == jab.binding.input_slots
    assert _fields(ab.layout) == _fields(jab.layout)


@pytest.mark.parametrize("split", [False, True])
def test_arena_binding_stages_like_the_copy_path_and_jax(split):
    """FE writes batch_* straight into the claimed views: staged tensors bit
    for bit the copy path's and the JAX arena feeder's on the same pre-final
    slots, over batches that regrow the arena; FeedStats counts
    (copies_elided included) equal."""
    plan, jplan = _plans()
    ab = plan.arena_binding(split_sparse_fields=split)
    jab = jplan.arena_binding(split_sparse_fields=split)
    feeder = ab.make_feeder(rows_hint=32, buffers=2, device=CPU)
    copy = DeviceFeeder(plan.feed_layout(split_sparse_fields=split), rows_hint=32,
                        buffers=2, device=CPU)
    jfeeder = jab.make_feeder(rows_hint=32, buffers=2)
    for i, rows in enumerate([32, 48, 16, 48]):
        env = _pre_final(ab.layers, rows, 90 + i)
        assert "batch_label" not in env and ab.binding.ready(env)
        staged = feeder.stage(env)
        want = copy.stage(plan.run(gen_views(rows, seed=90 + i), device=CPU))
        # the JAX feeder stages the port's pre-final slots (FE floats are
        # held against JAX elsewhere: LogNorm within 2 ulp, ROADMAP C5)
        jstaged = jfeeder.stage({k: v.numpy() if isinstance(v, torch.Tensor) else v
                                 for k, v in env.items()})
        for k in ab.layout.slot_names:
            assert torch.equal(staged[k], want[k]), k
            np.testing.assert_array_equal(staged[k].numpy(), np.asarray(jstaged[k]), err_msg=k)
        assert [(a.offset, a.size) for a in feeder.last_allocs] == \
            [(a.offset, a.size) for a in jfeeder.last_allocs]
    for field in STAT_FIELDS + ("copies_elided",):
        assert getattr(feeder.stats, field) == getattr(jfeeder.stats, field), field
    assert feeder.stats.copies_elided == 4 * len(ab.layout.slots)
    assert copy.stats.copies_elided == 0
    assert f"elided={feeder.stats.copies_elided}" in feeder.stats.summary()


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("slot", ["sparse_ids", "dense_feats", "interest_bag_mask"])
def test_arena_binding_rejects_a_wrong_shaped_slot_before_writing(split, slot):
    plan, _ = _plans()
    ab = plan.arena_binding(split_sparse_fields=split)
    feeder = ab.make_feeder(rows_hint=16, buffers=2, device=CPU)
    env = _pre_final(ab.layers, 16, 3)
    feeder.stage(env)
    bad = dict(env)
    bad[slot] = env[slot][:, :-1] if slot == "sparse_ids" else env[slot][:-1]
    target = feeder._host[feeder._next].clone()
    with pytest.raises(FeedError, match="shape"):
        feeder.stage(bad)
    assert torch.equal(feeder._host[(feeder._next - 1) % feeder.buffers], target)
    assert feeder.stats.batches == 1 and feeder.stats.copies_elided == len(ab.layout.slots)
