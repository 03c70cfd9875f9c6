"""The port's pipelined runner on the CPU: ``PipelinedRunner`` equals
``StagedRunner`` bit for bit for feed off / stage / arena (the claim of
``tests/test_runner_equivalence.py``), counts like the JAX runner on the
same batches, and surfaces a failure of any thread without leaving one
behind. Every run that starts threads is waited for with a bound, so a
regression fails instead of hanging."""

import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PipelinedRunner as JaxPipelinedRunner  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pipeline import PipelinedRunner, StagedRunner  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
THREADS = ("fe-worker", "h2d-feeder")
ROWS, N_BATCHES = 32, 4


def _bounded(fn, timeout=60.0):
    """Run ``fn`` in a thread; fail (not hang) if it does not finish."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised in the test thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"run did not finish within {timeout} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _threads_gone(timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if not [t for t in threading.enumerate() if t.name in THREADS]:
            return True
        time.sleep(0.02)
    return False


def _views(n=N_BATCHES, rows=ROWS, seed=500):
    return [gen_views(rows, seed=seed + i) for i in range(n)]


def _training(plan, *, split=False):
    """A fresh sparse train step on the smoke config, as the driver wires
    it; records every loss."""
    cfg = get_arch("dlrm-mlperf").smoke()
    mf = plan.model_feed(cfg, split_sparse_fields=split)
    step_fn, init = R.make_sparse_train_step(mf.config, adamw(1e-3))
    step = mf.make_step(step_fn)
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    losses = []

    def train(state, env):
        p, o, m = step(state["params"], state["opt"], env)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    train.feed_stats = mf.stats
    return train, {"params": params, "opt": init(params)}, losses


def _final(state):
    out = {k: v.clone() for k, v in state["params"].items()}
    out["embed_accum"] = state["opt"]["embed_accum"].clone()
    return out


@pytest.fixture(scope="module")
def staged_reference():
    plan = featureplan.compile(get_spec("dlrm"))
    train, state, losses = _training(plan)
    runner = StagedRunner(plan.layers, train, workdir=tempfile.mkdtemp(), device=CPU)
    state = runner.run(state, _views())
    assert runner.stats.batches == N_BATCHES and runner.stats.intermediate_bytes > 10_000
    return losses, _final(state)


@pytest.mark.parametrize("variant", ["off", "stage", "arena", "arena_split"])
def test_pipelined_equals_staged_bitwise(staged_reference, variant):
    plan = featureplan.compile(get_spec("dlrm"))
    split = variant == "arena_split"
    train, state, losses = _training(plan, split=split)
    feed = "arena" if split else variant
    runner = PipelinedRunner.from_plan(plan, train, device=CPU, feed=feed,
                                       split_sparse_fields=split, rows_hint=ROWS)
    state = _bounded(lambda: runner.run(state, _views()))
    want_losses, want_state = staged_reference
    assert losses == want_losses
    for k, v in _final(state).items():
        assert torch.equal(v, want_state[k]), k
    s = runner.stats
    assert s.batches == N_BATCHES and s.intermediate_bytes == 0
    assert s.train_feed is train.feed_stats and s.train_feed.steps == N_BATCHES
    if variant == "off":
        assert s.feed is None
    else:
        assert s.feed.batches == N_BATCHES
        assert s.feed.copies_elided == (N_BATCHES * len(runner.device_feed.layout.slots)
                                        if variant.startswith("arena") else 0)
    assert _threads_gone()


@pytest.mark.parametrize("feed", ["off", "stage", "arena"])
def test_runner_counts_like_jax(feed):
    """Same batches through both runners (a train step that only counts):
    batches, feed counts and FE execution counts equal."""
    plan, jplan = featureplan.compile(get_spec("dlrm")), jax_featureplan.compile(jax_get_spec("dlrm"))
    runner = PipelinedRunner.from_plan(plan, lambda s, env: s + 1, device=CPU, feed=feed,
                                       split_sparse_fields=True, rows_hint=ROWS)
    jrunner = JaxPipelinedRunner.from_plan(jplan, lambda s, env: s + 1, feed=feed,
                                           split_sparse_fields=True, rows_hint=ROWS)
    rows = [ROWS, ROWS, 2 * ROWS, ROWS]       # the third batch regrows the arena
    got = _bounded(lambda: runner.run(0, [gen_views(r, seed=40 + i) for i, r in enumerate(rows)]))
    want = jrunner.run(0, [jax_gen_views(r, seed=40 + i) for i, r in enumerate(rows)])
    assert got == want == len(rows)
    assert runner.stats.batches == jrunner.stats.batches == len(rows)
    for field in ("n_layers", "n_source_layers", "n_device_dispatches", "n_host_ops"):
        assert getattr(runner.stats.exec_stats, field) == \
            getattr(jrunner.stats.exec_stats, field), field
    if feed == "off":
        assert runner.stats.feed is None and jrunner.stats.feed is None
        return
    for field in ("batches", "bytes_staged", "rewinds", "reallocs", "buffers",
                  "arena_capacity", "copies_elided"):
        assert getattr(runner.stats.feed, field) == getattr(jrunner.stats.feed, field), field


def test_pipelined_overlaps_fe_with_training():
    """FE for batch i+1 runs while batch i trains: busy time exceeds wall."""
    plan = featureplan.compile(get_spec("dlrm"))

    def slow_train(state, env):
        time.sleep(0.05)
        return state

    runner = PipelinedRunner.from_plan(plan, slow_train, device=CPU, feed="arena",
                                       rows_hint=ROWS)
    _bounded(lambda: runner.run({}, _views()))
    s = runner.stats
    assert s.overlap_seconds > 0 and 0 < s.overlap_fraction <= 1, \
        f"fe={s.fe_seconds:.3f} train={s.train_seconds:.3f} wall={s.wall_seconds:.3f}"


@pytest.mark.parametrize("feed", ["off", "arena"])
def test_train_step_error_surfaces_and_joins_every_thread(feed):
    plan = featureplan.compile(get_spec("dlrm"))
    calls = {"n": 0}

    def explode_later(state, env):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("mid-run failure")
        return state

    runner = PipelinedRunner.from_plan(plan, explode_later, device=CPU, feed=feed,
                                       prefetch=1, rows_hint=ROWS)
    with pytest.raises(RuntimeError, match="mid-run failure"):
        _bounded(lambda: runner.run({}, _views(6)))
    assert calls["n"] == 2 and runner.stats.batches == 1
    assert runner.stats.wall_seconds > 0
    assert _threads_gone()


@pytest.mark.parametrize("feed", ["off", "arena"])
def test_fe_error_surfaces_after_the_good_batches(feed):
    plan = featureplan.compile(get_spec("dlrm"))

    def flaky():
        yield _views(1)[0]
        yield {"impressions": None}        # malformed: the FE worker raises

    runner = PipelinedRunner.from_plan(plan, lambda s, env: s + 1, device=CPU, feed=feed,
                                       rows_hint=ROWS)
    with pytest.raises((KeyError, TypeError, AttributeError)):
        _bounded(lambda: runner.run(0, flaky()))
    assert runner.stats.batches == 1
    assert _threads_gone()


def test_batch_source_error_surfaces_the_original_exception():
    plan = featureplan.compile(get_spec("dlrm"))

    def rotten():
        yield _views(1)[0]
        raise OSError("shard rot at offset 42")

    runner = PipelinedRunner.from_plan(plan, lambda s, env: s, device=CPU, feed="arena",
                                       rows_hint=ROWS)
    with pytest.raises(OSError, match="shard rot at offset 42"):
        _bounded(lambda: runner.run({}, rotten()))
    assert runner.stats.batches == 1 and runner.stats.feed.batches == 1
    assert _threads_gone()


def test_runner_defaults_to_the_card(monkeypatch):
    plan = featureplan.compile(get_spec("dlrm"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelinedRunner.from_plan(plan, lambda s, env: s)
    with pytest.raises(ValueError, match="feed must be"):
        PipelinedRunner.from_plan(plan, lambda s, env: s, device=CPU, feed="bogus")
    np.testing.assert_equal(PipelinedRunner(plan.layers, None, device=CPU).device.type, "cpu")


def test_feeder_shared_state_survives_forced_thread_switches():
    """Stress: the feeder thread stages while the train thread fences, with
    the interpreter switching threads every microsecond. Every fence is
    counted (a lost update would lose one), the fence queue stays bounded,
    and every step reads its own batch."""
    import sys

    plan = featureplan.compile(get_spec("dlrm"))
    views = _views(30, rows=16, seed=800)
    want = [plan.outputs(plan.run(v, device=CPU)) for v in views]
    runner = None
    seen = []

    def step(state, env):
        seen.append(all(torch.equal(env[k], want[len(seen)][k]) for k in want[0]))
        runner.device_feed.donation_fence()
        return state + 1

    runner = PipelinedRunner.from_plan(plan, step, device=CPU, feed="arena", rows_hint=16,
                                       prefetch=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert _bounded(lambda: runner.run(0, views), timeout=120) == len(views)
    finally:
        sys.setswitchinterval(old)
    feeder = runner.device_feed
    assert all(seen) and len(seen) == len(views)
    assert feeder._consumed_seq == feeder.stats.batches == len(views)
    assert len(feeder._fences) <= feeder.buffers
    assert _threads_gone()
