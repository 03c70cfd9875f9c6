"""The port's training path against the JAX package, on the CPU.

* ``sigmoid_bce`` to rtol 1e-6 / atol 1e-7: XLA's CPU ``log1p`` and
  ``exp`` are up to 2 ulp from torch's (ROADMAP C5).
* ``adamw`` on identical gradients, while the clip is inactive: moments bit
  for bit, params within 1 ulp (torch's CPU ``sqrt`` is not correctly
  rounded for about 0.7 % of inputs; XLA's is). With the global-norm clip
  active, the norm is summed in another order, so the clip scale may differ
  in its last bit: rtol 1e-6 / atol 1e-9.
* The sparse step's gradients (dense params and working rows) to rtol 1e-5
  / atol 1e-6 (fp32 sums in another order). Adam is NOT compared after a
  step: at step 1 its update is about lr*sign(g), so an element with g ~ 0
  may move by 2*lr in one framework and not the other (ROADMAP C6). Adagrad
  rows and accumulators are smooth in g and are compared to atol 1e-6.
* The whole slice (views -> plan -> feeder -> make_step) over 5 steps:
  losses to rtol 1e-4, working-set counts and feed counts exact.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import DeviceFeeder as JaxDeviceFeeder  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models.common import sigmoid_bce as jax_sigmoid_bce  # noqa: E402
from repro.train.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.devicefeed import DeviceFeeder  # noqa: E402
from repro_torch.embedding.dedup import FILL  # noqa: E402
from repro_torch.embedding.table import scatter_drop  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import gen_views  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models.common import sigmoid_bce  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
LR = 1e-3


def _configs(**kw):
    return (dataclasses.replace(get_arch("dlrm-mlperf").smoke(), **kw),
            dataclasses.replace(jax_get_arch("dlrm-mlperf").smoke(), **kw))


def _batch(cfg, rows, seed, *, row0=True):
    """A model batch; with ``row0`` the first field's id 0 (packed row 0)
    appears, and the smoke config's capacity (512 > 64 x 6) leaves FILL
    padding in the working set."""
    rng = np.random.default_rng(seed)
    b = {"sparse": np.stack([rng.integers(0, v, rows) for v in cfg.vocab_sizes], 1).astype(np.int32),
         "dense": rng.exponential(1.0, (rows, cfg.n_dense)).astype(np.float32),
         "label": (rng.random(rows) < 0.3).astype(np.float32)}
    if row0:
        b["sparse"][::3, 0] = 0
    return b


def _both(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}, \
        {k: jnp.asarray(v) for k, v in b.items()}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


# ------------------------------------------------------------------- losses
def test_sigmoid_bce_matches_jax():
    rng = np.random.default_rng(0)
    logits = np.concatenate([rng.normal(0, 5, 5000), [0.0, -0.0, 80.0, -80.0, 1e-8]])
    logits = logits.astype(np.float32)
    labels = (rng.random(logits.shape[0]) < 0.3).astype(np.float32)
    got = sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    want = np.asarray(jax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(labels)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- optimizer
SHAPES = {"top_w0": (50, 70), "top_b0": (7,), "bot_w0": (3, 4)}


def _adamw_run(grad_scale, seed, **kw):
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jopt, opt = jax_adamw(LR, **kw), adamw(LR, **kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    update = jax.jit(jopt.update)
    for _ in range(3):
        g = {k: (rng.normal(size=s) * grad_scale).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert ts["step"] == int(js["step"]) == 3
    return ([(tp[k].numpy(), np.asarray(jp[k])) for k in SHAPES]
            + [(ts[m][k].numpy(), np.asarray(js[m][k])) for m in ("m", "v") for k in SHAPES])


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.01}, {"clip_norm": None},
                                {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adamw_matches_jax_bitwise_on_identical_grads(kw):
    """Three updates with the clip inactive (global norm < 1): both moments
    bit for bit, params within 1 ulp."""
    pairs = _adamw_run(1e-3, 1, **kw)
    for got, want in pairs[:len(SHAPES)]:
        assert _ulps(got, want).max() <= 1
    for got, want in pairs[len(SHAPES):]:
        np.testing.assert_array_equal(got, want)


def test_adamw_with_active_clip_matches_jax():
    pairs = _adamw_run(1.0, 2, weight_decay=0.01)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert max(int(_ulps(g, w).max()) for g, w in pairs[:len(SHAPES)]) <= 4


def test_adamw_updates_in_place():
    opt = adamw(0.1)
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    new, state = opt.update(p, {"w": torch.tensor([1.0, -1.0, 0.0])}, state)
    assert new["w"] is p["w"] and state["step"] == 1
    assert torch.equal(p["w"], torch.tensor([0.9, 1.1, 1.0]))


# -------------------------------------------------------------- sparse step
def test_sparse_grads_match_jax():
    """Loss and the gradients of the dense params and of the working rows
    against jax.grad of the JAX loss (whose table gradient, read at the
    working set's ids, is the working-row gradient)."""
    cfg, jcfg = _configs()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    params = R.params_from_jax(jparams, CPU)
    tb, jb = _both(_batch(cfg, 64, seed=1))
    ws = R.sparse_grads(params, cfg, tb)
    jloss, jgrads = jax.value_and_grad(JR.loss_fn)(jparams, jcfg, jb)
    np.testing.assert_allclose(float(ws.loss), float(jloss), rtol=1e-6)
    n = int(ws.n_unique)
    unique = ws.unique.numpy()
    assert unique[0] == 0 and (unique[n:] == FILL).all() and n < unique.shape[0]
    assert ws.n_ids == 64 * cfg.n_sparse and not params["embed"].requires_grad
    np.testing.assert_allclose(ws.working_grad.numpy()[:n], np.asarray(jgrads["embed"])[unique[:n]],
                               rtol=1e-5, atol=1e-6)
    assert not ws.working_grad[n:].any()
    assert (ws.working_grad[:n].abs().amax(dim=1) > 0).all()
    assert set(ws.dense_grads) == set(jgrads) - {"embed"}
    for k, g in ws.dense_grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_sparse_train_step_matches_jax():
    """One step on a batch with packed row 0 and FILL padding: loss,
    unique, n_ids, the updated rows and Adagrad accumulators at the touched
    ids (row 0 included) against JAX; untouched rows and accumulators stay
    exactly as they were (FILL slots write nothing)."""
    cfg, jcfg = _configs()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(1))
    params = R.params_from_jax(jparams, CPU)
    embed0 = params["embed"].clone()
    tb, jb = _both(_batch(cfg, 64, seed=2))
    jstep, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(LR))
    step, init = R.make_sparse_train_step(cfg, adamw(LR))
    jnew, jstate, jm = jax.jit(jstep)(jparams, jinit(jparams), jb)
    state = init(params)
    new, state, m = step(params, state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    assert int(m["unique"]) == int(jm["unique"]) and m["n_ids"] == int(jm["n_ids"])
    assert new["embed"] is params["embed"]          # updated in place
    unique = R.sparse_grads(R.params_from_jax(jparams, CPU), cfg, tb).unique.numpy()
    touched = unique[unique != FILL]
    assert touched[0] == 0
    np.testing.assert_allclose(new["embed"].numpy()[touched], np.asarray(jnew["embed"])[touched],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(state["embed_accum"].numpy()[touched],
                               np.asarray(jstate["embed_accum"])[touched], rtol=1e-6, atol=1e-6)
    assert (state["embed_accum"].numpy()[touched] > 0.1).all()
    rest = np.setdiff1d(np.arange(embed0.shape[0]), touched)
    assert torch.equal(new["embed"][rest], embed0[rest])
    assert (state["embed_accum"].numpy()[rest] == np.float32(0.1)).all()
    assert not torch.equal(new["embed"][0], embed0[0])


def test_scatter_drop_writes_nothing_for_fill():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    unique = torch.tensor([0, 4, FILL, FILL], dtype=torch.int32)
    values = torch.tensor([[-1.0, -2.0], [-3.0, -4.0], [99.0, 99.0], [98.0, 98.0]])
    scatter_drop(table, unique, values)
    want = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    want[0], want[4] = values[0], values[1]
    assert torch.equal(table, want)
    scatter_drop(table, torch.full((3,), FILL, dtype=torch.int32), torch.full((3, 2), 7.0))
    assert torch.equal(table, want)                 # nothing valid: nothing written
    acc = torch.zeros(6)
    scatter_drop(acc, unique, torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert torch.equal(acc, torch.tensor([1.0, 0, 0, 0, 2.0, 0]))


def test_sparse_step_working_set_overflow_like_jax():
    """A capacity below the batch's unique count: ids past it read NaN rows,
    as jnp.take does, so both losses are NaN and the working sets agree."""
    cfg, jcfg = _configs(dedup_capacity=16)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(2))
    tb, jb = _both(_batch(cfg, 32, seed=3, row0=False))
    jstep, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(LR))
    step, init = R.make_sparse_train_step(cfg, adamw(LR))
    params = R.params_from_jax(jparams, CPU)
    _, _, m = step(params, init(params), tb)
    _, _, jm = jax.jit(jstep)(jparams, jinit(jparams), jb)
    assert np.isnan(float(m["loss"])) and np.isnan(float(jm["loss"]))
    assert int(m["unique"]) == int(jm["unique"]) == 16


# ---------------------------------------------------------------- make_step
def test_make_step_stats_fence_and_donation():
    """The step adapts inside the call, updates params and optimizer state in
    place (the port's form of donation), passes its fence (None on the CPU)
    and fills TrainFeedStats."""
    cfg, _ = _configs()
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg)
    train_step, init = R.make_sparse_train_step(cfg, adamw(LR))
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    state = init(params)
    fences = []
    env = plan.run(gen_views(32, seed=5), device=CPU)
    step = feed.make_step(train_step, fence_cb=fences.append)
    assert step.feed_stats is feed.stats
    before = {k: v.clone() for k, v in params.items()}
    for n in (1, 2):
        new, state, m = step(params, state, env)
        assert new["embed"] is params["embed"] and state["dense"]["step"] == n
        assert fences == [None] * n
    assert not torch.equal(params["embed"], before["embed"])
    s = feed.stats
    assert s.steps == s.fused_steps == 2 and s.adapt_dispatches == 0
    assert s.total_ids == 2 * 32 * cfg.n_sparse
    assert 0 < s.unique_ratio < 1 and s.overflows == 0
    assert "unique_ratio=" in s.summary()


def test_make_step_surfaces_working_set_saturation():
    cfg, _ = _configs(dedup_capacity=8)
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg)
    train_step, init = R.make_sparse_train_step(cfg, adamw(LR))
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    step = feed.make_step(train_step)
    with pytest.warns(RuntimeWarning, match="working set saturated"):
        step(params, init(params), plan.run(gen_views(32, seed=1), device=CPU))
    assert feed.stats.overflows == 1


# ------------------------------------------------------------- whole slice
def test_slice_five_steps_matches_jax():
    """views -> FeaturePlan.run -> DeviceFeeder.stage -> ModelFeed.make_step
    (sparse step, adamw), 5 steps, against the JAX chain on the same views
    and the same initial params."""
    cfg, jcfg = _configs()
    plan, jplan = featureplan.compile(get_spec("dlrm")), jax_featureplan.compile(jax_get_spec("dlrm"))
    feed, jfeed = plan.model_feed(cfg), jplan.model_feed(jcfg)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(3))
    params = R.params_from_jax(jparams, CPU)
    jstep_fn, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(LR))
    step_fn, init = R.make_sparse_train_step(cfg, adamw(LR))
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=64, buffers=2, device=CPU)
    jfeeder = JaxDeviceFeeder(jplan.feed_layout(), rows_hint=64, buffers=2)
    step = feed.make_step(step_fn, fence_cb=feeder.donation_fence)
    jstep = jfeed.make_step(jstep_fn, donate=False)
    state, jstate = init(params), jinit(jparams)
    losses, jlosses = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no working-set saturation
        for i in range(5):
            params, state, m = step(params, state, feeder.stage(
                plan.run(gen_views(64, seed=70 + i), device=CPU)))
            jparams, jstate, jm = jstep(jparams, jstate, jfeeder.stage(
                jplan.run(jax_gen_views(64, seed=70 + i))))
            losses.append(float(m["loss"]))
            jlosses.append(float(jm["loss"]))
            assert int(m["unique"]) == int(jm["unique"])
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for field in ("batches", "bytes_staged", "rewinds", "buffers", "reallocs"):
        assert getattr(feeder.stats, field) == getattr(jfeeder.stats, field), field
    for field in ("steps", "fused_steps", "unique_ids", "total_ids", "overflows"):
        assert getattr(feed.stats, field) == getattr(jfeed.stats, field), field
    assert feeder.stats.fresh_arenas == 0           # every arena reused after its fence


# ------------------------------------------------- DCN-v2, AutoInt and BST
def _opt_from_jax(jstate):
    dense = jstate["dense"]
    return {"dense": {"m": R.params_from_jax(dense["m"], CPU),
                      "v": R.params_from_jax(dense["v"], CPU), "step": int(dense["step"])},
            "embed_accum": torch.from_numpy(np.array(jstate["embed_accum"]))}


@pytest.mark.parametrize("arch", ["dcn-v2", "autoint", "bst"])
def test_three_sparse_steps_match_jax(arch):
    """Three sparse train steps of the smoke config, each started from the
    JAX chain's state before it (so the step-1 Adam sign noise of ROADMAP
    C6 never reaches the comparison): the loss (rtol 1e-6), the working-row
    and dense gradients (rtol 1e-5 / atol 1e-6), and the rows and Adagrad
    accumulators the step writes at the touched ids (atol 1e-6), against
    JAX; untouched rows stay as they were."""
    cfg, jcfg = get_arch(arch).smoke(), jax_get_arch(arch).smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    jstep_fn, jinit, _ = JR.make_sparse_train_step(jcfg, jax_adamw(LR))
    jstep = jax.jit(jstep_fn)
    step, _ = R.make_sparse_train_step(cfg, adamw(LR))
    jstate = jinit(jparams)
    for i in range(3):
        rng = np.random.default_rng(40 + i)
        b = {"sparse": np.stack([rng.integers(0, v, 64) for v in cfg.vocab_sizes], 1
                                ).astype(np.int32),
             "label": (rng.random(64) < 0.3).astype(np.float32)}
        if cfg.n_dense:
            b["dense"] = rng.exponential(1.0, (64, cfg.n_dense)).astype(np.float32)
        if cfg.kind == "bst":
            b["seq"] = rng.integers(0, cfg.vocab_sizes[0], (64, cfg.seq_len)).astype(np.int32)
        tb, jb = _both(b)
        params, state = R.params_from_jax(jparams, CPU), _opt_from_jax(jstate)
        embed0 = params["embed"].clone()
        ws = R.sparse_grads(params, cfg, tb)
        jloss, jgrads = jax.value_and_grad(JR.loss_fn)(jparams, jcfg, jb)
        np.testing.assert_allclose(float(ws.loss), float(jloss), rtol=1e-6)
        n = int(ws.n_unique)
        touched = ws.unique.numpy()[:n]
        np.testing.assert_allclose(ws.working_grad.numpy()[:n],
                                   np.asarray(jgrads["embed"])[touched], rtol=1e-5, atol=1e-6)
        assert (ws.working_grad[:n].abs().amax(dim=1) > 0).all()
        assert set(ws.dense_grads) == set(jgrads) - {"embed"}
        for k, g in ws.dense_grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")

        new, state, m = step(params, state, tb)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
        assert int(m["unique"]) == int(jm["unique"]) == n and m["n_ids"] == int(jm["n_ids"])
        np.testing.assert_allclose(new["embed"].numpy()[touched],
                                   np.asarray(jparams["embed"])[touched], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(state["embed_accum"].numpy()[touched],
                                   np.asarray(jstate["embed_accum"])[touched],
                                   rtol=1e-6, atol=1e-6)
        rest = np.setdiff1d(np.arange(embed0.shape[0]), touched)
        assert torch.equal(new["embed"][rest], embed0[rest])
