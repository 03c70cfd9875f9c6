"""The port's dense LM family, its common layers, ``adagrad``/``sgd`` and
the recsys ``make_train_step`` against the JAX package, on the CPU.

* ``rms_norm``: no cancellation (a product of ``x * rsqrt(var + eps)`` and
  the weight), so each element within 16 * 2**-24 of |x_hat * w| in
  float32, and within one bf16 ulp (2**-7 |y|) in bfloat16 (ROADMAP C23:
  a per-element bound, not an ulp count). ``swiglu`` and ``softmax_xent``
  (with logits shifted by 1,000, where the max shift matters) to rtol 1e-5.
* ``adagrad`` and ``sgd`` (momentum 0 and 0.9) on identical gradients over
  three steps: float32 params within one ulp plus one ulp of the step's
  update, their state bit for bit; bfloat16 params within one bf16 ulp. JAX's quadratic test
  (``tests/test_train.py:155``) on the port's three optimizers.
* The recsys ``make_train_step`` at the four smoke configs from JAX's
  params: with ``sgd(0.1)`` (so the params show the gradients, ROADMAP C6)
  the loss to rtol 1e-6 and the updated params to atol 1e-6; with
  ``adamw`` three losses of ``dlrm-mlperf`` to rtol 1e-5.
* The transformer at the yi and qwen smoke configs from ``params_from_jax``
  (sequences of 16, one q block, and of 40, three padded blocks):
  ``hidden_states`` within 1e-5 of the largest |h|, ``lm_loss`` to rtol
  1e-6, each gradient within 1e-5 of its largest |g| (JAX's read 1e-6 at
  most); ``make_train_step`` with ``grad_accum`` 1 and 2 and
  ``remat_group`` 1 and 2: one ``sgd(1.0)`` step's params within 1e-5 of
  the largest |g| plus an ulp of the param; the 6-step chain of
  ``tests/test_models_smoke.py`` (AdamW 2e-3, ``grad_accum`` 1) to rtol
  1e-5; ``serve_step``, ``make_cache`` and
  ``prefill`` against JAX's (logits and caches to rtol/atol 1e-5), and
  decode == prefill on the port. A mutant with one norm weight 1e-3 off
  must fail those comparisons.
* The driver's lm branch: ``synthetic_batch("lm")`` bit for bit, the CLI
  trains with falling loss, the recsys-only flags refused as JAX's driver
  refuses them.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import train as JD  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as D  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402

CPU = torch.device("cpu")
LM_ARCHS = ["yi-9b", "qwen2.5-14b", "qwen2.5-32b", "deepseek-moe-16b", "deepseek-v2-236b"]
MOE_ARCHS = ["deepseek-moe-16b", "deepseek-v2-236b"]
RECSYS_ARCHS = ["dlrm-mlperf", "dcn-v2", "autoint", "bst"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_within_its_bound(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 256)) * rng.uniform(0.01, 100, size=(64, 1))).astype(np.float32)
    w = rng.normal(size=256).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JC.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w)).astype(jnp.float32))
    got = C.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        x64 = x.astype(np.float64)
        y = np.abs(x64 / np.sqrt(np.mean(x64 * x64, axis=-1, keepdims=True) + 1e-6) * w)
        assert (np.abs(got - want) <= 16 * 2.0 ** -24 * y).all()
        assert (np.abs(got - y * np.sign(x * w)) <= 16 * 2.0 ** -24 * y).all()
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()


def test_swiglu_and_softmax_xent_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.2).astype(np.float32) for s in ((16, 24), (16, 24), (24, 16))]
    got = C.swiglu(torch.from_numpy(x), *(torch.from_numpy(w) for w in ws)).numpy()
    want = np.asarray(JC.swiglu(jnp.asarray(x), *(jnp.asarray(w) for w in ws)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    logits = (rng.normal(size=(4, 7, 300)) * 5).astype(np.float32)
    labels = rng.integers(0, 300, (4, 7)).astype(np.int32)
    for shift in (0.0, 1000.0):
        got = C.softmax_xent(torch.from_numpy(logits + shift), torch.from_numpy(labels)).numpy()
        want = np.asarray(JC.softmax_xent(jnp.asarray(logits + shift), jnp.asarray(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_inits_draw_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    he = C.he_init(gen, (512, 300))
    glorot = C.glorot_init(gen, (512, 300))
    emb = C.embed_init(gen, (512, 300))
    lim = np.sqrt(6.0 / (512 + 300))
    assert abs(float(he.std()) / np.sqrt(2.0 / 512) - 1) < 0.02
    assert float(glorot.abs().max()) <= lim
    assert abs(float(glorot.std()) / (lim / np.sqrt(3)) - 1) < 0.02
    assert abs(float(emb.std()) / 0.02 - 1) < 0.02
    assert not hasattr(C, "keygen")       # no caller in either package (ROADMAP A)


# -------------------------------------------------------------- optimizers
OPTS = {"adagrad": (lambda: JO.adagrad(0.05), lambda: O.adagrad(0.05), "accum"),
        "sgd": (lambda: JO.sgd(0.05), lambda: O.sgd(0.05), None),
        "sgd_momentum": (lambda: JO.sgd(0.05, momentum=0.9), lambda: O.sgd(0.05, momentum=0.9),
                         "mu")}
SHAPES = {"w0": (50, 70), "b0": (7,), "nest": {"w1": (3, 4, 5)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_adagrad_and_sgd_match_jax_on_identical_grads(name, dtype):
    """Three steps, each from JAX's params and state of the step before:
    the state bit for bit; a float32 param within one ulp of itself plus
    one ulp of the step's update (torch's CPU ``sqrt`` is not correctly
    rounded for about 0.7 % of inputs, ROADMAP C5, and an update larger
    than the param carries its ulp over); a bfloat16 param within one bf16
    ulp."""
    jopt, opt, slot = OPTS[name][0](), OPTS[name][1](), OPTS[name][2]
    rng = np.random.default_rng(2)
    leaves = O.flatten(SHAPES)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    jp = O.unflatten({k: jnp.asarray(v).astype(jdt) for k, v in p.items()})
    js = jopt.init(jp)
    update = jax.jit(jopt.update)
    for _ in range(3):
        prev = {k: np.asarray(v, np.float32) for k, v in O.flatten(_np_tree(jp)).items()}
        tp = T.params_from_jax(_np_tree(jp), CPU)
        ts = {k: O.flatten(T.params_from_jax(_np_tree(v), CPU)) for k, v in js.items()}
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
        jp, js = update(jp, O.unflatten({k: jnp.asarray(v) for k, v in g.items()}), js)
        tp, ts = opt.update(tp, O.unflatten({k: torch.from_numpy(v) for k, v in g.items()}), ts)
        jflat, tflat = O.flatten(_np_tree(jp)), O.flatten(tp)
        for k in leaves:
            got, want = tflat[k].to(torch.float32).numpy(), np.asarray(jflat[k], np.float32)
            if dtype == "float32":
                bound = np.spacing(np.abs(want)) + np.spacing(np.abs(want - prev[k]))
                assert (np.abs(got - want) <= bound).all(), k
            else:
                assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all(), k
        if slot:
            jstate = O.flatten(_np_tree(js[slot]))
            for k in leaves:
                np.testing.assert_array_equal(ts[slot][k].numpy(), jstate[k])


@pytest.mark.parametrize("name", ["adamw", "adagrad", "sgd"])
def test_optimizers_reduce_quadratic(name):
    """JAX's ``tests/test_train.py:155`` on the port's optimizers."""
    opt = {"adamw": O.adamw(1e-1), "adagrad": O.adagrad(0.5),
           "sgd": O.sgd(0.1, momentum=0.9)}[name]
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(120):
        params, state = opt.update(params, {"w": 2 * params["w"]}, state)
    assert float((params["w"] ** 2).sum()) < 0.5


def test_adamw_on_a_nested_tree_matches_jax():
    """The LM tree's nesting: leaves in the JAX tree order, the clip's norm
    summed over them; params within 4 ulp (the clip active), moments within
    rtol 1e-6."""
    rng = np.random.default_rng(3)
    leaves = O.flatten(SHAPES)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
    jopt, opt = JO.adamw(1e-3), O.adamw(1e-3)
    jp = O.unflatten({k: jnp.asarray(v) for k, v in p.items()})
    tp = O.unflatten({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    js, ts = jopt.init(jp), opt.init(tp)
    assert sorted(ts["m"]) == sorted(leaves)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
        jp, js = jax.jit(jopt.update)(jp, O.unflatten({k: jnp.asarray(v) for k, v in g.items()}),
                                      js)
        tp, ts = opt.update(tp, O.unflatten({k: torch.from_numpy(v) for k, v in g.items()}), ts)
    jflat, tflat = O.flatten(_np_tree(jp)), O.flatten(tp)
    for k in leaves:
        assert _ulps(tflat[k].numpy(), jflat[k]).max() <= 4, k
        np.testing.assert_allclose(ts["m"][k].numpy(), O.flatten(_np_tree(js["m"]))[k],
                                   rtol=1e-6, atol=1e-9)


def test_adamw_groups_leaves_without_changing_them(monkeypatch):
    """The elementwise steps run over groups of at most ``GROUP_ELEMS``
    elements: a group of one leaf each gives the same bits."""
    rng = np.random.default_rng(4)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in O.flatten(SHAPES).items()}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    out = []
    for cap in (O.GROUP_ELEMS, 1):
        monkeypatch.setattr(O, "GROUP_ELEMS", cap)
        opt = O.adamw(1e-3, weight_decay=0.01)
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        st = opt.init(tp)
        for _ in range(2):
            tp, st = opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        out.append(O.flatten(tp))
    for k in p:
        assert torch.equal(out[0][k], out[1][k]), k


# ------------------------------------------------------- recsys make_train_step
def _recsys_batch(cfg, b=32, seed=0):
    """``tests/test_models_smoke.py``'s recsys batch."""
    rng = np.random.default_rng(seed)
    out = {"sparse": np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes[:cfg.n_sparse]],
                              axis=1).astype(np.int32),
           "label": (rng.random(b) < 0.3).astype(np.float32)}
    if cfg.n_dense:
        out["dense"] = rng.exponential(1, (b, cfg.n_dense)).astype(np.float32)
    if cfg.kind == "bst":
        out["seq"] = rng.integers(0, cfg.vocab_sizes[0], (b, cfg.seq_len)).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_make_train_step_matches_jax(arch):
    jcfg, cfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _recsys_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # one SGD step: the updated params show the gradients
    jp, _, jm = jax.jit(JR.make_train_step(jcfg, JO.sgd(0.1)))(jparams, {}, jb)
    tp, _, tm = R.make_train_step(cfg, O.sgd(0.1))(R.params_from_jax(jparams, CPU), {}, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_recsys_make_train_step_adamw_chain_matches_jax():
    """Three AdamW steps of the whole-tree step (``dlrm-mlperf``)."""
    jcfg, cfg = jax_get_arch("dlrm-mlperf").smoke(), get_arch("dlrm-mlperf").smoke()
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _recsys_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jo, to = JO.adamw(1e-3), O.adamw(1e-3)
    jstep, tstep = jax.jit(JR.make_train_step(jcfg, jo)), R.make_train_step(cfg, to)
    jp, js = jparams, jo.init(jparams)
    tp = R.params_from_jax(jparams, CPU)
    ts = to.init(tp)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_match_jax(arch):
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    assert spec.family == jspec.family == "lm" and spec.describe == jspec.describe
    jfull = __import__(f"repro.configs.{arch.replace('-', '_').replace('.', '_')}",
                       fromlist=["CONFIG"]).CONFIG
    for cfg, jcfg in [(spec.config, jfull), (spec.smoke(), jspec.smoke())]:
        names = [f.name for f in dataclasses.fields(cfg)]
        assert names == [f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name in ("dtype", "accum_dtype"):
                assert str(got).split(".")[-1] == jnp.dtype(want).name, f.name
            elif f.name in ("moe", "mla") and want is not None:   # the port's own dataclasses
                assert type(got).__name__ == type(want).__name__, f.name
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            else:
                assert got == want, f.name
        assert O.flatten(T.param_shapes(cfg)) == O.flatten(
            jax.tree.map(tuple, JT.param_shapes(jcfg), is_leaf=lambda x: isinstance(x, tuple)))
    # the full-width count against JAX's abstract params (no memory on either side)
    want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(JT.abstract_params(jfull)))
    assert T.param_count(spec.config) == want
    ab = O.flatten(T.abstract_params(spec.config))
    assert sum(v.numel() for v in ab.values()) == want
    if arch == "yi-9b":
        assert T.param_count(spec.config) == 8_829_407_232
    if arch == "deepseek-moe-16b":
        assert T.param_count(spec.config) == 16_375_728_128
    if arch == "deepseek-v2-236b":
        assert T.param_count(spec.config) == 235_741_312_000


def test_init_and_abstract_params():
    cfg = get_arch("qwen2.5-14b").smoke()
    p = T.init_params(cfg, torch.Generator().manual_seed(0))
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    flat, shapes = O.flatten(p), O.flatten(T.param_shapes(cfg))
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes
    for k, v in flat.items():
        assert v.dtype == cfg.dtype and torch.equal(v, O.flatten(again)[k])
        if "norm" in k.rsplit(".", 1)[-1]:
            assert torch.equal(v, torch.ones_like(v))
        elif v.numel() > 4000:
            assert abs(float(v.std()) / 0.02 - 1) < 0.1, k
    ab = O.flatten(T.abstract_params(get_arch("yi-9b").config))
    assert all(v.device.type == "meta" and v.dtype == torch.bfloat16 for v in ab.values())


# -------------------------------------------------------------- transformer
def _jax_lm(arch, **kw):
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke(), **kw)
    cfg = dataclasses.replace(get_arch(arch).smoke(), **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, seq):
    """JAX's hidden states, loss and gradients (numpy) at the smoke config
    from its init params, on 3 sequences of ``seq`` tokens (jitted once)."""
    jcfg, cfg, jparams = _jax_lm(arch)
    toks = jnp.asarray(_tokens(cfg, 3, seq))
    fwd = jax.jit(lambda p, t: (JT.hidden_states(p, t, jcfg),
                                *jax.value_and_grad(JT.lm_loss)(p, t, t, jcfg)))
    (jh, jaux), jl, jg = fwd(jparams, toks)
    return np.asarray(jh), float(jaux), float(jl), O.flatten(_np_tree(jg))


def _forward_deviation(arch, seq, mutate=None):
    """The largest deviations of the port's hidden states, loss and
    gradients from JAX's, each relative to the largest |value|."""
    jcfg, cfg, jparams = _jax_lm(arch)
    params = T.params_from_jax(_np_tree(jparams), CPU)
    if mutate:
        mutate(params)
    toks = _tokens(cfg, 3, seq)
    jh, jaux, jl, jgf = _jax_forward(arch, seq)
    th, taux = T.hidden_states(params, torch.from_numpy(toks), cfg)
    leaves = {k: v.detach().requires_grad_(True) for k, v in O.flatten(params).items()}
    tl = T.lm_loss(O.unflatten(leaves), torch.from_numpy(toks), torch.from_numpy(toks), cfg)
    tl.backward()
    assert sorted(jgf) == sorted(leaves)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
    return {"hidden": rel(th.detach().numpy(), jh),
            "aux": abs(float(taux.detach()) - jaux) / max(abs(jaux), 1e-30),
            "loss": abs(float(tl.detach()) - jl) / abs(jl),
            "grads": max(rel(leaves[k].grad.numpy(), jgf[k]) for k in jgf)}


@pytest.mark.parametrize("seq", [16, 40])
@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-14b"] + MOE_ARCHS)
def test_hidden_states_loss_and_grads_match_jax(arch, seq):
    """The MoE archs also carry each MoE layer's aux out of its checkpoint:
    the summed aux to rtol 1e-6 (dense: 0 on both sides)."""
    dev = _forward_deviation(arch, seq)
    assert dev["hidden"] <= 1e-5 and dev["loss"] <= 1e-6 and dev["grads"] <= 1e-5, dev
    assert dev["aux"] <= 1e-6, dev


def _norm_off(params):
    params["dense_layers"]["norm1"][0, 5] *= 1 + 1e-3


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-14b"] + MOE_ARCHS)
def test_the_comparison_catches_one_norm_weight_off_by_1e_3(arch):
    dev = _forward_deviation(arch, 40, mutate=_norm_off)
    assert dev["hidden"] > 1e-5 or dev["loss"] > 1e-6 or dev["grads"] > 1e-5, dev


@pytest.mark.parametrize("arch,grad_accum,remat_group", [
    ("yi-9b", 1, 1), ("yi-9b", 2, 1), ("yi-9b", 1, 2), ("yi-9b", 2, 2),
    ("qwen2.5-14b", 1, 1), ("qwen2.5-14b", 2, 2),
    ("deepseek-moe-16b", 1, 1), ("deepseek-moe-16b", 2, 2), ("deepseek-v2-236b", 2, 2)])
def test_train_step_matches_jax(arch, grad_accum, remat_group):
    """One SGD step on sequences of 40 (three padded blocks): the params
    show the accumulated gradient."""
    jcfg, cfg, jparams = _jax_lm(arch, grad_accum=grad_accum, remat_group=remat_group)
    toks = _tokens(cfg, 4, 40)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jp, _, jm = jax.jit(JT.make_train_step(jcfg, JO.sgd(1.0)))(jparams, {}, jb)
    f0 = O.flatten(T.params_from_jax(_np_tree(jparams), CPU))
    tp, _, tm = T.make_train_step(cfg, O.sgd(1.0))(T.params_from_jax(_np_tree(jparams), CPU),
                                                   {}, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    jflat, tflat = O.flatten(_np_tree(jp)), O.flatten(tp)
    for k in jflat:
        g_want = f0[k].numpy() - jflat[k]
        bound = 1e-5 * np.abs(g_want).max() + np.spacing(np.abs(jflat[k]))
        assert (np.abs(tflat[k].numpy() - jflat[k]) <= bound).all(), k


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-14b"])
def test_train_chain_matches_jax(arch):
    """The 6-step AdamW chain of ``tests/test_models_smoke.py`` on
    sequences of 16."""
    jcfg, cfg, jparams = _jax_lm(arch)
    jo, to = JO.adamw(2e-3), O.adamw(2e-3)
    jstep, tstep = jax.jit(JT.make_train_step(jcfg, jo)), T.make_train_step(cfg, to)
    jp, js = jparams, jo.init(jparams)
    tp = T.params_from_jax(_np_tree(jparams), CPU)
    ts = to.init(tp)
    toks = _tokens(cfg, 4, 16)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jl, tl = [], []
    for _ in range(6):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


def no_drop(cfg):
    """``cfg`` with a capacity factor at which no ``(token, k)`` pair can
    drop (``n_experts / top_k``): decode (a call of B tokens) and prefill
    (a call of B x S) compute the same function only there (ROADMAP C25)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-14b"] + MOE_ARCHS)
def test_serve_step_cache_and_prefill_match_jax(arch):
    """``serve_step`` from the same cache (GQA ``k``/``v`` or MLA
    ``ckv``/``krope``), ``make_cache`` and ``prefill`` against JAX's at the
    arch's own capacity factor; decode == prefill on the port at the
    no-drop one (:func:`no_drop`)."""
    jcfg, cfg, jparams = _jax_lm(arch)
    params = T.params_from_jax(_np_tree(jparams), CPU)
    toks = _tokens(cfg, 4, 40)
    jcache = JT.make_cache(jcfg, 4, 24)
    cache = T.make_cache(cfg, 4, 24, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    assert all(v.device.type == "meta" for v in T.make_cache(cfg, 4, 24, abstract=True).values())
    jserve = jax.jit(JT.serve_step, static_argnames=("c",))
    ncfg, ncache = no_drop(cfg), T.make_cache(cfg, 4, 24, device="cpu")
    for t in range(6):
        jl, jcache = jserve(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t), c=jcfg)
        tl, cache = T.serve_step(params, torch.from_numpy(toks[:, t:t + 1]), cache,
                                 torch.tensor(t), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        # decode == prefill of the prefix at its last position
        nl, ncache = T.serve_step(params, torch.from_numpy(toks[:, t:t + 1]), ncache, t, ncfg)
        pf = T.prefill(params, torch.from_numpy(toks[:, :t + 1]), ncfg)
        np.testing.assert_allclose(nl.numpy(), pf.numpy(), rtol=1e-5, atol=1e-5)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5, atol=1e-6)
    for seq in (16, 40):
        want = JT.prefill(jparams, jnp.asarray(toks[:, :seq]), jcfg)
        got = T.prefill(params, torch.from_numpy(toks[:, :seq]), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat_group", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_gradient_reaches_the_routers_through_the_checkpoints(arch, remat_group):
    """``d(0.01 * aux) / d router`` of every MoE layer against JAX's, with
    one checkpoint a layer and with a group of two inside an outer one: a
    checkpointed function that dropped the aux would leave the routers no
    gradient (each within 1e-5 of its largest |value|, and not zero)."""
    jcfg, cfg, jparams = _jax_lm(arch, remat_group=remat_group)
    toks = _tokens(cfg, 3, 16)
    want = jax.jit(jax.grad(lambda p, t: 0.01 * JT.hidden_states(p, t, jcfg)[1]))(
        jparams, jnp.asarray(toks))["moe_layers"]["moe_router"]
    leaves = {k: v.requires_grad_(True) for k, v in
              O.flatten(T.params_from_jax(_np_tree(jparams), CPU)).items()}
    _, aux = T.hidden_states(O.unflatten(leaves), torch.from_numpy(toks), cfg)
    (0.01 * aux).backward()
    got = leaves["moe_layers.moe_router"].grad.numpy()
    assert np.abs(got).max() > 0 and np.abs(np.asarray(want)).max() > 0
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()


# ------------------------------------------------------------------ driver
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_synthetic_batch_is_jaxs(arch):
    cfg = get_arch(arch).smoke()
    for step, batch in ((0, 8), (3, 64)):
        want = JD.synthetic_batch("lm", jax_get_arch(arch).smoke(), batch, step)
        got = D.synthetic_batch("lm", cfg, batch, step, device=CPU)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _jax_driver_losses(arch, jparams, batch, steps):
    """The JAX driver's lm branch: ``run_training`` over ``synthetic_batch``
    with the jitted ``make_train_step(cfg, adamw(lr))``."""
    from repro.train.loop import LoopConfig, run_training

    jcfg = jax_get_arch(arch).smoke()
    opt = JO.adamw(1e-3)
    step = jax.jit(JT.make_train_step(jcfg, opt))

    def wrapper(state, b):
        p, o, m = step(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, m

    _, stats = run_training(cfg=LoopConfig(n_steps=steps),
                            state={"params": jparams, "opt": opt.init(jparams)},
                            train_step=wrapper,
                            batch_source=lambda s: JD.synthetic_batch("lm", jcfg, batch, s))
    return stats.losses


@pytest.mark.parametrize("arch", ["qwen2.5-32b"])
def test_lm_driver_chain_matches_jaxs(arch):
    """The in-memory driver from JAX's params against the JAX driver's chain
    (the yi and qwen2.5-14b chains are the curve fixture's)."""
    spec = get_arch(arch)
    cfg = spec.smoke()
    jparams = JT.init_params(jax_get_arch(arch).smoke(), jax.random.PRNGKey(0))
    params = T.params_from_jax(_np_tree(jparams), CPU)
    opt = O.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    args = D.parse_args(["--arch", arch, "--steps", "6", "--batch", "8", "--device", "cpu"])
    _, losses = D.run_in_memory(args, spec, cfg, state, opt)
    want = _jax_driver_losses(arch, jparams, 8, 6)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_lm_cli_trains_and_refuses_the_recsys_flags(tmp_path, capsys):
    stats, losses = D.main(["--arch", "yi-9b", "--steps", "4", "--batch", "8", "--device", "cpu"])
    assert stats.steps == 4 and losses[-1] < losses[0]
    assert "arch=yi-9b steps=4" in capsys.readouterr().out
    base = ["--arch", "qwen2.5-14b", "--steps", "1", "--device", "cpu"]
    for extra, msg in ((["--data-dir", str(tmp_path)], "--data-dir streaming runs"),
                       (["--embedding", "hierarchy"], "--embedding hierarchy is a recsys"),
                       (["--mesh", "1x1"], "--mesh data-parallel training shards"),
                       (["--check"], "--check verifies the FE feed pipeline"),
                       (["--vocab-scale", "2"], "--vocab-scale only applies to recsys archs")):
        with pytest.raises(SystemExit, match=re.escape(msg)):
            D.main(base + extra)


def test_lm_metrics_cost_the_step_on_meta_copies(capsys):
    D.main(["--arch", "yi-9b", "--steps", "2", "--batch", "8", "--device", "cpu", "--metrics"])
    out = capsys.readouterr().out
    flops = float(out.split("hlo/step: ")[1].split(" GFLOP")[0]) * 1e9
    # the step's matrix products: 3 GEMMs a weight use (forward, both
    # gradients) plus flash attention's, over 8 sequences of 64 tokens
    cfg = get_arch("yi-9b").smoke()
    tokens = 8 * 64
    per_layer = 2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim + \
        2 * cfg.n_heads * cfg.head_dim * cfg.d_model + 3 * 2 * cfg.d_model * cfg.d_ff
    dense_flops = 3 * tokens * (cfg.n_layers * per_layer + 2 * cfg.d_model * cfg.vocab)
    assert dense_flops < flops < 2 * dense_flops


def test_moe_metrics_cost_the_experts_at_their_capacity(capsys):
    """``--metrics`` on the MoE lm arch: the experts' batched products run
    over every slot of the capacity (``E * C`` rows, here 4x the tokens),
    whether a slot holds a token or not."""
    from repro_torch.models.moe import capacity

    stats, losses = D.main(["--arch", "deepseek-moe-16b", "--steps", "4", "--batch", "8",
                            "--device", "cpu", "--metrics"])
    assert stats.steps == 4 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    flops = float(out.split("hlo/step: ")[1].split(" GFLOP")[0]) * 1e9
    cfg = get_arch("deepseek-moe-16b").smoke()
    m, d, t = cfg.moe, cfg.d_model, 8 * 64
    attn = 2 * d * 4 * cfg.n_heads * cfg.head_dim * t
    dense = attn + 3 * 2 * d * cfg.d_ff * t
    slots = m.n_experts * capacity(t, m)
    assert slots == 4 * t
    moe = attn + 2 * d * m.n_experts * t + 3 * 2 * slots * d * m.d_ff_expert + \
        3 * 2 * t * d * m.n_shared * m.d_ff_expert
    dense_flops = 3 * (cfg.first_k_dense * dense + cfg.n_moe_layers * moe + 2 * d * cfg.vocab * t)
    assert dense_flops < flops < 2 * dense_flops, (flops, dense_flops)


def test_mla_moe_cli_trains_with_falling_loss(capsys):
    """``python -m repro_torch.launch.train --arch deepseek-v2-236b``: MLA
    and MoE layers through the driver's lm branch, the loss falling."""
    stats, losses = D.main(["--arch", "deepseek-v2-236b", "--steps", "4", "--batch", "8",
                            "--device", "cpu"])
    assert stats.steps == 4 and losses[-1] < losses[0]
    assert "arch=deepseek-v2-236b steps=4" in capsys.readouterr().out
