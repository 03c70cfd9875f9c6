"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, on the CPU, JAX under ``jax.jit`` (the
form its callers run).

* The dispatch plan (``order``, ``sorted_e``, ``pos``, ``keep``,
  ``token``) bit for bit, dtypes included: random routes, a capacity of 1
  and every pair routed to one expert; ``capacity`` and the dropped-pair
  count equal JAX's formula and keep mask.
* ``_route`` from the same fp32 inputs: ``top_e`` equal, ``top_p`` and the
  aux within rtol 1e-6 (XLA's CPU code takes ``probs.mean(0)`` as a sum
  times 1/T and fuses the softmax; random inputs have no near tie, so no
  expert flips).
* ``moe_ffn`` with and without drops, with and without shared experts:
  the output within 1e-6 of its largest |value| (the expert GEMMs of
  Eigen and of torch sum in other orders; the combine adds each token's k
  rows in JAX's order), the aux within rtol 1e-6; in bfloat16 within two
  bf16 ulps of the largest |value| (bf16 products and the bf16 combine
  round after fp32 sums in other orders). ``moe_ffn_ref`` within 1e-6, and
  ``moe_ffn`` equal to it where nothing drops.
* The gradients of every MoE leaf and of ``x`` against ``jax.grad`` of
  ``sum(out * cotangent) + 0.01 * aux``: each within 1e-5 of its largest
  |value|.
* The combine: each token's k rows added in ascending sorted position from
  zero, bit for bit a numpy loop in that order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402

from repro_torch.models import moe as M  # noqa: E402


def _cfgs(**kw):
    base = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=2, capacity_factor=8.0)
    base.update(kw)
    return M.MoEConfig(**base), JM.MoEConfig(**base)


def _params(c, d, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 0.1).astype(np.float32)
            for k, s in M.moe_params_shape(d, c).items()}


def _x(t, d, seed=1):
    return (np.random.default_rng(seed).normal(size=(t, d)) * 0.5).astype(np.float32)


def _dropped(x, router, c):
    """The ``(token, k)`` pairs the capacity drops in a call over ``x``."""
    top_e = M._route(x, router, c)[0]
    return int((~M._dispatch_indices(top_e, c, M.capacity(x.shape[0], c))[3]).sum())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_config_and_param_shapes_match_jax():
    for kw in ({}, {"n_shared": 0}, {"shard_ff_over_data": True}):
        c, jc = _cfgs(**kw)
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert M.moe_params_shape(32, c) == JM.moe_params_shape(32, jc)
    assert [f.name for f in dataclasses.fields(M.MoEConfig)] == \
        [f.name for f in dataclasses.fields(JM.MoEConfig)]


# (T, K, E, capacity, routes): random, capacity 1, every pair on one expert
DISPATCH_CASES = {
    "random": (32, 2, 4, 64, "random"),
    "random_drops": (40, 3, 8, 9, "random"),
    "capacity_1": (16, 2, 8, 1, "random"),
    "all_to_one": (16, 1, 2, 8, "one"),
    "all_to_one_k2": (12, 2, 4, 3, "one_two"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_plan_is_jaxs_bit_for_bit(case):
    t, k, e, cap, routes = DISPATCH_CASES[case]
    c, jc = _cfgs(n_experts=e, top_k=k)
    rng = np.random.default_rng(7)
    if routes == "random":      # distinct experts per token, as top_k gives
        top_e = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    elif routes == "one":
        top_e = np.zeros((t, k), np.int32)
    else:                       # every token's first pick on expert 1, its second on 3
        top_e = np.tile(np.asarray([[1, 3]], np.int32), (t, 1))
    got = M._dispatch_indices(torch.from_numpy(top_e), c, cap)
    want = JM._dispatch_indices(jnp.asarray(top_e), jc, cap)
    for name, g, w in zip(("order", "sorted_e", "pos", "keep", "token"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if routes != "random":
        assert int((~got[3]).sum()) == t * k - cap * len(np.unique(top_e))


@pytest.mark.parametrize("t", [1, 4, 7, 96, 32768])
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 64 / 6])
def test_capacity_is_jaxs_formula(t, cf):
    c, _ = _cfgs(n_experts=64, top_k=6, capacity_factor=cf)
    assert M.capacity(t, c) == max(int(np.ceil(t * 6 / 64 * cf)), 1)
    assert M.capacity(t, dataclasses.replace(c, capacity_factor=64 / 6)) >= t


def test_route_matches_jax():
    c, jc = _cfgs(n_experts=8, top_k=3)
    x, router = _x(64, 16), _params(c, 16)["router"]
    te, tp, aux = M._route(torch.from_numpy(x), torch.from_numpy(router), c)
    je, jp, jaux = jax.jit(lambda x, r: JM._route(x, r, jc))(jnp.asarray(x), jnp.asarray(router))
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# (n_shared, capacity_factor): no drops at 8.0, drops at 1.0 and 0.5
FFN_CASES = [(2, 8.0), (0, 8.0), (2, 1.0), (0, 0.5), (1, 1.25)]


def _jax_moe(jc, p, x):
    return jax.jit(lambda p, x: JM.moe_ffn(p, x, jc))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))


@pytest.mark.parametrize("n_shared,cf", FFN_CASES)
def test_moe_ffn_matches_jax(n_shared, cf):
    c, jc = _cfgs(n_shared=n_shared, capacity_factor=cf)
    d, t = 32, 96
    p, x = _params(c, d), _x(t, d)
    out, aux = M.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), c)
    jout, jaux = _jax_moe(jc, p, x)
    assert _rel(out.numpy(), jout) <= 1e-6
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    dropped = _dropped(torch.from_numpy(x), torch.from_numpy(p["router"]), c)
    je, _, _ = JM._route(jnp.asarray(x), jnp.asarray(p["router"]), jc)
    keep = np.asarray(JM._dispatch_indices(je, jc, M.capacity(t, c))[3])
    assert dropped == int((~keep).sum())
    if cf <= 1.0:
        assert dropped > 0
    if cf >= 8.0:
        assert dropped == 0


def test_moe_ffn_in_bfloat16_matches_jax():
    """The model's dtype: bf16 tokens and weights, routing in fp32, the
    combine's products and sums in bf16 as in JAX."""
    c, jc = _cfgs(capacity_factor=1.25)
    p, x = _params(c, 32), _x(96, 32)
    out, _ = M.moe_ffn({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()},
                       torch.from_numpy(x).to(torch.bfloat16), c)
    jout, _ = jax.jit(lambda p, x: JM.moe_ffn(p, x, jc))(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x).astype(jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), np.asarray(jout.astype(jnp.float32))) <= 2 * 2.0 ** -8


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_ffn_ref_matches_jax_and_moe_ffn_without_drops(n_shared):
    c, jc = _cfgs(n_shared=n_shared)
    p, x = _params(c, 32), _x(96, 32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ref = M.moe_ffn_ref(tp, torch.from_numpy(x), c)
    jref = jax.jit(lambda p, x: JM.moe_ffn_ref(p, x, jc))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert _rel(ref.numpy(), jref) <= 1e-6
    out, _ = M.moe_ffn(tp, torch.from_numpy(x), c)
    assert _dropped(torch.from_numpy(x), tp["router"], c) == 0
    assert _rel(out.numpy(), ref.numpy()) <= 1e-6


@pytest.mark.parametrize("n_shared,cf", [(2, 8.0), (1, 1.0)])
def test_moe_grads_match_jax(n_shared, cf):
    c, jc = _cfgs(n_experts=4, top_k=2, d_ff_expert=8, n_shared=n_shared, capacity_factor=cf)
    d, t = 16, 64
    p, x = _params(c, d), _x(t, d)
    cot = np.random.default_rng(3).normal(size=(t, d)).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_ffn(p, x, jc)
        return jnp.sum(out * cot) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_ffn(leaves, tx, c)
    (torch.sum(out * torch.from_numpy(cot)) + 0.01 * aux).backward()
    assert sorted(leaves) == sorted(jg)
    for k in jg:
        assert _rel(leaves[k].grad.numpy(), jg[k]) <= 1e-5, k
    assert _rel(tx.grad.numpy(), jgx) <= 1e-5


def test_combine_adds_in_sorted_order_from_zero():
    rng = np.random.default_rng(11)
    t, k, d = 9, 3, 5
    top_e = np.stack([rng.permutation(6)[:k] for _ in range(t)]).astype(np.int32)
    c, _ = _cfgs(n_experts=6, top_k=k)
    order = M._dispatch_indices(torch.from_numpy(top_e), c, 100)[0]
    contrib = (rng.normal(size=(t * k, d)) * 10.0 ** rng.integers(-3, 4, (t * k, 1))
               ).astype(np.float32)
    got = M._combine(torch.from_numpy(contrib), order, t, k).numpy()
    want = np.zeros((t, d), np.float32)
    for j, flat in enumerate(order.numpy()):          # sorted position j holds pair `flat`
        want[flat // k] = want[flat // k] + contrib[j]
    np.testing.assert_array_equal(got, want)
