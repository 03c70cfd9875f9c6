"""The port's attention (``repro_torch.models.attention``) against the JAX
package's, on the CPU, from the same numpy inputs.

* ``flash_attention``, forward and its gradients (JAX's through
  ``jax.vjp`` of the custom VJP), over the JAX package's own grid
  (``tests/test_attention.py``) and padded multi-block shapes (S not a
  multiple of either block, q and KV blocks of different sizes): within
  1e-5 of the largest |value| of each output (fp32 sums in another order:
  the port scores all the q rows of one KV block in one GEMM; it reads
  1.3e-6 at most).
* Against ``attention_ref`` in float64: within 2e-6 (forward) and 1e-5
  (gradients) of the largest |value|.
* The backward is the recompute form: the saved tensors are ``(q, k, v,
  out, lse)`` of the JAX residuals' shapes, nothing of (S, S); the causal
  skip is counted: the matrix products of one forward and backward are
  exactly those of the kept (q rows, KV block) pairs. Dropping the skip
  leaves the outputs equal (a skipped block's probabilities are exactly 0),
  so that count is the test that catches it.
* RoPE bit for bit in its frequencies, within 2 ulp of the largest |x| in
  its rotation (XLA's CPU ``cos``/``sin`` may differ from torch's by an ulp,
  ROADMAP C5); the GQA and MLA blocks and their decode steps within
  rtol/atol 1e-5, the decode steps' caches too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models.common import dense as jax_dense  # noqa: E402

from repro_torch.models import attention as A  # noqa: E402

GRID = [  # tests/test_attention.py:25-30 (q_block 64, kv_block 32), then padded multi-block
    (2, 128, 8, 2, 32, True, 64, 32),
    (1, 300, 4, 4, 16, False, 64, 32),
    (2, 64, 8, 1, 32, True, 64, 32),
    (1, 96, 6, 3, 8, True, 64, 32),
    (1, 100, 4, 2, 16, True, 16, 32),
    (1, 100, 4, 2, 16, True, 32, 16),
    (2, 70, 8, 8, 16, False, 16, 16),
]


def _qkv(b, s, h, hk, dh, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    dv = dv or dh
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, hk, dh)).astype(np.float32),
            rng.normal(size=(b, s, hk, dv)).astype(np.float32),
            rng.normal(size=(b, s, h, dv)).astype(np.float32))


def _port_vjp(q, k, v, do, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


def _close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("b,s,h,hk,dh,causal,qb,kb", GRID)
def test_flash_forward_and_grads_match_jax(b, s, h, hk, dh, causal, qb, kb):
    q, k, v, do = _qkv(b, s, h, hk, dh)
    kw = dict(causal=causal, q_block=qb, kv_block=kb)
    out, vjp = jax.vjp(lambda q, k, v: JA.flash_attention(q, k, v, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out, *vjp(jnp.asarray(do))]
    for got, w in zip(_port_vjp(q, k, v, do, **kw), want):
        assert got.shape == w.shape and got.dtype == np.float32
        _close(got, w, 1e-5)


@pytest.mark.parametrize("b,s,h,hk,dh,causal,qb,kb", GRID + [(2, 64, 4, 4, 12, True, 16, 16)])
def test_flash_matches_the_float64_reference(b, s, h, hk, dh, causal, qb, kb):
    dv = 8 if dh == 12 else dh           # the MLA regime: value head dim != qk head dim
    q, k, v, do = _qkv(b, s, h, hk, dh, dv, seed=1)
    got = _port_vjp(q, k, v, do, causal=causal, q_block=qb, kv_block=kb)
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v))
    ref = A.attention_ref(tq, tk, tv, causal=causal, compute_dtype=torch.float64)
    ref.backward(torch.from_numpy(do).double())
    assert ref.dtype == torch.float64
    _close(got[0], ref.detach().numpy(), 2e-6)
    for g, r in zip(got[1:], (tq.grad, tk.grad, tv.grad)):
        _close(g, r.numpy(), 1e-5)


def test_attention_ref_matches_jax():
    q, k, v, _ = _qkv(2, 40, 8, 2, 16)
    for causal in (True, False):
        got = A.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
        want = JA.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_flash_backward_saves_q_k_v_out_lse_only():
    b, s, h, hk, dh, qb, kb = 1, 100, 4, 2, 16, 32, 16
    q, k, v, _ = _qkv(b, s, h, hk, dh)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=True, q_block=qb, kv_block=kb)
    node = out.grad_fn
    while not isinstance(node, torch.autograd.function.BackwardCFunction):
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    s_pad = 128
    _, res = JA._flash_core_fwd(jnp.pad(jnp.asarray(q), ((0, 0), (0, s_pad - s), (0, 0), (0, 0))),
                                jnp.pad(jnp.asarray(k), ((0, 0), (0, 112 - s), (0, 0), (0, 0))),
                                jnp.pad(jnp.asarray(v), ((0, 0), (0, 112 - s), (0, 0), (0, 0))),
                                True, qb, kb, s)
    assert [tuple(t.shape) for t in saved] == [tuple(r.shape) for r in res]
    assert [tuple(t.shape) for t in saved] == [(1, 128, 4, 16), (1, 112, 2, 16), (1, 112, 2, 16),
                                               (1, 128, 4, 16), (1, 2, 2, 128)]
    assert saved[4].dtype == torch.float32


def _kept_pairs_flops(b, s, h, hk, dh, qb, kb, causal):
    """Matrix-product FLOPs of one forward and backward over the kept
    (q rows, KV block) pairs: forward QK^T and PV, backward QK^T, dV, dP,
    dQ and dK, each 2 * (rows * G) * kv_block * head dim per (batch, KV head)."""
    g = h // hk
    s_pad = -(-s // qb) * qb
    fwd = bwd = 0
    for j in range(-(-s // kb)):
        rows = s_pad - ((j * kb // qb) * qb if causal else 0)
        fwd += 2 * b * hk * rows * g * kb * (dh + dh)
        bwd += 2 * b * hk * rows * g * kb * (5 * dh)
    return fwd + bwd


@pytest.mark.parametrize("causal", [True, False])
def test_flash_computes_only_the_kept_blocks(causal):
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, hk, dh, qb, kb = 1, 128, 4, 2, 16, 16, 16
    q, k, v, do = _qkv(b, s, h, hk, dh)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with FlopCounterMode(display=False) as counter:
        A.flash_attention(tq, tk, tv, causal=causal, q_block=qb, kv_block=kb).backward(
            torch.from_numpy(do))
    assert counter.get_total_flops() == _kept_pairs_flops(b, s, h, hk, dh, qb, kb, causal)
    full = _kept_pairs_flops(b, s, h, hk, dh, qb, kb, False)
    assert (counter.get_total_flops() < 0.6 * full) == causal


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    for dh, base in ((16, 10000.0), (128, 5_000_000.0)):
        assert np.array_equal(A.rope_freqs(dh, base=base), JA.rope_freqs(dh, base=base))
        x = rng.normal(size=(2, 33, 3, dh)).astype(np.float32)
        pos = np.arange(33, dtype=np.int32) + 1000
        got = A.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base=base).numpy()
        want = np.asarray(JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), base=base))
        assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(np.abs(x).max()))
    # RoPE scores depend only on relative position (tests/test_attention.py's property)
    x = torch.from_numpy(rng.normal(size=(1, 2, 1, 16)).astype(np.float32))
    s1 = A.apply_rope(x, torch.tensor([0, 3]))
    s2 = A.apply_rope(x, torch.tensor([7, 10]))
    assert abs(float((s1[0, 0, 0] * s1[0, 1, 0]).sum() - (s2[0, 0, 0] * s2[0, 1, 0]).sum())) < 1e-4


def _gqa_params(d, h, hk, dh, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 0.05).astype(np.float32)
            for k, s in A.gqa_params_shape(d, h, hk, dh, qkv_bias=True).items()}


def test_gqa_attention_and_decode_match_jax():
    d, h, hk, dh, b, s = 64, 4, 2, 16, 2, 12
    assert A.gqa_params_shape(d, h, hk, dh, qkv_bias=True) == JA.gqa_params_shape(
        d, h, hk, dh, qkv_bias=True)
    p = _gqa_params(d, h, hk, dh, 0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = (np.random.default_rng(1).normal(size=(b, s + 1, d)) * 0.5).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hk, head_dim=dh)
    full = A.gqa_attention(tp, torch.from_numpy(x), q_block=4, kv_block=4, **kw)
    jfull = JA.gqa_attention(jp, jnp.asarray(x), q_block=4, kv_block=4, **kw)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=1e-5, atol=1e-6)
    # a decode step against a cache filled by the prefix, JAX's and the port's
    rng = np.random.default_rng(2)
    ck = rng.normal(size=(b, s + 4, hk, dh)).astype(np.float32)
    cv = rng.normal(size=(b, s + 4, hk, dh)).astype(np.float32)
    for cache_len in (s, 0, s + 3, s + 9):     # s + 9 lies past the cache: the write clamps
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        out, (nk, nv) = A.gqa_decode_step(tp, torch.from_numpy(x[:, s:s + 1]), tk, tv,
                                          cache_len, **kw)
        jout, (jk, jv) = JA.gqa_decode_step(jp, jnp.asarray(x[:, s:s + 1]), jnp.asarray(ck),
                                            jnp.asarray(cv), jnp.int32(cache_len), **kw)
        assert nk is tk and nv is tv                      # written in place
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(nk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(nv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    # decode == prefill (tests/test_attention.py's property, on the port)
    pos = torch.arange(s)
    kk = A.apply_rope((torch.from_numpy(x[:, :s]) @ tp["wk"] + tp["bk"]).reshape(b, s, hk, dh), pos)
    vv = (torch.from_numpy(x[:, :s]) @ tp["wv"] + tp["bv"]).reshape(b, s, hk, dh)
    ck0, cv0 = torch.zeros(b, s + 4, hk, dh), torch.zeros(b, s + 4, hk, dh)
    ck0[:, :s], cv0[:, :s] = kk, vv
    out, _ = A.gqa_decode_step(tp, torch.from_numpy(x[:, s:s + 1]), ck0, cv0,
                               torch.tensor(s), **kw)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, s].numpy(), rtol=2e-4, atol=2e-4)


def test_mla_attention_and_decode_match_jax():
    c = A.MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
    jc = JA.MLAConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__})
    assert A.mla_params_shape(c) == JA.mla_params_shape(jc)
    rng = np.random.default_rng(4)
    p = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in A.mla_params_shape(c).items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    b, s = 2, 10
    x = (rng.normal(size=(b, s + 1, 64)) * 0.5).astype(np.float32)
    full = A.mla_attention(tp, torch.from_numpy(x), c, q_block=4, kv_block=4)
    jfull = JA.mla_attention(jp, jnp.asarray(x), jc, q_block=4, kv_block=4)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=1e-5, atol=1e-6)
    ckv = np.asarray(jax_dense(jnp.asarray(x[:, :s]), jp["wdkv"]))
    krope = np.asarray(JA.apply_rope(jax_dense(jnp.asarray(x[:, :s]), jp["wkrope"])[:, :, None, :],
                                     jnp.arange(s))[:, :, 0])
    cc = np.zeros((b, s + 4, c.kv_lora_rank), np.float32)
    ck = np.zeros((b, s + 4, c.qk_rope_dim), np.float32)
    cc[:, :s], ck[:, :s] = ckv, krope
    tc, tk = torch.from_numpy(cc.copy()), torch.from_numpy(ck.copy())
    out, (nc, nk) = A.mla_decode_step(tp, torch.from_numpy(x[:, s:s + 1]), tc, tk, s, c)
    jout, (jc_, jk_) = JA.mla_decode_step(jp, jnp.asarray(x[:, s:s + 1]), jnp.asarray(cc),
                                          jnp.asarray(ck), jnp.int32(s), jc)
    assert nc is tc and nk is tk
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nc.numpy(), np.asarray(jc_), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(nk.numpy(), np.asarray(jk_), rtol=1e-6, atol=1e-7)
    # decode == prefill (JAX's bound for MLA, tests/test_attention.py)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, s].numpy(), rtol=2e-3, atol=2e-3)
