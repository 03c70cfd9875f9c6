"""Attention: GQA + MLA (DeepSeek-V2), RoPE, chunked flash, KV-cache decode.

A port of the JAX package's ``models/attention.py``. Prefill at 32k never
materializes an (S, S) score matrix: :func:`flash_attention` walks the KV
blocks with a running max and denominator (online softmax), and its
backward recomputes the scores blockwise from the saved ``(q, k, v, out,
lse)``, so memory is O(S) in both directions. Decode reads the cache once
per token and writes the new token's key and value into it in place.

MLA (Multi-head Latent Attention, DeepSeek-V2 [arXiv:2405.04434]) stores only
the compressed latent ``c_kv`` (kv_lora_rank) and a shared rope key per
token; the decode path scores against the latent directly by weight
absorption.

The attention math is plain PyTorch (matmuls and elementwise ops; no
library attention): the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import dense

NEG_INF = -1e30
CacheLen = Union[int, torch.Tensor]
HeadOut = Callable[[torch.Tensor], torch.Tensor]


def _out_proj(p: Dict[str, torch.Tensor], heads: torch.Tensor,
              head_out: Optional[HeadOut]) -> torch.Tensor:
    return dense(heads, p["wo"]) if head_out is None else head_out(heads)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, *, base: float = 10000.0) -> np.ndarray:
    return (1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
            ).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0
               ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh); positions: int (..., S) or (S,)."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(dh, base=base)).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                          # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- chunked flash attention
#
# Layout: q as (B, Hk, S*G, Dh) in float32 (the G query heads of a KV head
# interleaved under each position), k and v as (B, Hk, S, D). One KV block
# step scores every q row that keeps it at once, one GEMM of (R*G, Dh) x
# (Dh, kv_block) per (batch, KV head), where the JAX package maps over the q
# blocks: the arithmetic per element is the same (each query row's running
# max, denominator and accumulator, and its dQ, see the KV blocks in order;
# a KV block's dK and dV are one product per q block, added in q-block
# order), only the sums inside a GEMM run in another order. Under ``causal`` the rows of the
# q blocks before the block that first keeps a KV block are not computed
# (the JAX ``keep``); a KV block straddling the diagonal masks its rows with
# ``NEG_INF``, as do the padded KV positions.

def _first_row(j: int, kv_block: int, q_block: int, causal: bool) -> int:
    """First q row of the first q block that keeps KV block ``j``: JAX's
    ``keep = j*kv_block <= qi*q_block + q_block - 1``."""
    return (j * kv_block // q_block) * q_block if causal else 0


def _mask_block(scores: torch.Tensor, r0: int, g: int, kv_lo: int, causal: bool,
                s_orig: int) -> None:
    """NEG_INF where a q row (from row ``r0``) may not see a KV position
    of the block at ``kv_lo``: after it (causal) or past ``s_orig``."""
    kvb = scores.shape[-1]
    if kv_lo + kvb > s_orig:
        scores[..., max(s_orig - kv_lo, 0):] = NEG_INF
    if causal:
        r1 = min(kv_lo + kvb - 1, r0 + scores.shape[-2] // g)   # rows below see the block
        if r1 > r0:
            dev = scores.device
            qpos = torch.arange(r0, r1, device=dev).repeat_interleave(g)
            kpos = torch.arange(kv_lo, kv_lo + kvb, device=dev)
            scores[..., :(r1 - r0) * g, :].masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)


def _to_rows(x: torch.Tensor, hk: int) -> torch.Tensor:
    """(B, S, H, D) -> float32 (B, Hk, S*G, D)."""
    b, s, h, d = x.shape
    return (x.reshape(b, s, hk, h // hk, d).permute(0, 2, 1, 3, 4)
            .reshape(b, hk, s * (h // hk), d).to(torch.float32))


def _from_rows(x: torch.Tensor, s: int, dtype) -> torch.Tensor:
    """float32 (B, Hk, S*G, D) -> (B, S, H, D) in ``dtype``."""
    b, hk, sg, d = x.shape
    g = sg // s
    return x.reshape(b, hk, s, g, d).permute(0, 2, 1, 3, 4).reshape(b, s, hk * g, d).to(dtype)


def _flash_fwd_padded(q, k, v, causal, q_block, kv_block, s_orig):
    """Forward on padded tensors. q: (B, Sq, H, Dh); k: (B, Skv, Hk, Dh);
    v: (B, Skv, Hk, Dv). Returns out (B, Sq, H, Dv) in q's dtype and the
    per-query lse, float32 (B, Hk, G, Sq) as the JAX package's."""
    b, s_pad, h, dh = q.shape
    skv_pad, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hk
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    qf = _to_rows(q, hk)
    kf = k.permute(0, 2, 1, 3).to(torch.float32)
    vf = v.permute(0, 2, 1, 3).to(torch.float32)
    m = torch.full((b, hk, s_pad * g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, s_pad * g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, s_pad * g, dv), dtype=torch.float32, device=q.device)
    for j in range(skv_pad // kv_block):
        kv_lo = j * kv_block
        r0 = _first_row(j, kv_block, q_block, causal)
        rows = slice(r0 * g, s_pad * g)
        kb, vb = kf[:, :, kv_lo:kv_lo + kv_block], vf[:, :, kv_lo:kv_lo + kv_block]
        scores = torch.matmul(qf[:, :, rows], kb.transpose(-1, -2)).mul_(scale)
        _mask_block(scores, r0, g, kv_lo, causal, s_orig)
        m_old = m[:, :, rows]
        m_new = torch.maximum(m_old, scores.amax(dim=-1))
        p = scores.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m_old - m_new)
        l_rows = l[:, :, rows]
        l_rows.copy_(l_rows * corr + p.sum(dim=-1))
        acc_rows = acc[:, :, rows]
        acc_rows.copy_(acc_rows * corr[..., None] + torch.matmul(p, vb))
        m_old.copy_(m_new)
        del scores, p
    lc = torch.clamp(l, min=1e-30)
    out = _from_rows(acc / lc[..., None], s_pad, q.dtype)
    lse = (m + torch.log(lc)).reshape(b, hk, s_pad, g).permute(0, 1, 3, 2)
    return out, lse


def _sum_q_blocks(a: torch.Tensor, x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """``a^T x`` over the rows, summed as the JAX backward sums a KV
    block's dK and dV: one product per q block (``block_rows`` rows), the
    products added in q-block order."""
    b, hk, r, n = a.shape
    nq = r // block_rows
    part = torch.matmul(a.view(b, hk, nq, block_rows, n).transpose(-1, -2),
                        x.view(b, hk, nq, block_rows, x.shape[-1]))   # (B, Hk, nq, n, D)
    out = part[:, :, 0]
    for i in range(1, nq):
        out = out + part[:, :, i]
    return out


def _flash_bwd_padded(q, k, v, out, lse, dout, causal, q_block, kv_block, s_orig):
    """Blockwise-recompute backward (FlashAttention-style): the scores of
    each kept (q rows, KV block) pair are recomputed from ``q``, ``k`` and
    ``lse``; no (S, S) tensor is formed."""
    b, s_pad, h, dh = q.shape
    skv_pad, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hk
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    qf = _to_rows(q, hk)
    kf = k.permute(0, 2, 1, 3).to(torch.float32)
    vf = v.permute(0, 2, 1, 3).to(torch.float32)
    do = _to_rows(dout, hk)
    delta = torch.sum(do * _to_rows(out, hk), dim=-1)             # rowsum(do*o)
    lse_r = lse.permute(0, 1, 3, 2).reshape(b, hk, s_pad * g)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hk, skv_pad, dh), dtype=torch.float32, device=q.device)
    dvf = torch.zeros((b, hk, skv_pad, dv), dtype=torch.float32, device=q.device)
    for j in range(skv_pad // kv_block):
        kv_lo = j * kv_block
        kvs = slice(kv_lo, kv_lo + kv_block)
        r0 = _first_row(j, kv_block, q_block, causal)
        rows = slice(r0 * g, s_pad * g)
        qs, dos = qf[:, :, rows], do[:, :, rows]
        kb, vb = kf[:, :, kvs], vf[:, :, kvs]
        scores = torch.matmul(qs, kb.transpose(-1, -2)).mul_(scale)
        _mask_block(scores, r0, g, kv_lo, causal, s_orig)
        p = scores.sub_(lse_r[:, :, rows, None]).exp_()           # normalized probs
        dvf[:, :, kvs] = _sum_q_blocks(p, dos, q_block * g)
        dp = torch.matmul(dos, vb.transpose(-1, -2))
        ds = p.mul_(dp.sub_(delta[:, :, rows, None])).mul_(scale)
        del dp
        dq[:, :, rows] += torch.matmul(ds, kb)
        dk[:, :, kvs] = _sum_q_blocks(ds, qs, q_block * g)
        del ds, p
    return (_from_rows(dq, s_pad, q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dvf.permute(0, 2, 1, 3).to(v.dtype))


class FlashCore(torch.autograd.Function):
    """Flash attention on padded tensors: forward by online softmax, backward
    by blockwise recompute from the saved ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block, s_orig):
        out, lse = _flash_fwd_padded(q, k, v, causal, q_block, kv_block, s_orig)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block, s_orig)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_padded(q, k, v, out, lse, dout.contiguous(), *ctx.blocks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512, kv_block: int = 512
                    ) -> torch.Tensor:
    """Online-softmax attention with GQA head grouping, O(S) memory in S in
    both directions. q: (B, S, H, Dh); k: (B, S, Hk, Dh); v: (B, S, Hk, Dv);
    returns (B, S, H, Dv). S is padded up to whole q and KV blocks."""
    b, s, h, dh = q.shape
    assert h % k.shape[2] == 0, (h, k.shape[2])
    s_pad = (s + q_block - 1) // q_block * q_block
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    skv_pad = (s + kv_block - 1) // kv_block * kv_block
    if skv_pad != s:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_pad - s))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_pad - s))
    out = FlashCore.apply(q, k, v, causal, q_block, kv_block, s)
    return out[:, :s]


def attention_ref(q, k, v, *, causal=True, compute_dtype=torch.float32):
    """Quadratic oracle for :func:`flash_attention` (tests and checks only),
    in ``compute_dtype`` (the JAX package's: float32)."""
    b, s, h, dh = q.shape
    hk, dv = k.shape[2], v.shape[-1]
    g = h // hk
    qr = q.reshape(b, s, hk, g, dh).to(compute_dtype)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.to(compute_dtype))
    if compute_dtype == torch.float32:   # XLA's reciprocal multiply for / sqrt(dh)
        scores = scores * float(np.float32(1.0) / np.float32(np.sqrt(dh)))
    else:
        scores = scores / np.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None, None], scores,
                             torch.tensor(NEG_INF, dtype=compute_dtype, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(compute_dtype))
    return out.reshape(b, s, h, dv).to(q.dtype if compute_dtype == torch.float32
                                       else compute_dtype)


# --------------------------------------------------------------- GQA block
def gqa_params_shape(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                     *, qkv_bias: bool) -> Dict[str, Tuple[int, ...]]:
    shapes = {
        "wq": (d_model, n_heads * head_dim),
        "wk": (d_model, n_kv * head_dim),
        "wv": (d_model, n_kv * head_dim),
        "wo": (n_heads * head_dim, d_model),
    }
    if qkv_bias:
        shapes.update({
            "bq": (n_heads * head_dim,),
            "bk": (n_kv * head_dim,),
            "bv": (n_kv * head_dim,),
        })
    return shapes


def gqa_attention(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_heads: int, n_kv: int,
                  head_dim: int, positions: Optional[torch.Tensor] = None,
                  rope_base: float = 10000.0, causal: bool = True, q_block: int = 512,
                  kv_block: int = 512, head_out: Optional[HeadOut] = None) -> torch.Tensor:
    """GQA self-attention of x (B, S, D) with RoPE and flash attention.
    ``head_out`` (the heads' concatenated output -> the block's output)
    stands in for the product with ``p["wo"]`` (a model rank's slice of
    the heads, in the mesh form)."""
    b, s, _ = x.shape
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, n_heads, head_dim)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, s, n_kv, head_dim)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, s, n_kv, head_dim)
    q = apply_rope(q, pos, base=rope_base)
    k = apply_rope(k, pos, base=rope_base)
    out = flash_attention(q, k, v, causal=causal, q_block=q_block, kv_block=kv_block)
    return _out_proj(p, out.reshape(b, s, n_heads * head_dim), head_out)


def _cache_pos(cache_len: CacheLen, device) -> torch.Tensor:
    """``cache_len`` as a 0-d int64 tensor on ``device`` (no host read)."""
    return torch.as_tensor(cache_len, device=device).to(torch.int64).reshape(())


def _cache_index(cache_len: CacheLen, s_cache: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_cache_pos`, and the slot the new token goes to: ``cache_len``
    clamped into the cache, as ``dynamic_update_slice`` clamps its start."""
    cl = _cache_pos(cache_len, device)
    return cl, cl.clamp(0, s_cache - 1)[None]


def gqa_decode_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cache_len: CacheLen, *,
                   n_heads: int, n_kv: int, head_dim: int, rope_base: float = 10000.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode token's q (B, 1, H, Dh), k and v (B, 1, Hk, Dh) from x (B,
    1, D), RoPE at position ``cache_len`` on the whole head_dim (its
    rotate-half pairs ``i`` and ``i + Dh/2``)."""
    b = x.shape[0]
    pos = _cache_pos(cache_len, x.device)[None]                  # current position
    q = dense(x, p["wq"], p.get("bq")).reshape(b, 1, n_heads, head_dim)
    k_new = dense(x, p["wk"], p.get("bk")).reshape(b, 1, n_kv, head_dim)
    v_new = dense(x, p["wv"], p.get("bv")).reshape(b, 1, n_kv, head_dim)
    q = apply_rope(q, pos, base=rope_base)
    k_new = apply_rope(k_new, pos, base=rope_base)
    return q, k_new, v_new


def gqa_decode_scores(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, cache_len: CacheLen, *,
                      m: int = 0, n: int = 1) -> torch.Tensor:
    """Slice ``m`` of ``n`` of the head_dim (``cache_specs``' split over the
    model axis): writes the token's k and v slices (of every KV head) into
    the cache block (B, S_cache, Hk, Dh/n) at ``cache_len``, in place, and
    returns ``q[..., slice] . k_block^T``, float32 (B, Hk, G, S_cache),
    unscaled: the ``n`` slices' parts sum to the scores. ``n = 1`` is the
    whole cache."""
    b, _, h, dh = q.shape
    hk, ds = k_new.shape[2], dh // n
    s_cache = cache_k.shape[1]
    _, slot = _cache_index(cache_len, s_cache, q.device)
    lo = m * ds
    cache_k.index_copy_(1, slot, k_new[..., lo:lo + ds].to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new[..., lo:lo + ds].to(cache_v.dtype))
    qr = q[..., lo:lo + ds].reshape(b, hk, h // hk, ds).to(torch.float32)
    kt = cache_k.to(torch.float32).permute(0, 2, 3, 1)            # (B, Hk, Dh/n, S)
    return torch.matmul(qr, kt)


def gqa_decode_values(scores: torch.Tensor, cache_v: torch.Tensor, cache_len: CacheLen,
                      head_dim: int) -> torch.Tensor:
    """The summed scores (B, Hk, G, S_cache) scaled, masked past
    ``cache_len`` and softmaxed, against the value block (B, S_cache, Hk,
    Dh/n): the heads' context in the block's slice, float32 (B, Hk, G,
    Dh/n)."""
    s_cache = cache_v.shape[1]
    scores = scores / np.sqrt(head_dim)
    valid = torch.arange(s_cache, device=scores.device) <= _cache_pos(cache_len, scores.device)
    scores = scores.masked_fill(~valid, NEG_INF)
    pa = torch.softmax(scores, dim=-1)
    return torch.matmul(pa, k_v_cast(cache_v).permute(0, 2, 1, 3))


def gqa_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, cache_len: CacheLen, *, n_heads: int, n_kv: int,
                    head_dim: int, rope_base: float = 10000.0, head_out: Optional[HeadOut] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step of x (B, 1, D) against a fixed-size cache (B, S_cache,
    Hk, Dh): writes the token's key and value at ``cache_len`` (in place)
    and attends over positions ``<= cache_len``. Returns (out, (k, v)), the
    caches themselves. The three stages above with the whole head_dim; the
    LM's model-parallel decode runs them on its ``cache_specs`` block."""
    b = x.shape[0]
    q, k_new, v_new = gqa_decode_qkv(p, x, cache_len, n_heads=n_heads, n_kv=n_kv,
                                     head_dim=head_dim, rope_base=rope_base)
    scores = gqa_decode_scores(q, k_new, v_new, cache_k, cache_v, cache_len)
    ctx = gqa_decode_values(scores, cache_v, cache_len, head_dim)  # (B, Hk, G, Dh)
    out = _out_proj(p, ctx.reshape(b, 1, n_heads * head_dim).to(x.dtype), head_out)
    return out, (cache_k, cache_v)


def k_v_cast(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


# --------------------------------------------------------------- MLA block
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


def mla_params_shape(c: MLAConfig) -> Dict[str, Tuple[int, ...]]:
    h = c.n_heads
    return {
        "wdq": (c.d_model, c.q_lora_rank),
        "wuq": (c.q_lora_rank, h * (c.qk_nope_dim + c.qk_rope_dim)),
        "wdkv": (c.d_model, c.kv_lora_rank),
        "wkrope": (c.d_model, c.qk_rope_dim),
        "wuk": (c.kv_lora_rank, h * c.qk_nope_dim),
        "wuv": (c.kv_lora_rank, h * c.v_head_dim),
        "wo": (h * c.v_head_dim, c.d_model),
    }


def mla_attention(p: Dict[str, torch.Tensor], x: torch.Tensor, c: MLAConfig, *,
                  positions: Optional[torch.Tensor] = None, causal: bool = True,
                  q_block: int = 512, kv_block: int = 512,
                  head_out: Optional[HeadOut] = None) -> torch.Tensor:
    """Train/prefill MLA: per-head K/V rebuilt from the latent, flash attention."""
    b, s, _ = x.shape
    h = c.n_heads
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    q = dense(dense(x, p["wdq"]), p["wuq"]).reshape(b, s, h, c.qk_nope_dim + c.qk_rope_dim)
    q_nope, q_rope = q[..., :c.qk_nope_dim], q[..., c.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos)
    c_kv = dense(x, p["wdkv"])                                    # (B, S, R)
    k_rope = apply_rope(dense(x, p["wkrope"])[:, :, None, :], pos)  # (B, S, 1, rope)
    k_nope = dense(c_kv, p["wuk"]).reshape(b, s, h, c.qk_nope_dim)
    v = dense(c_kv, p["wuv"]).reshape(b, s, h, c.v_head_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, c.qk_rope_dim)], dim=-1)
    out = flash_attention(qf, kf, v, causal=causal, q_block=q_block, kv_block=kv_block)
    return _out_proj(p, out.reshape(b, s, h * c.v_head_dim), head_out)


def mla_decode_q(p: Dict[str, torch.Tensor], x: torch.Tensor, cache_len: CacheLen,
                 c: MLAConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode token's ``q_nope`` (B, H, nope), ``q_rope`` (B, H, rope)
    with RoPE, latent (B, R) and rope key (B, rope), from x (B, 1, D)."""
    b = x.shape[0]
    pos = _cache_pos(cache_len, x.device)[None]
    q = dense(dense(x, p["wdq"]), p["wuq"]).reshape(b, c.n_heads, c.qk_nope_dim + c.qk_rope_dim)
    q_nope, q_rope = q[..., :c.qk_nope_dim], q[..., c.qk_nope_dim:]
    q_rope = apply_rope(q_rope[:, None], pos, base=10000.0)[:, 0]
    ckv_new = dense(x, p["wdkv"])[:, 0]                           # (B, R)
    krope_new = apply_rope(dense(x, p["wkrope"])[:, :, None, :], pos)[:, 0, 0]  # (B, rope)
    return q_nope, q_rope, ckv_new, krope_new


def mla_decode_scores(q_nope: torch.Tensor, ckv_new: torch.Tensor, krope_new: torch.Tensor,
                      wuk: torch.Tensor, cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
                      cache_len: CacheLen, c: MLAConfig, *, m: int = 0, n: int = 1
                      ) -> torch.Tensor:
    """Slice ``m`` of ``n`` of the latent (``cache_specs``' split over the
    model axis): writes the token's latent slice into the block (B,
    S_cache, R/n) and its rope key whole into ``cache_krope``, in place,
    and returns the absorbed query's slice ``q_nope . W_uk[slice]`` against
    the block, float32 (B, H, S_cache): the ``n`` parts sum to the latent
    scores. ``wuk`` is the whole (R, H * nope) weight; ``q_nope`` every
    head's."""
    h = q_nope.shape[1]
    r = c.kv_lora_rank // n
    s_cache = cache_ckv.shape[1]
    _, slot = _cache_index(cache_len, s_cache, q_nope.device)
    cache_ckv.index_copy_(1, slot, ckv_new[:, None, m * r:(m + 1) * r].to(cache_ckv.dtype))
    cache_krope.index_copy_(1, slot, krope_new[:, None].to(cache_krope.dtype))
    wuk = wuk.reshape(c.kv_lora_rank, h, c.qk_nope_dim)[m * r:(m + 1) * r]
    q_c = torch.einsum("bhd,rhd->bhr", q_nope.to(torch.float32), wuk.to(torch.float32))
    return torch.einsum("bhr,bsr->bhs", q_c, cache_ckv.to(torch.float32))


def mla_decode_values(scores: torch.Tensor, q_rope: torch.Tensor, wuv: torch.Tensor,
                      cache_ckv: torch.Tensor, cache_krope: torch.Tensor, cache_len: CacheLen,
                      c: MLAConfig, *, m: int = 0, n: int = 1) -> torch.Tensor:
    """The summed latent scores plus the rope scores (added once), scaled,
    masked past ``cache_len`` and softmaxed; the latent context of the
    block's slice ``m`` of ``n`` through ``W_uv[slice]`` (``wuv`` whole):
    float32 (B, H, v_head_dim), whose ``n`` parts sum to the heads'
    context."""
    h = q_rope.shape[1]
    r = c.kv_lora_rank // n
    s_cache = cache_ckv.shape[1]
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope.to(torch.float32),
                                   cache_krope.to(torch.float32))
    scores = scores / np.sqrt(c.qk_nope_dim + c.qk_rope_dim)
    valid = torch.arange(s_cache, device=scores.device) <= _cache_pos(cache_len, scores.device)
    scores = scores.masked_fill(~valid, NEG_INF)
    pa = torch.softmax(scores, dim=-1)
    ctx_c = torch.einsum("bhs,bsr->bhr", pa, cache_ckv.to(torch.float32))  # latent ctx
    wuv = wuv.reshape(c.kv_lora_rank, h, c.v_head_dim)[m * r:(m + 1) * r]
    return torch.einsum("bhr,rhd->bhd", ctx_c, wuv.to(torch.float32))


def mla_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor, cache_ckv: torch.Tensor,
                    cache_krope: torch.Tensor, cache_len: CacheLen, c: MLAConfig, *,
                    head_out: Optional[HeadOut] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Decode against the compressed cache (B, S_cache, R) and (B, S_cache,
    rope) by weight absorption: score = q_nope^T W_uk c + q_rope^T k_rope,
    ctx = softmax . c, v = ctx W_uv. Writes the token's latent and rope key
    at ``cache_len`` in place; returns (out, (ckv, krope)). The three
    stages above with the whole latent; the LM's model-parallel decode runs
    them on its ``cache_specs`` block."""
    b = x.shape[0]
    q_nope, q_rope, ckv_new, krope_new = mla_decode_q(p, x, cache_len, c)
    scores = mla_decode_scores(q_nope, ckv_new, krope_new, p["wuk"], cache_ckv, cache_krope,
                               cache_len, c)
    ctx = mla_decode_values(scores, q_rope, p["wuv"], cache_ckv, cache_krope, cache_len, c)
    out = _out_proj(p, ctx.reshape(b, 1, c.n_heads * c.v_head_dim).to(x.dtype), head_out)
    return out, (cache_ckv, cache_krope)
