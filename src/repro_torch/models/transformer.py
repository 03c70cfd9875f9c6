"""LM transformer family: dense GQA (yi, qwen) and MLA-MoE (DeepSeek).

A port of the JAX package's ``models/transformer.py`` for one device
(the JAX ``mesh=None`` path):

* layers stacked on axis 0 (``dense_layers: {name: (L, ...)}``) with the
  JAX ``(in, out)`` weight layout, so :func:`params_from_jax` carries the
  tree over name for name; each layer runs under ``torch.utils.checkpoint``
  (non-reentrant), so activations live only at layer boundaries, and
  ``remat_group = g > 1`` keeps only every g-th boundary (an outer
  checkpoint over g layers, each checkpointed inside it);
* flash attention (:mod:`repro_torch.models.attention`, O(S) memory), GQA
  or MLA (``attn="mla"``: K and V rebuilt from the latent for train and
  prefill, the compressed cache ``ckv``/``krope`` for decode);
* ``first_k_dense`` dense layers, then ``moe_layers`` whose FFN is
  :func:`repro_torch.models.moe.moe_ffn`; each layer's load-balance aux is
  carried out of its checkpoint beside the hidden state, so the aux's
  gradient reaches the routers;
* a chunked cross entropy: each chunk's logits are formed, reduced and,
  under grad, recomputed in the backward, so the (B, S, V) logits never
  exist at once;
* ``grad_accum`` microbatches, their gradients summed as ``g / a`` in
  ``accum_dtype`` before one optimizer step.

The sharding declarations of the dry run are here too: :func:`param_specs`
(2-D FSDP x TP, or pure ZeRO-DP with ``tp=None``) and :func:`cache_specs`,
trees of :class:`repro_torch.core.sharding.PartitionSpec` equal to the JAX
package's. The steps that would run under them on a mesh (the JAX ``mesh=``
path's activation constraints and the MoE ``shard_map``) are ROADMAP A
item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sharding import P
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models.common import fold_in, rms_norm, softmax_xent, swiglu
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_params_shape
from repro_torch.train.optimizer import flatten, unflatten

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_base: float = 10000.0
    attn: str = "gqa"                       # "gqa" | "mla"
    mla: Optional[A.MLAConfig] = None
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0                  # leading dense-FFN layers (DeepSeek)
    dtype: torch.dtype = torch.bfloat16
    grad_accum: int = 1                     # microbatch accumulation steps
    accum_dtype: torch.dtype = torch.float32  # grad-accumulator dtype
    remat_group: int = 1                    # checkpoint every g layers (g > 1 saves memory)
    q_block: int = 512
    kv_block: int = 512
    loss_chunk: int = 2048                  # seq chunk for CE

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.moe else 0

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers if self.moe is None else self.first_k_dense


# ----------------------------------------------------------------- params
def _attn_shapes(c: LMConfig) -> Dict[str, Tuple[int, ...]]:
    if c.attn == "mla":
        assert c.mla is not None
        return A.mla_params_shape(c.mla)
    return A.gqa_params_shape(c.d_model, c.n_heads, c.n_kv, c.head_dim, qkv_bias=c.qkv_bias)


def _dense_layer_shapes(c: LMConfig) -> Dict[str, Tuple[int, ...]]:
    shapes = {f"attn_{k}": v for k, v in _attn_shapes(c).items()}
    shapes.update({
        "ffn_w1": (c.d_model, c.d_ff),
        "ffn_w3": (c.d_model, c.d_ff),
        "ffn_w2": (c.d_ff, c.d_model),
        "norm1": (c.d_model,),
        "norm2": (c.d_model,),
    })
    return shapes


def _moe_layer_shapes(c: LMConfig) -> Dict[str, Tuple[int, ...]]:
    assert c.moe is not None
    shapes = {f"attn_{k}": v for k, v in _attn_shapes(c).items()}
    shapes.update({f"moe_{k}": v for k, v in moe_params_shape(c.d_model, c.moe).items()})
    shapes.update({"norm1": (c.d_model,), "norm2": (c.d_model,)})
    return shapes


def param_shapes(c: LMConfig) -> Dict[str, Any]:
    """Full parameter tree as name -> shape (layers stacked on axis 0)."""
    tree: Dict[str, Any] = {
        "embed": (c.vocab, c.d_model),
        "final_norm": (c.d_model,),
        "lm_head": (c.d_model, c.vocab),
    }
    if c.n_dense_layers:
        tree["dense_layers"] = {k: (c.n_dense_layers,) + v
                                for k, v in _dense_layer_shapes(c).items()}
    if c.n_moe_layers:
        tree["moe_layers"] = {k: (c.n_moe_layers,) + v for k, v in _moe_layer_shapes(c).items()}
    return tree


def param_count(c: LMConfig) -> int:
    return int(sum(np.prod(s) for s in flatten(param_shapes(c)).values()))


def abstract_params(c: LMConfig) -> Params:
    """The tree as ``meta`` tensors of ``c.dtype`` (no memory)."""
    return unflatten({k: torch.empty(s, dtype=c.dtype, device="meta")
                      for k, s in flatten(param_shapes(c)).items()})


def init_params(c: LMConfig, generator: torch.Generator) -> Params:
    """Params on ``generator``'s device: normal(0, 1) in float32 cast to
    ``c.dtype`` times 0.02, the norms at 1. Leaf ``i`` of the JAX tree order
    (sorted dotted names) draws from a generator of its own, seeded from
    ``generator``'s seed and ``i``, as the JAX version splits one key per
    leaf. The bits are not JAX's; tests carry JAX's params over with
    :func:`params_from_jax`. The scale is applied in place: an
    out-of-place product would be carved from the freed float32 draw's
    cached block and pin half of it (9.3 GiB for each of deepseek-moe-16b's
    expert stacks), where the card's decode cache needs the room."""
    dev = generator.device
    seed = generator.initial_seed()
    flat = {}
    for i, (name, shape) in enumerate(sorted(flatten(param_shapes(c)).items())):
        if "norm" in name.rsplit(".", 1)[-1]:
            flat[name] = torch.ones(shape, dtype=c.dtype, device=dev)
            continue
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, i))
        flat[name] = torch.randn(shape, generator=gen, dtype=torch.float32,
                                 device=dev).to(c.dtype).mul_(0.02)
    return unflatten(flat)


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor of its own (a copy) with ``a``'s bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":                  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: Mapping[str, Any], device) -> Params:
    """Carry a JAX LM parameter tree (arrays or numpy; nested, or flat with
    dotted names) over to ``device``, name for name and bit for bit."""
    flat = flatten(np_params)
    return unflatten({k: _tensor_from_numpy(v).to(device) for k, v in flat.items()})


# ------------------------------------------------------------- param specs
def param_specs(c: LMConfig, *, dp: Tuple[str, ...] = ("data",),
                tp: Optional[str] = "model") -> Dict[str, Any]:
    """PartitionSpec tree (2-D FSDP x TP for big weights).

    ``tp=None`` selects pure ZeRO-DP: every matrix of at least 2**16
    elements row-sharded over ALL mesh axes (the caller passes them
    flattened as ``dp``), no tensor parallelism — the mapping for dense
    models whose layer weights fit one chip.
    """
    if tp is None:
        def spec_for(name: str, shape: Tuple[int, ...], stacked: bool) -> P:
            lead = (None,) if stacked else ()
            base = shape[1:] if stacked else shape
            if len(base) >= 2 and int(np.prod(base)) >= 1 << 16:
                return P(*lead, dp, *(None,) * (len(base) - 1))
            return P(*lead, *(None,) * len(base))
    else:
        def spec_for(name: str, shape: Tuple[int, ...], stacked: bool) -> P:
            lead = (None,) if stacked else ()
            base = shape[1:] if stacked else shape
            if name == "embed":
                return P(tp, None)      # vocab-sharded only (no all-gather at the lookup)
            if name == "lm_head":
                return P(None, tp)
            if name == "final_norm":
                return P(None)
            if "norm" in name:
                return P(*lead, None)
            if name.startswith("attn_b"):
                return P(*lead, tp)
            if name.startswith("attn_w") or name.startswith("ffn_"):
                if len(base) == 2:
                    # (d_in, d_out): FSDP on in, TP on out — except down-projections
                    if name == "attn_wo" or name.endswith("_w2"):
                        return P(*lead, tp, "data")
                    return P(*lead, "data", tp)
                return P(*lead, *(None,) * len(base))
            if name.startswith("moe_"):
                sub = name[len("moe_"):]
                ff = "data" if (c.moe and c.moe.shard_ff_over_data) else None
                if sub == "router":
                    return P(*lead, None, None)
                if sub in ("w1", "w3"):
                    return P(*lead, tp, None, ff)
                if sub == "w2":
                    return P(*lead, tp, ff, None)
                if sub in ("sw1", "sw3"):
                    return P(*lead, "data", tp)
                if sub == "sw2":
                    return P(*lead, tp, "data")
            raise ValueError(f"no spec rule for {name}: {shape}")

    out: Dict[str, Any] = {}
    for name, v in param_shapes(c).items():
        if isinstance(v, dict):
            out[name] = {k: spec_for(k, s, True) for k, s in v.items()}
        else:
            out[name] = spec_for(name, v, False)
    return out


def cache_specs(c: LMConfig, *, dp: Tuple[str, ...] = ("data",), tp: str = "model"
                ) -> Dict[str, P]:
    """PartitionSpecs of :func:`make_cache`'s tree: batch over ``dp``; MLA's
    latent over ``tp``, GQA's head_dim over ``tp`` (n_kv may not divide
    the tp axis)."""
    if c.attn == "mla":
        return {"ckv": P(None, dp, None, tp), "krope": P(None, dp, None, None)}
    return {"k": P(None, dp, None, None, tp), "v": P(None, dp, None, None, tp)}


# ------------------------------------------------------------------ blocks
def _attn_params(lp: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("attn_"):]: v for k, v in lp.items() if k.startswith("attn_")}


def _attn_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig) -> torch.Tensor:
    if c.attn == "mla":
        return A.mla_attention(_attn_params(lp), x, c.mla, q_block=c.q_block,
                               kv_block=c.kv_block)
    return A.gqa_attention(_attn_params(lp), x, n_heads=c.n_heads, n_kv=c.n_kv,
                           head_dim=c.head_dim, rope_base=c.rope_base,
                           q_block=c.q_block, kv_block=c.kv_block)


def _ffn_tail(lp: Mapping[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return h + swiglu(rms_norm(h, lp["norm2"]), lp["ffn_w1"], lp["ffn_w3"], lp["ffn_w2"])


def _moe_tail(lp: Mapping[str, torch.Tensor], h: torch.Tensor, c: LMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    hn = rms_norm(h, lp["norm2"])
    moe_p = {k[len("moe_"):]: v for k, v in lp.items() if k.startswith("moe_")}
    out2d, aux = moe_ffn(moe_p, hn.reshape(-1, hn.shape[-1]), c.moe)
    return h + out2d.reshape(hn.shape), aux


def _dense_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + _attn_block(lp, rms_norm(x, lp["norm1"]), c)
    return _ffn_tail(lp, h), torch.zeros((), dtype=torch.float32, device=x.device)


def _moe_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + _attn_block(lp, rms_norm(x, lp["norm1"]), c)
    return _moe_tail(lp, h, c)


# ----------------------------------------------------------------- forward
def _layers(stacked: Mapping[str, torch.Tensor]
            ) -> Tuple[List[str], List[Tuple[torch.Tensor, ...]]]:
    """Per-layer views of the stacked params: one ``unbind`` per leaf, so
    autograd stacks the per-layer gradients once, not a full-size zero
    tensor per layer as per-layer indexing would."""
    names = sorted(stacked)
    per_leaf = [stacked[k].unbind(0) for k in names]
    return names, list(zip(*per_leaf))


def _scan_blocks(x: torch.Tensor, aux_total: torch.Tensor, stacked: Mapping[str, torch.Tensor],
                 block_fn, c: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers of one stack in order, each under a checkpoint when grad
    is on (``c.remat_group = g > 1``: an outer checkpoint over g layers,
    each checkpointed inside it). Every checkpointed function returns
    ``(x, aux)``; the aux is summed from zero per group, then onto
    ``aux_total``, in JAX's order."""
    names, layers = _layers(stacked)
    n = len(layers)
    remat = torch.is_grad_enabled()

    def one_layer(x, *lp):
        return block_fn(dict(zip(names, lp)), x, c)

    def run(fn, x, *args):
        return checkpoint(fn, x, *args, use_reentrant=False) if remat else fn(x, *args)

    g = max(1, min(c.remat_group, n))
    if n % g:
        g = 1
    if g == 1:
        for lp in layers:
            x, a = run(one_layer, x, *lp)
            aux_total = aux_total + a
        return x, aux_total
    k = len(names)

    def group_fn(x, *flat):
        # nested remat: the outer checkpoint keeps only group boundaries,
        # the inner one bounds the recompute working set to one layer
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(g):
            x, a = run(one_layer, x, *flat[i * k:(i + 1) * k])
            aux = aux + a
        return x, aux

    for gi in range(n // g):
        x, a = run(group_fn, x, *[t for lp in layers[gi * g:(gi + 1) * g] for t in lp])
        aux_total = aux_total + a
    return x, aux_total


def hidden_states(params: Params, tokens: torch.Tensor, c: LMConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed + all layers (the dense ones, then the MoE ones) + the final
    norm; returns (hidden (B, S, D), the layers' summed aux loss). Under
    grad each layer is checkpointed (``c.remat_group``)."""
    x = params["embed"][tokens.to(torch.int64)].to(c.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if c.n_dense_layers:
        x, aux = _scan_blocks(x, aux, params["dense_layers"], _dense_block, c)
    if c.n_moe_layers:
        x, aux = _scan_blocks(x, aux, params["moe_layers"], _moe_block, c)
    return rms_norm(x, params["final_norm"]), aux


def _chunk_ce_sum(hx: torch.Tensor, lx: torch.Tensor, vx: torch.Tensor,
                  lm_head: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(hx, lm_head.to(hx.dtype))
    return (softmax_xent(logits, lx) * vx[None, :]).sum()


def lm_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor, c: LMConfig, *,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean CE over tokens with seq-chunked logits (never (B, S, V) at once:
    under grad each chunk's logits are recomputed in the backward)."""
    h, aux = hidden_states(params, tokens, c)
    b, s, d = h.shape
    chunk = min(c.loss_chunk, s)
    n_chunks = (s + chunk - 1) // chunk
    s_pad = n_chunks * chunk
    if s_pad != s:
        h = F.pad(h, (0, 0, 0, s_pad - s))
        labels = F.pad(labels, (0, s_pad - s))
    valid = (torch.arange(s_pad, device=h.device) < s).to(torch.float32)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], labels[:, sl], valid[sl], params["lm_head"])
        ce = (checkpoint(_chunk_ce_sum, *args, use_reentrant=False) if remat
              else _chunk_ce_sum(*args))
        total = total + ce
    return total / (b * s) + aux_weight * aux


# -------------------------------------------------------------- train step
def make_train_step(c: LMConfig, optimizer):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and optimizer state are updated in place and
    returned (the port's form of buffer donation). ``optimizer`` follows
    :mod:`repro_torch.train.optimizer` (``optimizer.init(params)`` builds
    the state). With ``c.grad_accum = a > 1`` the batch is split into ``a``
    microbatches and their gradients are summed as ``g / a`` in
    ``c.accum_dtype`` (``(acc + g / a)``, both in float32, then cast)
    before one optimizer step; the loss is the mean of theirs."""

    def value_and_grad(leaves, names, tokens, labels):
        with torch.enable_grad():
            loss = lm_loss(unflatten(leaves), tokens, labels, c)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), grads

    def train_step(params: Params, opt_state: Any, batch: Mapping[str, torch.Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        flat = flatten(params)
        names = sorted(flat)
        leaves = {k: flat[k].detach().requires_grad_(True) for k in names}
        if c.grad_accum > 1:
            b, a = tokens.shape[0], c.grad_accum
            assert b % a == 0, (b, a)
            tok = tokens.reshape(a, b // a, -1)
            lab = labels.reshape(a, b // a, -1)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = [torch.zeros(flat[k].shape, dtype=c.accum_dtype, device=flat[k].device)
                     for k in names]
            for i in range(a):
                l_i, g_i = value_and_grad(leaves, names, tok[i], lab[i])
                with torch.no_grad():
                    for acc, g in zip(grads, g_i):
                        acc.copy_(acc.to(torch.float32) + g.to(torch.float32) / a)
                del g_i
                loss = loss + l_i / a
        else:
            loss, grads = value_and_grad(leaves, names, tokens, labels)
        del leaves
        params, opt_state = optimizer.update(params, unflatten(dict(zip(names, grads))),
                                             opt_state)
        return params, opt_state, {"loss": loss}

    return train_step


# ------------------------------------------------------------ serve (decode)
def make_cache(c: LMConfig, batch: int, max_len: int, *, abstract: bool = False,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """KV cache, zeros of ``c.dtype`` on ``device`` (the card unless the CPU
    is asked for), or ``meta`` tensors with ``abstract``. GQA: ``{"k", "v":
    (L, B, max_len, Hk, Dh)}``; MLA: the latent ``ckv (L, B, max_len,
    kv_lora_rank)`` and the shared rope key ``krope (L, B, max_len,
    qk_rope_dim)``."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    if c.attn == "mla":
        m = c.mla
        shapes = {"ckv": (c.n_layers, batch, max_len, m.kv_lora_rank),
                  "krope": (c.n_layers, batch, max_len, m.qk_rope_dim)}
    else:
        shape = (c.n_layers, batch, max_len, c.n_kv, c.head_dim)
        shapes = {"k": shape, "v": shape}
    return {k: torch.zeros(s, dtype=c.dtype, device=dev) for k, s in shapes.items()}


@torch.no_grad()
def serve_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_len: A.CacheLen, c: LMConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token (B, 1) int -> (logits (B, V), cache). Each
    layer writes the token's key and value (MLA: its latent and rope key)
    into ``cache`` at ``cache_len`` (in place; the cache is returned). The
    dense layers use cache layers ``[0, n_dense)``, the MoE layers
    ``[n_dense, L)``; an MoE layer routes the B tokens of the step as one
    call of ``moe_ffn``."""
    x = params["embed"][token.to(torch.int64)].to(c.dtype)
    stacks = [("dense_layers", 0)] if c.n_dense_layers else []
    if c.n_moe_layers:
        stacks.append(("moe_layers", c.n_dense_layers))
    for group, first in stacks:
        names, layers = _layers(params[group])
        for j, lp_t in enumerate(layers):
            i = first + j
            lp = dict(zip(names, lp_t))
            xn = rms_norm(x, lp["norm1"])
            if c.attn == "mla":
                out, _ = A.mla_decode_step(_attn_params(lp), xn, cache["ckv"][i],
                                           cache["krope"][i], cache_len, c.mla)
            else:
                out, _ = A.gqa_decode_step(_attn_params(lp), xn, cache["k"][i], cache["v"][i],
                                           cache_len, n_heads=c.n_heads, n_kv=c.n_kv,
                                           head_dim=c.head_dim, rope_base=c.rope_base)
            x = _ffn_tail(lp, x + out) if "ffn_w1" in lp else _moe_tail(lp, x + out, c)[0]
    x = rms_norm(x, params["final_norm"])
    logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    return logits[:, 0], cache


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, c: LMConfig) -> torch.Tensor:
    """Prefill: the full forward; returns the last position's logits (B, V)."""
    h, _ = hidden_states(params, tokens, c)
    last = h[:, -1]
    return torch.matmul(last, params["lm_head"].to(last.dtype))
