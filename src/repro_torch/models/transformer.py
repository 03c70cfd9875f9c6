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

The sharding declarations are here too: :func:`param_specs` (2-D FSDP x
TP, or pure ZeRO-DP with ``tp=None``) and :func:`cache_specs`, trees of
:class:`repro_torch.core.sharding.PartitionSpec` equal to the JAX
package's.

``mesh=`` (a ``('data', 'model')`` ``DeviceMesh`` of
:func:`repro_torch.launch.mesh.make_model_mesh`) runs the model-parallel
form those specs imply, SPMD: each rank holds its shards of the params
(:func:`repro_torch.launch.mesh.shard_params` under :func:`param_specs`)
and its rows of the batch (over ``dp``), and the collectives are the ones
JAX's constraints make XLA insert:

* FSDP gather at use (JAX's ``_make_weight_gather``/``_strip_axis``): each
  layer's weights are all-gathered over ``data`` inside the layer's
  checkpoint and their gradients reduce-scattered back; the routed experts
  stay sharded and go to ``moe_ffn(mesh=)``;
* TP over ``model`` as the specs split it: ``attn_w*``/``ffn_w1``/
  ``ffn_w3`` column-parallel, ``attn_wo``/``ffn_w2`` row-parallel with a
  ``psum``; the embedding a vocab-parallel lookup (a masked take, then a
  ``psum``), the LM head vocab-parallel logits whose chunked cross entropy
  all-reduces its max and its sum of exponentials over ``model``, so the
  (B, S, V) logits still never exist at once;
* attention heads over ``model`` where they split (JAX's
  ``_head_constraint``: :func:`head_split`), else every model rank computes
  every head and keeps its slice of them for ``wo``;
* the residual stream row-split over ``dp`` and replicated over
  ``model``. JAX's ``_make_constraint`` also lays its ``d`` over
  ``model``: a layout for XLA's partitioner with no eager form;
* the decode cache as :func:`cache_specs` lays it out, each rank holding
  its rows and its slice of GQA's head_dim or MLA's latent: the new
  token's q, k and v gathered over ``model``, the partial scores summed
  there before the softmax, the context's slices gathered (GQA) or summed
  (MLA) (:func:`_decode_attn_body`).

A replicated param's gradient is summed over the ``dp`` axes its spec does
not split (never over ``model``: the model ranks computed it alike), and
AdamW's clipping norm is the global one. The entry points ``make_train_step``,
``prefill`` and ``serve_step`` take the global batch, as JAX's do, and cut
each rank's rows; ``hidden_states`` and ``lm_loss`` are per rank.

Rows that do not split evenly over ``dp`` (``n`` rows over ``n_dp`` data
ranks) are split as GSPMD pads them (:func:`_dp_rows`):

* each data rank takes at most ``dp_block(n, n_dp) = ceil(n / n_dp)``
  consecutive rows, the last ranks fewer or none, and holds a block of
  that many rows, padded with zero rows (every rank runs the same shapes,
  so every rank takes part in every collective at equal sizes). Padding
  counts in no loss (the loss masks it and divides by the real token
  count), no gradient (its cotangent is zero) and no logit (the gathered
  logits drop it); a decode cache block (``make_cache(mesh=)``) has the
  padded block's rows, as JAX's;
* ``grad_accum`` microbatches are sliced before the split: microbatch j
  is rows ``[j b / a, (j + 1) b / a)``, JAX's reshape ``(a, b // a, s)``,
  and each is split over ``dp`` on its own;
* the MoE block splits tokens, not rows: JAX flattens the ``b * s`` tokens
  and ``shard_map`` gives data rank i the i-th contiguous block of
  ``b * s / n_dp`` of them, which can cut a row in two (the capacity then
  follows that block, ROADMAP C30, C33). The normed hidden state moves
  from the row layout to that token block and back with one
  :func:`repro_torch.launch.mesh.all_to_all` each way (padding rows send
  nothing and get zeros). Where ``b * s`` does not divide over ``n_dp``
  the MoE raises ``ValueError``, as JAX's ``shard_map`` does (a decode of
  an odd number of tokens over 2 data ranks).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sharding import P, entry_axes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import attention as A
from repro_torch.models.common import dense, fold_in, rms_norm, softmax_xent, swiglu
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


def cache_specs(c: LMConfig, *, dp: Tuple[str, ...] = ("data",), tp: Optional[str] = "model"
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


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """The attention heads model rank ``m`` of ``n`` computes: with
    ``split``, ``n_q`` query heads (the rank's slice of them) over the
    ``n_kv`` KV heads from ``kv_lo``; else every head (``n_q`` = all)."""
    split: bool
    n_q: int
    kv_lo: int
    n_kv: int
    m: int = 0
    n: int = 1


def head_split(c: LMConfig, m: int = 0, n: int = 1) -> HeadSplit:
    """JAX's ``_head_constraint``: heads over ``model`` when ``n`` divides
    them (for GQA also where a KV head is whole on each rank: ``n`` divides
    ``n_kv`` or ``n_kv`` divides ``n``), else replicated on every rank."""
    h = c.mla.n_heads if c.attn == "mla" else c.n_heads
    hk = h if c.attn == "mla" else c.n_kv
    if h % n == 0 and (hk % n == 0 or n % hk == 0):
        hl, g = h // n, h // hk
        return HeadSplit(True, hl, m * hl // g, max(hl // g, 1), m, n)
    return HeadSplit(False, h, 0, hk, m, n)


def model_gathered(c: LMConfig, hs: HeadSplit, decode: bool = False) -> frozenset:
    """The attention weights a model rank needs whole, not as its TP shard:
    MLA's latent down-projections; the KV projections where a rank's KV
    heads are not its shard; every projection where heads do not split.
    ``decode``: MLA's ``wuk`` and ``wuv`` too, whose rows of the rank's
    latent slice the split decode contracts for every head."""
    if c.attn == "mla":
        full = {"attn_wdq", "attn_wdkv", "attn_wkrope"}
        if decode or not hs.split:
            full |= {"attn_wuk", "attn_wuv"}
        if not hs.split:
            full |= {"attn_wuq"}
        return frozenset(full)
    if not hs.split:
        return frozenset({"attn_wq", "attn_wk", "attn_wv", "attn_bq", "attn_bk", "attn_bv"})
    if c.n_kv % hs.n:
        return frozenset({"attn_wk", "attn_wv", "attn_bk", "attn_bv"})
    return frozenset()


def _rank_attn(lp: Mapping[str, torch.Tensor], c: LMConfig, hs: HeadSplit):
    """(params, keyword args) of the attention functions for the rank's
    heads; ``lp`` holds the rank's TP shards, and whole the weights of
    :func:`model_gathered`."""
    p = _attn_params(lp)
    kw: Dict[str, Any] = {}
    if not hs.split and hs.n > 1:
        wo = p["wo"]
        rows = wo.shape[0]
        kw["head_out"] = lambda o: dense(o.narrow(-1, hs.m * rows, rows), wo)
    if c.attn == "mla":
        kw["c"] = dataclasses.replace(c.mla, n_heads=hs.n_q) if hs.split else c.mla
        return p, kw
    if hs.split and c.n_kv % hs.n:
        for k in ("wk", "wv", "bk", "bv"):
            if k in p:
                p[k] = p[k].narrow(-1, hs.kv_lo * c.head_dim, hs.n_kv * c.head_dim)
    kw.update(n_heads=hs.n_q, n_kv=hs.n_kv, head_dim=c.head_dim, rope_base=c.rope_base)
    return p, kw


def _attn_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig,
                hs: Optional[HeadSplit] = None) -> torch.Tensor:
    """Attention of x (B, S, D). With ``hs`` the rank body: its heads'
    part of the output (summed over the model ranks it is the block's)."""
    p, kw = _rank_attn(lp, c, hs or head_split(c))
    if c.attn == "mla":
        return A.mla_attention(p, x, kw.pop("c"), q_block=c.q_block, kv_block=c.kv_block, **kw)
    return A.gqa_attention(p, x, q_block=c.q_block, kv_block=c.kv_block, **kw)


def _ffn_tail(lp: Mapping[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return h + swiglu(rms_norm(h, lp["norm2"]), lp["ffn_w1"], lp["ffn_w3"], lp["ffn_w2"])


def _moe_tail(lp: Mapping[str, torch.Tensor], h: torch.Tensor, c: LMConfig, mp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    hn = rms_norm(h, lp["norm2"])
    moe_p = {k[len("moe_"):]: v for k, v in lp.items() if k.startswith("moe_")}
    x = hn.reshape(-1, hn.shape[-1])
    if mp is None:
        out2d, aux = moe_ffn(moe_p, x, c.moe)
        return h + out2d.reshape(hn.shape), aux
    if mp.rows is not None:         # the rows' layout -> JAX's token block, and back
        send, recv = _token_splits(mp, hn.shape[0], hn.shape[1])
        x = M.all_to_all(x[:sum(send)], mp.mesh, mp.dp, send, recv)
    out2d, aux = moe_ffn(moe_p, x, c.moe, mesh=mp.mesh, dp_axes=mp.dp, tp_axis=mp.tp)
    if mp.rows is not None:         # padding rows get no MoE output
        out2d = _pad_rows(M.all_to_all(out2d, mp.mesh, mp.dp, recv, send), len(hn) * hn.shape[1])
    return h + out2d.reshape(hn.shape), aux


def _dense_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + _attn_block(lp, rms_norm(x, lp["norm1"]), c)
    return _ffn_tail(lp, h), torch.zeros((), dtype=torch.float32, device=x.device)


def _moe_block(lp: Mapping[str, torch.Tensor], x: torch.Tensor, c: LMConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + _attn_block(lp, rms_norm(x, lp["norm1"]), c)
    return _moe_tail(lp, h, c)


# ------------------------------------------------------------ mesh form
@dataclasses.dataclass(frozen=True)
class _MeshCtx:
    """A mesh, its data axes ``dp`` and model axis ``tp`` (None: pure
    ZeRO-DP), the spec tree of :func:`param_specs` over them, and ``rows``:
    the call's global row count where it does not split evenly over ``dp``
    (each rank then holds its padded block of ``dp_block(rows, n_dp)``
    rows), else None."""
    mesh: Any
    dp: Tuple[str, ...]
    tp: Optional[str]
    specs: Dict[str, Any]
    rows: Optional[int] = None

    @property
    def n_dp(self) -> int:
        return M.axis_size(self.mesh, self.dp)

    def real_rows(self, block: int) -> int:
        """How many of this rank's ``block`` rows are real (not padding)."""
        if self.rows is None:
            return block
        return min(max(self.rows - M.axis_index(self.mesh, self.dp) * block, 0), block)

    @property
    def n_tp(self) -> int:
        return 1 if self.tp is None else M.axis_size(self.mesh, self.tp)

    @property
    def m(self) -> int:
        return 0 if self.tp is None else M.axis_index(self.mesh, self.tp)

    @property
    def strip(self) -> Tuple[str, ...]:
        """The axes a layer's weights are gathered over at use."""
        return ("data",) if self.tp is not None else self.dp

    def pvary(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else M.pvary(x, self.mesh, self.tp)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else M.psum(x, self.mesh, self.tp)

    def heads(self, c: LMConfig) -> HeadSplit:
        return head_split(c, self.m, self.n_tp)


def _mesh_ctx(c: LMConfig, mesh, dp, tp, rows: Optional[int] = None) -> _MeshCtx:
    dp = M.as_axes(dp)
    if tp is not None and tp in dp:
        raise ValueError(f"the model axis {tp!r} is one of the data axes {dp}")
    if rows is not None and rows % M.axis_size(mesh, dp) == 0:
        rows = None                                 # an even split: every row real
    return _MeshCtx(mesh, dp, tp, param_specs(c, dp=dp, tp=tp), rows)


def dp_block(n: int, n_dp: int) -> int:
    """The rows a data rank holds of ``n`` over ``n_dp`` ranks: ``ceil(n /
    n_dp)``, GSPMD's padded shard (the last ranks' blocks end in padding)."""
    return -(-n // n_dp)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _token_splits(mp: _MeshCtx, block: int, s: int) -> Tuple[List[int], List[int]]:
    """``(send, recv)`` of the MoE's layout change: the tokens this rank
    sends to each data rank and gets from each, from the rows' layout (rank
    k: rows ``[k block, min((k + 1) block, rows))`` of ``s`` tokens) to
    JAX's token block (rank j: tokens ``[j T / n_dp, (j + 1) T / n_dp)`` of
    ``T = rows * s``). ``ValueError`` where ``T`` does not divide over
    ``n_dp``, as JAX's ``shard_map``."""
    n, n_dp = mp.rows, mp.n_dp
    if n * s % n_dp:
        raise ValueError(f"the MoE's {n * s} tokens ({n} rows of {s}) are not evenly divisible "
                         f"over {n_dp} data ranks")
    per = n * s // n_dp

    def rows_of(k):
        return min(k * block, n) * s, min((k + 1) * block, n) * s

    def overlap(a, b):
        return max(min(a[1], b[1]) - max(a[0], b[0]), 0)

    i = M.axis_index(mp.mesh, mp.dp)
    mine, block_i = rows_of(i), (i * per, (i + 1) * per)
    return ([overlap(mine, (j * per, (j + 1) * per)) for j in range(n_dp)],
            [overlap(rows_of(k), block_i) for k in range(n_dp)])


def _gather_at_use(v: torch.Tensor, spec, mesh, axes) -> torch.Tensor:
    """``v`` all-gathered along each dimension whose spec entry lies in
    ``axes`` (autograd: the gradient is reduce-scattered back)."""
    for dim, e in enumerate(spec):
        ea = entry_axes(e)
        if ea and all(a in axes for a in ea):
            v = M.all_gather(v, mesh, ea, dim)
    return v


def _layer_gather(lp: Mapping[str, torch.Tensor], group: str, c: LMConfig, mp: _MeshCtx,
                  decode: bool = False) -> Dict[str, torch.Tensor]:
    """FSDP gather at use (JAX's ``_make_weight_gather``): the layer's
    weights over ``mp.strip``, those of :func:`model_gathered` (of the
    split decode with ``decode``) over the model axis too; the routed
    experts stay as they are (``moe_ffn`` gathers their hidden dim
    itself)."""
    specs = mp.specs[group]
    full = model_gathered(c, mp.heads(c), decode) if mp.tp is not None else frozenset()
    out = {}
    for k, v in lp.items():
        if k in ("moe_w1", "moe_w3", "moe_w2"):
            out[k] = v
            continue
        axes = mp.strip + ((mp.tp,) if k in full else ())
        out[k] = _gather_at_use(v, tuple(specs[k])[1:], mp.mesh, axes)
    return out


def _dense_block_mesh(lp, x, c: LMConfig, mp: _MeshCtx):
    hs = mp.heads(c)
    h = x + mp.psum(_attn_block(lp, mp.pvary(rms_norm(x, lp["norm1"])), c, hs))
    hn = mp.pvary(rms_norm(h, lp["norm2"]))
    out = h + mp.psum(swiglu(hn, lp["ffn_w1"], lp["ffn_w3"], lp["ffn_w2"]))
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def _moe_block_mesh(lp, x, c: LMConfig, mp: _MeshCtx):
    if mp.tp is None:
        raise ValueError("MoE layers require a tensor/expert-parallel axis")
    h = x + mp.psum(_attn_block(lp, mp.pvary(rms_norm(x, lp["norm1"])), c, mp.heads(c)))
    return _moe_tail(lp, h, c, mp)


def _top(params: Params, name: str, mp: _MeshCtx) -> torch.Tensor:
    """A top-level param (``embed``, ``lm_head``) gathered over the axes
    its layer weights would be (pure ZeRO-DP shards them over ``dp``)."""
    return _gather_at_use(params[name], tuple(mp.specs[name]), mp.mesh, mp.strip)


def _embed(params: Params, tokens: torch.Tensor, c: LMConfig, mp: Optional[_MeshCtx]
           ) -> torch.Tensor:
    if mp is None:
        return params["embed"][tokens.to(torch.int64)].to(c.dtype)
    table = _top(params, "embed", mp)
    if mp.tp is None:
        return table[tokens.to(torch.int64)].to(c.dtype)
    # vocab-parallel: a masked take of the rank's rows, summed over model
    rows = table.shape[0]
    t = tokens.to(torch.int64) - mp.m * rows
    ok = (t >= 0) & (t < rows)
    x = table[t.clamp(0, rows - 1)] * ok[..., None].to(table.dtype)
    return mp.psum(x).to(c.dtype)


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


def hidden_states(params: Params, tokens: torch.Tensor, c: LMConfig, *, mesh=None,
                  dp=("data",), tp: Optional[str] = "model", rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed + all layers (the dense ones, then the MoE ones) + the final
    norm; returns (hidden (B, S, D), the layers' summed aux loss). Under
    grad each layer is checkpointed (``c.remat_group``). With ``mesh``:
    ``tokens`` are this rank's rows, ``params`` its shards, and the hidden
    states its rows (the same on every model rank); ``rows``, the global
    row count where it does not split evenly over ``dp``: ``tokens`` is
    then the rank's padded block (:func:`dp_block` rows)."""
    mp = None if mesh is None else _mesh_ctx(c, mesh, dp, tp, rows)
    x = _embed(params, tokens, c, mp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, block, block_mesh, n in (("dense_layers", _dense_block, _dense_block_mesh,
                                         c.n_dense_layers),
                                        ("moe_layers", _moe_block, _moe_block_mesh,
                                         c.n_moe_layers)):
        if not n:
            continue
        if mp is not None:
            def block(lp, x, c, group=group, block_mesh=block_mesh):
                return block_mesh(_layer_gather(lp, group, c, mp), x, c, mp)
        x, aux = _scan_blocks(x, aux, params[group], block, c)
    return rms_norm(x, params["final_norm"]), aux


def _chunk_ce_sum(hx: torch.Tensor, lx: torch.Tensor, vx: torch.Tensor,
                  lm_head: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(hx, lm_head.to(hx.dtype))
    return (softmax_xent(logits, lx) * vx).sum()


def _chunk_ce_sum_tp(hx: torch.Tensor, lx: torch.Tensor, vx: torch.Tensor,
                     lm_head: torch.Tensor, mp: _MeshCtx) -> torch.Tensor:
    """:func:`_chunk_ce_sum` over vocab-parallel logits: the rank's columns
    of the LM head; the max and the sum of exponentials all-reduced over
    the model axis, the gold logit summed from the rank that holds it."""
    logits = torch.matmul(mp.pvary(hx), lm_head.to(hx.dtype)).to(torch.float32)
    cols = logits.shape[-1]
    m = M.pmax(torch.amax(logits, dim=-1, keepdim=True), mp.mesh, mp.tp)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(mp.psum(torch.sum(torch.exp(logits - m), dim=-1))) + m[..., 0]
    t = lx.to(torch.int64) - mp.m * cols
    ok = (t >= 0) & (t < cols)
    gold = torch.gather(logits, -1, t.clamp(0, cols - 1)[..., None])[..., 0]
    gold = mp.psum(torch.where(ok, gold, torch.zeros_like(gold)))
    return ((lse - gold) * vx).sum()


def lm_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor, c: LMConfig, *,
            mesh=None, dp=("data",), tp: Optional[str] = "model",
            aux_weight: float = 0.01, rows: Optional[int] = None) -> torch.Tensor:
    """Mean CE over tokens with seq-chunked logits (never (B, S, V) at once:
    under grad each chunk's logits are recomputed in the backward). With
    ``mesh``: the global loss from this rank's rows; each rank's backward
    gives its share of the gradient (see :func:`make_train_step`).
    ``rows`` as :func:`hidden_states`: the padding rows are masked out and
    the mean is over the real tokens."""
    mp = None if mesh is None else _mesh_ctx(c, mesh, dp, tp, rows)
    h, aux = hidden_states(params, tokens, c, mesh=mesh, dp=dp, tp=tp, rows=rows)
    b, s, d = h.shape
    chunk = min(c.loss_chunk, s)
    n_chunks = (s + chunk - 1) // chunk
    s_pad = n_chunks * chunk
    if s_pad != s:
        h = F.pad(h, (0, 0, 0, s_pad - s))
        labels = F.pad(labels, (0, s_pad - s))
    valid = (torch.arange(s_pad, device=h.device) < s).to(torch.float32)[None, :]
    if mp is not None and mp.real_rows(b) < b:        # the padding rows count nowhere
        valid = valid * (torch.arange(b, device=h.device) < mp.real_rows(b)).to(
            torch.float32)[:, None]
    remat = torch.is_grad_enabled()
    if mp is None:
        head, ce_fn = params["lm_head"], _chunk_ce_sum
    elif mp.tp is None:
        head, ce_fn = _top(params, "lm_head", mp), _chunk_ce_sum
    else:
        head = params["lm_head"]
        ce_fn = functools.partial(_chunk_ce_sum_tp, mp=mp)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], labels[:, sl], valid[:, sl], head)
        ce = checkpoint(ce_fn, *args, use_reentrant=False) if remat else ce_fn(*args)
        total = total + ce
    if mp is None:
        return total / (b * s) + aux_weight * aux
    n = b * mp.n_dp if mp.rows is None else mp.rows
    return M.psum(total, mesh, mp.dp) / (n * s) + aux_weight * aux


# -------------------------------------------------------------- train step
def _dp_rows(n: int, mesh, dp, parts: int = 1) -> List[slice]:
    """This rank's rows of each of ``parts`` consecutive microbatches of
    ``m = n / parts`` rows, split over ``dp`` as GSPMD splits a sharded
    batch: at most ``dp_block(m, n_dp)`` consecutive rows of each, the
    last ranks fewer or none (an empty slice)."""
    if n % parts:
        raise ValueError(f"batch of {n} rows does not split into {parts} microbatches")
    n_dp, i = M.axis_size(mesh, dp), M.axis_index(mesh, dp)
    m = n // parts
    block = dp_block(m, n_dp)
    lo, hi = min(i * block, m), min((i + 1) * block, m)
    return [slice(j * m + lo, j * m + hi) for j in range(parts)]


def global_sq_norm(sq: Mapping[str, torch.Tensor], specs: Mapping[str, Any], mesh
                   ) -> torch.Tensor:
    """The squared norm of the whole gradient from each leaf's local sum of
    squares: summed over the axes the leaf's spec splits, once for the
    axes it is replicated over."""
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for k, v in sq.items():
        axes = M.spec_axes(specs[k])
        by_axes[axes] = by_axes.get(axes, 0) + v
    total = torch.zeros((), dtype=torch.float32, device=next(iter(sq.values())).device)
    for axes in sorted(by_axes):
        part = by_axes[axes]
        if axes:
            order = [a for a in mesh.mesh_dim_names if a in axes]
            part = M.psum(part, mesh, tuple(order))
        total = total + part
    return total


def make_train_step(c: LMConfig, optimizer, *, mesh=None, dp=("data",),
                    tp: Optional[str] = "model"):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and optimizer state are updated in place and
    returned (the port's form of buffer donation). ``optimizer`` follows
    :mod:`repro_torch.train.optimizer` (``optimizer.init(params)`` builds
    the state). With ``c.grad_accum = a > 1`` the batch is split into ``a``
    microbatches and their gradients are summed as ``g / a`` in
    ``c.accum_dtype`` (``(acc + g / a)``, both in float32, then cast)
    before one optimizer step; the loss is the mean of theirs.

    With ``mesh``: ``params`` and ``opt_state`` are this rank's shards
    (:func:`repro_torch.launch.mesh.shard_params` under :func:`param_specs`;
    the state from ``optimizer.init`` of the shards), ``batch`` the global
    one; each microbatch's rows are split over ``dp`` as GSPMD splits them
    (:func:`_dp_rows`, padded to :func:`dp_block` rows where they do not
    split evenly). A leaf's gradient is summed over the ``dp`` axes its
    spec does not split after the microbatches, and the optimizer gets the
    global gradient norm (``sq_norm``)."""
    mp = None if mesh is None else _mesh_ctx(c, mesh, dp, tp)
    specs = None if mp is None else flatten(mp.specs)

    def value_and_grad(leaves, names, tokens, labels, rows):
        with torch.enable_grad():
            loss = lm_loss(unflatten(leaves), tokens, labels, c, mesh=mesh, dp=dp, tp=tp,
                           rows=rows)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), grads

    def train_step(params: Params, opt_state: Any, batch: Mapping[str, torch.Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        flat = flatten(params)
        names = sorted(flat)
        leaves = {k: flat[k].detach().requires_grad_(True) for k in names}
        a, b = c.grad_accum, tokens.shape[0]
        if mp is None:
            assert b % a == 0, (b, a)
            rows = [slice(i * (b // a), (i + 1) * (b // a)) for i in range(a)]
            block = b // a
        else:
            rows = _dp_rows(b, mesh, mp.dp, a)
            block = dp_block(b // a, mp.n_dp)

        def cut(x, r):
            return _pad_rows(x[r], block)

        if a > 1:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = [torch.zeros(flat[k].shape, dtype=c.accum_dtype, device=flat[k].device)
                     for k in names]
            for r in rows:
                l_i, g_i = value_and_grad(leaves, names, cut(tokens, r), cut(labels, r), b // a)
                with torch.no_grad():
                    for acc, g in zip(grads, g_i):
                        acc.copy_(acc.to(torch.float32) + g.to(torch.float32) / a)
                del g_i
                loss = loss + l_i / a
        else:
            loss, grads = value_and_grad(leaves, names, cut(tokens, rows[0]),
                                         cut(labels, rows[0]), b)
        del leaves
        kw = {}
        if mp is not None:
            grads = list(grads)
            for j, k in enumerate(names):
                axes = tuple(ax for ax in mp.dp if ax not in M.spec_axes(specs[k]))
                if axes:
                    grads[j] = M.psum(grads[j], mesh, axes)
            kw["sq_norm"] = lambda sq: global_sq_norm(sq, specs, mesh)
        params, opt_state = optimizer.update(params, unflatten(dict(zip(names, grads))),
                                             opt_state, **kw)
        return params, opt_state, {"loss": loss}

    return train_step


# ------------------------------------------------------------ serve (decode)
def make_cache(c: LMConfig, batch: int, max_len: int, *, abstract: bool = False,
               device: DeviceLike = None, mesh=None, dp=("data",), tp: Optional[str] = "model"
               ) -> Dict[str, torch.Tensor]:
    """KV cache, zeros of ``c.dtype`` on ``device`` (the card unless the CPU
    is asked for), or ``meta`` tensors with ``abstract``. GQA: ``{"k", "v":
    (L, B, max_len, Hk, Dh)}``; MLA: the latent ``ckv (L, B, max_len,
    kv_lora_rank)`` and the shared rope key ``krope (L, B, max_len,
    qk_rope_dim)``.

    With ``mesh``: this rank's block of that cache under
    :func:`cache_specs`, for ``serve_step(mesh=)``: its ``dp_block(B,
    |dp|)`` rows (JAX's padded block: where ``B`` does not split evenly the
    last ranks' blocks end in padding rows) and, over ``tp``, every KV
    head's slice of the head_dim (GQA) or its slice of the latent beside
    the whole rope key (MLA). ``tp=None`` (a ``puredp`` mesh) keeps
    ``'model'``: decode keeps the standard mapping, as JAX's decode cell
    does. A head_dim or latent that does not split over its ranks raises
    ``ValueError``."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    if c.attn == "mla":
        m = c.mla
        shapes = {"ckv": (c.n_layers, batch, max_len, m.kv_lora_rank),
                  "krope": (c.n_layers, batch, max_len, m.qk_rope_dim)}
    else:
        shape = (c.n_layers, batch, max_len, c.n_kv, c.head_dim)
        shapes = {"k": shape, "v": shape}
    if mesh is not None:
        mp = _mesh_ctx(c, mesh, dp, tp or "model")
        padded = dp_block(batch, mp.n_dp) * mp.n_dp
        specs = cache_specs(c, dp=mp.dp, tp=mp.tp)
        shapes = {k: M.shard_shape((s[0], padded) + s[2:], specs[k], mesh)
                  for k, s in shapes.items()}
    return {k: torch.zeros(s, dtype=c.dtype, device=dev) for k, s in shapes.items()}


def _decode_attn_body(lp: Mapping[str, torch.Tensor], xn: torch.Tensor,
                      cache: Mapping[str, torch.Tensor], i: int, cache_len: A.CacheLen,
                      c: LMConfig, hs: HeadSplit):
    """Model rank ``hs.m`` of ``hs.n``: its part of layer ``i``'s attention
    in a decode step, against its :func:`cache_specs` block of ``cache``.

    A generator that yields each collective over the model axis it needs,
    ``("gather", x, dim)`` (the ranks' ``x`` concatenated along ``dim`` in
    rank order) or ``("psum", x)``, is sent its result, and returns the
    rank's part of the block's output (the parts sum to it). So one body
    runs SPMD (:func:`_run_body`) and, on one device, in turn with the
    other ranks' (``tests/model_parallel_ranks.py``). ``lp`` is the rank's
    layer after the gather at use with ``decode=True``.

    The new token's q, k and v come from the rank's heads (every head where
    they do not split), RoPE on the whole head_dim, and are gathered to
    every head (small: one token) before the rank takes its slice: RoPE's
    pairs ``i`` and ``i + Dh/2`` lie on different ranks. GQA: the partial
    scores ``q[..., slice] . k_block^T`` are summed over the ranks before
    the scale, mask and softmax (a mask added on every rank would be summed
    ``n`` times); the context's slice ``p . v_block`` is gathered along the
    head_dim. MLA (JAX's absorbed form with the latent contraction split):
    the partial latent scores are summed, the rope scores added once, and
    ``ctx_c[..., slice] . W_uv[slice]`` summed. Then the rank's heads go
    through its ``wo`` shard (``head_out`` where heads do not split)."""
    p, kw = _rank_attn(lp, c, hs)
    if c.attn == "mla":
        q_nope, q_rope, ckv_new, krope_new = A.mla_decode_q(p, xn, cache_len, kw.pop("c"))
        if hs.split:
            q_nope = yield "gather", q_nope, 1
            q_rope = yield "gather", q_rope, 1
        ckv, krope = cache["ckv"][i], cache["krope"][i]
        scores = yield "psum", A.mla_decode_scores(q_nope, ckv_new, krope_new, p["wuk"], ckv,
                                                   krope, cache_len, c.mla, m=hs.m, n=hs.n)
        ctx = yield "psum", A.mla_decode_values(scores, q_rope, p["wuv"], ckv, krope, cache_len,
                                                c.mla, m=hs.m, n=hs.n)
        width = c.mla.v_head_dim
    else:
        q, k, v = A.gqa_decode_qkv(p, xn, cache_len, n_heads=kw["n_heads"], n_kv=kw["n_kv"],
                                   head_dim=c.head_dim, rope_base=c.rope_base)
        if hs.split:
            step = max(hs.n // c.n_kv, 1)        # ranks that share a KV head computed it alike
            q = yield "gather", q, 2
            k = (yield "gather", k, 2)[:, :, ::step]
            v = (yield "gather", v, 2)[:, :, ::step]
        ck, cv = cache["k"][i], cache["v"][i]
        scores = yield "psum", A.gqa_decode_scores(q, k, v, ck, cv, cache_len, m=hs.m, n=hs.n)
        ctx = yield "gather", A.gqa_decode_values(scores, cv, cache_len, c.head_dim), -1
        width = c.head_dim
    heads = ctx.reshape(xn.shape[0], 1, -1).to(xn.dtype)
    if hs.split:
        heads = heads.narrow(-1, hs.m * hs.n_q * width, hs.n_q * width)
    return kw["head_out"](heads) if "head_out" in kw else dense(heads, p["wo"])


def _run_body(body, mp: _MeshCtx):
    """A rank body's result, each collective it yields run over ``mp.tp``."""
    sent = None
    while True:
        try:
            op = body.send(sent)
        except StopIteration as done:
            return done.value
        sent = M.all_gather(op[1], mp.mesh, mp.tp, op[2]) if op[0] == "gather" else mp.psum(op[1])


def _decode_layer(lp: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cache: Mapping[str, torch.Tensor], i: int, cache_len: A.CacheLen,
                  c: LMConfig, mp: Optional[_MeshCtx] = None) -> torch.Tensor:
    """Layer ``i`` of a decode step of x (B, 1, D): attention against (and
    writing) layer ``i`` of ``cache``, then the FFN or the MoE. With ``mp``
    the rank's form: ``lp`` gathered at use, its attention body's part
    summed over the model axis, the FFN's row-parallel part too."""
    xn = rms_norm(x, lp["norm1"])
    if mp is None:
        p, kw = _rank_attn(lp, c, head_split(c))
        if c.attn == "mla":
            out, _ = A.mla_decode_step(p, xn, cache["ckv"][i], cache["krope"][i], cache_len,
                                       kw.pop("c"), **kw)
        else:
            out, _ = A.gqa_decode_step(p, xn, cache["k"][i], cache["v"][i], cache_len, **kw)
        return _ffn_tail(lp, x + out) if "ffn_w1" in lp else _moe_tail(lp, x + out, c)[0]
    body = _decode_attn_body(lp, xn, cache, i, cache_len, c, mp.heads(c))
    h = x + mp.psum(_run_body(body, mp))
    if "ffn_w1" not in lp:
        return _moe_tail(lp, h, c, mp)[0]
    hn = rms_norm(h, lp["norm2"])
    return h + mp.psum(swiglu(hn, lp["ffn_w1"], lp["ffn_w3"], lp["ffn_w2"]))


def _gather_logits(logits: torch.Tensor, mp: Optional[_MeshCtx]) -> torch.Tensor:
    """The rank's (rows, vocab columns) block of the logits -> all of them
    (the padding rows dropped)."""
    if mp is None:
        return logits
    if mp.tp is not None:
        logits = M.all_gather(logits, mp.mesh, mp.tp, dim=-1)
    logits = M.all_gather(logits, mp.mesh, mp.dp, dim=0)
    return logits if mp.rows is None else logits[:mp.rows]


def _rank_rows(x: torch.Tensor, mp: _MeshCtx) -> torch.Tensor:
    """This rank's rows of the global ``x``, padded to its block."""
    return _pad_rows(x[_dp_rows(x.shape[0], mp.mesh, mp.dp)[0]], dp_block(x.shape[0], mp.n_dp))


@torch.no_grad()
def serve_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_len: A.CacheLen, c: LMConfig, *, mesh=None, dp=("data",),
               tp: Optional[str] = "model") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token (B, 1) int -> (logits (B, V), cache). Each
    layer writes the token's key and value (MLA: its latent and rope key)
    into ``cache`` at ``cache_len`` (in place; the cache is returned). The
    dense layers use cache layers ``[0, n_dense)``, the MoE layers
    ``[n_dense, L)``; an MoE layer routes the B tokens of the step as one
    call of ``moe_ffn``. With ``mesh``: ``token`` is the global batch,
    ``params`` the rank's shards under :func:`param_specs` over ``dp`` and
    ``tp`` (``tp=None`` keeps ``'model'``, as :func:`make_cache`), ``cache``
    the rank's :func:`cache_specs` block (``make_cache(mesh=)``), which the
    attention reads alone (:func:`_decode_attn_body`); the MoE layers call
    ``moe_ffn(mesh=)`` on the rank's rows (JAX's token block where the rows
    do not split evenly, which an MoE decode of B tokens refuses unless
    ``|dp|`` divides B, as JAX's ``shard_map``), and the logits are
    gathered."""
    mp = None if mesh is None else _mesh_ctx(c, mesh, dp, tp or "model", token.shape[0])
    if mp is not None:
        token = _rank_rows(token, mp)
    x = _embed(params, token, c, mp)
    stacks = [("dense_layers", 0)] if c.n_dense_layers else []
    if c.n_moe_layers:
        stacks.append(("moe_layers", c.n_dense_layers))
    for group, first in stacks:
        names, layers = _layers(params[group])
        for j, lp_t in enumerate(layers):
            lp = dict(zip(names, lp_t))
            if mp is not None:
                lp = _layer_gather(lp, group, c, mp, decode=True)
            x = _decode_layer(lp, x, cache, first + j, cache_len, c, mp)
    x = rms_norm(x, params["final_norm"])
    logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    return _gather_logits(logits[:, 0], mp), cache


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, c: LMConfig, *, mesh=None, dp=("data",),
            tp: Optional[str] = "model") -> torch.Tensor:
    """Prefill: the full forward; returns the last position's logits (B, V).
    With ``mesh``: ``tokens`` global, each rank runs its rows (its padded
    block where they do not split evenly), and the logits are gathered."""
    n = tokens.shape[0]
    mp = None if mesh is None else _mesh_ctx(c, mesh, dp, tp, n)
    if mp is not None:
        tokens = _rank_rows(tokens, mp)
    h, _ = hidden_states(params, tokens, c, mesh=mesh, dp=dp, tp=tp, rows=n)
    last = h[:, -1]
    head = params["lm_head"] if mp is None or mp.tp is not None else _top(params, "lm_head", mp)
    return _gather_logits(torch.matmul(last, head.to(last.dtype)), mp)
