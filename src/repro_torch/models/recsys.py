"""CTR/recsys models on the packed embedding table: DLRM, DCN-v2, AutoInt
and BST serving, training and retrieval scoring.

FeatureBox trains and serves CTR models with 10^12-dim sparse inputs. All
four models share one packed :class:`~repro_torch.embedding.table.MultiTable`
for all sparse fields and the working-set lookup (``lookup_dedup``). DLRM
runs the bottom MLP, the pairwise-dot interaction through the
``interaction_dot`` CUDA kernels (forward and backward) and the top MLP;
DCN-v2 its full-rank cross layers and deep tower; AutoInt its field
self-attention; BST a transformer block over the behaviour sequence and the
target item. The JAX package runs no Pallas kernel in the DCN-v2, AutoInt
and BST forwards, so theirs are plain PyTorch ops written as the JAX code
is. The hierarchical-PS sparse train step (:func:`make_sparse_train_step`)
differentiates only the batch's working set of embedding rows;
:func:`retrieval_score` scores one user against many candidates in one call.

Parameters are a plain ``{name: tensor}`` dict with the JAX package's names
and shapes (dense weights ``(in, out)``), so :func:`params_from_jax` carries
a JAX parameter tree across as it is. :func:`make_mesh_train_step` is the
data-parallel form on a ``('pod', 'data')`` mesh of ranks, and
:func:`make_train_step` the dense step that differentiates the whole tree.
:func:`make_hierarchy_train_step` is the same sparse step over a working set
pulled from the hierarchical parameter server. :func:`abstract_params`,
:func:`param_specs` and :func:`sparse_abstract_state` describe a step's
inputs to the dry run without allocating them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sharding import P
from repro_torch.embedding.dedup import FILL, dedup, take_rows
from repro_torch.embedding.table import (MultiTable, TableSpec, adagrad_rows, lookup,
                                         lookup_dedup, scatter_drop)
from repro_torch.kernels.interaction_dot import ops as interaction_ops
from repro_torch.models.common import dense as dense_layer
from repro_torch.models.common import fold_in, layer_norm, mlp, sigmoid_bce
from repro_torch.obs.trace import get_tracer

Params = Dict[str, torch.Tensor]

# MLPerf DLRM (Criteo 1TB) per-field vocabulary sizes [arXiv:1906.00091].
CRITEO_1TB_VOCABS: Tuple[int, ...] = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # "dlrm" | "dcnv2" | "autoint" | "bst"
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: Tuple[int, ...]
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    n_cross_layers: int = 0
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    seq_len: int = 0                # BST behavior-sequence length
    n_blocks: int = 0               # BST transformer blocks
    dtype: Any = torch.float32
    dedup_lookup: bool = True       # FeatureBox working-set path
    dedup_capacity: int = 0         # 0 -> batch*fields (safe upper bound)
    # which sparse field holds the candidate item (retrieval scoring)
    item_field: int = 0
    # physical row padding so the packed table shards evenly on any mesh
    row_align: int = 512

    def multi_table(self) -> MultiTable:
        specs = [TableSpec(f"f{i}", v, self.embed_dim)
                 for i, v in enumerate(self.vocab_sizes)]
        return MultiTable.build(specs)

    @property
    def padded_rows(self) -> int:
        rows = self.multi_table().total_rows
        return (rows + self.row_align - 1) // self.row_align * self.row_align


# ------------------------------------------------------------------ params
def _mlp_shapes(dims: Sequence[int], d_in: int, prefix: str) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    prev = d_in
    for i, d in enumerate(dims):
        shapes[f"{prefix}_w{i}"] = (prev, d)
        shapes[f"{prefix}_b{i}"] = (d,)
        prev = d
    return shapes


def param_shapes(c: RecsysConfig) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {"embed": (c.padded_rows, c.embed_dim)}
    if c.kind == "dlrm":
        shapes.update(_mlp_shapes(c.bot_mlp, c.n_dense, "bot"))
        n_fields = c.n_sparse + 1
        d_inter = n_fields * (n_fields - 1) // 2 + c.bot_mlp[-1]
        shapes.update(_mlp_shapes(c.top_mlp, d_inter, "top"))
    elif c.kind == "dcnv2":
        d0 = c.n_dense + c.n_sparse * c.embed_dim
        for i in range(c.n_cross_layers):
            shapes[f"cross_w{i}"] = (d0, d0)
            shapes[f"cross_b{i}"] = (d0,)
        shapes.update(_mlp_shapes(tuple(c.top_mlp) + (1,), d0, "deep"))
    elif c.kind == "autoint":
        d = c.embed_dim
        for i in range(c.n_attn_layers):
            d_out = c.d_attn * c.n_heads
            shapes[f"attn{i}_wq"] = (d, d_out)
            shapes[f"attn{i}_wk"] = (d, d_out)
            shapes[f"attn{i}_wv"] = (d, d_out)
            shapes[f"attn{i}_wres"] = (d, d_out)
            d = d_out
        shapes["out_w"] = (c.n_sparse * d, 1)
        shapes["out_b"] = (1,)
    elif c.kind == "bst":
        d = c.embed_dim
        shapes["pos_embed"] = (c.seq_len + 1, d)
        for i in range(c.n_blocks):
            shapes[f"blk{i}_wq"] = (d, d)
            shapes[f"blk{i}_wk"] = (d, d)
            shapes[f"blk{i}_wv"] = (d, d)
            shapes[f"blk{i}_wo"] = (d, d)
            shapes[f"blk{i}_ln1_w"] = (d,)
            shapes[f"blk{i}_ln1_b"] = (d,)
            shapes[f"blk{i}_ffn_w1"] = (d, 4 * d)
            shapes[f"blk{i}_ffn_b1"] = (4 * d,)
            shapes[f"blk{i}_ffn_w2"] = (4 * d, d)
            shapes[f"blk{i}_ffn_b2"] = (d,)
            shapes[f"blk{i}_ln2_w"] = (d,)
            shapes[f"blk{i}_ln2_b"] = (d,)
        d_in = (c.seq_len + 1) * d + (c.n_sparse - 1) * d
        shapes.update(_mlp_shapes(tuple(c.top_mlp) + (1,), d_in, "top"))
    else:
        raise ValueError(f"unknown recsys kind {c.kind!r}")
    return shapes


def abstract_params(c: RecsysConfig) -> Params:
    """The params as ``meta`` tensors of ``c.dtype`` (no memory)."""
    return {k: torch.empty(s, dtype=c.dtype, device="meta") for k, s in param_shapes(c).items()}


def param_specs(c: RecsysConfig, *, dp: Tuple[str, ...] = ("data",), tp: str = "model"
                ) -> Dict[str, P]:
    """Embedding rows sharded over every device; small dense nets replicated."""
    return {name: P(dp + (tp,), None) if name == "embed" else P(*(None,) * len(shape))
            for name, shape in param_shapes(c).items()}


def init_params(c: RecsysConfig, generator: torch.Generator, *,
                include_embed: bool = True) -> Params:
    """Materialize params on ``generator``'s device with the JAX package's
    distributions: uniform ±1/√D for ``embed``, He-normal for weights, ones
    for layer-norm scales, zeros for biases. Each param draws from a
    generator of its own, seeded from ``generator``'s seed and the param's
    position in :func:`param_shapes`, so ``include_embed=False`` (the
    hierarchical-PS path keeps the table in the PS file) leaves every dense
    param bit for bit as in the full init. The bits differ from JAX's PRNG;
    parity tests carry JAX's params over with :func:`params_from_jax`."""
    dev = generator.device
    seed = generator.initial_seed()
    params: Params = {}
    for i, (name, shape) in enumerate(param_shapes(c).items()):
        if name == "embed" and not include_embed:
            continue
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, i))
        if name == "embed":
            scale = 1.0 / np.sqrt(c.embed_dim)
            params[name] = torch.empty(shape, dtype=c.dtype, device=dev).uniform_(
                -scale, scale, generator=gen)
        elif "ln" in name and name.endswith("_w"):
            params[name] = torch.ones(shape, dtype=c.dtype, device=dev)
        elif len(shape) == 1:
            params[name] = torch.zeros(shape, dtype=c.dtype, device=dev)
        else:
            std = np.sqrt(2.0 / max(shape[0], 1))
            params[name] = torch.randn(shape, generator=gen, dtype=c.dtype,
                                       device=dev) * std
    return params


def params_from_jax(np_params: Mapping[str, Any], device) -> Params:
    """Carry a JAX parameter dict (arrays or numpy) over to ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in np_params.items()}


# ----------------------------------------------------------------- lookups
def collect_gids(c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All packed global row ids this batch will look up, keyed by site."""
    mt = c.multi_table()
    if c.kind == "bst":
        return {"seq": _seq_gids(c, batch, mt), "other": _other_gids(c, batch["sparse"], mt)}
    return {"sparse": mt.global_ids(batch["sparse"])}


def _seq_gids(c: RecsysConfig, batch: Mapping[str, torch.Tensor],
              mt: MultiTable) -> torch.Tensor:
    """BST's (B, L+1) ids: the behaviour sequence and the target item, both
    in the item field's table."""
    seq_plus = torch.cat([batch["seq"], batch["sparse"][:, c.item_field][:, None]], dim=1)
    return seq_plus.to(torch.int32) + int(mt.offsets[c.item_field])


def _other_gids(c: RecsysConfig, sparse: torch.Tensor, mt: MultiTable) -> torch.Tensor:
    """BST's (B, F-1) ids of the fields other than the item field, in order
    (JAX's ``jnp.delete``)."""
    keep = [i for i in range(sparse.shape[1]) if i != c.item_field]
    offs = torch.as_tensor(np.asarray(mt.offsets)[keep].astype(np.int32), device=sparse.device)
    return sparse[:, keep].to(torch.int32) + offs[None, :]


def _lookup_gids(params: Params, c: RecsysConfig, gids: torch.Tensor) -> torch.Tensor:
    """Rows of packed ids ``gids`` (any shape), through the working set
    when ``c.dedup_lookup`` (span ``embed.lookup``)."""
    table = params["embed"]
    with get_tracer().span("embed.lookup", device=table):
        if c.dedup_lookup:
            return lookup_dedup(table, gids, capacity=c.dedup_capacity or gids.numel())
        return lookup(table, gids)


def _embed_fields(params: Params, c: RecsysConfig, field_ids: torch.Tensor,
                  mt: MultiTable) -> torch.Tensor:
    """(B, F) per-field ids -> (B, F, D) rows via packed global ids."""
    return _lookup_gids(params, c, mt.global_ids(field_ids))


# ----------------------------------------------------------------- forward
def _dlrm_forward(params, c, batch, mt):
    dense_x = batch["dense"].to(c.dtype)
    emb = batch.get("_rows_sparse")
    if emb is None:
        emb = _embed_fields(params, c, batch["sparse"], mt)      # (B, F, D)
    n_bot = len(c.bot_mlp)
    bot = mlp(dense_x,
              [params[f"bot_w{i}"] for i in range(n_bot)],
              [params[f"bot_b{i}"] for i in range(n_bot)],
              act=torch.relu, final_act=torch.relu)              # (B, D)
    fields = torch.cat([bot[:, None, :], emb], dim=1)             # (B, F+1, D)
    inter = interaction_ops.pairwise_dots(fields)                 # (B, P)
    top_in = torch.cat([bot, inter], dim=1)
    n_top = len(c.top_mlp)
    logit = mlp(top_in,
                [params[f"top_w{i}"] for i in range(n_top)],
                [params[f"top_b{i}"] for i in range(n_top)])
    return logit[:, 0]


def _dcnv2_forward(params, c, batch, mt):
    emb = batch.get("_rows_sparse")
    if emb is None:
        emb = _embed_fields(params, c, batch["sparse"], mt)
    b = emb.shape[0]
    x0 = torch.cat([batch["dense"].to(c.dtype), emb.reshape(b, -1)], dim=1)
    x = x0
    for i in range(c.n_cross_layers):
        xw = dense_layer(x, params[f"cross_w{i}"], params[f"cross_b{i}"])
        x = x0 * xw + x                                           # DCN-v2 cross
    n_deep = len(c.top_mlp) + 1
    logit = mlp(x,
                [params[f"deep_w{i}"] for i in range(n_deep)],
                [params[f"deep_b{i}"] for i in range(n_deep)])
    return logit[:, 0]


def _autoint_forward(params, c, batch, mt):
    emb = batch.get("_rows_sparse")
    if emb is None:
        emb = _embed_fields(params, c, batch["sparse"], mt)      # (B, F, D)
    # JAX divides by sqrt(d_attn); under jit XLA multiplies by the float32
    # reciprocal instead (ROADMAP C5), and so does the port.
    inv_scale = float(np.float32(1.0) / np.float32(np.sqrt(c.d_attn)))
    x = emb
    for i in range(c.n_attn_layers):
        q = dense_layer(x, params[f"attn{i}_wq"])
        k = dense_layer(x, params[f"attn{i}_wk"])
        v = dense_layer(x, params[f"attn{i}_wv"])
        b, f, _ = q.shape
        qh = q.reshape(b, f, c.n_heads, c.d_attn)
        kh = k.reshape(b, f, c.n_heads, c.d_attn)
        vh = v.reshape(b, f, c.n_heads, c.d_attn)
        scores = torch.einsum("bfhd,bghd->bhfg", qh, kh) * inv_scale
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhfg,bghd->bfhd", attn, vh).reshape(b, f, -1)
        x = torch.relu(out + dense_layer(x, params[f"attn{i}_wres"]))
    b = x.shape[0]
    logit = dense_layer(x.reshape(b, -1), params["out_w"], params["out_b"])
    return logit[:, 0]


def _bst_forward(params, c, batch, mt):
    # the item field is the target; the remaining fields are user/context features
    b, l = batch["seq"].shape                                     # (B, L) item ids
    # behavior sequence + target share the item table (the item field's id space)
    x = batch.get("_rows_seq")
    if x is None:
        x = _lookup_gids(params, c, _seq_gids(c, batch, mt))     # (B, L+1, D)
    x = x.to(c.dtype) + params["pos_embed"][None, :, :].to(c.dtype)
    d_h = c.embed_dim // c.n_heads
    # JAX divides by sqrt(d_h); XLA multiplies by the float32 reciprocal
    # (ROADMAP C5), exact here: d_h is 4 at both widths
    inv_scale = float(np.float32(1.0) / np.float32(np.sqrt(d_h)))
    for i in range(c.n_blocks):
        q = dense_layer(x, params[f"blk{i}_wq"])
        k = dense_layer(x, params[f"blk{i}_wk"])
        v = dense_layer(x, params[f"blk{i}_wv"])
        qh = q.reshape(b, l + 1, c.n_heads, d_h)
        kh = k.reshape(b, l + 1, c.n_heads, d_h)
        vh = v.reshape(b, l + 1, c.n_heads, d_h)
        # one expression, so the (B, H, L+1, L+1) scores and weights are
        # freed before the FFN (14 GB each when scoring 10^6 candidates)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            torch.einsum("bqhd,bkhd->bhqk", qh, kh) * inv_scale, dim=-1), vh
        ).reshape(b, l + 1, -1)
        h = layer_norm(x + dense_layer(out, params[f"blk{i}_wo"]),
                       params[f"blk{i}_ln1_w"], params[f"blk{i}_ln1_b"])
        ff = dense_layer(
            torch.relu(dense_layer(h, params[f"blk{i}_ffn_w1"], params[f"blk{i}_ffn_b1"])),
            params[f"blk{i}_ffn_w2"], params[f"blk{i}_ffn_b2"])
        x = layer_norm(h + ff, params[f"blk{i}_ln2_w"], params[f"blk{i}_ln2_b"])
    other_emb = batch.get("_rows_other")
    if other_emb is None:
        other_emb = _lookup_gids(params, c, _other_gids(c, batch["sparse"], mt))  # (B, F-1, D)
    feat = torch.cat([x.reshape(b, -1), other_emb.reshape(b, -1)], dim=1)
    n_top = len(c.top_mlp) + 1
    logit = mlp(feat,
                [params[f"top_w{i}"] for i in range(n_top)],
                [params[f"top_b{i}"] for i in range(n_top)])
    return logit[:, 0]


_FORWARDS: Dict[str, Callable] = {
    "dlrm": _dlrm_forward,
    "dcnv2": _dcnv2_forward,
    "autoint": _autoint_forward,
    "bst": _bst_forward,
}


def forward(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Batch -> CTR logits (B,)."""
    return _FORWARDS[c.kind](params, c, batch, c.multi_table())


@torch.no_grad()
def serve_step(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Online/offline scoring: batch -> pCTR (B,) (span ``serve.step``)."""
    with get_tracer().span("serve.step", device=params["embed"]):
        return torch.sigmoid(forward(params, c, batch))


@torch.no_grad()
def retrieval_score(params: Params, c: RecsysConfig, user_batch: Mapping[str, torch.Tensor],
                    candidate_ids: torch.Tensor) -> torch.Tensor:
    """Score ONE user context against many candidates (batched, no loop).

    User-side features (batch size 1) are broadcast across the candidate
    axis; the candidate id replaces the item field. This is full-model
    scoring at candidate batch size — the `retrieval_cand` shape.
    """
    n = candidate_ids.shape[0]
    batch: Dict[str, torch.Tensor] = {}
    for key, v in user_batch.items():
        if key == "label":
            continue
        batch[key] = v.expand((n,) + tuple(v.shape[1:]))
    # a copy: a write into an expanded view would hit its one shared row
    sparse = batch["sparse"].clone()
    sparse[:, c.item_field] = candidate_ids.to(torch.int32)
    batch["sparse"] = sparse
    return torch.sigmoid(forward(params, c, batch))


def loss_fn(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return sigmoid_bce(forward(params, c, batch), batch["label"]).mean()


def make_train_step(c: RecsysConfig, optimizer):
    """Dense train step: differentiates the whole tree, the table included
    (the small-table path). ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss"})`` updates the params and the optimizer
    state in place and returns them; ``optimizer.init(params)`` builds the
    state."""

    def train_step(params: Params, opt_state: Any, batch: Mapping[str, torch.Tensor]):
        names = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss = loss_fn(leaves, c, batch)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        params, opt_state = optimizer.update(params, dict(zip(names, grads)), opt_state)
        return params, opt_state, {"loss": loss.detach()}

    return train_step


# ------------------------------------------------------------ sparse train
@dataclasses.dataclass
class WorkingSetGrads:
    """One batch's working set and the loss gradients (:func:`sparse_grads`)."""

    loss: torch.Tensor          # f32[]
    dense_grads: Params         # gradient of every param except ``embed``
    working: torch.Tensor       # f32[cap, D] the rows gathered from the table
    working_grad: torch.Tensor  # f32[cap, D] their gradient
    unique: torch.Tensor        # int32[cap] sorted unique packed ids, FILL-padded
    n_unique: torch.Tensor      # int32[] non-FILL slots of ``unique``
    n_ids: int                  # ids the batch references (batch x fields)


def sparse_grads(params: Params, c: RecsysConfig,
                 batch: Mapping[str, torch.Tensor], *,
                 dedup_fn: Callable = dedup) -> WorkingSetGrads:
    """Steps 1–3 of the sparse train step: dedup the batch's packed ids into
    a working set of ``dedup_capacity`` rows (outside the gradient), gather
    those rows, and differentiate the loss with respect to (dense params,
    working rows). ``params["embed"]`` never requires grad, so no gradient
    of the table's size is formed. ``dedup_fn(ids, capacity=)`` is
    :func:`dedup` unless the caller passes the two-stage form. Spans:
    ``sparse.dedup`` and ``sparse.gather``, then those of
    :func:`working_set_grads`."""
    tracer, table = get_tracer(), params["embed"]
    with torch.no_grad():
        with tracer.span("sparse.dedup", device=table):
            gids = collect_gids(c, batch)
            sites = sorted(gids)
            flat_all = torch.cat([gids[s].reshape(-1) for s in sites])
            cap = c.dedup_capacity or int(flat_all.shape[0])
            unique, inverse, n_unique = dedup_fn(flat_all, capacity=cap)
        with tracer.span("sparse.gather", device=table):
            safe = torch.where(unique == FILL, 0, unique)
            working = take_rows(table, safe)                     # (cap, D)
    return working_set_grads(params, c, batch, working, unique, n_unique, inverse,
                             {s: tuple(gids[s].shape) for s in sites})


def working_set_grads(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor],
                      working: torch.Tensor, unique: torch.Tensor, n_unique: torch.Tensor,
                      inverse: torch.Tensor,
                      shapes: Mapping[str, Tuple[int, ...]]) -> WorkingSetGrads:
    """Step 3 on a given working set: the loss and its gradient with respect
    to (dense params, ``working`` rows), the batch's rows at each site taken
    from ``working`` through ``inverse`` (the flat inverse over the sites'
    id arrays of ``shapes``, concatenated in sorted site order). Spans:
    ``sparse.forward`` (the rows at each site, the forward and the loss)
    and ``sparse.backward``."""
    tracer = get_tracer()
    sites = sorted(shapes)
    inv_by_site, off = {}, 0
    for s in sites:
        n = int(np.prod(shapes[s]))
        inv_by_site[s] = inverse[off: off + n].reshape(shapes[s])
        off += n

    names = sorted(k for k in params if k != "embed")
    dense = {k: params[k].detach().requires_grad_(True) for k in names}
    rows = working.detach().requires_grad_(True)
    b2 = dict(batch)
    p2 = dict(dense)
    if "embed" in params:
        p2["embed"] = params["embed"]  # untouched by grad (rows injected)
    with torch.enable_grad():
        with tracer.span("sparse.forward", device=working):
            b2.update({f"_rows_{s}": take_rows(rows, inv_by_site[s]) for s in sites})
            loss = sigmoid_bce(forward(p2, c, b2), batch["label"]).mean()
        with tracer.span("sparse.backward", device=working):
            grads = torch.autograd.grad(loss, [dense[k] for k in names] + [rows])
    return WorkingSetGrads(loss=loss.detach(), dense_grads=dict(zip(names, grads[:-1])),
                           working=working, working_grad=grads[-1], unique=unique,
                           n_unique=n_unique, n_ids=int(inverse.shape[0]))


def make_sparse_train_step(c: RecsysConfig, dense_optimizer, *,
                           embed_lr: float = 0.01, embed_eps: float = 1e-10,
                           mesh=None, batch_axes=None, local_dedup_capacity: int = 0):
    """Hierarchical-PS train step ([37]/FeatureBox): working-set embeddings.

    1. dedup the batch's global ids into a fixed working set (OUTSIDE grad);
       with ``mesh``, ``batch_axes`` and ``local_dedup_capacity`` all given,
       by the two-stage :func:`~repro_torch.embedding.dedup.dedup_hierarchical`
       over as many row blocks as ``mesh`` has devices on ``batch_axes``
       (``mesh`` a ``DeviceMesh`` or a ``{axis: size}`` mapping; one
       process, no ranks);
    2. gather working rows + their Adagrad accumulators (the only table
       traffic — proportional to unique ids, not batch x fields x dim);
    3. differentiate w.r.t. (working rows, dense params);
    4. Adagrad the working rows, ``dense_optimizer`` the dense params;
    5. scatter updated rows + accumulators back, FILL slots dropped.

    Returns ``(train_step, init)``. ``init(params)`` builds the optimizer
    state: the dense optimizer's plus a per-row Adagrad accumulator
    ``embed_accum`` (f32[V_total], 0.1). ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` updates the table, the
    accumulator and the dense params **in place** (the port's form of the
    JAX step's buffer donation) and returns them; metrics are ``loss``,
    ``unique`` and ``n_ids``. Spans: those of :func:`sparse_grads`, then
    ``sparse.dense_opt`` and ``sparse.rows_opt`` (Adagrad and both
    scatters), each also timed on the device.
    """

    def init(params: Params) -> Dict[str, Any]:
        dense = {k: v for k, v in params.items() if k != "embed"}
        return {"dense": dense_optimizer.init(dense),
                "embed_accum": torch.full((params["embed"].shape[0],), 0.1,
                                          dtype=torch.float32,
                                          device=params["embed"].device)}

    dedup_fn = dedup
    if mesh is not None and batch_axes is not None and local_dedup_capacity:
        from repro_torch.embedding.dedup import dedup_hierarchical

        shape = _mesh_shape(mesh)
        n_shards = int(np.prod([shape[a] for a in batch_axes]))

        def dedup_fn(ids, *, capacity):
            return dedup_hierarchical(ids, capacity=capacity, n_shards=n_shards,
                                      local_capacity=local_dedup_capacity)

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]):
        tracer = get_tracer()
        ws = sparse_grads(params, c, batch, dedup_fn=dedup_fn)
        dense = {k: v for k, v in params.items() if k != "embed"}
        with tracer.span("sparse.dense_opt", device=ws.working):
            new_dense, new_dense_state = dense_optimizer.update(
                dense, ws.dense_grads, opt_state["dense"])
        accum = opt_state["embed_accum"]
        with torch.no_grad(), tracer.span("sparse.rows_opt", device=ws.working):
            safe = torch.where(ws.unique == FILL, 0, ws.unique).to(torch.int64)
            new_rows, accum_rows = adagrad_rows(ws.working, ws.working_grad, ws.unique,
                                                accum[safe], lr=embed_lr, eps=embed_eps)
            scatter_drop(params["embed"], ws.unique, new_rows.to(params["embed"].dtype))
            scatter_drop(accum, ws.unique, accum_rows)
        new_params = dict(new_dense)
        new_params["embed"] = params["embed"]
        metrics = {"loss": ws.loss, "unique": ws.n_unique, "n_ids": ws.n_ids}
        return new_params, {"dense": new_dense_state, "embed_accum": accum}, metrics

    return train_step, init


def sparse_abstract_state(params: Params, dense_optimizer) -> Dict[str, Any]:
    """The state :func:`make_sparse_train_step`'s ``init`` builds, as
    ``meta`` tensors: the dense optimizer's abstract state and the
    f32[V_total] ``embed_accum``."""
    dense = {k: v for k, v in params.items() if k != "embed"}
    return {"dense": dense_optimizer.abstract_state(dense),
            "embed_accum": torch.empty((params["embed"].shape[0],), dtype=torch.float32,
                                       device="meta")}


def _mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of such a mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# -------------------------------------------------------------- mesh train
def dense_param_elems(c: RecsysConfig) -> int:
    """Total element count of the dense (non-embedding) parameter tree —
    the gradient volume the mesh step's cross-pod all-reduce carries."""
    return int(sum(np.prod(s) for k, s in param_shapes(c).items() if k != "embed"))


def batch_id_count(c: RecsysConfig, rows: int) -> int:
    """Flat id count :func:`collect_gids` yields for ``rows`` examples
    (the comm plan's per-device raw-id volume)."""
    if c.kind == "bst":
        return rows * (c.seq_len + 1) + rows * (c.n_sparse - 1)
    return rows * c.n_sparse


def comm_residual_init(c: RecsysConfig, n_pods: int, inner: int, *, device=None) -> torch.Tensor:
    """The mesh step's zero error-feedback residual of the whole mesh,
    ``f32[n_pods, npad]`` with ``npad`` the dense element count rounded up
    to a multiple of ``inner`` (JAX's layout)."""
    npad = -(-dense_param_elems(c) // inner) * inner
    return torch.zeros((n_pods, npad), dtype=torch.float32, device=device)


def make_mesh_train_step(c: RecsysConfig, dense_optimizer, *, mesh,
                         embed_lr: float = 0.01, embed_eps: float = 1e-10,
                         local_dedup_capacity: int = 0, compress: Any = None,
                         pod_axis: str = "pod", data_axis: str = "data"):
    """Data-parallel working-set train step on a ``('pod', 'data')`` mesh.

    The scale-out form of :func:`make_sparse_train_step`, the same
    arithmetic distributed per the FeatureBox authors' recipe (arXiv
    2201.05500 + 2003.05622). Every rank of ``mesh`` (a ``DeviceMesh``, one
    process per device) calls the returned ``train_step(params, opt_state,
    batch)`` with the **global** batch and its own state: the packed table
    and its Adagrad accumulators are **row-sharded** over the flattened
    mesh (:func:`~repro_torch.embedding.table.row_sharding`,
    :func:`shard_train_state`), and each rank takes its contiguous block of
    the batch rows, as JAX's ``P(('pod', 'data'))`` does. On each rank:

    1. **two-stage dedup** —
       :func:`~repro_torch.embedding.dedup.dedup_two_stage_local`;
    2. **working-set exchange** — each rank contributes the unique rows +
       accumulators it owns (out-of-shard slots zeroed), one fp32
       reduction replicates the working set everywhere;
    3. forward/backward on the rank's rows against the replicated working
       set (:func:`working_set_grads`, the single-device step's);
    4. **gradient reduction** — working-set grads and the flattened dense
       grads (sorted by name, as JAX flattens a dict) each go through
       :func:`~repro_torch.train.compression.hierarchical_psum` (JAX's
       ``hierarchical=False`` form, a flat all-reduce that ignores the
       codec, has no caller and is not ported; ``flat_psum`` stays as the
       baseline). The dense reduction carries the codec's
       error-feedback residual in ``opt_state["comm_residual"]`` (JAX's
       ``f32[n_pods, padded_dense_elems]``, of which this rank holds row
       ``pod`` and the ``data``-th block of columns: the residual of its
       reduce-scattered shard). Working-set grads are compressed without
       state: their slots map to different rows every step;
    5. replicated Adagrad on the working set (:func:`adagrad_rows`), each
       rank writing back only the rows it owns (``mode="drop"``,
       :func:`~repro_torch.embedding.table.scatter_rows`); the dense update
       replicated.

    Loss and gradients are divided by the device count only when there is
    more than one device, so on a **1x1 mesh with compression off** every
    collective is a copy, every pad a no-op, and losses, params and
    optimizer state are bit for bit :func:`make_sparse_train_step`'s.
    Metrics: ``loss``, ``unique``, ``n_ids`` and ``local_unique`` (the
    summed stage-1 unique counts).

    Returns ``(train_step, init)``; ``init(params)`` builds the full
    optimizer state (the residual of the whole mesh included), which
    :func:`shard_train_state` then places. Params and state are updated in
    place, as the sparse step's.
    """
    from repro_torch.embedding.dedup import dedup_two_stage_local
    from repro_torch.embedding.table import row_sharding, scatter_rows
    from repro_torch.train.compression import codec_name, hierarchical_psum

    shape = _mesh_shape(mesh)
    n_pods, inner = int(shape[pod_axis]), int(shape[data_axis])
    n_dev = n_pods * inner
    codec = codec_name(compress)
    if c.padded_rows % n_dev:
        raise ValueError(
            f"padded table rows {c.padded_rows} do not shard evenly over "
            f"{n_dev} devices — raise RecsysConfig.row_align")
    dev_index = row_sharding(mesh, axes=(pod_axis, data_axis)).index

    def _pad_to_inner(v):
        npad = -(-int(v.shape[0]) // inner) * inner
        if npad == v.shape[0]:
            return v
        return torch.cat([v, v.new_zeros(npad - int(v.shape[0]))])

    def _reduce(vec, *, codec=None, residual=None):
        """All-reduce a 1-D fp32 vector over the whole mesh."""
        return hierarchical_psum(vec, mesh, pod_axis=pod_axis, inner_axis=data_axis,
                                 compress=codec, residual=residual)

    def _psum(t):
        import torch.distributed as dist

        out = t.reshape(1).clone()
        dist.all_reduce(out)
        return out.reshape(())

    def init(params: Params) -> Dict[str, Any]:
        dense = {k: v for k, v in params.items() if k != "embed"}
        st = {"dense": dense_optimizer.init(dense),
              "embed_accum": torch.full((params["embed"].shape[0],), 0.1,
                                        dtype=torch.float32, device=params["embed"].device)}
        if codec is not None:
            st["comm_residual"] = comm_residual_init(c, n_pods, inner,
                                                     device=params["embed"].device)
        return st

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]):
        rows = int(batch["label"].shape[0])
        if rows % n_dev:
            raise ValueError(
                f"batch of {rows} rows does not split over {n_dev} mesh "
                f"devices — pick a batch size divisible by the mesh")
        per = rows // n_dev
        local = {k: v[dev_index * per:(dev_index + 1) * per] for k, v in batch.items()}
        embed_shard, accum_shard = params["embed"], opt_state["embed_accum"]
        shard_rows = int(embed_shard.shape[0])
        lo = dev_index * shard_rows                     # first owned row

        gids = collect_gids(c, local)
        sites = sorted(gids)
        flat_local = torch.cat([gids[s].reshape(-1) for s in sites])
        n_local = int(flat_local.shape[0])
        cap = c.dedup_capacity or n_local * n_dev
        local_cap = local_dedup_capacity or min(cap, n_local)
        if n_dev == 1:
            # stage 1 must never overflow when it IS the whole dedup
            local_cap = min(cap, n_local)
        with torch.no_grad():
            unique, inverse, n_unique, local_count = dedup_two_stage_local(
                flat_local, capacity=cap, local_capacity=local_cap)
            # -------- working-set exchange: each rank contributes owned rows
            local_idx = unique.to(torch.int64) - lo     # FILL -> huge
            owned = (local_idx >= 0) & (local_idx < shard_rows)
            idx = local_idx.clamp(0, shard_rows - 1)
            contrib = torch.where(owned[:, None], embed_shard[idx], 0.0)
            acc_contrib = torch.where(owned, accum_shard[idx], 0.0)
            packed = torch.cat([contrib.to(torch.float32).reshape(-1), acc_contrib])
            red, _ = _reduce(_pad_to_inner(packed))     # fp32, never quantized
            working = red[:cap * c.embed_dim].reshape(cap, c.embed_dim)
            accum_rows0 = red[cap * c.embed_dim: cap * c.embed_dim + cap]

        ws = working_set_grads(params, c, local, working.to(c.dtype), unique, n_unique,
                               inverse, {s: tuple(gids[s].shape) for s in sites})
        with torch.no_grad():
            # -------- gradient reduction (the compressed inter-pod wire)
            valid = (unique != FILL).to(torch.float32)[:, None]
            gw = ws.working_grad.to(torch.float32) * valid
            # stateless codec: working-set slots alias different rows each step
            gw_red, _ = _reduce(_pad_to_inner(gw.reshape(-1)), codec=codec)
            gw = gw_red[:cap * c.embed_dim].reshape(cap, c.embed_dim)
            names = sorted(ws.dense_grads)
            gd_flat = torch.cat([ws.dense_grads[k].reshape(-1).to(torch.float32)
                                 for k in names])
            residual = opt_state["comm_residual"][0] if codec is not None else None
            gd_red, new_residual = _reduce(_pad_to_inner(gd_flat), codec=codec,
                                           residual=residual)
            loss = ws.loss
            if n_dev > 1:
                inv_ndev = float(np.float32(1.0 / n_dev))
                loss = _psum(loss) * inv_ndev
                gw = gw * inv_ndev
                gd_red = gd_red * inv_ndev
                local_count = _psum(local_count)
            gd, off = {}, 0
            for k in names:
                g = ws.dense_grads[k]
                gd[k] = gd_red[off: off + g.numel()].reshape(g.shape).to(g.dtype)
                off += g.numel()

        # -------- replicated updates, sharded write-back
        dense = {k: v for k, v in params.items() if k != "embed"}
        new_dense, new_dense_state = dense_optimizer.update(dense, gd, opt_state["dense"])
        with torch.no_grad():
            new_rows, accum_rows = adagrad_rows(working, gw, unique, accum_rows0,
                                                lr=embed_lr, eps=embed_eps)
            # only the rows this shard owns; other shards' rows and FILL
            # slots are dropped
            scatter_rows(embed_shard, local_idx, new_rows.to(embed_shard.dtype), owned)
            scatter_rows(accum_shard, local_idx, accum_rows, owned)
        new_params = dict(new_dense)
        new_params["embed"] = embed_shard
        new_opt = {"dense": new_dense_state, "embed_accum": accum_shard}
        if codec is not None:
            new_opt["comm_residual"] = new_residual[None]
        metrics = {"loss": loss, "unique": n_unique, "n_ids": n_local * n_dev,
                   "local_unique": local_count}
        return new_params, new_opt, metrics

    return train_step, init


def shard_train_state(mesh, params: Params, opt_state: Dict[str, Any], *,
                      pod_axis: str = "pod", data_axis: str = "data"):
    """This rank's part of the full ``(params, opt_state)`` under the mesh
    step's sharding contract: the embedding rows and Adagrad accumulators
    split over the flattened mesh (:func:`~repro_torch.embedding.table.
    row_sharding`), the dense tree replicated (this rank's own tensors),
    the codec residual ``f32[n_pods, npad]`` cut to row ``pod`` and the
    ``data``-th of ``data`` column blocks, JAX's ``P('pod', 'data')``."""
    from repro_torch.embedding.table import row_sharding

    rs = row_sharding(mesh, axes=(pod_axis, data_axis))
    new_params = {k: rs.shard(v) if k == "embed" else v for k, v in params.items()}
    new_opt: Dict[str, Any] = {"dense": opt_state["dense"],
                               "embed_accum": rs.shard(opt_state["embed_accum"])}
    if "comm_residual" in opt_state:
        res = opt_state["comm_residual"]
        inner = _mesh_shape(mesh)[data_axis]
        block = res.shape[1] // inner
        p, d = mesh.get_local_rank(pod_axis), mesh.get_local_rank(data_axis)
        new_opt["comm_residual"] = res[p:p + 1, d * block:(d + 1) * block].clone()
    return new_params, new_opt


def unshard_train_state(mesh, params: Params, opt_state: Dict[str, Any], *,
                        pod_axis: str = "pod", data_axis: str = "data"):
    """The inverse of :func:`shard_train_state`, called by every rank: the
    full table, accumulators and residual gathered from the ranks' shards
    (each rank's own tensors as they are on a mesh of one), the layout a
    checkpoint holds so that any mesh can restore it."""
    import torch.distributed as dist

    def gather(t, dim):
        if dist.get_world_size() == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=dim)

    full_params = {k: gather(v, 0) if k == "embed" else v for k, v in params.items()}
    full_opt: Dict[str, Any] = {"dense": opt_state["dense"],
                                "embed_accum": gather(opt_state["embed_accum"], 0)}
    if "comm_residual" in opt_state:
        # every rank's (1, block), in (pod, data) rank order: pod p's row is
        # the blocks of ranks p * data .. p * data + data - 1
        res = gather(opt_state["comm_residual"], 1)
        inner = _mesh_shape(mesh)[data_axis]
        full_opt["comm_residual"] = res.reshape(-1, inner * opt_state["comm_residual"].shape[1])
    return full_params, full_opt


def gid_site_shapes(c: RecsysConfig, batch: Mapping[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Shapes of :func:`collect_gids`'s per-site id arrays, without computing
    them. Shared by the hierarchy train step (which splits a host-computed
    inverse back per site) and its host twin
    :func:`repro_torch.embedding.psfeed.collect_gids_np`; the flat concat
    order is ``sorted(sites)`` in both."""
    if c.kind == "bst":
        b, l = batch["seq"].shape
        return {"other": (b, c.n_sparse - 1), "seq": (b, l + 1)}
    return {"sparse": tuple(batch["sparse"].shape)}


def make_hierarchy_train_step(c: RecsysConfig, dense_optimizer, *,
                              embed_lr: float = 0.01, embed_eps: float = 1e-10):
    """Working-set train step for the hierarchical PS backend.

    Same arithmetic as :func:`make_sparse_train_step`, but the working set
    arrives *in the batch* (pulled host-side by
    :class:`repro_torch.embedding.psfeed.HierarchyFeed`) instead of being
    gathered from a table on the device:

    * ``_ws_rows``    f32[cap, D]  pulled working rows (FILL slots padded);
    * ``_ws_accum``   f32[cap]     pulled Adagrad accumulators;
    * ``_ws_unique``  int32[cap]   unique global ids, FILL-padded;
    * ``_ws_inverse`` int32[N]     flat inverse over the sorted-site concat.

    Returns ``(train_step, init)``. ``params`` carries the dense tree only
    (no ``"embed"``), and ``init(params)`` builds ``{"dense": ...}``. The
    dense params are updated in place; the updated rows and accumulators
    come back in the metrics (``ws_rows``/``ws_accum``) for the write-back
    ``push()``, FILL slots keeping their pulled values. For valid slots the
    loss and row updates are bit for bit the in-memory step's as long as
    the pulled rows and accumulators match the table's.
    """

    def init(params: Params) -> Dict[str, Any]:
        return {"dense": dense_optimizer.init(params)}

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]):
        working, unique = batch["_ws_rows"], batch["_ws_unique"]
        valid = unique != FILL
        ws = working_set_grads(params, c, batch, working, unique,
                               valid.sum().to(torch.int32), batch["_ws_inverse"],
                               gid_site_shapes(c, batch))
        new_dense, new_dense_state = dense_optimizer.update(
            params, ws.dense_grads, opt_state["dense"])
        with torch.no_grad():
            new_rows, accum_rows = adagrad_rows(working, ws.working_grad, unique,
                                                batch["_ws_accum"], lr=embed_lr,
                                                eps=embed_eps)
            new_rows = torch.where(valid[:, None], new_rows, working)
        metrics = {"loss": ws.loss, "unique": ws.n_unique, "n_ids": ws.n_ids,
                   "ws_rows": new_rows, "ws_accum": accum_rows}
        return new_dense, {"dense": new_dense_state}, metrics

    return train_step, init
