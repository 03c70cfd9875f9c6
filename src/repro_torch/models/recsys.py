"""CTR/recsys models on the packed embedding table: DLRM serving and training.

FeatureBox trains and serves CTR models with 10^12-dim sparse inputs. The
port runs DLRM: one packed :class:`~repro_torch.embedding.table.MultiTable`
for all sparse fields, the working-set lookup (``lookup_dedup``), bottom
MLP, the pairwise-dot interaction through the ``interaction_dot`` CUDA
kernels (forward and backward), and the top MLP; and the hierarchical-PS
sparse train step (:func:`make_sparse_train_step`), which differentiates
only the batch's working set of embedding rows.

Parameters are a plain ``{name: tensor}`` dict with the JAX package's names
and shapes (dense weights ``(in, out)``), so :func:`params_from_jax` carries
a JAX parameter tree across as it is. The DCN-v2, AutoInt and BST forwards,
the dense ``make_train_step`` and the mesh and hierarchy steps are not
ported yet (ROADMAP A5, A7, A8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.embedding.dedup import FILL, dedup, take_rows
from repro_torch.embedding.table import MultiTable, TableSpec, lookup, lookup_dedup
from repro_torch.kernels.interaction_dot import ops as interaction_ops
from repro_torch.models.common import mlp, sigmoid_bce

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


def init_params(c: RecsysConfig, generator: torch.Generator) -> Params:
    """Materialize params on ``generator``'s device with the JAX package's
    distributions: uniform ±1/√D for ``embed``, He-normal for weights, ones
    for layer-norm scales, zeros for biases. The bits differ from JAX's
    PRNG; parity tests carry JAX's params over with :func:`params_from_jax`."""
    dev = generator.device
    params: Params = {}
    for name, shape in param_shapes(c).items():
        if name == "embed":
            scale = 1.0 / np.sqrt(c.embed_dim)
            params[name] = torch.empty(shape, dtype=c.dtype, device=dev).uniform_(
                -scale, scale, generator=generator)
        elif "ln" in name and name.endswith("_w"):
            params[name] = torch.ones(shape, dtype=c.dtype, device=dev)
        elif len(shape) == 1:
            params[name] = torch.zeros(shape, dtype=c.dtype, device=dev)
        else:
            std = np.sqrt(2.0 / max(shape[0], 1))
            params[name] = torch.randn(shape, generator=generator, dtype=c.dtype,
                                       device=dev) * std
    return params


def params_from_jax(np_params: Mapping[str, Any], device) -> Params:
    """Carry a JAX parameter dict (arrays or numpy) over to ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in np_params.items()}


# ----------------------------------------------------------------- lookups
def collect_gids(c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All packed global row ids this batch will look up, keyed by site."""
    mt = c.multi_table()
    gids: Dict[str, torch.Tensor] = {}
    if c.kind == "bst":
        sparse = batch["sparse"]
        seq_plus = torch.cat([batch["seq"], sparse[:, c.item_field][:, None]], dim=1)
        gids["seq"] = seq_plus.to(torch.int32) + int(mt.offsets[c.item_field])
        keep = [i for i in range(sparse.shape[1]) if i != c.item_field]
        other_offs = torch.as_tensor(
            np.delete(np.asarray(mt.offsets), c.item_field).astype(np.int32),
            device=sparse.device)
        gids["other"] = sparse[:, keep].to(torch.int32) + other_offs[None, :]
    else:
        gids["sparse"] = mt.global_ids(batch["sparse"])
    return gids


def _embed_fields(params: Params, c: RecsysConfig, field_ids: torch.Tensor,
                  mt: MultiTable) -> torch.Tensor:
    """(B, F) per-field ids -> (B, F, D) rows via packed global ids."""
    gids = mt.global_ids(field_ids)
    if c.dedup_lookup:
        cap = c.dedup_capacity or gids.numel()
        return lookup_dedup(params["embed"], gids, capacity=cap)
    return lookup(params["embed"], gids)


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


def _not_ported(kind: str) -> Callable:
    def forward(params, c, batch, mt):
        raise NotImplementedError(
            f"the {kind} forward is not ported to PyTorch yet (ROADMAP A5)")
    return forward


_FORWARDS: Dict[str, Callable] = {
    "dlrm": _dlrm_forward,
    "dcnv2": _not_ported("dcnv2"),
    "autoint": _not_ported("autoint"),
    "bst": _not_ported("bst"),
}


def forward(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Batch -> CTR logits (B,)."""
    return _FORWARDS[c.kind](params, c, batch, c.multi_table())


@torch.no_grad()
def serve_step(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Online/offline scoring: batch -> pCTR (B,)."""
    return torch.sigmoid(forward(params, c, batch))


def loss_fn(params: Params, c: RecsysConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return sigmoid_bce(forward(params, c, batch), batch["label"]).mean()


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
                 batch: Mapping[str, torch.Tensor]) -> WorkingSetGrads:
    """Steps 1–3 of the sparse train step: dedup the batch's packed ids into
    a working set of ``dedup_capacity`` rows (outside the gradient), gather
    those rows, and differentiate the loss with respect to (dense params,
    working rows). ``params["embed"]`` never requires grad, so no gradient
    of the table's size is formed."""
    gids = collect_gids(c, batch)
    sites = sorted(gids)
    flat_all = torch.cat([gids[s].reshape(-1) for s in sites])
    cap = c.dedup_capacity or int(flat_all.shape[0])
    with torch.no_grad():
        unique, inverse, n_unique = dedup(flat_all, capacity=cap)
        safe = torch.where(unique == FILL, 0, unique)
        working = take_rows(params["embed"], safe)               # (cap, D)
    inv_by_site, off = {}, 0
    for s in sites:
        n = gids[s].numel()
        inv_by_site[s] = inverse[off: off + n].reshape(gids[s].shape)
        off += n

    names = sorted(k for k in params if k != "embed")
    dense = {k: params[k].detach().requires_grad_(True) for k in names}
    rows = working.detach().requires_grad_(True)
    b2 = dict(batch)
    b2.update({f"_rows_{s}": take_rows(rows, inv_by_site[s]) for s in sites})
    p2 = dict(dense)
    p2["embed"] = params["embed"]  # untouched by grad (rows injected)
    with torch.enable_grad():
        loss = sigmoid_bce(forward(p2, c, b2), batch["label"]).mean()
        grads = torch.autograd.grad(loss, [dense[k] for k in names] + [rows])
    return WorkingSetGrads(loss=loss.detach(), dense_grads=dict(zip(names, grads[:-1])),
                           working=working, working_grad=grads[-1], unique=unique,
                           n_unique=n_unique, n_ids=int(flat_all.shape[0]))


def _scatter_drop(table: torch.Tensor, unique: torch.Tensor, values: torch.Tensor) -> None:
    """``table[unique] = values`` in place, where FILL slots write nothing
    (``mode="drop"``). ``unique`` is sorted, so any valid slot comes first:
    a FILL slot rewrites slot 0's row with slot 0's own value, an identical
    duplicate write; with no valid slot at all, row 0 gets its own value
    back. Never aliasing pad slots onto row 0 with other values is what
    keeps row 0's real update (the bug the JAX package fixed with
    ``mode="drop"``). No host sync."""
    valid = unique != FILL
    first = valid[0]
    anchor = torch.where(first, unique[0], 0).to(torch.int64)
    idx = torch.where(valid, unique.to(torch.int64), anchor)
    fill_value = torch.where(first, values[0], table[0])
    keep = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    table.index_copy_(0, idx, torch.where(keep, values, fill_value))


def make_sparse_train_step(c: RecsysConfig, dense_optimizer, *,
                           embed_lr: float = 0.01, embed_eps: float = 1e-10):
    """Hierarchical-PS train step ([37]/FeatureBox): working-set embeddings.

    1. dedup the batch's global ids into a fixed working set (OUTSIDE grad);
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
    ``unique`` and ``n_ids``.
    """

    def init(params: Params) -> Dict[str, Any]:
        dense = {k: v for k, v in params.items() if k != "embed"}
        return {"dense": dense_optimizer.init(dense),
                "embed_accum": torch.full((params["embed"].shape[0],), 0.1,
                                          dtype=torch.float32,
                                          device=params["embed"].device)}

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]):
        ws = sparse_grads(params, c, batch)
        dense = {k: v for k, v in params.items() if k != "embed"}
        new_dense, new_dense_state = dense_optimizer.update(
            dense, ws.dense_grads, opt_state["dense"])
        accum = opt_state["embed_accum"]
        with torch.no_grad():
            valid = (ws.unique != FILL).to(torch.float32)[:, None]
            gw = ws.working_grad.to(torch.float32) * valid
            gsq = torch.sum(gw * gw, dim=-1)
            safe = torch.where(ws.unique == FILL, 0, ws.unique).to(torch.int64)
            accum_rows = accum[safe] + gsq
            denom = torch.sqrt(accum_rows) + embed_eps
            scale = torch.full_like(denom, embed_lr) / denom
            new_rows = ws.working.to(torch.float32) - scale[:, None] * gw
            _scatter_drop(params["embed"], ws.unique, new_rows.to(params["embed"].dtype))
            _scatter_drop(accum, ws.unique, accum_rows)
        new_params = dict(new_dense)
        new_params["embed"] = params["embed"]
        metrics = {"loss": ws.loss, "unique": ws.n_unique, "n_ids": ws.n_ids}
        return new_params, {"dense": new_dense_state, "embed_accum": accum}, metrics

    return train_step, init
