"""Packed multi-field embedding tables and their lookups.

* :class:`TableSpec` / :class:`MultiTable` — many logical tables (one per
  sparse field) packed into ONE physical (sum(vocab), dim) tensor with field
  offsets.
* :func:`lookup` — one embedding row per (row, field) id: a plain gather.
* :func:`lookup_dedup` — FeatureBox/[37] working-set path: dedup ids, gather
  the unique rows once, then expand on the device.
* :func:`bag_lookup_segment` / :func:`bag_lookup_padded` — ragged and padded
  EmbeddingBag sums in plain torch (the ``embedding_bag`` kernel's entry
  point is :func:`repro_torch.kernels.embedding_bag.ops.bag_lookup`).
* :func:`sparse_grad_update` — sparse Adagrad over the batch's unique rows,
  FILL slots dropped (:func:`scatter_drop`); :func:`adagrad_rows` is its
  arithmetic, shared with the train steps of ``models/recsys.py``.
* :func:`row_sharding` / :func:`shard_bounds` — the even row split of the
  packed table over a mesh (plain per-rank shards).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.embedding.dedup import FILL, dedup, scatter_unique_grads, take_rows, undedup


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One logical embedding table (one sparse field)."""

    name: str
    vocab: int
    dim: int


@dataclasses.dataclass(frozen=True)
class MultiTable:
    """Several logical tables packed into one physical array."""

    specs: Tuple[TableSpec, ...]
    dim: int

    @staticmethod
    def build(specs: Sequence[TableSpec]) -> "MultiTable":
        dims = {s.dim for s in specs}
        if len(dims) != 1:
            raise ValueError(f"all tables must share dim, got {dims}")
        return MultiTable(specs=tuple(specs), dim=dims.pop())

    @property
    def offsets(self) -> np.ndarray:
        """Row offset of each field in the packed array."""
        sizes = np.array([s.vocab for s in self.specs], np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    @property
    def total_rows(self) -> int:
        return int(sum(s.vocab for s in self.specs))

    def global_ids(self, field_ids: torch.Tensor) -> torch.Tensor:
        """Per-field local ids (B, F) -> packed global row ids (B, F), int32."""
        offs = torch.as_tensor(self.offsets.astype(np.int32), device=field_ids.device)
        return field_ids.to(torch.int32) + offs[None, :]

    def lookup_dedup(self, params: torch.Tensor, field_ids: torch.Tensor, *,
                     capacity: int) -> torch.Tensor:
        """Working-set lookup over per-field local ids: (B, F) -> (B, F, D)."""
        return lookup_dedup(params, self.global_ids(field_ids), capacity=capacity)


# ------------------------------------------------------------- row sharding
@dataclasses.dataclass(frozen=True)
class RowSharding:
    """The even row split of a packed table over a flattened mesh: this
    rank, ``index`` of ``n_shards``, holds the contiguous rows
    :func:`shard_bounds` gives it as a tensor of its own. The port's form
    of the JAX package's ``NamedSharding(mesh, P(('pod', 'data'), None))``:
    plain per-rank shards (no DTensor), placed by
    :func:`repro_torch.models.recsys.shard_train_state`."""

    n_shards: int
    index: int

    def bounds(self, total_rows: int) -> Tuple[int, int]:
        return shard_bounds(total_rows, self.n_shards, self.index)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``full`` (the tensor itself when it holds
        them all, else a copy that owns its memory)."""
        lo, hi = self.bounds(int(full.shape[0]))
        if (lo, hi) == (0, int(full.shape[0])):
            return full
        return full[lo:hi].clone()


def row_sharding(mesh, *, axes: Tuple[str, ...] = ("pod", "data")) -> RowSharding:
    """The :class:`RowSharding` of this rank over ``axes`` of ``mesh`` (a
    ``DeviceMesh``), flattened in order: rank ``(p, d)`` of a
    ``('pod', 'data')`` mesh is shard ``p * data + d``."""
    n, index = 1, 0
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        n, index = n * size, index * size + mesh.get_local_rank(a)
    return RowSharding(n_shards=n, index=index)


def shard_bounds(total_rows: int, n_shards: int, shard_index: int
                 ) -> Tuple[int, int]:
    """[lo, hi) global row range owned by shard ``shard_index`` under the
    even row split of :func:`row_sharding`. ``total_rows`` must divide by
    ``n_shards`` (guaranteed when it is the row_align-padded count and the
    alignment covers the mesh size)."""
    if total_rows % n_shards:
        raise ValueError(
            f"{total_rows} rows do not shard evenly over {n_shards} devices "
            f"(raise RecsysConfig.row_align)")
    rows = total_rows // n_shards
    return shard_index * rows, (shard_index + 1) * rows


# ------------------------------------------------------------------ lookups
def lookup(params: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain embedding lookup: (...) ids -> (..., D) rows."""
    return take_rows(params, ids)


def lookup_dedup(params: torch.Tensor, ids: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """Working-set lookup: gather unique rows once, expand locally."""
    unique, inverse, _ = dedup(ids, capacity=capacity)
    safe = torch.where(unique == FILL, 0, unique)
    working = take_rows(params, safe)                 # (capacity, D) gather
    return undedup(working, inverse)                  # local expand


def bag_lookup_segment(params: torch.Tensor, flat_ids: torch.Tensor,
                       segment_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Ragged EmbeddingBag: sum rows of each segment (take + segment sum)."""
    rows = take_rows(params, flat_ids)
    return scatter_unique_grads(rows, segment_ids, n_segments)


def bag_lookup_padded(params: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Padded EmbeddingBag: (B, L) ids + (B, L) mask -> (B, D)."""
    rows = take_rows(params, ids)                     # (B, L, D)
    return (rows * mask[..., None].to(rows.dtype)).sum(dim=1)


# ----------------------------------------------------------- sparse updates
@dataclasses.dataclass
class SparseAdagradState:
    """Per-row accumulator for the embedding table (same shape rows x 1)."""

    accum: torch.Tensor  # f32[V_total]


def init_sparse_adagrad(total_rows: int, *, init: float = 0.1,
                        device=None) -> SparseAdagradState:
    return SparseAdagradState(accum=torch.full((total_rows,), init, dtype=torch.float32,
                                               device=device))


def scatter_drop(table: torch.Tensor, unique: torch.Tensor, values: torch.Tensor) -> None:
    """``table[unique] = values`` in place, where FILL slots write nothing
    (``mode="drop"``); :func:`scatter_rows` with the non-FILL slots valid."""
    scatter_rows(table, unique, values, unique != FILL)


def scatter_rows(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor) -> None:
    """``table[idx[valid]] = values[valid]`` in place, the other slots
    writing nothing (``mode="drop"``), with no host sync: an invalid slot
    rewrites the first valid slot's row with that slot's own value, an
    identical duplicate write; with no valid slot at all, row 0 gets its
    own value back. Never aliasing dropped slots onto a row with other
    values is what keeps that row's real update (the bug the JAX package
    fixed with ``mode="drop"``). The valid slots' indices are distinct."""
    first = valid.to(torch.int32).argmax()
    any_valid = valid[first]
    anchor = torch.where(any_valid, idx[first].to(torch.int64), 0)
    at = torch.where(valid, idx.to(torch.int64), anchor)
    fill_value = torch.where(any_valid, values[first], table[0])
    keep = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    table.index_copy_(0, at, torch.where(keep, values, fill_value))


def adagrad_rows(working: torch.Tensor, grad: torch.Tensor, unique: torch.Tensor,
                 accum: torch.Tensor, *, lr: float, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse Adagrad on a working set: ``(new_rows, new_accum)`` from the
    rows, their gradient and their accumulators, with the gradient of FILL
    slots zeroed. ``lr / x`` is a true f32 division (torch's ``float /
    tensor`` would multiply by a reciprocal)."""
    valid = (unique != FILL).to(torch.float32)[:, None]
    gw = grad.to(torch.float32) * valid
    gsq = torch.sum(gw * gw, dim=-1)
    accum_rows = accum + gsq
    denom = torch.sqrt(accum_rows) + eps
    scale = torch.full_like(denom, lr) / denom
    return working.to(torch.float32) - scale[:, None] * gw, accum_rows


def sparse_grad_update(params: torch.Tensor, state: SparseAdagradState, ids: torch.Tensor,
                       grad_rows: torch.Tensor, *, capacity: int, lr: float = 0.01,
                       eps: float = 1e-10) -> Tuple[torch.Tensor, SparseAdagradState]:
    """Adagrad update touching only the batch's unique rows, **in place**
    (the port's form of the JAX function's new arrays); returns them.

    ``ids``: int[N] global row ids of the batch (may repeat);
    ``grad_rows``: f32[N, D] gradient of each referenced row instance.
    """
    unique, inverse, _ = dedup(ids, capacity=capacity)
    g = scatter_unique_grads(grad_rows, inverse, capacity)       # (cap, D)
    safe = torch.where(unique == FILL, 0, unique).to(torch.int64)
    new_rows, accum_rows = adagrad_rows(take_rows(params, safe), g, unique,
                                        state.accum[safe], lr=lr, eps=eps)
    scatter_drop(params, unique, new_rows.to(params.dtype))
    scatter_drop(state.accum, unique, accum_rows)
    return params, state
