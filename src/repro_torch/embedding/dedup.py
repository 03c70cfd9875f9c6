"""Per-batch working-set construction (dedup of sparse ids).

The hierarchical GPU parameter server's key observation ([37], §II-B): the
number of *referenced* parameters in a mini-batch fits device memory because
inputs are sparse. Before any table access, a batch's ids are deduplicated
and remapped to a dense local index space.

:func:`dedup` has a static working-set capacity, like its JAX counterpart
(``jnp.unique(size=, fill_value=FILL)``), and is written with sort, cumsum
and scatter so it never waits on the device for the unique count.
:func:`dedup_np` is the host twin used by the hierarchical PS pull path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Sentinel for unused working-set slots (never a valid row id).
FILL = 2**31 - 1

# Legal id range: ids must be in [0, 2**31 - 1). The upper bound is
# exclusive because FILL == 2**31 - 1 is the padding sentinel.
MAX_ID = 2**31 - 1


def dedup(ids: torch.Tensor, *, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate a batch of sparse ids into a fixed-capacity working set.

    Args:
      ids: int[...] batch of row ids, each in ``[0, MAX_ID)``.
      capacity: static upper bound on unique ids (working-set size).

    Returns (bit for bit what the JAX ``dedup`` returns):
      unique:  int32[capacity] the sorted unique ids, FILL-padded; when the
               batch holds more than ``capacity`` unique ids only the
               smallest ``capacity`` are kept;
      inverse: int32[ids.shape] position of each id among ALL sorted unique
               ids (so it can reach past ``capacity`` on overflow);
      count:   int32[] number of non-FILL slots in ``unique``.
    """
    flat = ids.reshape(-1).to(torch.int32)
    vals, order = torch.sort(flat)
    is_new = torch.ones_like(vals, dtype=torch.bool)
    is_new[1:] = vals[1:] != vals[:-1]
    pos = torch.cumsum(is_new, 0, dtype=torch.int64) - 1
    inverse = torch.empty_like(pos).scatter_(0, order, pos)
    # Scatter each run's first value to its slot; duplicates and overflow
    # go to the dump slot at index ``capacity``, cut off below.
    slot = torch.where(is_new & (pos < capacity), pos, capacity)
    unique = torch.full((capacity + 1,), FILL, dtype=torch.int32, device=ids.device)
    unique.scatter_(0, slot, vals)
    unique = unique[:capacity]
    count = (unique != FILL).sum().to(torch.int32)
    return unique, inverse.reshape(ids.shape).to(torch.int32), count


def undedup(rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Expand working-set rows back to per-slot rows: ``rows[inverse]``,
    with ``jnp.take``'s fill semantics (see :func:`take_rows`)."""
    return take_rows(rows, inverse)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 with ``jnp.take``'s default semantics:
    indices in ``[-n, 0)`` wrap, indices outside ``[-n, n)`` give NaN rows
    instead of faulting (a working-set overflow surfaces as NaN, as in the
    JAX package)."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx), 0)
    rows = table[safe]
    return rows.masked_fill(~valid.unsqueeze(-1), float("nan"))


def expected_unique(rows: int, vocab: int) -> float:
    """E[#unique] of ``rows`` uniform draws from a ``vocab``-id space:
    ``v (1 - (1 - 1/v)^n)`` (working-set capacity sizing)."""
    if rows <= 0 or vocab <= 0:
        return 0.0
    return vocab * (1.0 - (1.0 - 1.0 / vocab) ** rows)


def dedup_np(ids: np.ndarray, *, check_bounds: bool = True
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host dedup (exact size): returns (unique ids, inverse).

    Enforces the id-range contract the device path (:func:`dedup`) can only
    document: ids must be in ``[0, 2**31 - 1)``. Out-of-range ids would wrap
    negative / collide with ``FILL`` on device, so they are rejected here,
    at the host boundary, with a clear error instead of silent corruption.
    """
    flat = ids.reshape(-1)
    if check_bounds and flat.size:
        lo = int(flat.min())
        hi = int(flat.max())
        if lo < 0 or hi >= MAX_ID:
            raise ValueError(
                f"sparse ids out of range: min={lo} max={hi}, legal range "
                f"is [0, {MAX_ID}) — ids >= 2**31 wrap negative under the "
                f"device path's int32 cast and {MAX_ID} collides with the "
                f"FILL padding sentinel")
    unique, inverse = np.unique(flat, return_inverse=True)
    return unique.astype(np.int64), inverse.reshape(ids.shape).astype(np.int32)


def scatter_unique_grads(grad_rows: torch.Tensor, inverse: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Accumulate per-slot gradients onto the working set (transpose of
    :func:`undedup`): ``out[inverse[i]] += grad_rows[i]``, f32[capacity, D].
    Slots whose inverse falls outside ``[0, capacity)`` are dropped, as
    ``jax.ops.segment_sum`` drops out-of-range segments."""
    flat = grad_rows.reshape(-1, grad_rows.shape[-1])
    seg = inverse.reshape(-1).to(torch.int64)
    # out-of-range slots go to a dump row past the end, cut off below
    seg = torch.where((seg >= 0) & (seg < capacity), seg, capacity)
    out = torch.zeros((capacity + 1, flat.shape[-1]), dtype=flat.dtype, device=flat.device)
    return out.index_add_(0, seg, flat)[:capacity]


def dedup_hierarchical(ids: torch.Tensor, *, capacity: int, n_shards: int,
                       local_capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage dedup in one process: a local unique of each of the
    ``n_shards`` contiguous blocks of the flat ids (the row blocks a mesh of
    ``n_shards`` devices would hold), then a global unique of the pooled
    local uniques, the inverses composed.

    The single-controller form the sparse step's ``mesh=`` branch calls
    (JAX runs the local stage under ``shard_map``); deduping locally first
    shrinks the globally-sorted pool to ``n_shards x local_capacity`` ids.
    Semantics match :func:`dedup` (the same unique set, FILL-padded) as
    long as ``local_capacity`` bounds every block's unique count; an id a
    block's stage 1 drops gets the inverse ``-2**31``, as in JAX.
    """
    flat = ids.reshape(-1).to(torch.int32)
    blocks = flat.reshape(n_shards, -1)
    local = [dedup(b, capacity=local_capacity) for b in blocks]
    pool = torch.cat([u for u, _, _ in local])              # (n_shards * cap_loc,)
    unique, inv_pool, count = dedup(pool, capacity=capacity)
    inv_pool = inv_pool.reshape(n_shards, local_capacity).to(torch.int64)
    # compose: element e of block s -> local inverse -> its pooled slot; an
    # id stage 1 dropped (inverse past local_capacity) gets INT32_MIN, the
    # fill of JAX's take_along_axis
    local_inv = torch.stack([inv for _, inv, _ in local]).to(torch.int64)
    final_inv = torch.gather(inv_pool, 1, local_inv.clamp(max=local_capacity - 1))
    final_inv = torch.where(local_inv < local_capacity, final_inv, -2**31)
    return unique, final_inv.reshape(ids.shape).to(torch.int32), count


def dedup_two_stage_local(local_ids: torch.Tensor, *, capacity: int, local_capacity: int,
                          group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage dedup from inside one rank of a mesh (the mesh train
    step's form): a local unique (stage 1, bounding the pooled sort to
    ``n_ranks x local_capacity`` ids) -> an all-gather of the FILL-padded
    local uniques over ``group`` (the default group when None; no gather
    without an initialized process group) -> a global unique of the pool
    (stage 2, the same on every rank). The local inverse is recovered by
    ``searchsorted`` against the sorted global uniques, which is exactly
    :func:`dedup`'s inverse (the position in the sorted uniques), so on one
    rank the result is bitwise :func:`dedup`'s.

    Returns ``(unique, inverse, count, local_count)``: ``unique``/``count``
    the same on every rank, ``inverse`` for this rank's ``local_ids``,
    ``local_count`` this rank's stage-1 unique count. ``local_capacity``
    must bound this rank's unique count, or stage 1 drops its largest ids.
    """
    import torch.distributed as dist

    flat = local_ids.reshape(-1).to(torch.int32)
    local_u, _, local_count = dedup(flat, capacity=local_capacity)
    if dist.is_available() and dist.is_initialized():
        parts = [torch.empty_like(local_u) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local_u, group=group)
        pool = torch.cat(parts)
    else:
        pool = local_u
    unique, _, count = dedup(pool, capacity=capacity)
    # every local id is in `unique` (sorted), so searchsorted is exactly
    # the unique's inverse for this rank's slice of the batch
    inverse = torch.searchsorted(unique, flat).to(torch.int32)
    return unique, inverse.reshape(local_ids.shape), count, local_count
