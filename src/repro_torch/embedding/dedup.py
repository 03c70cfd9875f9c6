"""Per-batch working-set construction (dedup of sparse ids).

The hierarchical GPU parameter server's key observation ([37], §II-B): the
number of *referenced* parameters in a mini-batch fits device memory because
inputs are sparse. Before any table access, a batch's ids are deduplicated
and remapped to a dense local index space.

:func:`dedup` has a static working-set capacity, like its JAX counterpart
(``jnp.unique(size=, fill_value=FILL)``), and is written with sort, cumsum
and scatter so it never waits on the device for the unique count.
"""

from __future__ import annotations

from typing import Tuple

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
