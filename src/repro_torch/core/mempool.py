"""Block-level memory pool with prefix-sum allocation (paper §V, Alg. 1).

The paper's mechanism: each GPU thread computes its required size; a parallel
prefix sum over the block yields per-thread offsets; one thread bumps a global
``idle_memory_head`` with ``atomic_add``; the pool is reset (O(1) pointer
rewind) after every meta-kernel, because layer-wise scheduling makes all
allocations of a layer dead once the layer's barrier passes.

* :func:`plan_offsets` — the prefix-sum offset plan as torch ops.
* :class:`ArenaPool` — the host-side pool object: a flat arena's bump
  pointer, block allocation and the O(1) reset. The device side of Alg. 1 is
  the ``mempool_alloc`` CUDA kernel (:mod:`repro_torch.kernels.mempool_alloc`);
  :meth:`ArenaPool.commit_block` advances the pool by a block the kernel
  placed, and :meth:`ArenaPool.alloc_block` places one on the host. The tests
  hold the two against each other.

A copy of the JAX package's ``core/mempool.py``; alignment is 128 units
(bytes, where the device feed uses it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

ALIGN = 128  # the paper's 128-byte alignment


def align_up(x, align: int = ALIGN):
    """Round ``x`` up to a multiple of ``align`` (ints, arrays and tensors)."""
    return (x + align - 1) // align * align


def plan_offsets(sizes: torch.Tensor, *, align: int = ALIGN
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1 lines 1–4 as a pure function.

    Args:
      sizes: int[N] requested sizes per "thread" (per instance).
      align: alignment granularity.

    Returns:
      offsets: int32[N] start offset of each request in the arena.
      total:   int32[]  total arena units consumed (aligned).

    Sums are taken in int64; callers keep the total within int32
    (:meth:`repro_torch.core.devicefeed.FeedLayout.plan` checks it).
    """
    aligned = align_up(sizes.to(torch.int64), align)
    inclusive = torch.cumsum(aligned, 0)
    offsets = inclusive - aligned
    total = inclusive[-1] if sizes.shape[0] > 0 else torch.zeros((), dtype=torch.int64)
    return offsets.to(torch.int32), total.to(torch.int32)


@dataclasses.dataclass
class Allocation:
    offset: int
    size: int


class ArenaPool:
    """Pre-allocated flat pool with bump allocation and O(1) reset.

    Mirrors Fig. 5: ``idle_memory_head`` advances by the block's total
    (prefix_N); ``reset()`` rewinds it to the start after each meta-kernel.
    """

    def __init__(self, capacity: int, *, align: int = ALIGN):
        if capacity % align:
            raise ValueError(f"capacity must be {align}-aligned, got {capacity}")
        self.capacity = int(capacity)
        self.align = align
        self._head = 0
        self._high_water = 0
        self.n_resets = 0
        self.n_allocs = 0

    @property
    def head(self) -> int:
        return self._head

    @property
    def high_water(self) -> int:
        """Peak usage across resets — sizing feedback for deployments."""
        return self._high_water

    def alloc_block(self, sizes: Sequence[int]) -> List[Allocation]:
        """Allocate for a whole block of requests at once (Alg. 1), placing
        it on the host: one prefix sum + one head bump, regardless of
        ``len(sizes)``."""
        sizes_arr = np.asarray(sizes, dtype=np.int64)
        if sizes_arr.size == 0:
            return []
        if (sizes_arr < 0).any():
            raise ValueError("negative allocation size")
        aligned = align_up(sizes_arr, self.align)
        prefix = np.cumsum(aligned)
        return self.commit_block(prefix - aligned, sizes_arr, int(prefix[-1]))

    def commit_block(self, offsets: Sequence[int], sizes: Sequence[int],
                     total: int) -> List[Allocation]:
        """Bump the head by a block placed elsewhere (the ``mempool_alloc``
        kernel): ``offsets`` are the block's exclusive scan and ``total`` its
        aligned sum. Returns the block's allocations, based at the old head."""
        base = self._head  # "atomic_add(idle_memory_head, prefix_N)"
        if base + total > self.capacity:
            raise MemoryError(
                f"arena exhausted: head={base} request={total} capacity={self.capacity}"
            )
        self._head = base + int(total)
        self._high_water = max(self._high_water, self._head)
        self.n_allocs += 1
        return [Allocation(offset=base + int(o), size=int(s))
                for o, s in zip(offsets, sizes)]

    def reset(self) -> None:
        """O(1) batch free after a meta-kernel (paper §V 'Reset')."""
        self._head = 0
        self.n_resets += 1


def required_capacity(layer_sizes: Sequence[Sequence[int]], *, align: int = ALIGN) -> int:
    """Size a pool so every layer's total allocation fits (reset between layers).

    The paper assumes "the total required memory for dynamic allocations
    [per layer] fits the GPU memory"; this helper computes that bound from
    the schedule's static cost model so the assumption is checked, not hoped.
    """
    worst = 0
    for sizes in layer_sizes:
        arr = np.asarray(list(sizes), dtype=np.int64)
        if arr.size == 0:
            continue
        worst = max(worst, int(align_up(arr, align).sum()))
    return int(align_up(worst, align))
