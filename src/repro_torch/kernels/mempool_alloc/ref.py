"""Plain PyTorch version of the Alg. 1 allocator kernel."""

from __future__ import annotations

import torch

from repro_torch.core.mempool import ALIGN


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (jnp int32 overflow)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def alloc_offsets_ref(sizes: torch.Tensor, *, align: int = ALIGN):
    """Reference allocator: exclusive scan of aligned sizes.

    Returns ``(offsets int32[N], head int32[1])`` with the int32 arithmetic
    of the JAX package's ``alloc_offsets_ref``: ``(s + align - 1) // align *
    align`` with floor division, and sums that wrap in 32 bits. ``head`` is
    the total (``[0]`` for N = 0).
    """
    s = sizes.to(torch.int64)
    t = _wrap_int32(s + (align - 1)).to(torch.int64)
    aligned = _wrap_int32(torch.div(t, align, rounding_mode="floor") * align).to(torch.int64)
    inclusive = _wrap_int32(torch.cumsum(aligned, 0)).to(torch.int64)
    offsets = _wrap_int32(inclusive - aligned)
    head = (inclusive[-1:].to(torch.int32) if sizes.shape[0]
            else torch.zeros((1,), dtype=torch.int32, device=sizes.device))
    return offsets, head
