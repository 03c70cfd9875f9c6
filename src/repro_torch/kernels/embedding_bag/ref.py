"""Plain PyTorch versions of the EmbeddingBag kernel: gather + weighted sum.

They follow the TPU kernel (``src/repro/kernels/embedding_bag/kernel.py``)
where the JAX package's own oracle differs from it: an id outside
``[0, U)`` contributes 0, as no one-hot vocab block matches it, where
``jnp.take`` gives NaN for ``id >= U`` and wraps a negative id. A slot
whose weight is 0 contributes 0 and its row is never read.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, weights: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_l weights[b,l] * table[ids[b,l]] via gather: f32[B, D]."""
    u, d = table.shape
    live = (weights != 0) & (ids >= 0) & (ids < u)
    if u == 0:
        return torch.zeros((ids.shape[0], d), dtype=table.dtype, device=table.device)
    rows = table[torch.where(live, ids, 0).to(torch.int64)]           # (B, L, D)
    w = torch.where(live, weights, 0).to(table.dtype)
    return (rows * w[..., None]).sum(dim=1)


def embedding_bag_segment_ref(flat_ids: torch.Tensor, segment_ids: torch.Tensor,
                              table: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Ragged form (flat ids + their segment ids), unweighted sum:
    f32[n_segments, D]."""
    out = torch.zeros((n_segments, table.shape[1]), dtype=table.dtype, device=table.device)
    return out.index_add_(0, segment_ids.to(torch.int64), table[flat_ids.to(torch.int64)])
