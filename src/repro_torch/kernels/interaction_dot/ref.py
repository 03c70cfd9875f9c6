"""Plain PyTorch version of the DLRM dot-interaction kernel."""

from __future__ import annotations

import torch


def dot_interaction_ref(x: torch.Tensor) -> torch.Tensor:
    """Strictly-lower-triangle pairwise dots: f32[B, F*(F-1)/2], pairs in
    ``np.tril_indices(F, -1)`` order (``torch.tril_indices`` is the same
    row-major order)."""
    _, f, _ = x.shape
    x = x.to(torch.float32)
    scores = torch.einsum("bfd,bgd->bfg", x, x)
    rows, cols = torch.tril_indices(f, f, -1, device=x.device)
    return scores[:, rows, cols]
