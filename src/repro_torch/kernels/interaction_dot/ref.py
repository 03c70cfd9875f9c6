"""Plain PyTorch versions of the DLRM dot-interaction kernels."""

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


def dot_interaction_bwd_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`dot_interaction_ref` written from the formula:
    ``dx = (G + G^T) x``, where ``G`` f32[B, F, F] holds ``dy`` at the
    strictly-lower-triangle pairs and zeros elsewhere."""
    b, f, _ = x.shape
    rows, cols = torch.tril_indices(f, f, -1, device=x.device)
    g = torch.zeros((b, f, f), dtype=torch.float32, device=x.device)
    g[:, rows, cols] = dy.to(torch.float32)
    return torch.einsum("bfg,bgd->bfd", g + g.transpose(1, 2), x.to(torch.float32))
