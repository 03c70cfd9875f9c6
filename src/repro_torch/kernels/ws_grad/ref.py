"""Plain PyTorch version of the working-set gradient kernels."""

from __future__ import annotations

import torch


def ws_grad_ref(grad: torch.Tensor, inverse: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The gradient of ``take_rows(rows, inverse)`` with respect to ``rows``
    f32[n_rows, D], given ``grad`` f32[N, D] and ``inverse`` int[N]:
    ``out[s]`` is the sum of ``grad[i]`` over the positions ``i`` whose
    index wraps to ``s`` (``jnp.take``'s wrap of ``[-n_rows, 0)``), added
    in increasing ``i``; a position whose index lies outside ``[-n_rows,
    n_rows)`` goes to a dump row past the end, cut off below."""
    idx = inverse.reshape(-1).to(torch.int64)
    valid = (idx >= -n_rows) & (idx < n_rows)
    seg = torch.where(valid, torch.where(idx < 0, idx + n_rows, idx), n_rows)
    out = torch.zeros((n_rows + 1, grad.shape[-1]), dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, seg, grad.reshape(-1, grad.shape[-1]))[:n_rows]
