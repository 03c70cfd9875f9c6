"""Wrapper of the DLRM dot-interaction kernel (``csrc/interaction_dot.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref

__all__ = ["pairwise_dots"]


def pairwise_dots(x: torch.Tensor) -> torch.Tensor:
    """DLRM feature interaction: all <x_i, x_j>, i>j, per batch row.

    ``x`` is f32[B, F, D]; returns f32[B, F*(F-1)/2] in
    ``np.tril_indices(F, -1)`` order. CPU tensors take the plain version,
    CUDA tensors the kernel (one launch). Forward only.
    """
    if x.dim() != 3:
        raise ValueError(f"expected (B, F, D), got {tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 fields to interact")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.device.type == "cpu":
        return dot_interaction_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, f, d = x.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = build.library().fbk_dot_interaction(
        x.data_ptr(), b, f, d, out.data_ptr(), stream)
    build.check(code, "fbk_dot_interaction")
    pairwise_dots.launches += 1
    return out


pairwise_dots.launches = 0
