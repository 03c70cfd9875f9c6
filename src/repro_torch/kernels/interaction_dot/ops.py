"""Wrappers of the DLRM dot-interaction kernels (``csrc/interaction_dot.cu``).

:func:`pairwise_dots` goes through :class:`InteractionDot`, an autograd
Function whose forward and backward are each one kernel launch on the card
and the plain versions of ``ref.py`` on the CPU (the CPU backward is the
formula, not autograd of the plain forward).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interaction_dot.ref import (
    dot_interaction_bwd_ref,
    dot_interaction_ref,
)

__all__ = ["InteractionDot", "pairwise_dots", "pairwise_dots_backward"]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} for {what}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return dot_interaction_ref(x)
    _check_cuda(x, "x")
    b, f, d = x.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    code = build.library().fbk_dot_interaction(
        x.data_ptr(), b, f, d, out.data_ptr(), _stream(x))
    build.check(code, "fbk_dot_interaction")
    pairwise_dots.launches += 1
    return out


def pairwise_dots_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`pairwise_dots` with respect to ``x`` f32[B, F, D],
    given ``dy`` f32[B, F*(F-1)/2]. CPU tensors take the plain formula, CUDA
    tensors the kernel (one launch)."""
    b, f, d = x.shape
    if tuple(dy.shape) != (b, f * (f - 1) // 2):
        raise ValueError(f"dy shape {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    if dy.dtype != torch.float32:
        raise TypeError(f"expected float32 dy, got {dy.dtype}")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return dot_interaction_bwd_ref(x, dy)
    _check_cuda(x, "x")
    _check_cuda(dy, "dy")
    dx = torch.empty_like(x)
    if b == 0:
        return dx
    code = build.library().fbk_dot_interaction_bwd(
        x.data_ptr(), dy.data_ptr(), b, f, d, dx.data_ptr(), _stream(x))
    build.check(code, "fbk_dot_interaction_bwd")
    pairwise_dots_backward.launches += 1
    return dx


class InteractionDot(torch.autograd.Function):
    """Pairwise dots with a hand-written backward (one kernel each way)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, dy: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return pairwise_dots_backward(x, dy.contiguous())


def pairwise_dots(x: torch.Tensor) -> torch.Tensor:
    """DLRM feature interaction: all <x_i, x_j>, i>j, per batch row.

    ``x`` is f32[B, F, D]; returns f32[B, F*(F-1)/2] in
    ``np.tril_indices(F, -1)`` order, differentiable with respect to ``x``
    through :class:`InteractionDot`. CPU tensors take the plain versions,
    CUDA tensors the kernels (one launch forward, one backward).
    """
    if x.dim() != 3:
        raise ValueError(f"expected (B, F, D), got {tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 fields to interact")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return InteractionDot.apply(x)


pairwise_dots.launches = 0
pairwise_dots_backward.launches = 0
