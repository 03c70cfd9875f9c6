"""Wrappers of the DLRM dot-interaction kernels (``csrc/interaction_dot.cu``).

:func:`pairwise_dots` goes through :class:`InteractionDot`, an autograd
Function whose forward and backward are each one kernel launch on the card
and the plain versions of ``ref.py`` on the CPU (the CPU backward is the
formula, not autograd of the plain forward). Every device gets the same
input checks (rank, float32, contiguity, ``dy``'s shape) before the
wrapper branches on it. On ``meta`` tensors each returns an empty output
and charges its kernel's work to
:mod:`repro_torch.kernels.cost`: the forward ``2*B*P*D`` FLOPs and
``4*(B*F*D + B*P)`` bytes, the backward ``4*B*P*D`` FLOPs and
``4*(2*B*F*D + B*P)`` bytes, with ``P = F*(F-1)/2`` (only the lower
pairs; XLA's ``einsum`` in the JAX package computes all ``F*F``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.interaction_dot.ref import (
    dot_interaction_bwd_ref,
    dot_interaction_ref,
)

__all__ = ["InteractionDot", "pairwise_dots", "pairwise_dots_backward"]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, what: str) -> None:
    """The checks every device shares: float32, a device a wrapper serves,
    contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"expected float32 {what}, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {t.device} for {what}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return dot_interaction_ref(x)
    b, f, d = x.shape
    p = f * (f - 1) // 2
    out = torch.empty((b, p), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        cost.charge("interaction_dot", flops=2 * b * p * d, nbytes=4 * (b * f * d + b * p))
        return out
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
    tensors the kernel (one launch), meta tensors the shape alone."""
    b, f, d = x.shape
    p = f * (f - 1) // 2
    if tuple(dy.shape) != (b, p):
        raise ValueError(f"dy shape {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    _check(x, "x")
    _check(dy, "dy")
    if x.device != dy.device:
        raise ValueError(f"x on {x.device} and dy on {dy.device}")
    if x.device.type == "cpu":
        return dot_interaction_bwd_ref(x, dy)
    dx = torch.empty_like(x)
    if x.device.type == "meta":
        cost.charge("interaction_dot_backward", flops=4 * b * p * d,
                    nbytes=4 * (2 * b * f * d + b * p))
        return dx
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
    CUDA tensors the kernels (one launch forward, one backward), meta
    tensors the shapes alone, their work charged to
    :mod:`repro_torch.kernels.cost`.
    """
    if x.dim() != 3:
        raise ValueError(f"expected (B, F, D), got {tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 fields to interact")
    _check(x, "x")
    return InteractionDot.apply(x)


pairwise_dots.launches = 0
pairwise_dots_backward.launches = 0
