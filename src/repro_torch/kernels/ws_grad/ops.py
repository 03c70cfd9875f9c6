"""Wrapper of the working-set gradient kernels (``csrc/ws_grad.cu``).

:func:`gather_rows` is ``take_rows(rows, inverse)`` (``jnp.take``'s fill
semantics: indices in ``[-n, 0)`` wrap, any outside ``[-n, n)`` give a NaN
row) through :class:`GatherRows`, an autograd Function whose forward is that
same gather and ``masked_fill`` and whose backward is :func:`ws_grad`: the
sum of the gathered rows' gradients onto their rows, where an index outside
``[-n, n)`` contributes nothing (``masked_fill``'s backward followed by the
index backward, in one op). CPU tensors take the plain version of
``ref.py``; CUDA tensors the kernels: one launch that makes the slot keys,
a stable sort of them, then one that sums (the chunk and finish kernels).
On ``meta`` tensors the backward allocates what the card's does and charges
the kernels' work to :mod:`repro_torch.kernels.cost`: no FLOPs, and
``4*(N*D + n*D + 2*N)`` bytes (each gradient row read once, each output row
written once, a slot key and a sorted position read for each of the N
gathered rows).
"""

from __future__ import annotations

import torch

from repro_torch.embedding.dedup import take_rows
from repro_torch.kernels import build, cost
from repro_torch.kernels.ws_grad.ref import ws_grad_ref

__all__ = ["CHUNK", "GatherRows", "gather_rows", "ws_grad"]

CHUNK = 128   # sorted positions a warp sums (``kChunk`` in csrc/ws_grad.cu)


def ws_grad(grad: torch.Tensor, inverse: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gradient of :func:`gather_rows` with respect to ``rows`` f32[n_rows, D],
    given ``grad`` [..., D] of the gathered rows and ``inverse`` int32 or
    int64 of the same leading shape: ``out[s]`` sums ``grad`` over the
    positions whose index wraps to ``s``; a slot no position references is
    0. CPU tensors take the plain version; CUDA tensors the kernels, which
    add each slot's terms in a fixed order (chunks of :data:`CHUNK` sorted
    positions, then the chunks' partials in order), the same bits every
    call; meta tensors the shapes, their work charged."""
    d = grad.shape[-1]
    g = grad.reshape(-1, d)
    idx = inverse.reshape(-1)
    if g.shape[0] != idx.shape[0]:
        raise ValueError(f"grad {tuple(grad.shape)} does not match inverse "
                         f"{tuple(inverse.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"expected an int32 or int64 inverse, got {idx.dtype}")
    if g.device.type == "cpu":
        return ws_grad_ref(g, idx, n_rows)
    if g.device.type not in ("cuda", "meta") or idx.device != g.device:
        raise ValueError(f"grad on {g.device} and inverse on {idx.device}; the kernels "
                         f"take CUDA tensors on one device")
    if g.dtype != torch.float32:
        raise TypeError(f"expected a float32 grad, got {g.dtype}")
    if not 0 <= n_rows < 2**31:
        raise ValueError(f"{n_rows} rows: the slot keys are int32")
    g, idx = g.contiguous(), idx.contiguous()
    n = g.shape[0]
    meta = g.device.type == "meta"
    keys = torch.empty(n, dtype=torch.int32, device=g.device)
    marks = torch.empty(n_rows, dtype=torch.uint8, device=g.device)
    if not meta:
        code = build.library().fbk_ws_grad_keys(
            idx.data_ptr(), int(idx.dtype == torch.int64), n, n_rows, keys.data_ptr(),
            marks.data_ptr(), _stream(g))
        build.check(code, "fbk_ws_grad_keys")
    keys, order = torch.sort(keys, stable=True)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=g.device)
    carry = torch.empty((2 * -(-n // CHUNK), d), dtype=torch.float32, device=g.device)
    if meta:
        cost.charge("ws_grad", flops=0, nbytes=4 * (n * d + n_rows * d + 2 * n))
        return out
    code = build.library().fbk_ws_grad_sum(
        g.data_ptr(), keys.data_ptr(), order.data_ptr(), n, n_rows, d, out.data_ptr(),
        carry.data_ptr(), marks.data_ptr(), _stream(g))
    build.check(code, "fbk_ws_grad_sum")
    gather_rows.launches += 1
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class GatherRows(torch.autograd.Function):
    """``take_rows`` forward; :func:`ws_grad` backward."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(inverse)
        ctx.n_rows = rows.shape[0]
        return take_rows(rows, inverse)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (inverse,) = ctx.saved_tensors
        return ws_grad(grad, inverse, ctx.n_rows), None


def gather_rows(rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """``rows[inverse]`` along dim 0 with ``jnp.take``'s fill semantics,
    f32[*inverse.shape, D], differentiable with respect to ``rows``
    [n, D] through :class:`GatherRows`: its backward is :func:`ws_grad`
    (on the card one keys launch, a sort and one summing launch, counted
    in ``gather_rows.launches``)."""
    if rows.dim() != 2:
        raise ValueError(f"expected rows (n, D), got {tuple(rows.shape)}")
    return GatherRows.apply(rows, inverse)


gather_rows.launches = 0
