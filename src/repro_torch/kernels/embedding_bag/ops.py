"""Wrapper of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

:func:`bag_lookup` is the port of the JAX package's entry point
``repro.kernels.embedding_bag.ops.bag_lookup``: a weighted EmbeddingBag
over a working-set table (ids already remapped into ``[0, U)``). Its path
caller is the scoring pass of ``repro_torch.examples.serve_ctr``, which
pools the behaviour sequence with it; the train steps gather with a plain
gather in both packages, and the JAX kernel has no gradient rule, so the
kernel has no backward (ROADMAP B4).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["bag_lookup"]


def bag_lookup(ids: torch.Tensor, weights: torch.Tensor, table: torch.Tensor,
               *, use_kernel: bool = True) -> torch.Tensor:
    """Weighted EmbeddingBag: ``out[b] = sum_l weights[b,l] * table[ids[b,l]]``.

    ``ids`` int32[B, L], ``weights`` [B, L] (0 disables a slot, whose id is
    then never read), ``table`` f32[U, D]; returns f32[B, D]. An id outside
    ``[0, U)`` contributes 0. CPU tensors, or ``use_kernel=False``, take the
    plain version; CUDA tensors the kernel (one launch on the current
    stream). The kernel has no backward: with grad mode on and a ``table``
    or ``weights`` that requires grad, a CUDA call raises.
    """
    if ids.dim() != 2 or tuple(weights.shape) != tuple(ids.shape) or table.dim() != 2:
        raise ValueError(f"bad shapes ids={tuple(ids.shape)} w={tuple(weights.shape)} "
                         f"table={tuple(table.shape)}")
    if not use_kernel or table.device.type == "cpu":
        return embedding_bag_ref(ids, weights, table)
    for name, t in (("ids", ids), ("weights", weights), ("table", table)):
        if t.device != table.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}; the kernel takes CUDA tensors "
                             f"on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ids.dtype != torch.int32:
        raise TypeError(f"expected int32 ids, got {ids.dtype}")
    if table.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"expected float32 weights and table, got {weights.dtype}, "
                        f"{table.dtype}")
    if torch.is_grad_enabled() and (table.requires_grad or weights.requires_grad):
        raise RuntimeError(
            "bag_lookup's CUDA kernel has no backward (ROADMAP B4: the JAX "
            "kernel has none to port); call it under torch.no_grad() or on "
            "tensors that do not require grad")
    b, l = ids.shape
    u, d = table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    code = build.library().fbk_embedding_bag(
        ids.data_ptr(), weights.data_ptr(), b, l, table.data_ptr(), u, d,
        out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream)
    build.check(code, "fbk_embedding_bag")
    bag_lookup.launches += 1
    return out


bag_lookup.launches = 0
