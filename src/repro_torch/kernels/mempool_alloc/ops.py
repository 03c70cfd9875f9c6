"""Wrappers of the Alg. 1 allocator kernel (``csrc/mempool_alloc.cu``).

:func:`alloc_offsets` runs the kernel on a tensor of sizes;
:func:`plan_block` is the host entry the device feed places each batch
with: plain ints in, ``(offsets, total)`` out, with the kernel's result
brought back through a small pinned buffer on the caller's stream.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mempool import ALIGN, align_up
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.mempool_alloc.ref import alloc_offsets_ref

__all__ = ["alloc_offsets", "plan_allocation", "plan_block"]

_INT32_MAX = np.iinfo(np.int32).max


@functools.lru_cache(maxsize=None)
def tile() -> int:
    """Requests one block of the kernel scans; N above it takes the
    multi-block form with its look-back workspace."""
    return int(build.library().fbk_alloc_offsets_tile())


def alloc_offsets(sizes: torch.Tensor, *, align: int = ALIGN
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Alg. 1 over ``sizes`` int32[N]: ``(offsets int32[N], head
    int32[1])``, where ``head[0]`` is the pool head after the bump (the
    aligned total). CPU tensors take the plain version, CUDA tensors the
    kernel (one launch on the current stream; above :func:`tile` requests
    a zero fill of its workspace goes first)."""
    if sizes.dim() != 1:
        raise ValueError(f"sizes must be rank-1, got {tuple(sizes.shape)}")
    if sizes.dtype != torch.int32:
        raise TypeError(f"expected int32 sizes, got {sizes.dtype}")
    if align <= 0:
        raise ValueError(f"align must be positive, got {align}")
    if sizes.device.type == "cpu":
        return alloc_offsets_ref(sizes, align=align)
    if sizes.device.type != "cuda":
        raise ValueError(f"unsupported device {sizes.device}")
    if not sizes.is_contiguous():
        raise ValueError("sizes must be contiguous")
    n = sizes.shape[0]
    offsets = torch.empty_like(sizes)
    head = torch.empty((1,), dtype=torch.int32, device=sizes.device)
    tiles = -(-n // tile())
    # two or more tiles: the ticket and one look-back status word per tile,
    # zeroed on this stream before the launch; the caching allocator is
    # stream-aware, so calls on other streams never share them
    workspace = (torch.zeros((tiles + 1,), dtype=torch.int64, device=sizes.device)
                 if tiles > 1 else None)
    stream = torch.cuda.current_stream(sizes.device).cuda_stream
    code = build.library().fbk_alloc_offsets(
        sizes.data_ptr(), n, align, offsets.data_ptr(), head.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        0 if workspace is None else tiles + 1, stream)
    build.check(code, "fbk_alloc_offsets")
    alloc_offsets.launches += 1
    return offsets, head


alloc_offsets.launches = 0


def plan_allocation(sizes: torch.Tensor, *, align: int = ALIGN
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan arena offsets for a block of requests on ``sizes``' device.

    Returns ``(offsets int32[N], head int32[1])``; callers compare ``head``
    against the pool's capacity before using the placement.
    """
    return alloc_offsets(sizes.to(torch.int32), align=align)


def plan_block(sizes: Sequence[int], *, align: int = ALIGN, device: DeviceLike = None,
               stream: Optional[torch.cuda.Stream] = None) -> Tuple[np.ndarray, int]:
    """Host entry: place a block of requests given as plain ints.

    Runs the allocator kernel on ``device`` (the card unless the caller
    asks for ``"cpu"``, which takes the plain version) and returns
    ``(offsets int64[N], total)``, equal to what
    :meth:`repro_torch.core.mempool.ArenaPool.alloc_block` places on a fresh
    pool. On the card the sizes go up and the result comes back through
    pinned buffers on ``stream`` (default: the current stream), and only
    that stream is waited for.

    Raises ``ValueError`` on a negative size and ``OverflowError``, before
    any launch, when the aligned total does not fit the kernel's int32
    offsets, as the pool's int64 bookkeeping would accept it.
    """
    reqs = np.asarray(list(sizes), dtype=np.int64)
    if reqs.ndim != 1:
        raise ValueError(f"sizes must be rank-1, got {reqs.shape}")
    if (reqs < 0).any():
        raise ValueError("negative allocation size")
    head_bound = sum(int(align_up(s, align)) for s in reqs)
    if head_bound > _INT32_MAX:
        raise OverflowError(
            f"allocation block needs {head_bound} aligned bytes, which "
            f"overflows the kernel's int32 offsets (max {_INT32_MAX}); "
            f"split the block or plan with ArenaPool.alloc_block (int64)")
    dev = resolve_device(device)
    if reqs.size == 0:
        return np.zeros((0,), np.int64), 0
    if dev.type == "cpu":
        offsets, head = plan_allocation(torch.from_numpy(reqs.astype(np.int32)), align=align)
        return offsets.numpy().astype(np.int64), int(head[0])
    stream = stream if stream is not None else torch.cuda.current_stream(dev)
    n = reqs.size
    # one pinned buffer: the sizes go up from [:n], the result comes back
    # into [n:] (offsets, then the head)
    io = torch.empty((2 * n + 1,), dtype=torch.int32, pin_memory=True)
    io[:n] = torch.from_numpy(reqs.astype(np.int32))
    with torch.cuda.stream(stream):
        offsets, head = plan_allocation(io[:n].to(dev, non_blocking=True), align=align)
        io[n:2 * n].copy_(offsets, non_blocking=True)
        io[2 * n:].copy_(head, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    out = io.numpy()
    return out[n:2 * n].astype(np.int64), int(out[2 * n])
