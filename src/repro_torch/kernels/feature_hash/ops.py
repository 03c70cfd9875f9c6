"""Wrapper of the feature-hash meta-kernel (``csrc/feature_hash.cu``).

A program is a static tuple of ``(kind, a_col, b_col, field_size)`` ops over
int32[K, N] columns (see :func:`repro_torch.kernels.feature_hash.ref.
hash_layer_ref` for the semantics). The kernel takes at most
``OPS_PER_LAUNCH`` ops a launch, so a longer program runs as consecutive
launches of at most that many ops, each writing its own contiguous rows of
the int32[n_ops, N] output. A program is validated and packed into the
kernel's int32 table once per ``(program, K)`` (:func:`packed_program`);
each call then checks only the tensor, with the same checks on every
device. On ``meta`` columns the wrapper returns an empty output and charges
each launch's work to :mod:`repro_torch.kernels.cost`: no FLOPs (integer
hashing) and ``4*(K + ops)*N`` bytes, its ``ops`` rows written and the
columns read once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.feature_hash.ref import hash_layer_ref

OpProgram = Tuple[Tuple[str, int, int, int], ...]

_KIND_CODES = {"cross": 0, "hash": 1, "mod": 2}   # as in csrc/feature_hash.cu
OPS_PER_LAUNCH = 64                                 # kMaxOps in the kernel

__all__ = ["OPS_PER_LAUNCH", "OpProgram", "PackedProgram", "packed_program", "run_hash_layer",
           "validate_program"]


class PackedProgram(NamedTuple):
    program: OpProgram      # the validated ops
    table: np.ndarray       # int32[n_ops, 4] rows of (kind code, a, b, m), read-only
    address: int            # the table's data pointer, for the C entry


def validate_program(program: Sequence[Tuple[str, int, int, int]], n_cols: int) -> OpProgram:
    prog = tuple(tuple(op) for op in program)
    for kind, a, b, m in prog:
        if kind not in _KIND_CODES:
            raise ValueError(f"unknown op kind {kind!r}")
        if not (0 <= a < n_cols) or (kind == "cross" and not (0 <= b < n_cols)):
            raise ValueError(f"column index out of range in {(kind, a, b, m)}")
        if m <= 0:
            raise ValueError(f"field_size must be positive in {(kind, a, b, m)}")
        if m >= 2**31:
            raise ValueError(f"field_size must fit int32 in {(kind, a, b, m)}")
    return prog  # type: ignore[return-value]


@functools.lru_cache(maxsize=256)
def _pack(program: OpProgram, n_cols: int) -> PackedProgram:
    # an invalid program raises here, and lru_cache keeps no result for it
    prog = validate_program(program, n_cols)
    table = np.asarray([(_KIND_CODES[k], a, b, m) for k, a, b, m in prog],
                       np.int32).reshape(len(prog), 4)
    table.flags.writeable = False
    return PackedProgram(prog, table, table.ctypes.data)


def packed_program(program: Sequence[Tuple[str, int, int, int]], n_cols: int) -> PackedProgram:
    """``program`` validated against ``n_cols`` columns and packed, made once
    per distinct ``(program, n_cols)`` and shared by every later call."""
    if not (isinstance(program, tuple) and all(type(op) is tuple for op in program)):
        program = tuple(tuple(op) for op in program)
    return _pack(program, n_cols)


def run_hash_layer(cols: torch.Tensor, program: Sequence[Tuple[str, int, int, int]]) -> torch.Tensor:
    """Run a fixed layer of hash/cross FE ops over stacked int32[K, N] id
    columns; returns int32[n_ops, N]. CPU tensors take the plain version,
    CUDA tensors the kernel (one launch per ``OPS_PER_LAUNCH`` ops), meta
    tensors the shape alone."""
    if cols.dim() != 2:
        raise ValueError(f"expected int32[K, N] columns, got shape {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"expected int32 columns, got {cols.dtype}")
    if cols.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {cols.device}")
    if not cols.is_contiguous():
        raise ValueError("columns must be contiguous")
    packed = packed_program(program, cols.shape[0])
    n_ops = len(packed.program)
    if n_ops == 0:
        raise ValueError("program needs at least one op")
    if cols.device.type == "cpu":
        return hash_layer_ref(cols, program=packed.program)
    k, n = cols.shape
    out = torch.empty((n_ops, n), dtype=torch.int32, device=cols.device)
    for start in range(0, n_ops, OPS_PER_LAUNCH):
        ops = min(OPS_PER_LAUNCH, n_ops - start)
        if cols.device.type == "meta":
            cost.charge("feature_hash", flops=0, nbytes=4 * (k + ops) * n)
            continue
        if n == 0:
            break
        code = build.library().fbk_hash_layer(
            cols.data_ptr(), n, packed.address + packed.table.strides[0] * start, ops,
            out[start].data_ptr(), torch.cuda.current_stream(cols.device).cuda_stream)
        build.check(code, "fbk_hash_layer")
        run_hash_layer.launches += 1
    return out


run_hash_layer.launches = 0
