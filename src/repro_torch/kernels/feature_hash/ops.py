"""Wrapper of the feature-hash meta-kernel (``csrc/feature_hash.cu``).

A program is a static tuple of ``(kind, a_col, b_col, field_size)`` ops over
int32[K, N] columns (see :func:`repro_torch.kernels.feature_hash.ref.
hash_layer_ref` for the semantics); the whole program runs in one launch.
A program is validated and packed into the kernel's int32 table once per
``(program, K)`` (:func:`packed_program`); each call then checks only the
tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.feature_hash.ref import hash_layer_ref

OpProgram = Tuple[Tuple[str, int, int, int], ...]

_KIND_CODES = {"cross": 0, "hash": 1, "mod": 2}   # as in csrc/feature_hash.cu
MAX_OPS = 64                                        # kMaxOps in the kernel

__all__ = ["MAX_OPS", "OpProgram", "PackedProgram", "packed_program", "run_hash_layer",
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
    CUDA tensors the kernel (one launch)."""
    if cols.dim() != 2:
        raise ValueError(f"expected int32[K, N] columns, got shape {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"expected int32 columns, got {cols.dtype}")
    packed = packed_program(program, cols.shape[0])
    if cols.device.type == "cpu":
        return hash_layer_ref(cols, program=packed.program)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    if not cols.is_contiguous():
        raise ValueError("columns must be contiguous")
    n_ops = len(packed.program)
    if not 0 < n_ops <= MAX_OPS:
        raise ValueError(f"program needs 1..{MAX_OPS} ops, got {n_ops}")
    n = cols.shape[1]
    out = torch.empty((n_ops, n), dtype=torch.int32, device=cols.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = build.library().fbk_hash_layer(
        cols.data_ptr(), n, packed.address, n_ops, out.data_ptr(), stream)
    build.check(code, "fbk_hash_layer")
    run_hash_layer.launches += 1
    return out


run_hash_layer.launches = 0
