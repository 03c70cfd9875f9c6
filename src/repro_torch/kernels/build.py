"""Build and load the port's CUDA kernels (``libfbkernels.so``).

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper) into position-independent
objects, which are then linked into one shared library with a plain C
interface and loaded with :mod:`ctypes`. Nothing here includes PyTorch's
headers, so a full build takes seconds.

The build runs at first use and lands in ``build/repro_torch/`` at the root
of the checkout; a digest of the sources and flags, stored beside the
library, decides whether an existing library is current.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libfbkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (restype, argtypes); every pointer and the stream are c_void_p
    "fbk_hash_layer": (ctypes.c_int, [_P, ctypes.c_int64, _P, ctypes.c_int32,
                                      _P, _P]),
    "fbk_dot_interaction": (ctypes.c_int, [_P, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, _P, _P]),
    "fbk_dot_interaction_bwd": (ctypes.c_int, [_P, _P, ctypes.c_int64, ctypes.c_int32,
                                               ctypes.c_int32, _P, _P]),
    "fbk_alloc_offsets": (ctypes.c_int, [_P, ctypes.c_int64, ctypes.c_int32, _P, _P, _P,
                                         ctypes.c_int64, _P]),
    "fbk_alloc_offsets_tile": (ctypes.c_int64, []),
    "fbk_embedding_bag": (ctypes.c_int, [_P, _P, ctypes.c_int64, ctypes.c_int32, _P,
                                         ctypes.c_int64, ctypes.c_int32, _P, _P]),
    "fbk_ws_grad_keys": (ctypes.c_int, [_P, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                                        _P, _P, _P]),
    "fbk_ws_grad_sum": (ctypes.c_int, [_P, _P, _P, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int32, _P, _P, _P, _P]),
    "fbk_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    library: Path
    seconds: float          # 0.0 when the library on disk was current
    ptxas_log: str          # nvcc's -Xptxas=-v report (registers, spills)


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or PATH."""
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
            "the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into ``build/repro_torch/libfbkernels.so``.

    Reuses the library on disk when its stored digest matches the sources;
    otherwise builds into a temporary directory and moves the result into
    place atomically. Raises ``RuntimeError`` with nvcc's output on failure.
    """
    srcs = sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    log = BUILD_DIR / "ptxas.log"
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return BuildResult(lib, 0.0, log.read_text() if log.is_file() else "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(srcs, objs)]
        reports = [(s, p.communicate()[0], p.returncode) for s, p in zip(srcs, procs)]
        failed = [f"{s.name} (exit {rc}):\n{out}" for s, out, rc in reports if rc]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        ptxas = "".join(f"== {s.name}\n{out}" for s, out, _ in reports)
        os.replace(tmp_lib, lib)
    log.write_text(ptxas)
    stamp.write_text(digest)
    return BuildResult(lib, time.perf_counter() - t0, ptxas)


def ptxas_lines(log: str, kernel: str) -> List[str]:
    """The ``-Xptxas -v`` lines of the kernels whose mangled name holds
    ``kernel``: each one's stack frame and spill line, then its registers."""
    lines, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "registers" in line):
            lines.append(line.strip())
    return lines


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every C entry's
    ``restype``/``argtypes`` declared so ctypes never truncates a pointer."""
    lib = ctypes.CDLL(str(build().library))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if code != 0:
        msg = library().fbk_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
