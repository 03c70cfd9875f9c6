"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the recsys configs this slice serves are registered; the JAX package's
dry-run cell machinery (``configs/base.py``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # "recsys" (the only family ported)
    config: Any                     # the published full-width config
    smoke: Callable[[], Any]        # a small config of the same shape class
    describe: str = ""


def registry() -> Dict[str, ArchSpec]:
    from repro_torch.configs import dlrm_mlperf
    return {a.arch_id: a for a in (dlrm_mlperf.ARCH,)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(reg)}")
    return reg[arch_id]


def list_archs() -> List[str]:
    return sorted(registry())


__all__ = ["ArchSpec", "get_arch", "list_archs", "registry"]
