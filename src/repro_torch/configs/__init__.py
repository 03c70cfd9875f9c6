"""Architecture registry of the port: ``--arch <id>`` resolves here.

The recsys configs and the dense LM configs (yi, qwen) are registered; the
JAX package's dry-run cell machinery (``configs/base.py``) is not ported.
:data:`NOT_PORTED` names the JAX package's other archs, with their family
and the ROADMAP item that ports them, so the drivers can refuse them by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # "recsys" or "lm"
    config: Any                     # the published full-width config
    smoke: Callable[[], Any]        # a small config of the same shape class
    describe: str = ""


# The JAX package's archs without a port yet: arch id -> (family, ROADMAP item).
NOT_PORTED: Dict[str, Tuple[str, str]] = {
    "deepseek-moe-16b": ("lm", "A item 4(b)"),
    "deepseek-v2-236b": ("lm", "A item 4(b)"),
    "pna": ("gnn", "A item 4(b)"),
}


def registry() -> Dict[str, ArchSpec]:
    from repro_torch.configs import (autoint, bst, dcn_v2, dlrm_mlperf, qwen2_5_14b, qwen2_5_32b,
                                     yi_9b)
    return {a.arch_id: a for a in (dlrm_mlperf.ARCH, dcn_v2.ARCH, autoint.ARCH, bst.ARCH,
                                   yi_9b.ARCH, qwen2_5_14b.ARCH, qwen2_5_32b.ARCH)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(reg)}")
    return reg[arch_id]


def list_archs() -> List[str]:
    return sorted(registry())


def refuse_unported(arch_id: str) -> None:
    """Raise ``SystemExit`` naming the ROADMAP item for an arch of the JAX
    package that the port does not run yet; do nothing for a ported one."""
    if arch_id in NOT_PORTED:
        family, item = NOT_PORTED[arch_id]
        raise SystemExit(f"arch {arch_id!r} ({family}) is not ported yet (ROADMAP {item})")


__all__ = ["ArchSpec", "NOT_PORTED", "get_arch", "list_archs", "refuse_unported", "registry"]
