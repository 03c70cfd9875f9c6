"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every arch of the JAX package is registered: the recsys configs, the LM
configs (the dense yi and qwen, the MoE DeepSeek ones) and the gnn config
(``pna``). Of the JAX package's ``configs/base.py`` only the GNN shapes are
ported (:mod:`repro_torch.configs.base`); its dry-run cell machinery goes
with the dry run (ROADMAP A item 4(c)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # "recsys", "lm" or "gnn"
    config: Any                     # the published full-width config
    smoke: Callable[[], Any]        # a small config of the same shape class
    describe: str = ""


def registry() -> Dict[str, ArchSpec]:
    from repro_torch.configs import (autoint, bst, dcn_v2, deepseek_moe_16b, deepseek_v2_236b,
                                     dlrm_mlperf, pna, qwen2_5_14b, qwen2_5_32b, yi_9b)
    return {a.arch_id: a for a in (dlrm_mlperf.ARCH, dcn_v2.ARCH, autoint.ARCH, bst.ARCH,
                                   yi_9b.ARCH, qwen2_5_14b.ARCH, qwen2_5_32b.ARCH,
                                   deepseek_moe_16b.ARCH, deepseek_v2_236b.ARCH, pna.ARCH)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(reg)}")
    return reg[arch_id]


def list_archs() -> List[str]:
    return sorted(registry())


__all__ = ["ArchSpec", "get_arch", "list_archs", "registry"]
