"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every arch of the JAX package is registered: the recsys configs, the LM
configs (the dense yi and qwen, the MoE DeepSeek ones) and the gnn config
(``pna``). Each :class:`ArchSpec` carries its published config, its dry-run
shapes and the ``build_cell`` that makes a dry-run :class:`Cell` of it
(:mod:`repro_torch.configs.base`, all of the JAX package's; the
model-parallel forms its cells would run on a mesh stay ROADMAP A item 6).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchSpec, Cell, dp_axes_for


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


__all__ = ["ArchSpec", "Cell", "dp_axes_for", "get_arch", "list_archs", "registry"]
