"""Bundled feature-engineering scenario presets.

Each module defines one :class:`~repro_torch.fe.spec.FeatureSpec` over the
synthetic ads views (``repro_torch.fe.datagen``):

* ``dlrm`` — DLRM-style dense + multi-hot shape matching
  ``configs/dlrm_mlperf.py`` (13 dense, 26 sparse fields, interest bag).

The ``ads_ctr`` and ``bst`` presets are not ported yet (ROADMAP A2).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.fe.spec import FeatureSpec
from repro_torch.fe.specs import dlrm

_REGISTRY: Dict[str, Callable[[], FeatureSpec]] = {
    "dlrm": dlrm.build_spec,
}


def list_specs() -> List[str]:
    return sorted(_REGISTRY)


def get_spec(name: str) -> FeatureSpec:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown feature spec {name!r} (available: {list_specs()})"
        ) from None


__all__ = ["get_spec", "list_specs"]
