"""Bundled feature-engineering scenario presets.

Each module defines one :class:`~repro_torch.fe.spec.FeatureSpec` over the
synthetic ads views (``repro_torch.fe.datagen``):

* ``ads_ctr`` — the paper's standard ads pipeline (8 sparse fields, 6+3
  dense, 3x16 sequences; the JAX driver's default ``--spec``);
* ``dlrm`` — DLRM-style dense + multi-hot shape matching
  ``configs/dlrm_mlperf.py`` (13 dense, 26 sparse fields, interest bag);
* ``bst`` — behavior-sequence shape matching ``configs/bst.py`` (4 sparse
  fields, a 20-step behavior sequence, no dense block).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.fe.spec import FeatureSpec
from repro_torch.fe.specs import ads_ctr, bst, dlrm

_REGISTRY: Dict[str, Callable[[], FeatureSpec]] = {
    "ads_ctr": ads_ctr.build_spec,
    "dlrm": dlrm.build_spec,
    "bst": bst.build_spec,
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
