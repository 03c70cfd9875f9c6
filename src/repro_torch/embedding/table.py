"""Packed multi-field embedding tables and their lookups.

* :class:`TableSpec` / :class:`MultiTable` — many logical tables (one per
  sparse field) packed into ONE physical (sum(vocab), dim) tensor with field
  offsets.
* :func:`lookup` — one embedding row per (row, field) id: a plain gather.
* :func:`lookup_dedup` — FeatureBox/[37] working-set path: dedup ids, gather
  the unique rows once, then expand on the device.

Sparse updates come with the training path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.embedding.dedup import FILL, dedup, take_rows, undedup


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One logical embedding table (one sparse field)."""

    name: str
    vocab: int
    dim: int


@dataclasses.dataclass(frozen=True)
class MultiTable:
    """Several logical tables packed into one physical array."""

    specs: Tuple[TableSpec, ...]
    dim: int

    @staticmethod
    def build(specs: Sequence[TableSpec]) -> "MultiTable":
        dims = {s.dim for s in specs}
        if len(dims) != 1:
            raise ValueError(f"all tables must share dim, got {dims}")
        return MultiTable(specs=tuple(specs), dim=dims.pop())

    @property
    def offsets(self) -> np.ndarray:
        """Row offset of each field in the packed array."""
        sizes = np.array([s.vocab for s in self.specs], np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    @property
    def total_rows(self) -> int:
        return int(sum(s.vocab for s in self.specs))

    def global_ids(self, field_ids: torch.Tensor) -> torch.Tensor:
        """Per-field local ids (B, F) -> packed global row ids (B, F), int32."""
        offs = torch.as_tensor(self.offsets.astype(np.int32), device=field_ids.device)
        return field_ids.to(torch.int32) + offs[None, :]

    def lookup_dedup(self, params: torch.Tensor, field_ids: torch.Tensor, *,
                     capacity: int) -> torch.Tensor:
        """Working-set lookup over per-field local ids: (B, F) -> (B, F, D)."""
        return lookup_dedup(params, self.global_ids(field_ids), capacity=capacity)


def lookup(params: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain embedding lookup: (...) ids -> (..., D) rows."""
    return take_rows(params, ids)


def lookup_dedup(params: torch.Tensor, ids: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """Working-set lookup: gather unique rows once, expand locally."""
    unique, inverse, _ = dedup(ids, capacity=capacity)
    safe = torch.where(unique == FILL, 0, unique)
    working = take_rows(params, safe)                 # (capacity, D) gather
    return undedup(working, inverse)                  # local expand
