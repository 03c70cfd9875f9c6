"""Column schemas for views and basic features (paper §III).

A *view* is a collection of raw data logs from one source (user purchase
history, query logs, ad inventory...). After the cleaning stage every column
has a non-empty, simple type: integer, float, or string (paper §III "Clean
views"). Strings never reach the device — the host stage hashes/parses them;
device columns are always numeric.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class ColType(enum.Enum):
    INT = "int"        # int64 ids/keys
    FLOAT = "float"    # float32 measures
    STRING = "string"  # host-only; object ndarray of str
    # Ragged int list (e.g. multi-hot feature ids, tokenized query); stored as
    # (values, row_lengths) pair of columns — the variable-length case that
    # motivates Alg. 1.
    INT_LIST = "int_list"

    @property
    def np_dtype(self):
        return {
            ColType.INT: np.int64,
            ColType.FLOAT: np.float32,
            ColType.STRING: object,
            ColType.INT_LIST: np.int64,
        }[self]


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    ctype: ColType
    nullable: bool = True
    # Fill used by the cleaning stage for nulls (paper: "fill the null values").
    null_fill: object = None

    def default_fill(self):
        if self.null_fill is not None:
            return self.null_fill
        return {
            ColType.INT: np.int64(0),
            ColType.FLOAT: np.float32(0.0),
            ColType.STRING: "",
            ColType.INT_LIST: np.int64(0),
        }[self.ctype]


@dataclasses.dataclass(frozen=True)
class ViewSchema:
    name: str
    key: str                     # join key column (user_id, ad_id, ...)
    columns: Tuple[Column, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate columns in view {self.name!r}")
        if self.key not in names:
            raise ValueError(f"join key {self.key!r} not a column of view {self.name!r}")

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"view {self.name!r} has no column {name!r}")

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)
