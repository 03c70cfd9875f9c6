"""View cleaning (paper §III "Clean views").

Views arrive with null values and semi-structured payloads (JSON). Cleaning
fills nulls, extracts required fields from semi-structured columns, and
applies application-specific instance filters, producing a structured table
where every column has a non-empty simple type.

These are HOST operators in the schedule (string/JSON work), exactly as the
paper assigns them; their numeric outputs flow to the device.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.fe.colstore import Columns, RaggedColumn
from repro_torch.fe.schema import ColType, Column, ViewSchema

# Null sentinels used by the raw log generator / real logs.
_NULL_INT = np.iinfo(np.int64).min
_NULL_FLOAT = np.nan


def fill_nulls(
    columns: Columns,
    schema: ViewSchema,
    *,
    extracted: Optional[Mapping[str, ColType]] = None,
) -> Columns:
    """Replace null sentinels with each column's fill value.

    ``extracted`` names columns that are not part of ``schema`` (typically
    produced by :func:`extract_json_fields`) but should be null-filled with
    their type's default as well, so callers never hand-roll a second
    sentinel pass.
    """
    extra_cols = tuple(Column(name, ctype) for name, ctype in (extracted or {}).items())
    for col in extra_cols:
        if col.name in {c.name for c in schema.columns}:
            raise ValueError(
                f"extracted column {col.name!r} shadows a schema column of "
                f"view {schema.name!r}")
    out: Columns = {}
    for col in schema.columns + extra_cols:
        if col.name not in columns:
            continue
        data = columns[col.name]
        if isinstance(data, RaggedColumn):
            values = np.where(data.values == _NULL_INT,
                              np.int64(col.default_fill()), data.values)
            out[col.name] = RaggedColumn(values=values, lengths=data.lengths)
        elif col.ctype is ColType.INT:
            out[col.name] = np.where(data == _NULL_INT, np.int64(col.default_fill()), data)
        elif col.ctype is ColType.FLOAT:
            out[col.name] = np.where(np.isnan(data), np.float32(col.default_fill()),
                                     data).astype(np.float32)
        elif col.ctype is ColType.STRING:
            fill = str(col.default_fill())
            out[col.name] = np.array([fill if (s is None or s == "") else s for s in data],
                                     dtype=object)
        else:
            out[col.name] = data
    # carry through any extra columns untouched
    for name, data in columns.items():
        out.setdefault(name, data)
    return out


def extract_json_fields(
    columns: Columns, source_col: str, fields: Mapping[str, ColType]
) -> Columns:
    """Parse a JSON string column into simple-typed columns (host op).

    Missing/unparseable fields become null sentinels so ``fill_nulls`` can
    handle them uniformly.
    """
    raw = columns[source_col]
    parsed: List[Dict] = []
    for s in raw:
        try:
            parsed.append(json.loads(s) if s else {})
        except (json.JSONDecodeError, TypeError):
            parsed.append({})
    out = dict(columns)
    for fname, ctype in fields.items():
        if ctype is ColType.INT:
            out[fname] = np.array(
                [int(p[fname]) if fname in p and p[fname] is not None else _NULL_INT
                 for p in parsed], np.int64)
        elif ctype is ColType.FLOAT:
            out[fname] = np.array(
                [float(p[fname]) if fname in p and p[fname] is not None else _NULL_FLOAT
                 for p in parsed], np.float32)
        elif ctype is ColType.STRING:
            out[fname] = np.array(
                [str(p.get(fname, "")) for p in parsed], dtype=object)
        else:
            raise ValueError(f"cannot extract {ctype} from JSON")
    return out


def filter_rows(columns: Columns, mask: np.ndarray) -> Columns:
    """Apply an application filter (paper: 'custom filter ... unrelated
    instances'), keeping rows where mask is True."""
    idx = np.nonzero(mask)[0]
    out: Columns = {}
    for name, data in columns.items():
        if isinstance(data, RaggedColumn):
            out[name] = data.take(idx)
        else:
            out[name] = data[idx]
    return out


def n_rows(columns: Columns) -> int:
    for data in columns.values():
        if isinstance(data, RaggedColumn):
            return data.n_rows
        return int(np.asarray(data).shape[0])
    return 0
