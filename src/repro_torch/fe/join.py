"""Multi-view join (paper §III "Join views" / "Merge features").

Joins are the memory-intensive operators of the pipeline — "large table joins
(which corresponds to a large dictionary lookup)" — so the scheduler places
them on HOST (CPU workers) by default, matching the paper.

``hash_join`` performs a left join of a probe table against one build view
keyed on a shared column. ``merge_on_instance`` is the final merge of
extracted features with basic features on ``instance_id``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.fe.colstore import Columns, RaggedColumn


def _build_index(keys: np.ndarray) -> Dict[int, int]:
    """Last-writer-wins hash index key -> row (dictionary build side)."""
    return {int(k): i for i, k in enumerate(keys)}


def hash_join(
    left: Columns,
    right: Columns,
    *,
    key: str,
    right_prefix: str = "",
    default_int: int = 0,
    default_float: float = 0.0,
) -> Columns:
    """Left-join ``right`` onto ``left`` by ``key`` (host dictionary lookup).

    Unmatched rows get type-appropriate defaults, mirroring the cleaned-view
    guarantee that columns stay non-empty. Output keeps left's row order.
    """
    lkeys = np.asarray(left[key])
    rkeys = np.asarray(right[key])
    index = _build_index(rkeys)
    match = np.array([index.get(int(k), -1) for k in lkeys], dtype=np.int64)
    matched = match >= 0
    safe = np.where(matched, match, 0)

    out: Columns = dict(left)
    for name, data in right.items():
        if name == key:
            continue
        out_name = f"{right_prefix}{name}"
        if out_name in out:
            raise ValueError(f"join output column collision: {out_name!r}")
        if isinstance(data, RaggedColumn):
            taken = data.take(safe)
            lengths = np.where(matched, taken.lengths, 0).astype(np.int32)
            # re-take to drop values of unmatched rows
            offs = taken.offsets()
            parts = [taken.values[offs[i]: offs[i] + lengths[i]]
                     for i in range(len(lengths))]
            values = (np.concatenate(parts) if parts
                      else np.zeros((0,), np.int64))
            out[out_name] = RaggedColumn(values=values, lengths=lengths)
        else:
            arr = np.asarray(data)
            taken = arr[safe]
            if arr.dtype == object:
                out[out_name] = np.array(
                    [taken[i] if matched[i] else "" for i in range(len(matched))],
                    dtype=object)
            elif np.issubdtype(arr.dtype, np.floating):
                out[out_name] = np.where(matched, taken, default_float).astype(arr.dtype)
            else:
                out[out_name] = np.where(matched, taken, default_int).astype(arr.dtype)
    return out


def join_views(
    base: Columns,
    views: Sequence[Tuple[Columns, str]],
    *,
    prefix_with_index: bool = True,
) -> Columns:
    """Join a sequence of (view, key) pairs onto a base table (paper Fig. 3).

    Each view may use a different key (user_id, ad_id, ...), matching the
    paper's "joined with particular keys such as user id, ads id, etc."
    """
    out = base
    for i, (view, key) in enumerate(views):
        prefix = f"v{i}_" if prefix_with_index else ""
        out = hash_join(out, view, key=key, right_prefix=prefix)
    return out


def merge_on_instance(
    extracted: Columns, basic: Columns, *, instance_key: str = "instance_id"
) -> Columns:
    """Final merge of extracted features with basic features (paper §III):
    'realized by a join operation on the instance id'."""
    return hash_join(extracted, basic, key=instance_key, right_prefix="basic_")


def bytes_of(columns: Columns) -> int:
    total = 0
    for data in columns.values():
        if isinstance(data, RaggedColumn):
            total += data.values.nbytes + data.lengths.nbytes
        else:
            arr = np.asarray(data)
            if arr.dtype == object:
                total += sum(len(str(s)) for s in arr)
            else:
                total += arr.nbytes
    return total
