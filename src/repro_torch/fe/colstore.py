"""Columnar chunk store (paper §III "Read views and basic features").

The paper cuts network I/O by (a) materializing frequently-used features as
*basic features* for reuse and (b) storing logs column-wise so a job reads
only the columns it needs. This module is that column store: each chunk of a
view is a directory with one ``.npy`` file per column plus a tiny manifest,
so ``read_columns`` touches exactly the requested columns' bytes.

Ragged INT_LIST columns are stored as two files (``<col>.values.npy`` and
``<col>.lengths.npy``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence

import numpy as np


MANIFEST = "manifest.json"


@dataclasses.dataclass
class RaggedColumn:
    """Host-side ragged column: values concatenated, per-row lengths."""

    values: np.ndarray   # int64[sum(lengths)]
    lengths: np.ndarray  # int32[n_rows]

    @property
    def n_rows(self) -> int:
        return int(self.lengths.shape[0])

    def offsets(self) -> np.ndarray:
        """Exclusive prefix sum of lengths (row start offsets) — Alg. 1 shape."""
        return np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)

    def row(self, i: int) -> np.ndarray:
        off = self.offsets()
        return self.values[off[i]: off[i] + self.lengths[i]]

    def take(self, idx: np.ndarray) -> "RaggedColumn":
        off = self.offsets()
        parts = [self.values[off[i]: off[i] + self.lengths[i]] for i in idx]
        lengths = self.lengths[idx]
        values = np.concatenate(parts) if parts else np.zeros((0,), np.int64)
        return RaggedColumn(values=values, lengths=lengths)


Columns = Dict[str, object]  # str -> np.ndarray | RaggedColumn


class ColumnStore:
    """Chunked column-wise storage rooted at a directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ----------------------------------------------------------------- write
    def write_chunk(self, view: str, chunk_id: int, columns: Mapping[str, object]) -> str:
        cdir = self._chunk_dir(view, chunk_id)
        os.makedirs(cdir, exist_ok=True)
        manifest: Dict[str, Dict] = {}
        n_rows = None
        for name, col in columns.items():
            if isinstance(col, RaggedColumn):
                np.save(os.path.join(cdir, f"{name}.values.npy"), col.values)
                np.save(os.path.join(cdir, f"{name}.lengths.npy"), col.lengths)
                manifest[name] = {"kind": "ragged", "rows": col.n_rows}
                rows = col.n_rows
            else:
                arr = np.asarray(col)
                if arr.dtype == object:
                    # Strings: store as encoded bytes with per-row lengths
                    # (host-only column).
                    enc = [str(s).encode("utf-8") for s in arr]
                    lengths = np.array([len(b) for b in enc], np.int32)
                    values = np.frombuffer(b"".join(enc), dtype=np.uint8).copy()
                    np.save(os.path.join(cdir, f"{name}.values.npy"), values)
                    np.save(os.path.join(cdir, f"{name}.lengths.npy"), lengths)
                    manifest[name] = {"kind": "string", "rows": int(arr.shape[0])}
                    rows = int(arr.shape[0])
                else:
                    np.save(os.path.join(cdir, f"{name}.npy"), arr)
                    manifest[name] = {"kind": "dense", "rows": int(arr.shape[0])}
                    rows = int(arr.shape[0])
            if n_rows is None:
                n_rows = rows
            elif n_rows != rows:
                raise ValueError(f"column {name!r} row count {rows} != {n_rows}")
        with open(os.path.join(cdir, MANIFEST), "w") as f:
            json.dump({"columns": manifest, "n_rows": n_rows}, f)
        return cdir

    # ------------------------------------------------------------------ read
    def chunks(self, view: str) -> List[int]:
        vdir = os.path.join(self.root, view)
        if not os.path.isdir(vdir):
            return []
        out = []
        for d in os.listdir(vdir):
            if d.startswith("chunk_"):
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def read_columns(self, view: str, chunk_id: int, names: Sequence[str]) -> Columns:
        """Read ONLY the requested columns (the column-store I/O saving)."""
        cdir = self._chunk_dir(view, chunk_id)
        with open(os.path.join(cdir, MANIFEST)) as f:
            manifest = json.load(f)["columns"]
        out: Columns = {}
        for name in names:
            meta = manifest.get(name)
            if meta is None:
                raise KeyError(f"view {view!r} chunk {chunk_id} has no column {name!r}")
            if meta["kind"] == "dense":
                out[name] = np.load(os.path.join(cdir, f"{name}.npy"))
            elif meta["kind"] == "ragged":
                out[name] = RaggedColumn(
                    values=np.load(os.path.join(cdir, f"{name}.values.npy")),
                    lengths=np.load(os.path.join(cdir, f"{name}.lengths.npy")),
                )
            elif meta["kind"] == "string":
                values = np.load(os.path.join(cdir, f"{name}.values.npy"))
                lengths = np.load(os.path.join(cdir, f"{name}.lengths.npy"))
                offs = np.concatenate([[0], np.cumsum(lengths)])
                buf = values.tobytes()
                out[name] = np.array(
                    [buf[offs[i]: offs[i + 1]].decode("utf-8") for i in range(len(lengths))],
                    dtype=object,
                )
            else:  # pragma: no cover
                raise ValueError(f"unknown column kind {meta['kind']!r}")
        return out

    def column_bytes(self, view: str, chunk_id: int, names: Sequence[str]) -> int:
        """Bytes that reading these columns costs (for the I/O accounting)."""
        cdir = self._chunk_dir(view, chunk_id)
        total = 0
        for name in names:
            for suffix in (".npy", ".values.npy", ".lengths.npy"):
                p = os.path.join(cdir, f"{name}{suffix}")
                if os.path.exists(p):
                    total += os.path.getsize(p)
        return total

    def n_rows(self, view: str, chunk_id: int) -> int:
        with open(os.path.join(self._chunk_dir(view, chunk_id), MANIFEST)) as f:
            return int(json.load(f)["n_rows"])

    def _chunk_dir(self, view: str, chunk_id: int) -> str:
        return os.path.join(self.root, view, f"chunk_{chunk_id:06d}")
