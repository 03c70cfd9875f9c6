"""Binary record-shard format (``.fbshard``) for raw-log ingestion.

One shard file holds a set of named *tables* (the per-batch views of the ads
pipeline: impressions, user_profile, ...), each a set of named columns of the
three kinds the FE pipeline consumes:

* ``dense``  — fixed-width numeric ndarray (any numeric dtype, any shape
  whose leading axis is the row count),
* ``ragged`` — variable-length int lists per row
  (:class:`~repro_torch.fe.colstore.RaggedColumn`: concatenated values + lengths),
* ``string`` — variable-length UTF-8 strings per row (object ndarray),
  stored as a concatenated byte payload + per-row byte lengths.

File layout::

    +--------------------------------------------------------------+
    | header (24 B): magic "FBSHARD1" | version u32 | flags u32    |
    |                crc32(prev 16 B) u32 | reserved u32           |
    +--------------------------------------------------------------+
    | column payload parts, back to back (raw little-endian bytes) |
    +--------------------------------------------------------------+
    | index: JSON (tables -> columns -> parts{offset,nbytes,crc32})|
    +--------------------------------------------------------------+
    | trailer (24 B): index_offset u64 | index_len u64 |           |
    |                 crc32(index) u32 | magic "FBX1"              |
    +--------------------------------------------------------------+

Every payload part carries a CRC32 (verified on read by default) and the
index itself is checksummed from the trailer, so torn/corrupt shards fail
loudly instead of feeding garbage into training. Writes go to a ``.tmp``
sibling and are renamed into place, so a crashed writer never leaves a
half-shard that readers would pick up.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fe.colstore import Columns, RaggedColumn

SHARD_SUFFIX = ".fbshard"

_MAGIC = b"FBSHARD1"
_TRAILER_MAGIC = b"FBX1"
_VERSION = 1
_HEADER = struct.Struct("<8sII")      # magic, version, flags
_HEADER_CRC = struct.Struct("<II")    # crc32(header), reserved
_HEADER_LEN = _HEADER.size + _HEADER_CRC.size          # 24
_TRAILER = struct.Struct("<QQI4s")    # index_offset, index_len, crc32, magic
_TRAILER_LEN = _TRAILER.size                           # 24

KIND_DENSE = "dense"
KIND_RAGGED = "ragged"
KIND_STRING = "string"

_LENGTHS_DTYPE = "<i4"


class ShardFormatError(ValueError):
    """Malformed, truncated, or corrupt shard file."""


# --------------------------------------------------------------------- write
class ShardWriter:
    """Write one shard: ``add_table`` per view, then ``close`` (atomic)."""

    def __init__(self, path: str, *, meta: Optional[Mapping[str, Any]] = None):
        if not path.endswith(SHARD_SUFFIX):
            path += SHARD_SUFFIX
        self.path = path
        self._tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(self._tmp, "wb")
        hdr = _HEADER.pack(_MAGIC, _VERSION, 0)
        self._f.write(hdr + _HEADER_CRC.pack(zlib.crc32(hdr), 0))
        self._tables: Dict[str, Dict[str, Any]] = {}
        self._meta = dict(meta or {})
        self._closed = False

    # -- context manager: commit on success, discard the temp file on error
    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()

    def add_table(self, name: str, columns: Columns) -> None:
        """Add one table (all columns must agree on row count)."""
        if self._closed:
            raise ShardFormatError("writer already closed")
        if name in self._tables:
            raise ShardFormatError(f"duplicate table {name!r}")
        cols: Dict[str, Any] = {}
        n_rows: Optional[int] = None
        for cname, col in columns.items():
            entry, rows = self._write_column(col)
            cols[cname] = entry
            if n_rows is None:
                n_rows = rows
            elif rows != n_rows:
                raise ShardFormatError(
                    f"table {name!r}: column {cname!r} has {rows} rows, "
                    f"expected {n_rows}")
        self._tables[name] = {"n_rows": int(n_rows or 0), "columns": cols}

    def _write_column(self, col: object) -> Tuple[Dict[str, Any], int]:
        if isinstance(col, RaggedColumn):
            values = np.ascontiguousarray(col.values)
            lengths = np.ascontiguousarray(col.lengths, dtype=_LENGTHS_DTYPE)
            if int(lengths.sum()) != values.shape[0]:
                raise ShardFormatError(
                    f"ragged column: sum(lengths)={int(lengths.sum())} != "
                    f"len(values)={values.shape[0]}")
            return {
                "kind": KIND_RAGGED,
                "values_dtype": values.dtype.str,
                "parts": [self._write_part(values), self._write_part(lengths)],
            }, int(lengths.shape[0])
        arr = np.asarray(col)
        if arr.dtype == object:
            for s in arr.reshape(-1):
                if not isinstance(s, str):
                    # str(None)/str(b"x") would roundtrip as their reprs —
                    # silent corruption; refuse at write time instead.
                    raise ShardFormatError(
                        f"string column element has type "
                        f"{type(s).__name__}; only str is supported")
            enc = [s.encode("utf-8") for s in arr.reshape(-1)]
            lengths = np.array([len(b) for b in enc], dtype=_LENGTHS_DTYPE)
            payload = np.frombuffer(b"".join(enc), dtype=np.uint8)
            return {
                "kind": KIND_STRING,
                "shape": list(arr.shape),
                "parts": [self._write_part(payload), self._write_part(lengths)],
            }, int(arr.shape[0]) if arr.ndim else 1
        arr = np.ascontiguousarray(arr)
        return {
            "kind": KIND_DENSE,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "parts": [self._write_part(arr)],
        }, int(arr.shape[0]) if arr.ndim else 1

    def _write_part(self, arr: np.ndarray) -> Dict[str, int]:
        data = arr.tobytes()
        offset = self._f.tell()
        self._f.write(data)
        return {"offset": offset, "nbytes": len(data), "crc32": zlib.crc32(data)}

    def close(self) -> str:
        """Write index + trailer, fsync, and atomically publish the shard."""
        if self._closed:
            return self.path
        index = json.dumps(
            {"tables": self._tables, "meta": self._meta},
            separators=(",", ":")).encode("utf-8")
        index_offset = self._f.tell()
        self._f.write(index)
        self._f.write(_TRAILER.pack(index_offset, len(index),
                                    zlib.crc32(index), _TRAILER_MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)
        self._closed = True
        return self.path

    def abort(self) -> None:
        """Discard the partially-written shard."""
        if self._closed:
            return
        self._f.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)
        self._closed = True


# ---------------------------------------------------------------------- read
class ShardReader:
    """Read a shard: header + index parsed eagerly, payloads on demand."""

    def __init__(self, path: str, *, verify: bool = True):
        self.path = path
        self.verify = verify
        self.nbytes = os.path.getsize(path)
        # Decode accounting (projection pushdown observability): payload
        # bytes and column count actually decoded by this reader.
        self.bytes_decoded = 0
        self.columns_decoded = 0
        if self.nbytes < _HEADER_LEN + _TRAILER_LEN:
            raise ShardFormatError(f"{path}: truncated ({self.nbytes} bytes)")
        with open(path, "rb") as f:
            head = f.read(_HEADER_LEN)
            magic, version, _flags = _HEADER.unpack_from(head)
            if magic != _MAGIC:
                raise ShardFormatError(f"{path}: bad magic {magic!r}")
            crc, _ = _HEADER_CRC.unpack_from(head, _HEADER.size)
            if crc != zlib.crc32(head[:_HEADER.size]):
                raise ShardFormatError(f"{path}: header checksum mismatch")
            if version != _VERSION:
                raise ShardFormatError(f"{path}: unsupported version {version}")
            f.seek(self.nbytes - _TRAILER_LEN)
            idx_off, idx_len, idx_crc, tmagic = _TRAILER.unpack(
                f.read(_TRAILER_LEN))
            if tmagic != _TRAILER_MAGIC:
                raise ShardFormatError(f"{path}: bad trailer magic {tmagic!r}")
            if idx_off + idx_len + _TRAILER_LEN != self.nbytes:
                raise ShardFormatError(f"{path}: index extent out of bounds")
            f.seek(idx_off)
            raw = f.read(idx_len)
        if zlib.crc32(raw) != idx_crc:
            raise ShardFormatError(f"{path}: index checksum mismatch")
        index = json.loads(raw.decode("utf-8"))
        self._tables: Dict[str, Dict[str, Any]] = index["tables"]
        self.meta: Dict[str, Any] = index.get("meta", {})

    # ------------------------------------------------------------- metadata
    @property
    def table_names(self) -> List[str]:
        return list(self._tables)

    def n_rows(self, table: str) -> int:
        return int(self._table(table)["n_rows"])

    def column_names(self, table: str) -> List[str]:
        return list(self._table(table)["columns"])

    def _table(self, name: str) -> Dict[str, Any]:
        try:
            return self._tables[name]
        except KeyError:
            raise KeyError(
                f"{self.path}: no table {name!r} (have {self.table_names})"
            ) from None

    # --------------------------------------------------------------- decode
    def read_table(self, table: str,
                   columns: Optional[Sequence[str]] = None) -> Columns:
        """Decode the requested columns of one table (all by default)."""
        with open(self.path, "rb") as f:
            return self._read_table(f, table, columns)

    def read_all(
        self,
        columns: Optional[Mapping[str, Sequence[str]]] = None,
    ) -> Dict[str, Columns]:
        """Decode tables — the env shape the FE runners consume.

        ``columns`` is an optional projection ``{table: [column, ...]}``
        (e.g. a ``FeaturePlan.required_columns``): only the listed tables
        and columns are decoded; everything else stays as undecoded bytes
        on disk. ``None`` decodes every table in full.

        One file handle for the whole shard (hot reader-thread path)."""
        with open(self.path, "rb") as f:
            if columns is None:
                return {t: self._read_table(f, t, None) for t in self._tables}
            return {t: self._read_table(f, t, cols)
                    for t, cols in columns.items()}

    def _read_table(self, f, table: str,
                    columns: Optional[Sequence[str]]) -> Columns:
        tmeta = self._table(table)
        names = list(columns) if columns is not None else list(tmeta["columns"])
        out: Columns = {}
        for name in names:
            cmeta = tmeta["columns"].get(name)
            if cmeta is None:
                raise KeyError(
                    f"{self.path}: table {table!r} has no column {name!r}")
            out[name] = self._read_column(f, cmeta)
            self.columns_decoded += 1
            self.bytes_decoded += sum(p["nbytes"] for p in cmeta["parts"])
        return out

    def _read_column(self, f, cmeta: Mapping[str, Any]) -> object:
        kind = cmeta["kind"]
        if kind == KIND_DENSE:
            arr = self._read_part(f, cmeta["parts"][0], cmeta["dtype"])
            return arr.reshape(cmeta["shape"])
        if kind == KIND_RAGGED:
            values = self._read_part(f, cmeta["parts"][0], cmeta["values_dtype"])
            lengths = self._read_part(f, cmeta["parts"][1], _LENGTHS_DTYPE)
            return RaggedColumn(values=values, lengths=lengths)
        if kind == KIND_STRING:
            payload = self._read_part(f, cmeta["parts"][0], "|u1")
            lengths = self._read_part(f, cmeta["parts"][1], _LENGTHS_DTYPE)
            offs = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
            buf = payload.tobytes()
            arr = np.array(
                [buf[offs[i]: offs[i + 1]].decode("utf-8")
                 for i in range(len(lengths))],
                dtype=object)
            # "shape" absent in shards written before it was recorded: 1-D.
            return arr.reshape(cmeta.get("shape", [len(lengths)]))
        raise ShardFormatError(f"{self.path}: unknown column kind {kind!r}")

    def _read_part(self, f, part: Mapping[str, int], dtype: str) -> np.ndarray:
        f.seek(part["offset"])
        data = f.read(part["nbytes"])
        if len(data) != part["nbytes"]:
            raise ShardFormatError(f"{self.path}: truncated payload part")
        if self.verify and zlib.crc32(data) != part["crc32"]:
            raise ShardFormatError(
                f"{self.path}: payload checksum mismatch at "
                f"offset {part['offset']}")
        return np.frombuffer(data, dtype=np.dtype(dtype)).copy()


# --------------------------------------------------------------- conveniences
def write_shard(path: str, tables: Mapping[str, Columns],
                *, meta: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``{table: columns}`` as one shard; returns the final path."""
    with ShardWriter(path, meta=meta) as w:
        for name, cols in tables.items():
            w.add_table(name, cols)
    return w.path


def read_shard(path: str, *, verify: bool = True) -> Dict[str, Columns]:
    """Read every table of a shard into ``{table: columns}``."""
    return ShardReader(path, verify=verify).read_all()
