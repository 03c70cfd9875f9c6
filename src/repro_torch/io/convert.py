"""Bulk conversion of in-memory views / column-store chunks into shards.

Two producers feed the shard tier:

* :func:`write_view_shards` — an iterable of per-batch view dicts (what
  ``fe.datagen.gen_views`` yields) becomes one shard per batch, plus a
  manifest. This is how the synthetic "raw log" is laid out on disk.
* :func:`colstore_to_shards` — re-shards an existing
  :class:`~repro_torch.fe.colstore.ColumnStore`: chunk *i* of every view is
  bundled into shard *i* (side views with fewer chunks wrap around, the
  same association ``examples/train_ctr_e2e.py`` uses for shard leases).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from repro_torch.fe.colstore import ColumnStore, Columns
from repro_torch.io.dataset import write_manifest
from repro_torch.io.shardfmt import SHARD_SUFFIX, write_shard

_NAME_FMT = "shard_{:05d}" + SHARD_SUFFIX


def views_to_shard(path: str, views: Mapping[str, Columns],
                   *, meta: Optional[Mapping[str, Any]] = None) -> str:
    """Write one batch of views (``{view: columns}``) as a single shard."""
    return write_shard(path, views, meta=meta)


def write_view_shards(data_dir: str,
                      batches: Iterable[Mapping[str, Columns]],
                      *, primary: str = "impressions",
                      manifest: bool = True) -> List[str]:
    """Write one shard per batch of views; returns the shard paths."""
    os.makedirs(data_dir, exist_ok=True)
    paths: List[str] = []
    entries: List[Dict] = []
    for i, views in enumerate(batches):
        path = os.path.join(data_dir, _NAME_FMT.format(i))
        paths.append(views_to_shard(path, views, meta={"seq": i}))
        entries.append(_manifest_entry(paths[-1], views, primary))
    if manifest and paths:
        write_manifest(data_dir, primary=primary, entries=entries)
    return paths


def _manifest_entry(path: str, views: Mapping[str, Columns],
                    primary: str) -> Dict:
    """Manifest entry from in-memory data — no reopening the shard."""
    # Explicit membership test: an empty primary view must count as 0 rows,
    # not silently fall through to another view's row count.
    cols = views[primary] if primary in views else next(iter(views.values()))
    n_rows = 0
    for data in cols.values():
        n_rows = data.n_rows if hasattr(data, "n_rows") else len(data)
        break
    return {"file": os.path.basename(path),
            "nbytes": os.path.getsize(path), "n_rows": int(n_rows)}


def colstore_to_shards(store: ColumnStore, data_dir: str,
                       views: Mapping[str, Sequence[str]],
                       *, primary: str = "impressions",
                       manifest: bool = True) -> List[str]:
    """Re-shard column-store chunks: one shard per chunk of ``primary``.

    ``views`` maps view name -> column names to include. Views with fewer
    chunks than the primary (dimension tables like ``user_profile``) wrap
    around modulo their own chunk count.
    """
    if primary not in views:
        raise ValueError(f"primary view {primary!r} missing from {list(views)}")
    chunk_ids = {v: store.chunks(v) for v in views}
    if not chunk_ids[primary]:
        raise FileNotFoundError(
            f"column store has no chunks for primary view {primary!r}")
    for v, cids in chunk_ids.items():
        if not cids:
            raise FileNotFoundError(f"column store has no chunks for {v!r}")
    os.makedirs(data_dir, exist_ok=True)
    paths: List[str] = []
    entries: List[Dict] = []
    for i, cid in enumerate(chunk_ids[primary]):
        env: Dict[str, Columns] = {}
        for v, cols in views.items():
            # Wrap by loop *position*, not chunk-id value: ids are parsed
            # from directory names and need not be contiguous from 0.
            vcid = cid if v == primary else chunk_ids[v][i % len(chunk_ids[v])]
            env[v] = store.read_columns(v, vcid, list(cols))
        path = os.path.join(data_dir, _NAME_FMT.format(i))
        paths.append(views_to_shard(path, env,
                                    meta={"seq": i, "source_chunk": cid}))
        entries.append(_manifest_entry(paths[-1], env, primary))
    if manifest and paths:
        write_manifest(data_dir, primary=primary, entries=entries)
    return paths
