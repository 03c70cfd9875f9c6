"""Shard discovery, manifests, and deterministic host assignment.

A *dataset* is a directory of ``.fbshard`` files plus an optional
``manifest.json`` recording per-shard size/rows (written at conversion time
so discovery never has to open every shard). Assignment to hosts is
round-robin over the manifest order — ``shards[host_id::n_hosts]`` — which
is a disjoint cover, is stable across runs, and composes with the data axis
of ``launch/mesh.py``: host *i* of *n* always streams the same shard subset,
so restarts and stragglers re-read identical data.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.io.shardfmt import SHARD_SUFFIX, ShardFormatError, ShardReader

MANIFEST_NAME = "manifest.json"
_FORMAT = "fbshard.v1"


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """One shard as discovered from a manifest or directory scan."""

    path: str
    nbytes: int
    n_rows: int      # rows of the primary (instance) table
    seq: int         # position in manifest order; assignment key

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


def write_manifest(data_dir: str, shard_paths: Sequence[str] = (),
                   *, primary: str = "impressions",
                   extra: Optional[Mapping[str, Any]] = None,
                   entries: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write ``manifest.json``.

    Writers that just produced the shards pass prebuilt ``entries``
    (``{file, nbytes, n_rows}``) so nothing is reopened; the
    ``shard_paths`` form reads each shard's index — the repair path for a
    directory of pre-existing shards.
    """
    if entries is None:
        entries = []
        for path in shard_paths:
            r = ShardReader(path)
            table = primary if primary in r.table_names else r.table_names[0]
            entries.append({
                "file": os.path.basename(path),
                "nbytes": r.nbytes,
                "n_rows": r.n_rows(table),
            })
    manifest = {
        "format": _FORMAT,
        "primary": primary,
        "shards": entries,
        **dict(extra or {}),
    }
    path = os.path.join(data_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    return path


def assign_shards(shards: Sequence, host_id: int, n_hosts: int) -> List:
    """Round-robin host assignment: a disjoint cover of ``shards``.

    ``assign_shards(s, i, n) for i in range(n)`` partitions ``s``: every
    shard lands on exactly one host, and hosts differ in size by at most 1.
    """
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} out of range [0, {n_hosts})")
    return list(shards[host_id::n_hosts])


class ShardDataset:
    """Shards of one data directory, filtered to this host's assignment."""

    def __init__(self, data_dir: str, *, host_id: int = 0, n_hosts: int = 1,
                 primary: str = "impressions"):
        self.data_dir = data_dir
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.primary = primary
        self.shards: List[ShardInfo] = self._discover()
        if not self.shards:
            raise FileNotFoundError(
                f"no {SHARD_SUFFIX} shards under {data_dir!r}")
        self.local_shards: List[ShardInfo] = assign_shards(
            self.shards, host_id, n_hosts)

    def _discover(self) -> List[ShardInfo]:
        mpath = os.path.join(self.data_dir, MANIFEST_NAME)
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
            if manifest.get("format") != _FORMAT:
                raise ShardFormatError(
                    f"{mpath}: unknown manifest format "
                    f"{manifest.get('format')!r}")
            return [
                ShardInfo(path=os.path.join(self.data_dir, e["file"]),
                          nbytes=int(e["nbytes"]), n_rows=int(e["n_rows"]),
                          seq=i)
                for i, e in enumerate(manifest["shards"])
            ]
        # No manifest: scan the directory (sorted for determinism) and pull
        # row counts from each shard's index.
        out = []
        for i, path in enumerate(
                sorted(glob.glob(os.path.join(self.data_dir,
                                              "*" + SHARD_SUFFIX)))):
            r = ShardReader(path)
            table = (self.primary if self.primary in r.table_names
                     else r.table_names[0])
            out.append(ShardInfo(path=path, nbytes=r.nbytes,
                                 n_rows=r.n_rows(table), seq=i))
        return out

    # ------------------------------------------------------------ iteration
    def epoch_order(self, epoch: int = 0, *, shuffle: bool = False,
                    seed: int = 0) -> List[ShardInfo]:
        """This host's shards for ``epoch``, optionally shuffled.

        The permutation is a deterministic function of ``(seed, epoch)``, so
        every host reshuffles consistently and restarts replay the same
        order.
        """
        local = self.local_shards
        if not shuffle:
            return list(local)
        perm = np.random.default_rng(
            (seed, epoch)).permutation(len(local))
        return [local[i] for i in perm]

    def epoch_plan(self, epochs: int, *, shuffle: bool = False,
                   seed: int = 0) -> List[ShardInfo]:
        """Concatenated :meth:`epoch_order` over ``epochs`` passes.

        This is the loader's full lease plan: plan index == shard id in
        :class:`~repro_torch.train.fault.ShardServer`, so one ShardInfo appears
        once per epoch under distinct ids and restarts replay identically.
        """
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        plan: List[ShardInfo] = []
        for epoch in range(epochs):
            plan.extend(self.epoch_order(epoch, shuffle=shuffle, seed=seed))
        return plan

    def __len__(self) -> int:
        return len(self.local_shards)

    def __iter__(self) -> Iterator[ShardInfo]:
        return iter(self.local_shards)

    @property
    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self.local_shards)

    @property
    def total_rows(self) -> int:
        return sum(s.n_rows for s in self.local_shards)
