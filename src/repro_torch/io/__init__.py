"""Streaming shard ingestion (the pipeline's on-disk front end).

A copy of the JAX package's ``repro.io`` (jax-free), imports renamed.

FeatureBox's pipeline starts from 15–25 TB of raw ads logs; this package is
the scaled-down stand-in for that ingest tier:

* :mod:`repro_torch.io.shardfmt` — compact binary record-shard format
  (``.fbshard``) with checksummed headers covering the three column kinds
  the FE pipeline uses (dense numeric, ragged int lists, strings).
* :mod:`repro_torch.io.dataset` — shard discovery, manifests, and deterministic
  host-sharded assignment so ingestion composes with ``launch/mesh.py``.
* :mod:`repro_torch.io.stream` — multi-worker prefetching :class:`StreamingLoader`
  with bounded queues, backpressure, ingest statistics, and lease-based
  fault tolerance (``ShardServer`` scheduling, reap/retry/backup recovery).
* :mod:`repro_torch.io.chaos` — deterministic fault injection (kill/delay/
  transient/corrupt schedules) for proving the recovery paths.
* :mod:`repro_torch.io.convert` — bulk conversion from ``fe.datagen`` views and
  ``fe.colstore`` chunks into shards.
"""

from repro_torch.io.chaos import (
    ChaosEvent,
    ChaosInjector,
    ChaosKill,
    ChaosTransientIOError,
    parse_chaos_spec,
    random_schedule,
)
from repro_torch.io.shardfmt import (
    SHARD_SUFFIX,
    ShardFormatError,
    ShardReader,
    ShardWriter,
    read_shard,
    write_shard,
)
from repro_torch.io.dataset import ShardDataset, ShardInfo, assign_shards, write_manifest
from repro_torch.io.stream import IngestStats, StreamingLoader
from repro_torch.io.convert import colstore_to_shards, views_to_shard, write_view_shards

__all__ = [
    "ChaosEvent",
    "ChaosInjector",
    "ChaosKill",
    "ChaosTransientIOError",
    "IngestStats",
    "SHARD_SUFFIX",
    "ShardDataset",
    "ShardFormatError",
    "ShardInfo",
    "ShardReader",
    "ShardWriter",
    "StreamingLoader",
    "assign_shards",
    "colstore_to_shards",
    "parse_chaos_spec",
    "random_schedule",
    "read_shard",
    "views_to_shard",
    "write_manifest",
    "write_shard",
    "write_view_shards",
]
