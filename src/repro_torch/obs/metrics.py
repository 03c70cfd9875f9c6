"""Metrics registry: one ``snapshot() -> dict`` over every stats tier.

The pipeline grew seven ad-hoc stats dataclasses (``IngestStats``,
``FeedStats``, ``ExecutionStats``, ``PipelineStats``, ``TrainFeedStats``,
``LoopStats``, ``TierStats``) — each fine alone, none comparable across
runs without hand-written glue. This module consolidates them behind one
protocol without changing any of them behaviorally:

* :func:`harvest` turns any stats object into a flat ``{metric: number}``
  dict — numeric dataclass fields plus numeric ``@property`` values (so
  derived ratios like ``unique_ratio`` or ``overlap_fraction`` come along
  for free). Every stats class gains an ``as_metrics()`` adapter that is
  exactly ``harvest(self)``; existing fields and call sites are untouched.
* :class:`MetricsRegistry` names each tier and flattens the whole run into
  one ``snapshot()`` dict (``"ingest.bytes_read": ...``), plus derived
  pipeline-level metrics (:func:`pipeline_rollup`): overlap fraction,
  per-stage stall attribution, and the disk/H2D/train bytes-and-seconds
  rollup the benchmark rows and the ``--metrics`` driver flag surface.

The registry holds *references* to live stats objects: snapshot late (after
``run()``) and the numbers are final; snapshot mid-run and they are a
consistent-enough progress sample (fields are monotone accumulators).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Mapping, Optional, Union

Number = Union[int, float]
MetricSource = Union[Mapping[str, Number], Callable[[], Mapping[str, Number]], Any]


def harvest(obj: Any) -> Dict[str, Number]:
    """Flatten a stats object into ``{name: number}``.

    Takes numeric dataclass fields (bools as 0/1) and numeric properties;
    skips nested objects, lists, strings, and properties that raise.
    Works on any object, dataclass or not.
    """
    out: Dict[str, Number] = {}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name, None)
            if isinstance(v, bool):
                out[f.name] = int(v)
            elif isinstance(v, (int, float)):
                out[f.name] = v
    for name in dir(type(obj)):
        if name.startswith("_"):
            continue
        descr = getattr(type(obj), name, None)
        if not isinstance(descr, property):
            continue
        try:
            v = descr.fget(obj)  # type: ignore[misc]
        except Exception:
            continue
        if isinstance(v, bool):
            out[name] = int(v)
        elif isinstance(v, (int, float)):
            out[name] = v
    return out


def _resolve(source: MetricSource) -> Dict[str, Number]:
    if callable(source) and not hasattr(source, "as_metrics"):
        source = source()
    as_metrics = getattr(source, "as_metrics", None)
    if as_metrics is not None:
        return dict(as_metrics())
    if isinstance(source, Mapping):
        return {k: v for k, v in source.items()
                if isinstance(v, (int, float))}
    return harvest(source)


class MetricsRegistry:
    """Named metric tiers, flattened to one ``snapshot()`` dict.

    Sources may be stats objects (anything :func:`harvest` understands,
    preferring an ``as_metrics()`` method when present), plain dicts, or
    zero-arg callables returning dicts (evaluated at snapshot time, so
    derived metrics always reflect the current state).
    """

    def __init__(self) -> None:
        self._sources: Dict[str, MetricSource] = {}
        self._gauges: Dict[str, Number] = {}

    def register(self, name: str, source: MetricSource) -> "MetricsRegistry":
        if not name:
            raise ValueError("metric tier name must be non-empty")
        self._sources[name] = source
        return self

    def gauge(self, name: str, value: Number) -> "MetricsRegistry":
        """Record a single static value (e.g. ``hlo.flops_per_step``)."""
        self._gauges[name] = value
        return self

    @property
    def tiers(self) -> tuple:
        return tuple(self._sources)

    def snapshot(self) -> Dict[str, Number]:
        """Flatten every tier: ``{"<tier>.<metric>": number}``, sorted."""
        out: Dict[str, Number] = dict(self._gauges)
        for tier, source in self._sources.items():
            for k, v in _resolve(source).items():
                out[f"{tier}.{k}"] = v
        return dict(sorted(out.items()))

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    # ------------------------------------------------------------ pipeline
    @classmethod
    def from_pipeline(cls, stats: Any,
                      extra: Optional[Mapping[str, MetricSource]] = None
                      ) -> "MetricsRegistry":
        """Registry over a :class:`~repro_torch.core.pipeline.PipelineStats` and
        every tier attached to it (ingest / feed / train_feed / exec),
        plus the derived :func:`pipeline_rollup` tier."""
        reg = cls()
        reg.register("pipeline", stats)
        exec_stats = getattr(stats, "exec_stats", None)
        if exec_stats is not None:
            reg.register("exec", exec_stats)
        for tier in ("ingest", "feed", "train_feed", "ps", "comm", "fault"):
            obj = getattr(stats, tier, None)
            if obj is not None:
                reg.register(tier, obj)
        reg.register("rollup", lambda: pipeline_rollup(stats))
        for name, source in (extra or {}).items():
            reg.register(name, source)
        return reg


def pipeline_rollup(stats: Any) -> Dict[str, Number]:
    """Derived pipeline-level metrics off a :class:`PipelineStats` tree.

    Bytes-and-seconds per stage (disk -> FE -> H2D -> train) plus stall
    attribution: which stage was waiting, and on whom. All keys are
    present even when a tier is absent (0), so snapshots from different
    configurations stay structurally comparable.
    """
    ingest = getattr(stats, "ingest", None)
    feed = getattr(stats, "feed", None)
    tf = getattr(stats, "train_feed", None)
    ps = getattr(stats, "ps", None)
    wall = float(getattr(stats, "wall_seconds", 0.0))
    out: Dict[str, Number] = {
        "wall_seconds": wall,
        "batches": int(getattr(stats, "batches", 0)),
        "overlap_fraction": float(getattr(stats, "overlap_fraction", 0.0)),
        "overhead_seconds": float(getattr(stats, "overhead_seconds", 0.0)),
        # stage seconds
        "disk_seconds": float(getattr(ingest, "read_seconds", 0.0)) if ingest else 0.0,
        "fe_seconds": float(getattr(stats, "fe_seconds", 0.0)),
        "h2d_seconds": float(getattr(feed, "h2d_seconds", 0.0)) if feed else 0.0,
        "adapt_seconds": float(getattr(stats, "adapt_seconds", 0.0)),
        "train_seconds": float(getattr(stats, "train_net_seconds",
                                       getattr(stats, "train_seconds", 0.0))),
        # stage bytes
        "disk_bytes": int(getattr(ingest, "bytes_read", 0)) if ingest else 0,
        "decoded_bytes": int(getattr(ingest, "bytes_decoded", 0)) if ingest else 0,
        "h2d_bytes": int(getattr(feed, "bytes_staged", 0)) if feed else 0,
        "intermediate_bytes": int(getattr(stats, "intermediate_bytes", 0)),
        # stall attribution: who waited, and for whom
        "stall_loader_backpressure_seconds":
            float(getattr(ingest, "reader_stall_seconds", 0.0)) if ingest else 0.0,
        "stall_waiting_on_disk_seconds":
            float(getattr(ingest, "consumer_stall_seconds", 0.0)) if ingest else 0.0,
        "stall_h2d_reclaim_seconds":
            float(getattr(feed, "stall_seconds", 0.0)) if feed else 0.0,
        "dedup_unique_ratio": float(getattr(tf, "unique_ratio", 0.0)) if tf else 0.0,
        # hierarchical-PS tier (0 when the embedding backend is in-memory)
        "ps_pull_seconds": float(getattr(ps, "pull_seconds", 0.0)) if ps else 0.0,
        "ps_wait_seconds": float(getattr(ps, "wait_seconds", 0.0)) if ps else 0.0,
        "ps_host_hit_rate": float(getattr(ps, "host_hit_rate", 0.0)) if ps else 0.0,
        "ps_evictions": int(getattr(ps, "evictions", 0)) if ps else 0,
    }
    # mesh collectives tier (0 when single-device)
    comm = getattr(stats, "comm", None)
    out["comm_interpod_bytes_total"] = \
        int(getattr(comm, "interpod_bytes_total", 0)) if comm else 0
    plan = getattr(comm, "plan", None)
    out["comm_interpod_reduction"] = \
        float(getattr(plan, "interpod_reduction", 1.0)) if plan else 1.0
    # fault-tolerance tier (0 when the loader saw no failures / is static)
    fault = getattr(stats, "fault", None)
    out["fault_reissued"] = int(getattr(fault, "reissued", 0)) if fault else 0
    out["fault_retries"] = int(getattr(fault, "retries", 0)) if fault else 0
    out["fault_backup_wins"] = \
        int(getattr(fault, "backup_wins", 0)) if fault else 0
    out["fault_failed_workers"] = \
        int(getattr(fault, "failed_workers", 0)) if fault else 0
    if wall > 0:
        for stage in ("disk", "fe", "h2d", "train"):
            out[f"{stage}_busy_fraction"] = \
                min(float(out[f"{stage}_seconds"]) / wall, 1.0)
    return out
