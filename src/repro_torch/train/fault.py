"""Fault tolerance + straggler mitigation + elastic scaling.

FeatureBox's pipelined design gives up the MapReduce-style per-stage
recovery of the framework it replaced, so recovery is rebuilt native to
the pipelined world (ROADMAP item 4). The live integration is
:class:`repro_torch.io.stream.StreamingLoader`: reader threads lease shards from
a :class:`ShardServer` instead of draining a static work queue, a reaper
thread returns dead readers' leases, and a heartbeat thread keeps live
readers' leases fresh. Failures are injected deterministically by
:mod:`repro_torch.io.chaos` and verified by ``tests/test_chaos.py``:

* :class:`ShardServer` — over-decomposed input-shard assignment with leases.
  Data is split into many more shards than workers; workers lease shards,
  heartbeat while processing, and commit on completion. A worker death
  (missed heartbeats) returns its leased shards to the queue — no data loss,
  no global restart. This is the MapReduce-style recovery FeatureBox's
  baseline used, applied to the pipelined world.
* :class:`StragglerPolicy` — duplicate-issue of the slowest in-flight shards
  (backup tasks): when a shard's processing time exceeds p50 x factor, it is
  re-issued to an idle worker; first commit wins, the loser is discarded.
* :func:`elastic_remesh` — recompute the mesh + data partition when the
  healthy-worker set changes; training resumes from the latest checkpoint
  with the new topology (the step function is re-lowered; model sharding
  specs are topology-relative so they transfer). The driver's
  ``--mesh auto --resume`` pair exercises this end to end
  (``launch/train.py``): checkpoint under one simulated device count,
  restart under another, and ``shard_train_state`` re-places the restored
  host arrays on the new mesh.

Commit protocol
---------------
``commit`` is strictly first-commit-wins: the first worker to commit a
shard — original lease holder, duplicate-issued backup, or even a worker
whose lease was already reaped — marks it done and is the one that yields
its data downstream. Every later commit returns ``False`` and the caller
discards its copy. Shard decode is deterministic (same bytes, same
checksum), so accepting any first commit loses nothing, and it is what
makes the loader's exactly-once yield guarantee hold under races between
``commit``, ``reap``, and backup issue (see ``tests/test_fault.py`` and the
hypothesis schedule property in ``tests/test_fault_property.py``).

The shard-state partition invariant (checked by :meth:`ShardServer.counts`):
every shard is in exactly one of *done*, *leased* (>= 1 live lease), or
*pending*, so ``completed + pending + leased == n_shards`` at all times.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

from repro_torch.check.annotations import guarded_by, shared_entry
from repro_torch.obs.metrics import harvest


@dataclasses.dataclass
class Lease:
    shard_id: int
    worker_id: str
    issued_at: float
    heartbeat_at: float
    backup: bool = False  # duplicate-issued by the straggler policy


@dataclasses.dataclass
class FaultStats:
    """The ``fault.*`` metrics tier (registered by
    :meth:`repro_torch.obs.MetricsRegistry.from_pipeline` off
    ``PipelineStats.fault``). ``ShardServer`` owns the instance; the
    loader funnels its reader-side events (retries, respawns) through
    ``record_retry``/``record_respawn`` so one tier tells the whole
    recovery story."""

    reissued: int = 0          # leases returned to pending (reap + fail)
    completed: int = 0         # shards committed (exactly once each)
    failed_workers: int = 0    # explicit fail_worker notifications
    retries: int = 0           # transient read errors retried with backoff
    backup_issued: int = 0     # straggler shards duplicate-issued
    backup_wins: int = 0       # commits won by the backup lease
    commits_rejected: int = 0  # late/duplicate commits discarded
    leases_reaped: int = 0     # individual leases expired by the reaper
    reap_latency_seconds: float = 0.0  # total time past expiry at reap
    respawned: int = 0         # replacement reader threads spawned

    @property
    def reap_latency_mean(self) -> float:
        """Mean delay between lease expiry and its reap (detection lag)."""
        return self.reap_latency_seconds / max(self.leases_reaped, 1)

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro_torch.obs.MetricsRegistry`."""
        return harvest(self)

    def summary(self) -> str:
        return (f"completed={self.completed} reissued={self.reissued} "
                f"reaped={self.leases_reaped} "
                f"(latency {self.reap_latency_mean*1e3:.0f}ms) "
                f"failed_workers={self.failed_workers} "
                f"respawned={self.respawned} retries={self.retries} "
                f"backups={self.backup_wins}/{self.backup_issued} "
                f"rejected_commits={self.commits_rejected}")


class StragglerPolicy:
    """Backup-task policy: re-issue shards running slower than p50 x factor.

    Memory is bounded: durations live in a rolling window (``deque`` of
    ``window`` samples) and a sorted shadow list is maintained
    incrementally (bisect insert + evict), so ``record`` costs O(window)
    array movement at worst — constant w.r.t. epoch length — and
    ``should_backup`` is O(1): it compares against the cached window
    median instead of re-sorting history per call.

    Not internally locked: :class:`ShardServer` drives it under its own
    lock (``record`` from ``commit``, ``should_backup`` from
    ``issue_backups``).
    """

    def __init__(self, factor: float = 3.0, min_samples: int = 5,
                 window: int = 128):
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        if window < min_samples:
            raise ValueError(
                f"window ({window}) must be >= min_samples ({min_samples})")
        self.factor = factor
        self.min_samples = min_samples
        self.window = window
        self._durations: Deque[float] = collections.deque(maxlen=window)
        self._sorted: List[float] = []
        self._p50 = float("inf")

    @property
    def n_samples(self) -> int:
        return len(self._durations)

    @property
    def p50(self) -> float:
        """Cached median of the rolling window (inf before any sample)."""
        return self._p50

    def record(self, seconds: float) -> None:
        if len(self._durations) == self.window:
            evicted = self._durations[0]
            self._sorted.pop(bisect.bisect_left(self._sorted, evicted))
        self._durations.append(seconds)
        bisect.insort(self._sorted, seconds)
        n = len(self._sorted)
        mid = self._sorted[n // 2]
        self._p50 = mid if n % 2 else (self._sorted[n // 2 - 1] + mid) / 2.0

    def should_backup(self, elapsed: float) -> bool:
        if len(self._durations) < self.min_samples:
            return False
        return elapsed > self._p50 * self.factor


# Thread contract (the JAX package's lockset audit checks its copy of it):
# every public method is called from a different thread (loader readers,
# the reaper, the heartbeater, the consumer), so all shard-state writes —
# including stats fields and the straggler policy it drives — happen under
# _lock. Each entry gets its own thread label to force that discipline.
@guarded_by("_lock", "_pending", "_backup", "_leases", "_done", "stats")
@shared_entry("acquire", "heartbeat", "commit", "fail_worker", "reap",
              "issue_backups", "record_retry", "record_respawn",
              "done", "progress", "counts")
class ShardServer:
    """Lease-based shard queue with heartbeat failure detection.

    ``straggler`` (a :class:`StragglerPolicy`) enables duplicate-issue of
    slow in-flight shards via :meth:`issue_backups`; commit durations feed
    its rolling window automatically.
    """

    def __init__(self, n_shards: int, *, lease_timeout: float = 30.0,
                 straggler: Optional[StragglerPolicy] = None):
        if n_shards < 0:
            raise ValueError(f"n_shards must be >= 0, got {n_shards}")
        if lease_timeout <= 0:
            raise ValueError(
                f"lease_timeout must be > 0, got {lease_timeout}")
        self.n_shards = n_shards
        self.lease_timeout = lease_timeout
        self.straggler = straggler
        self._pending: Deque[int] = collections.deque(range(n_shards))
        self._backup: Deque[int] = collections.deque()
        self._leases: Dict[int, List[Lease]] = {}
        self._done: Set[int] = set()
        self._lock = threading.Lock()
        self.stats = FaultStats()

    # ------------------------------------------------------------ lease ops
    def acquire(self, worker_id: str, *, now: Optional[float] = None
                ) -> Optional[int]:
        """Lease the next shard (duplicate-issued stragglers first).

        Returns ``None`` when nothing is currently assignable — which is
        *not* the same as done: a reaped or duplicate-issued lease may
        still arrive, so workers poll until :meth:`done`.
        """
        now = time.monotonic() if now is None else now
        # Reap first (own lock acquisition — the audit's lock discipline is
        # lexical) so a busy pool never depends on the reaper's cadence; an
        # interleaved acquire between reap and pop just takes the shard
        # first, which is fine.
        self.reap(now=now)
        with self._lock:
            taken: Optional[int] = None
            kept: List[int] = []  # skipped-for-self, stay queued for others
            while self._backup:
                sid = self._backup.popleft()
                leases = self._leases.get(sid)
                if sid in self._done or not leases:
                    continue  # original finished or was reaped meanwhile
                if any(l.worker_id == worker_id for l in leases):
                    kept.append(sid)  # a worker cannot back itself up
                    continue
                leases.append(Lease(sid, worker_id, now, now, backup=True))
                taken = sid
                break
            for sid in reversed(kept):
                self._backup.appendleft(sid)
            if taken is not None:
                return taken
            while self._pending:
                sid = self._pending.popleft()
                if sid in self._done:
                    # reaped back into pending, then committed late by the
                    # original holder: handing it out again would process
                    # it twice (the seed's double-processing bug)
                    continue
                self._leases.setdefault(sid, []).append(
                    Lease(sid, worker_id, now, now))
                return sid
            return None

    def heartbeat(self, worker_id: str, shard_id: int,
                  *, now: Optional[float] = None) -> bool:
        """Refresh ``worker_id``'s lease; False when the lease is gone
        (reaped, or the shard was committed by someone else)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for lease in self._leases.get(shard_id, ()):
                if lease.worker_id == worker_id:
                    lease.heartbeat_at = now
                    return True
            return False

    def commit(self, worker_id: str, shard_id: int,
               *, now: Optional[float] = None) -> bool:
        """First commit wins — from the lease holder, a backup, or a
        reaped-but-alive original; late/duplicate commits return False
        and the caller must discard its copy of the data."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if shard_id in self._done or not 0 <= shard_id < self.n_shards:
                self.stats.commits_rejected += 1
                return False
            leases = self._leases.pop(shard_id, [])
            self._done.add(shard_id)
            try:
                # a reaped shard may sit in pending; a committed shard must
                # never be handed out again (acquire also skips done ids)
                self._pending.remove(shard_id)
            except ValueError:
                pass
            self.stats.completed += 1
            mine = next((l for l in leases if l.worker_id == worker_id), None)
            if mine is not None:
                if mine.backup:
                    self.stats.backup_wins += 1
                if self.straggler is not None:
                    self.straggler.record(now - mine.issued_at)
            return True

    def fail_worker(self, worker_id: str) -> int:
        """Explicit failure notification: return all its shards at once
        instead of waiting out the lease timeout."""
        with self._lock:
            lost = 0
            for sid in list(self._leases):
                leases = self._leases[sid]
                kept = [l for l in leases if l.worker_id != worker_id]
                if len(kept) == len(leases):
                    continue
                lost += 1
                if kept:
                    self._leases[sid] = kept
                else:
                    del self._leases[sid]
                    self._pending.appendleft(sid)
                    self.stats.reissued += 1
            if lost:
                self.stats.failed_workers += 1
            return lost

    # ----------------------------------------------------- failure handling
    def reap(self, *, now: Optional[float] = None) -> List[int]:
        """Expire overdue leases; shards left without any live lease go
        back to the front of the pending queue. Returns the reissued shard
        ids (the reaper thread's entry point; ``acquire`` also reaps so a
        busy pool never depends on the reaper's cadence)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            reissued: List[int] = []
            for sid in list(self._leases):
                live: List[Lease] = []
                for lease in self._leases[sid]:
                    if now - lease.heartbeat_at > self.lease_timeout:
                        self.stats.leases_reaped += 1
                        self.stats.reap_latency_seconds += max(
                            now - (lease.heartbeat_at + self.lease_timeout),
                            0.0)
                    else:
                        live.append(lease)
                if live:
                    self._leases[sid] = live
                else:
                    del self._leases[sid]
                    self._pending.appendleft(sid)
                    self.stats.reissued += 1
                    reissued.append(sid)
            return reissued

    def issue_backups(self, *, now: Optional[float] = None) -> List[int]:
        """Duplicate-issue in-flight stragglers per the policy: shards
        whose oldest lease has run longer than p50 x factor are queued for
        the next idle worker (at most one backup per shard)."""
        if self.straggler is None:
            return []
        now = time.monotonic() if now is None else now
        with self._lock:
            issued: List[int] = []
            for sid, leases in self._leases.items():
                if sid in self._backup or any(l.backup for l in leases):
                    continue
                elapsed = now - min(l.issued_at for l in leases)
                if self.straggler.should_backup(elapsed):
                    self._backup.append(sid)
                    self.stats.backup_issued += 1
                    issued.append(sid)
            return issued

    # -------------------------------------------------------- loader events
    def record_retry(self) -> None:
        """A reader retried a transient read error (loader-side event)."""
        with self._lock:
            self.stats.retries += 1

    def record_respawn(self) -> None:
        """The loader replaced a dead reader thread (loader-side event)."""
        with self._lock:
            self.stats.respawned += 1

    # ------------------------------------------------------------ inspection
    def done(self) -> bool:
        with self._lock:
            return len(self._done) == self.n_shards

    def progress(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._done), self.n_shards

    def counts(self) -> Tuple[int, int, int]:
        """(completed, pending, leased) — partitions the shard space:
        ``completed + pending + leased == n_shards`` always (the lease
        invariant the hypothesis schedule property asserts)."""
        with self._lock:
            return len(self._done), len(self._pending), len(self._leases)


def elastic_remesh(n_healthy: int, *, model_parallel: int,
                   pod_size: Optional[int] = None):
    """Largest usable mesh for the current healthy-device count.

    Keeps model parallelism fixed (the model's sharding requires it) and
    shrinks/grows data parallelism; returns (mesh_shape, axis_names, n_used).
    Devices beyond the largest full data-parallel replica sit out until the
    next resize — the standard elastic-training contract.
    """
    if n_healthy < model_parallel:
        raise ValueError(
            f"cannot run: {n_healthy} healthy devices < model_parallel={model_parallel}")
    dp = n_healthy // model_parallel
    n_used = dp * model_parallel
    if pod_size and n_used >= pod_size * 2 and n_used % pod_size == 0 \
            and (pod_size % model_parallel == 0):
        pods = n_used // pod_size
        return ((pods, pod_size // model_parallel, model_parallel),
                ("pod", "data", "model"), n_used)
    return ((dp, model_parallel), ("data", "model"), n_used)
