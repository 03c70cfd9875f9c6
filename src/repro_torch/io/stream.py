"""Fault-tolerant multi-worker shard loader with lease-based scheduling.

:class:`StreamingLoader` turns a :class:`~repro_torch.io.dataset.ShardDataset`
(or a plain list of shard paths) into an iterator of ``{table: columns}``
environments — exactly the batch shape the FE runners consume — while a
pool of reader threads keeps the disk busy. Shards are *leased* from a
:class:`~repro_torch.train.fault.ShardServer` rather than drained from a static
queue (ROADMAP item 4):

    ShardServer (leases) <- N reader threads -> bounded output queue
          ^  ^
          |  heartbeat thread (keeps live readers' leases fresh)
          reaper thread (expires dead readers' leases; issues backups)

Recovery story, proven by ``tests/test_chaos.py`` under injected faults
(:mod:`repro_torch.io.chaos`):

* A reader that dies mid-shard stops heartbeating; the reaper returns its
  lease to the queue and another reader re-reads the shard — no data loss.
  The consumer respawns chaos-killed readers (bounded budget) so even a
  single-worker pool survives.
* ``StragglerPolicy`` duplicate-issues shards running slower than
  p50 x factor; commits are strictly first-wins in the server, so every
  shard is yielded downstream **exactly once** (losers discard their copy).
* Transient ``OSError`` reads get bounded retry-with-backoff (``io.retry``
  spans); :class:`~repro_torch.io.shardfmt.ShardFormatError` — checksum/format
  corruption — still fails the job fast, never retried.
* Commit-then-yield ordering: a reader publishes to the consumer only
  after winning the commit, and nothing can kill it between the two
  (chaos kill points are pre-commit by design; threads don't die
  spontaneously between adjacent statements), so the commit log is
  exactly the set of yielded shards.
* ``ordered=True`` re-sequences completions into plan order through a
  small consumer-side reorder buffer, making a chaos run's yielded stream
  *bit-identical* to the failure-free run — at the cost of head-of-line
  blocking on the oldest outstanding shard. A reader failure that ends the
  run (corruption) is re-sequenced too: it is raised when its shard's turn
  comes, after every shard before it in the plan has been yielded, so the
  batches a run yields before failing are a function of the plan alone
  (every rank of a mesh, reading the same plan, fails at the same batch).

The output queue bounds memory (backpressure: readers block when the
consumer falls behind) and :class:`IngestStats` records where time went:

* ``read_seconds``          — readers doing disk I/O + decode,
* ``reader_stall_seconds``  — readers blocked on a full queue
  (consumer-bound: the trainer can't keep up),
* ``consumer_stall_seconds``— consumer blocked on an empty queue
  (reader-bound: the disk can't keep up).

Only the commit *winner* updates :class:`IngestStats` (``stats.shards``
stays the epoch's shard count under duplicate reads); recovery activity is
a separate tier, :class:`~repro_torch.train.fault.FaultStats`, exposed as
:attr:`StreamingLoader.fault_stats` and registered as the ``fault.*``
metrics tier.

Reader-thread exceptions are re-raised in the consumer, so a corrupt shard
fails the training job instead of silently shrinking the epoch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Union)

from repro_torch.check.annotations import guarded_by, single_writer
from repro_torch.io.chaos import ChaosInjector, ChaosKill
from repro_torch.io.dataset import ShardDataset, ShardInfo
from repro_torch.io.shardfmt import ShardReader
from repro_torch.obs.metrics import harvest
from repro_torch.obs.trace import get_tracer
from repro_torch.train.fault import FaultStats, ShardServer, StragglerPolicy


@dataclasses.dataclass
class _ReaderError:
    exc: BaseException
    shard: str
    sid: Optional[int] = None          # the shard's place in the plan, once leased


@dataclasses.dataclass
class IngestStats:
    shards: int = 0
    bytes_read: int = 0
    # Projection pushdown accounting: payload bytes / columns actually
    # decoded (== bytes_read's payload when no column projection is set).
    bytes_decoded: int = 0
    columns_decoded: int = 0
    read_seconds: float = 0.0
    reader_stall_seconds: float = 0.0
    consumer_stall_seconds: float = 0.0
    wall_seconds: float = 0.0
    max_queue_depth: int = 0

    @property
    def read_bytes_per_second(self) -> float:
        """Disk+decode throughput of the reader pool (sum over workers)."""
        return self.bytes_read / max(self.read_seconds, 1e-9)

    @property
    def wall_bytes_per_second(self) -> float:
        """End-to-end ingest throughput as the consumer observed it."""
        return self.bytes_read / max(self.wall_seconds, 1e-9)

    def as_metrics(self) -> "dict":
        """Flat numeric snapshot for :class:`repro_torch.obs.MetricsRegistry`."""
        return harvest(self)

    def summary(self) -> str:
        return (f"shards={self.shards} bytes={self.bytes_read/2**20:.1f}MiB "
                f"decoded={self.bytes_decoded/2**20:.1f}MiB "
                f"({self.columns_decoded} cols) "
                f"read={self.read_seconds:.2f}s "
                f"({self.read_bytes_per_second/2**20:.0f}MiB/s) "
                f"wall={self.wall_seconds:.2f}s "
                f"({self.wall_bytes_per_second/2**20:.0f}MiB/s) "
                f"reader_stall={self.reader_stall_seconds:.2f}s "
                f"consumer_stall={self.consumer_stall_seconds:.2f}s")


# Thread contract (the JAX package's lockset audit checks its copy of it):
# N reader threads and the consuming thread both update IngestStats and the
# active-lease map the heartbeater reads, so every write to `stats` /
# `_active` (including the per-pass rebinds in __iter__) holds _lock. The
# pool plumbing — thread lists, the lease server, the plan, the respawn
# budget — is only ever written by the consumer thread (spawn/respawn/close
# all happen there); readers and the aux threads only read it.
@guarded_by("_lock", "stats", "_active")
@single_writer("_threads", "_aux_threads", "_reader_threads", "_out",
               "_running", "_server", "_plan", "_respawns", "_clean")
class StreamingLoader:
    """Iterate shard environments with a fault-tolerant reader pool.

    Parameters
    ----------
    source:
        :class:`ShardDataset`, or a sequence of shard paths /
        :class:`ShardInfo`.
    workers:
        Reader threads. 1 gives deterministic shard order; more overlap
        seeks and decode.
    prefetch:
        Output queue capacity (decoded shards held ahead of the consumer).
    epochs:
        How many passes over the source to enqueue.
    shuffle / seed:
        Per-epoch deterministic shard-order shuffle (datasets only).
    transform:
        Optional ``fn(env, info) -> env`` applied in the reader thread, so
        per-shard host work (filtering, re-batching) overlaps the consumer.
    columns:
        Optional projection ``{table: [column, ...]}`` — typically a
        ``FeaturePlan.required_columns`` — pushed down into
        :meth:`ShardReader.read_all` so untouched tables/columns are never
        decoded from disk. ``IngestStats.bytes_decoded`` /
        ``columns_decoded`` make the saving observable.
    verify:
        Verify payload checksums while decoding (default on).
    lease_timeout:
        Seconds without a heartbeat before the reaper returns a reader's
        shard to the queue. Small values recover faster but may reap a
        reader that is merely slow (first-commit-wins makes that safe,
        just wasteful).
    retries / retry_backoff:
        Bounded retry for transient ``OSError`` reads: up to ``retries``
        re-reads with exponential backoff starting at ``retry_backoff``
        seconds. Corruption (``ShardFormatError``) is never retried.
    straggler:
        Optional :class:`~repro_torch.train.fault.StragglerPolicy`; by default a
        fresh policy per pass duplicate-issues shards slower than
        p50 x factor.
    chaos:
        Optional :class:`~repro_torch.io.chaos.ChaosInjector` firing scheduled
        faults at the lease lifecycle's injection points (tests/demos).
    ordered:
        Yield in plan order via a consumer-side reorder buffer (makes
        multi-worker and chaos runs bit-identical to ``workers=1``); off
        by default — completion order maximizes pipeline overlap.
    max_respawns:
        Budget for replacing dead readers (default ``2*workers + 2``);
        exhausting it raises instead of looping forever under a
        kill-everything chaos schedule.
    """

    def __init__(self, source: Union[ShardDataset, Sequence],
                 *, workers: int = 2, prefetch: int = 4, epochs: int = 1,
                 shuffle: bool = False, seed: int = 0,
                 transform: Optional[Callable[[Dict[str, Any], ShardInfo],
                                              Dict[str, Any]]] = None,
                 columns: Optional[Mapping[str, Sequence[str]]] = None,
                 verify: bool = True,
                 lease_timeout: float = 30.0,
                 retries: int = 2, retry_backoff: float = 0.05,
                 straggler: Optional[StragglerPolicy] = None,
                 chaos: Optional[ChaosInjector] = None,
                 ordered: bool = False,
                 max_respawns: Optional[int] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.source = source
        self.workers = workers
        self.prefetch = prefetch
        self.epochs = epochs
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.columns = (None if columns is None
                        else {t: tuple(c) for t, c in columns.items()})
        self.verify = verify
        self.lease_timeout = lease_timeout
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.straggler = straggler
        self.chaos = chaos
        self.ordered = ordered
        self.max_respawns = max_respawns
        self.stats = IngestStats()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._aux_threads: List[threading.Thread] = []
        self._reader_threads: Dict[str, threading.Thread] = {}
        self._out: Optional[queue.Queue] = None
        self._running = False
        self._server: Optional[ShardServer] = None
        self._plan: List[ShardInfo] = []
        self._active: Dict[str, int] = {}
        self._clean: set = set()
        self._respawns = 0

    @property
    def rows_hint(self) -> Optional[int]:
        """Largest shard row count this loader will emit, if known.

        Pre-sizes downstream staging arenas (``DeviceFeeder(rows_hint=...)``)
        at compile time from the dataset manifest instead of growing on the
        first oversized batch. ``None`` when the source carries no row
        counts (plain path lists).
        """
        if isinstance(self.source, ShardDataset):
            rows = [s.n_rows for s in self.source.local_shards if s.n_rows]
            return max(rows) if rows else None
        rows = [s.n_rows for s in self.source
                if isinstance(s, ShardInfo) and s.n_rows]
        return max(rows) if rows else None

    @property
    def fault_stats(self) -> FaultStats:
        """The current (or last) pass's recovery counters — the ``fault.*``
        metrics tier, owned by the lease server."""
        server = self._server
        return server.stats if server is not None else FaultStats()

    # ------------------------------------------------------------- plumbing
    def _shard_plan(self) -> List[ShardInfo]:
        if isinstance(self.source, ShardDataset):
            return self.source.epoch_plan(self.epochs, shuffle=self.shuffle,
                                          seed=self.seed)
        plan: List[ShardInfo] = []
        for _epoch in range(self.epochs):
            for i, it in enumerate(self.source):
                if not isinstance(it, ShardInfo):
                    import os
                    it = ShardInfo(path=str(it),
                                   nbytes=os.path.getsize(str(it)),
                                   n_rows=0, seq=i)
                plan.append(it)
        return plan

    def _read_with_retry(self, info: ShardInfo, sid: int, worker_id: str):
        """One shard read with bounded transient-error retry.

        Returns ``(reader, env, seconds)``. ``OSError`` (real filesystem
        hiccups and injected :class:`ChaosTransientIOError`) retries up to
        ``self.retries`` times with exponential backoff, heartbeating the
        lease between attempts; :class:`ShardFormatError` (corruption) and
        :class:`ChaosKill` pass straight through.
        """
        tracer = get_tracer()
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                with tracer.span("io.read_shard", seq=info.seq,
                                 attempt=attempt):
                    if self.chaos is not None:
                        self.chaos.trip("read", sid, worker_id)
                    reader = ShardReader(info.path, verify=self.verify)
                    env = reader.read_all(self.columns)
                    if self.transform is not None:
                        env = self.transform(env, info)
                return reader, env, time.perf_counter() - t0
            except OSError as e:
                attempt += 1
                if attempt > self.retries:
                    raise
                server = self._server
                if server is not None:
                    server.record_retry()
                    server.heartbeat(worker_id, sid)
                w0 = tracer.now_ns() if tracer.enabled else 0
                aborted = self._stop.wait(
                    self.retry_backoff * (2 ** (attempt - 1)))
                if tracer.enabled:
                    tracer.complete("io.retry", w0, tracer.now_ns(),
                                    seq=info.seq, attempt=attempt,
                                    error=type(e).__name__)
                if aborted:
                    raise

    def _lease_reader(self, worker_id: str, out: "queue.Queue") -> None:
        """Reader-thread body: acquire -> read (retry) -> commit -> publish.

        Publish strictly follows a *winning* commit, so the server's commit
        log is exactly the multiset of yielded shards; a lost commit race
        (backup or reissued duplicate finished first) discards the copy
        without touching IngestStats.
        """
        tracer = get_tracer()
        server = self._server
        info: Optional[ShardInfo] = None
        sid: Optional[int] = None
        try:
            while not self._stop.is_set():
                sid = server.acquire(worker_id)
                if sid is None:
                    if server.done():
                        break
                    # In-flight leases may yet be reaped or backed up.
                    time.sleep(0.005)
                    continue
                info = self._plan[sid]
                with self._lock:
                    self._active[worker_id] = sid
                try:
                    if self.chaos is not None:
                        self.chaos.trip("acquire", sid, worker_id)
                    reader, env, dt = self._read_with_retry(
                        info, sid, worker_id)
                    if self.chaos is not None:
                        # Worst kill point: work done but unacknowledged.
                        self.chaos.trip("commit", sid, worker_id)
                finally:
                    with self._lock:
                        self._active.pop(worker_id, None)
                if server.commit(worker_id, sid):
                    with self._lock:
                        self.stats.shards += 1
                        self.stats.bytes_read += reader.nbytes
                        self.stats.bytes_decoded += reader.bytes_decoded
                        self.stats.columns_decoded += reader.columns_decoded
                        self.stats.read_seconds += dt
                    self._put(out, (sid, env))
        except ChaosKill:
            # Simulated silent death: no fail_worker, no error to the
            # consumer — recovery must come from the lease reaper, exactly
            # as for a SIGKILL'd worker.
            if tracer.enabled:
                tracer.instant("fault.kill", worker=worker_id)
            return
        except BaseException as e:  # propagate to the consumer
            server.fail_worker(worker_id)
            self._put(out, _ReaderError(e, info.path if info else "?",
                                        sid if info else None), force=True)
            return
        with self._lock:
            self._clean.add(worker_id)

    def _heartbeat_loop(self) -> None:
        """Refresh every live reader's lease; a dead reader's lease goes
        stale (the thread-alive check is what lets the reaper notice)."""
        server = self._server
        interval = max(min(self.lease_timeout / 4.0, 1.0), 0.01)
        while not self._stop.is_set():
            with self._lock:
                active = dict(self._active)
            threads = dict(self._reader_threads)
            for worker_id, sid in active.items():
                t = threads.get(worker_id)
                if t is not None and t.is_alive():
                    server.heartbeat(worker_id, sid)
            if server.done():
                break
            self._stop.wait(interval)

    def _reaper_loop(self) -> None:
        """Expire dead readers' leases and duplicate-issue stragglers."""
        tracer = get_tracer()
        server = self._server
        interval = max(min(self.lease_timeout / 2.0, 1.0), 0.01)
        while not self._stop.is_set():
            w0 = tracer.now_ns() if tracer.enabled else 0
            reissued = server.reap()
            if reissued and tracer.enabled:
                tracer.complete("fault.reap", w0, tracer.now_ns(),
                                reissued=len(reissued))
            for sid in server.issue_backups():
                if tracer.enabled:
                    tracer.instant("fault.backup", shard=sid)
            if server.done():
                break
            self._stop.wait(interval)

    def _ensure_readers(self, out: "queue.Queue") -> None:
        """Consumer-side pool supervision (runs when the queue goes quiet):
        respawn readers that died without finishing (chaos kills), within
        the respawn budget; raise if the whole pool is gone with shards
        still uncommitted."""
        server = self._server
        if server is None or server.done() or self._stop.is_set():
            return
        with self._lock:
            clean = set(self._clean)
        dead = [wid for wid, t in self._reader_threads.items()
                if not t.is_alive() and wid not in clean]
        if not dead:
            return
        tracer = get_tracer()
        budget = (self.max_respawns if self.max_respawns is not None
                  else 2 * self.workers + 2)
        for wid in dead:
            self._reader_threads.pop(wid, None)
            if self._respawns >= budget:
                raise RuntimeError(
                    f"shard reader pool exhausted: {self._respawns} respawns "
                    f"used and reader {wid!r} died with shards uncommitted")
            self._respawns += 1
            server.record_respawn()
            new_wid = f"reader-r{self._respawns}"
            t = threading.Thread(target=self._lease_reader,
                                 args=(new_wid, out), daemon=True,
                                 name=f"shard-reader-r{self._respawns}")
            self._reader_threads[new_wid] = t
            self._threads.append(t)
            t.start()
            if tracer.enabled:
                tracer.instant("fault.respawn", worker=new_wid,
                               replacing=wid)

    def _put(self, out: "queue.Queue", item: Any, *, force: bool = False) -> None:
        """Bounded put that respects close(); stall time is backpressure.

        After close() the consumer is gone, so every put (errors included)
        aborts rather than spinning on a full queue.
        """
        tracer = get_tracer()
        w0 = tracer.now_ns() if tracer.enabled else 0
        t0 = time.perf_counter()
        while True:
            try:
                out.put(item, timeout=0.05)
                break
            except queue.Full:
                if self._stop.is_set():
                    return
        stall = time.perf_counter() - t0
        if stall > 1e-4 and not force:
            with self._lock:
                self.stats.reader_stall_seconds += stall
            if tracer.enabled:
                # Reader blocked on a full queue: the consumer (FE/train)
                # is the bottleneck over this window.
                tracer.complete("io.backpressure", w0, tracer.now_ns())

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._running:
            raise RuntimeError("StreamingLoader is already being iterated")
        # Fresh stats per pass: a reused loader must not blend a prior
        # (possibly abandoned) pass into this run's throughput numbers.
        # Under _lock: a prior pass's readers may still be draining.
        with self._lock:
            self.stats = IngestStats()
            self._active = {}
        plan = self._shard_plan()
        self._plan = plan
        self._server = ShardServer(
            len(plan), lease_timeout=self.lease_timeout,
            straggler=(self.straggler if self.straggler is not None
                       else StragglerPolicy()))
        out: "queue.Queue" = queue.Queue(
            maxsize=max(self.prefetch, self.workers))
        n_workers = min(self.workers, max(1, len(plan)))
        self._stop.clear()
        self._out = out
        self._clean = set()
        self._respawns = 0
        self._reader_threads = {}
        for i in range(n_workers):
            wid = f"reader-{i}"
            self._reader_threads[wid] = threading.Thread(
                target=self._lease_reader, args=(wid, out),
                daemon=True, name=f"shard-reader-{i}")
        self._threads = list(self._reader_threads.values())
        self._aux_threads = [
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="shard-heartbeat"),
            threading.Thread(target=self._reaper_loop, daemon=True,
                             name="shard-reaper"),
        ]
        self._running = True
        t_start = time.perf_counter()
        for t in self._threads:
            t.start()
        for t in self._aux_threads:
            t.start()
        tracer = get_tracer()
        n_items = len(plan)
        received = 0
        next_out = 0
        hold: Dict[int, Any] = {}  # ordered-mode reorder buffer
        failed: Dict[int, _ReaderError] = {}   # and its failures, raised in turn
        try:
            while received < n_items:
                w0 = tracer.now_ns() if tracer.enabled else 0
                t0 = time.perf_counter()
                item = None
                while item is None:
                    try:
                        item = out.get(timeout=0.05)
                    except queue.Empty:
                        # Quiet queue: check the pool (a chaos-killed
                        # reader is invisible until someone looks).
                        self._ensure_readers(out)
                stall = time.perf_counter() - t0
                if stall > 1e-4:
                    # Under _lock: readers concurrently update sibling
                    # IngestStats fields (a lost update otherwise).
                    with self._lock:
                        self.stats.consumer_stall_seconds += stall
                    if tracer.enabled:
                        # Consumer blocked on an empty queue: the disk /
                        # decode side is the bottleneck over this window.
                        tracer.complete("io.wait_shard", w0, tracer.now_ns())
                with self._lock:
                    self.stats.max_queue_depth = max(
                        self.stats.max_queue_depth, out.qsize() + 1)
                tracer.counter("io.queue_depth", out.qsize() + 1)
                if isinstance(item, _ReaderError):
                    if not self.ordered or item.sid is None or item.sid < next_out:
                        raise RuntimeError(
                            f"shard reader failed on {item.shard}") from item.exc
                    failed.setdefault(item.sid, item)
                else:
                    sid, env = item
                    received += 1
                    if not self.ordered:
                        yield env
                        continue
                    hold[sid] = env
                while self.ordered and (next_out in failed or next_out in hold):
                    if next_out in failed:
                        err = failed[next_out]
                        raise RuntimeError(
                            f"shard reader failed on {err.shard}") from err.exc
                    yield hold.pop(next_out)
                    next_out += 1
        finally:
            with self._lock:
                self.stats.wall_seconds += time.perf_counter() - t_start
            self.close()

    def close(self) -> None:
        """Stop readers and release queue slots (idempotent).

        Readers may refill the queue between drains (a shard decode was in
        flight), so drain-and-join loops until every thread has exited.
        """
        self._stop.set()
        for t in self._threads + self._aux_threads:
            while t.is_alive():
                if self._out is not None:
                    try:
                        while True:
                            self._out.get_nowait()
                    except queue.Empty:
                        pass
                t.join(timeout=0.1)
        self._threads = []
        self._aux_threads = []
        self._reader_threads = {}
        self._running = False
