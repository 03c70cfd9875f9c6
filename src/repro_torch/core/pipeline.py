"""End-to-end pipelined execution (paper Fig. 1 lower / Fig. 3).

FeatureBox's headline mechanism: feature extraction and training share the
same servers and run as a mini-batch pipeline, so extracted features are fed
directly into the trainer without materializing intermediates. A port of
the JAX package's ``repro.core.pipeline``.

Two executors:

* :class:`PipelinedRunner` — FeatureBox mode. A worker thread runs the FE
  layers for batch i+1 while the train thread steps on batch i; the bounded
  queue provides backpressure. With ``device_feed`` set to a
  :class:`~repro_torch.core.devicefeed.DeviceFeeder`, a third stage is
  inserted — *read+extract -> H2D stage -> train* — where the ``h2d-feeder``
  thread stages batch i+1 through the arena ring while batch i trains. With
  ``ps_feed`` set to a :class:`~repro_torch.embedding.psfeed.HierarchyFeed`,
  a ``ps-feeder`` thread between the FE worker and the ``h2d-feeder`` pulls
  batch i+1's working set from the hierarchical parameter server while
  batch i trains.
* :class:`StagedRunner` — the MapReduce-style baseline: stage after stage,
  each stage writes its full output to disk and the next reads it back.

On the card every thread has a stream of its own, so no thread's copies or
launches queue behind another's work:

* the ``fe-worker`` thread runs the FE layers (host ops, H2D of their
  outputs, ``feature_hash`` and the FE device ops) on a stream the runner
  creates; the blocking H2D copies of the FE layers would otherwise wait for
  every step kernel already queued on the compute stream;
* the ``ps-feeder`` thread pulls with the PS feed's own stream
  (:attr:`HierarchyFeed.stream`) as its current stream, so its copies of
  the ids to the host and of the working set to the card wait only for FE
  work;
* the ``h2d-feeder`` thread stages with the feeder's own stream
  (:attr:`DeviceFeeder.stream`) as its current stream, so the arena
  binding's copies of CUDA slots back to the host wait only for FE work;
* the train thread steps on the caller's current stream.

Every batch handed from one thread to the next carries a CUDA event
recorded on the producer's stream after its work; the consumer's stream
waits on it, and every CUDA tensor of the batch is ``record_stream``-ed on
the consumer's stream, so the caching allocator never hands its memory to
the producer's stream while the consumer may still read it.

Both runners take any iterable of raw batches — in particular a
:class:`repro_torch.io.StreamingLoader`, whose ``IngestStats`` are attached
to :attr:`PipelineStats.ingest` after the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.check.annotations import single_writer
from repro_torch.core.devicefeed import DeviceFeeder
from repro_torch.core.metakernel import ExecutionStats, LayerExecutable, run_layers
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding.psfeed import HierarchyFeed
from repro_torch.obs.trace import get_tracer

# Sentinel for end-of-stream in the prefetch queue.
_DONE = object()

# A batch between threads: its environment and the event its consumer's
# stream waits on (None on the CPU).
_Batch = Tuple[Dict[str, Any], Optional[torch.cuda.Event]]


@dataclasses.dataclass
class PipelineStats:
    batches: int = 0
    fe_seconds: float = 0.0
    train_seconds: float = 0.0
    # StagedRunner only: time draining the batch source up front (disk reads
    # with no compute overlap).
    drain_seconds: float = 0.0
    wall_seconds: float = 0.0
    intermediate_bytes: int = 0  # bytes written to disk between stages
    exec_stats: ExecutionStats = dataclasses.field(default_factory=ExecutionStats)
    # the batch source's IngestStats (a repro_torch.io.StreamingLoader)
    ingest: Optional[Any] = None
    # the DeviceFeeder's FeedStats, when a feeder staged the batches
    feed: Optional[Any] = None
    # the train step's TrainFeedStats (ModelFeed.make_step), splitting
    # "adapt" out of the train bucket
    train_feed: Optional[Any] = None
    # the lease-based loader's FaultStats
    fault: Optional[Any] = None
    # PS-pull stage seconds (ps-feeder thread) and the HierarchyFeed, when a
    # ps_feed pulled the working sets
    ps_seconds: float = 0.0
    ps: Optional[Any] = None
    # the mesh step's CommStats (repro_torch.train.compression), the comm tier
    comm: Optional[Any] = None

    @property
    def adapt_seconds(self) -> float:
        """Host time spent adapting staged batches to the model's layout
        (0 when the train step carries no train-feed stats)."""
        return (self.train_feed.adapt_seconds
                if self.train_feed is not None else 0.0)

    @property
    def train_net_seconds(self) -> float:
        """train_seconds with the measurable adapt share split out."""
        return max(self.train_seconds - self.adapt_seconds, 0.0)

    # The accounting identity both runners satisfy:
    #     wall <= fe + train + drain + overhead
    # with equality for the serial (Staged) runner, overhead >= 0 always,
    # and the pipelined runner's surplus busy time showing up as overlap.

    @property
    def busy_seconds(self) -> float:
        """Stage time summed across threads: fe + ps + train + drain.
        Exceeds wall exactly when pipelining hid stage time behind another
        stage."""
        return (self.fe_seconds + self.ps_seconds + self.train_seconds
                + self.drain_seconds)

    @property
    def overhead_seconds(self) -> float:
        """Wall time no stage accounts for (queue waits, thread startup,
        end-of-stream drain). Never negative."""
        return max(self.wall_seconds - self.busy_seconds, 0.0)

    @property
    def overlap_seconds(self) -> float:
        """Stage seconds hidden by pipelining (busy time beyond wall)."""
        return max(self.busy_seconds - self.wall_seconds, 0.0)

    @property
    def overlap_fraction(self) -> float:
        """How much of the smaller stage (FE vs train) was hidden behind
        the other, in [0, 1]. 0 = fully serial; 1 = the cheaper stage ran
        entirely in the other's shadow."""
        denom = min(self.fe_seconds, self.train_seconds)
        if denom <= 0.0:
            return 0.0
        return min(self.overlap_seconds / denom, 1.0)


def _capture_ingest(stats: PipelineStats, batches: Any) -> None:
    """Adopt ingest stats from a StreamingLoader-like batch source."""
    src_stats = getattr(batches, "stats", None)
    if src_stats is not None and hasattr(src_stats, "bytes_read"):
        stats.ingest = src_stats


def _capture_fault(stats: PipelineStats, batches: Any) -> None:
    """Adopt recovery stats from a lease-based StreamingLoader source."""
    fs = getattr(batches, "fault_stats", None)
    if fs is not None and hasattr(fs, "reissued"):
        stats.fault = fs


def _capture_train_feed(stats: PipelineStats, train_step: Any) -> None:
    """Adopt train-feed stats from a ModelFeed.make_step boundary step."""
    fs = getattr(train_step, "feed_stats", None)
    if fs is not None and hasattr(fs, "adapt_seconds"):
        stats.train_feed = fs


def _capture_comm(stats: PipelineStats, train_step: Any) -> None:
    """Adopt the mesh step's collective stats from the train step's
    ``comm_stats`` (a :class:`repro_torch.train.compression.CommStats`)."""
    cs = getattr(train_step, "comm_stats", None)
    if cs is not None and hasattr(cs, "interpod_bytes_total"):
        stats.comm = cs


def _on_stream(stream: Optional[torch.cuda.Stream]):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _ready(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event behind the current stream's work so far (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _adopt(batch: _Batch, device: torch.device) -> Dict[str, Any]:
    """Take a batch from another thread onto the current stream: wait for
    the producer's event and mark every CUDA tensor as used here."""
    env, ready = batch
    if ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for val in env.values():
            if isinstance(val, torch.Tensor) and val.device.type == "cuda":
                val.record_stream(stream)
    return env


# Thread contract: every PipelineStats field has exactly one writing
# thread — the fe-worker owns fe_seconds, the ps-feeder ps_seconds, the
# train thread the rest (it reads them only after joining the workers).
@single_writer("stats.fe_seconds",                       # fe-worker thread
               "stats.ps_seconds",                       # ps-feeder thread
               "stats.train_seconds", "stats.batches",   # main train loop
               "stats.wall_seconds", "stats.feed", "stats.ps")
class PipelinedRunner:
    """FeatureBox: FE for batch i+1 overlaps training on batch i.

    With ``device_feed`` set, an H2D staging thread is inserted between the
    FE worker and the train loop (three-stage pipeline); ``None`` keeps the
    two-stage path and hands the FE environments straight to
    ``train_step``. ``device`` is where the FE device layer runs: the card
    unless the caller asks for ``"cpu"``.

    With ``ps_feed`` set (a :class:`repro_torch.embedding.psfeed.
    HierarchyFeed`), a PS-pull stage runs between the FE worker and the
    H2D/train stages: batch i+1's dedup'd working set is pulled from the
    hierarchical parameter server while batch i trains — the paper's
    pre-built working parameter set, as a pipeline stage.
    """

    def __init__(
        self,
        layers: List[LayerExecutable],
        train_step: Callable[[Any, Mapping[str, Any]], Any],
        *,
        prefetch: int = 2,
        device: DeviceLike = None,
        device_feed: Optional[DeviceFeeder] = None,
        ps_feed: Optional[HierarchyFeed] = None,
    ) -> None:
        self.layers = layers
        self.train_step = train_step
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.device_feed = device_feed
        self.ps_feed = ps_feed
        self.stats = PipelineStats()

    @classmethod
    def from_plan(cls, plan: Any, train_step: Callable[[Any, Mapping[str, Any]], Any],
                  *, prefetch: int = 2, device: DeviceLike = None, feed: str = "off",
                  split_sparse_fields: bool = False,
                  rows_hint: Optional[int] = None,
                  buffers: int = 3) -> "PipelinedRunner":
        """Wire a compiled ``repro_torch.fe.featureplan.FeaturePlan`` into a
        runner. ``feed`` selects the H2D tier:

        * ``"off"``   — two-stage pipeline; the train step receives the FE
          environment as the plan's layers leave it;
        * ``"stage"`` — three-stage: a :class:`DeviceFeeder` copies each
          batch's outputs into the block-planned arena and transfers it;
        * ``"arena"`` — FE assembles the ``batch_*`` outputs **directly
          into claimed arena views** (``plan.arena_binding()``).
        """
        if feed == "off":
            return cls(plan.layers, train_step, prefetch=prefetch, device=device)
        if feed == "stage":
            feeder = DeviceFeeder(
                plan.feed_layout(split_sparse_fields=split_sparse_fields),
                rows_hint=rows_hint, buffers=buffers, device=device)
            return cls(plan.layers, train_step, prefetch=prefetch,
                       device=device, device_feed=feeder)
        if feed == "arena":
            ab = plan.arena_binding(split_sparse_fields=split_sparse_fields)
            feeder = ab.make_feeder(rows_hint=rows_hint, buffers=buffers, device=device)
            return cls(ab.layers, train_step, prefetch=prefetch,
                       device=device, device_feed=feeder)
        raise ValueError(f"feed must be 'off', 'stage', or 'arena', got {feed!r}")

    def _fe_worker(self, batches: Iterator[Mapping[str, Any]], q: "queue.Queue",
                   stop: threading.Event, stream: Optional[torch.cuda.Stream]) -> None:
        tracer = get_tracer()
        try:
            with _on_stream(stream):
                for bi, raw in enumerate(batches):
                    if stop.is_set():  # consumer died: don't extract the rest
                        break
                    t0 = time.perf_counter()
                    with tracer.span("fe.extract", batch=bi):
                        env = dict(raw)
                        run_layers(self.layers, env, device=self.device,
                                   stats=self.stats.exec_stats)
                        batch = (env, _ready(self.device))
                    self.stats.fe_seconds += time.perf_counter() - t0
                    self._put(q, batch, stop)
        except BaseException as e:  # surface worker failures to the consumer
            tracer.instant("fe.error", kind=type(e).__name__)
            self._put(q, e, stop)
        finally:
            self._put(q, _DONE, stop)

    @staticmethod
    def _put(q: "queue.Queue", item: Any, stop: threading.Event) -> None:
        """Backpressured put that gives up once the consumer is gone, so a
        failed train_step can't leave a worker blocked forever."""
        while True:
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                if stop.is_set():
                    return

    def _feed_worker(self, q: "queue.Queue", out: "queue.Queue",
                     stop: threading.Event) -> None:
        """H2D stage: pull extracted batches, stage batch i+1 while i trains.

        Sentinels and FE-worker exceptions pass through unchanged so the
        consumer sees the original failure, not a feed artifact.
        """
        try:
            with _on_stream(self.device_feed.stream):
                while True:
                    try:
                        item = q.get(timeout=0.1)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is _DONE:
                        self._put(out, _DONE, stop)
                        return
                    if isinstance(item, BaseException):
                        self._put(out, item, stop)
                        continue  # _DONE follows from the FE worker
                    staged = self.device_feed.stage(_adopt(item, self.device))
                    self._put(out, (staged, _ready(self.device)), stop)
        except BaseException as e:  # staging failure: surface + terminate
            self._put(out, e, stop)
            self._put(out, _DONE, stop)

    def _ps_worker(self, q: "queue.Queue", out: "queue.Queue",
                   stop: threading.Event) -> None:
        """PS stage: pull batch i+1's working set while batch i trains, on
        the PS feed's stream (:attr:`HierarchyFeed.stream`, None on the CPU).

        Same pass-through contract as :meth:`_feed_worker` — sentinels and
        upstream exceptions flow downstream unchanged.
        """
        try:
            with _on_stream(self.ps_feed.stream):
                while True:
                    try:
                        item = q.get(timeout=0.1)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is _DONE:
                        self._put(out, _DONE, stop)
                        return
                    if isinstance(item, BaseException):
                        self._put(out, item, stop)
                        continue  # _DONE follows from the FE worker
                    t0 = time.perf_counter()
                    prepared = self.ps_feed(_adopt(item, self.device))
                    self.stats.ps_seconds += time.perf_counter() - t0
                    self._put(out, (prepared, _ready(self.device)), stop)
        except BaseException as e:  # pull/consistency failure: surface it
            self._put(out, e, stop)
            self._put(out, _DONE, stop)

    def run(self, state: Any, batches: Iterable[Mapping[str, Any]]) -> Any:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t_start = time.perf_counter()
        fe_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                     else None)
        worker = threading.Thread(
            target=self._fe_worker, args=(iter(batches), q, stop, fe_stream),
            daemon=True, name="fe-worker",
        )
        threads = [worker]
        queues = [q]
        out_q = q
        if self.ps_feed is not None:
            # Working sets hold device buffers: keep at most one prepared
            # batch queued ahead of the train loop (single-batch pull-ahead;
            # the consistency protocol in HierarchyFeed assumes it).
            ps_q: "queue.Queue" = queue.Queue(maxsize=1)
            ps_feeder = threading.Thread(
                target=self._ps_worker, args=(out_q, ps_q, stop),
                daemon=True, name="ps-feeder",
            )
            threads.append(ps_feeder)
            queues.append(ps_q)
            out_q = ps_q
        if self.device_feed is not None:
            # Bounded by the buffer ring: with one batch held by the train
            # loop and one being staged, at most buffers-2 more fit in the
            # queue before the feeder would reclaim a ring slot.
            feed_q: "queue.Queue" = queue.Queue(
                maxsize=max(1, self.device_feed.buffers - 2))
            feeder = threading.Thread(
                target=self._feed_worker, args=(out_q, feed_q, stop),
                daemon=True, name="h2d-feeder",
            )
            threads.append(feeder)
            queues.append(feed_q)
            out_q = feed_q
        for t in threads:
            t.start()
        tracer = get_tracer()
        try:
            while True:
                if tracer.enabled:
                    # Record the wait for the next batch only when it
                    # stalled the train loop: the pipeline's backpressure.
                    w0 = tracer.now_ns()
                    item = out_q.get()
                    w1 = tracer.now_ns()
                    if w1 - w0 > 100_000:  # >0.1 ms
                        tracer.complete("train.wait_batch", w0, w1)
                else:
                    item = out_q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                t0 = time.perf_counter()
                with tracer.span("train.step", batch=self.stats.batches):
                    state = self.train_step(state, _adopt(item, self.device))
                self.stats.train_seconds += time.perf_counter() - t0
                self.stats.batches += 1
                # Release the batch before blocking on the next get so its
                # memory is reclaimed as soon as the device is done with it.
                del item
        finally:
            stop.set()
            if self.ps_feed is not None:
                # Unblock a prepare() waiting on a write-back that will
                # never arrive (HierarchyFeed.close never raises).
                # Drain/flush is the driver's job, not teardown's.
                self.ps_feed.close()
            for qq in queues:  # release workers blocked on a full queue
                try:
                    while True:
                        qq.get_nowait()
                except queue.Empty:
                    pass
            for t in threads:
                t.join(timeout=5.0)
            if self.device_feed is not None:
                # Drain in-flight copies so wall time covers them — but only
                # once the feeder thread is confirmed dead: join can time out
                # with the thread still inside stage(), and flush must not
                # race the ring it is draining.
                if not any(t.is_alive() for t in threads):
                    self.device_feed.flush()
                self.stats.feed = self.device_feed.stats
            if self.ps_feed is not None:
                self.stats.ps = self.ps_feed
            self.stats.wall_seconds = time.perf_counter() - t_start
            _capture_ingest(self.stats, batches)
            _capture_fault(self.stats, batches)
            _capture_train_feed(self.stats, self.train_step)
            _capture_comm(self.stats, self.train_step)
        return state


class StagedRunner:
    """Baseline: materialize every stage's output before the next stage runs.

    Mirrors the paper's Fig. 1 (upper): MapReduce jobs write intermediate
    files to the DFS; the trainer then streams the final features back. Here
    each scheduled layer plays the role of one MapReduce job and writes its
    produced slots to ``workdir`` as .npy files (tensors come back to the
    device they were on).
    """

    def __init__(
        self,
        layers: List[LayerExecutable],
        train_step: Callable[[Any, Mapping[str, Any]], Any],
        *,
        workdir: str,
        device: DeviceLike = None,
    ) -> None:
        self.layers = layers
        self.train_step = train_step
        self.workdir = workdir
        self.device = resolve_device(device)
        self.stats = PipelineStats()
        os.makedirs(workdir, exist_ok=True)

    def _materialize(self, env: Dict[str, Any], stage: int, batch: int) -> Dict[str, Any]:
        """Write every slot to disk and read it back (stage boundary)."""
        return {slot: self._roundtrip(val, f"b{batch}_s{stage}_{_safe(slot)}")
                for slot, val in env.items()}

    def _roundtrip(self, val: Any, stem: str) -> Any:
        if isinstance(val, torch.Tensor):
            arr = self._roundtrip(val.cpu().numpy(), stem)
            return torch.from_numpy(arr).to(val.device)
        if isinstance(val, dict):
            return {k: self._roundtrip(v, f"{stem}__{_safe(str(k))}")
                    for k, v in val.items()}
        if hasattr(val, "values") and hasattr(val, "lengths"):  # RaggedColumn
            vals = self._roundtrip(np.asarray(val.values), stem + "__values")
            lens = self._roundtrip(np.asarray(val.lengths), stem + "__lengths")
            return type(val)(values=vals, lengths=lens)
        arr = np.asarray(val)
        path = os.path.join(self.workdir, stem + ".npy")
        np.save(path, arr, allow_pickle=True)  # string columns are object arrays
        # on-disk size: for object (string) columns arr.nbytes counts pointers
        self.stats.intermediate_bytes += os.path.getsize(path)
        return np.load(path, allow_pickle=True)

    def run(self, state: Any, batches: Iterable[Mapping[str, Any]]) -> Any:
        tracer = get_tracer()
        t_start = time.perf_counter()
        # A StreamingLoader source is drained up front: the staged baseline
        # has no read/compute overlap by definition.
        with tracer.span("staged.drain"):
            all_batches = list(batches)
        self.stats.drain_seconds = time.perf_counter() - t_start
        _capture_ingest(self.stats, batches)
        _capture_fault(self.stats, batches)
        # Stage-after-stage: every batch through layer k, materialize, then
        # layer k+1 — the defining property of the baseline.
        envs: List[Dict[str, Any]] = [dict(b) for b in all_batches]
        for li, layer in enumerate(self.layers):
            t0 = time.perf_counter()
            with tracer.span("fe.stage", layer=li, batches=len(envs)):
                for bi, env in enumerate(envs):
                    run_layers([layer], env, device=self.device,
                               stats=self.stats.exec_stats)
                    envs[bi] = self._materialize(env, li, bi)
            self.stats.fe_seconds += time.perf_counter() - t0
        for bi, env in enumerate(envs):
            t0 = time.perf_counter()
            with tracer.span("train.step", batch=bi):
                state = self.train_step(state, env)
            self.stats.train_seconds += time.perf_counter() - t0
            self.stats.batches += 1
        self.stats.wall_seconds = time.perf_counter() - t_start
        _capture_train_feed(self.stats, self.train_step)
        _capture_comm(self.stats, self.train_step)
        return state


def _safe(slot: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in slot)
