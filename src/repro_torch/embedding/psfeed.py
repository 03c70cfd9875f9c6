"""Working-set prefetch for the hierarchical PS (the streaming PS tier).

:class:`HierarchyFeed` wires :class:`~repro_torch.embedding.hierarchy.
HierarchicalPS` into the pipelined runner as a fourth stage — *read+extract
-> PS pull -> H2D stage -> train* — so the dedup'd working-set ``pull()``
for batch i+1 overlaps batch i's train step, the same trick the
:class:`~repro_torch.core.devicefeed.DeviceFeeder` plays for H2D transfers
(arXiv 2003.05622's pre-building of the working parameter set). A port of
the JAX package's ``repro.embedding.psfeed``.

Consistency protocol (pull-ahead vs write-back)
-----------------------------------------------
``prepare(env)`` (prefetch thread) pulls batch *n*'s working set
*optimistically*, possibly before batch *n-1*'s updated rows were pushed
back. Before releasing the batch it (a) waits until every predecessor's
push has applied, then (b) re-reads exactly the rows that were pushed
after its pull snapshot (the intersection of its unique set with the
recently-pushed id sets). The expensive SSD gather therefore overlaps
training, while the released working set is always identical to a serial
pull-train-push execution (bit for bit on the CPU,
``tests/test_torch_hierarchy.py``).

The device seams (CUDA streams and events)
------------------------------------------
* ``_pack`` (prefetch thread): the pulled rows, ids and inverse go into
  pinned host tensors and are copied to the card with
  ``non_blocking=True`` on the **current** stream. In the runner that is
  the ps-feeder thread's stream, :attr:`HierarchyFeed.stream`; the runner
  records an event behind the copies and the consumer's stream waits on it
  (``core/pipeline.py``'s ``(env, ready_event)`` hand-off). PyTorch's
  caching host allocator reuses a pinned block only after the copy out of
  it has completed (the event it records on each ``non_blocking`` copy).
  A caller that runs ``prepare`` on its own stream needs no event.
* ``complete(meta, ws_rows, ws_accum)`` (train thread): records an event
  behind the step on the current stream, and a copy stream of the feed
  waits on it and copies the updated rows and accumulators into pinned
  host memory; the write-back thread waits on that copy's event, never on
  a stream as a whole, then pushes. The train thread never synchronizes
  for the write-back. ``drain()`` is the epoch-end handshake: wait for
  every write-back, stop the writer, flush the SSD memmap.

On the CPU (``device="cpu"``) the same path runs with plain tensors.

Thread-shared state is annotated for the lockset audit
(:mod:`repro_torch.check.lockset`; this file is one of its
``DEFAULT_FILES``): the :class:`HierarchicalPS` instance itself is not
thread-safe, so *all* PS access (pull, read_rows, push) happens under
``_cond``'s lock.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.check.annotations import guarded_by, shared_entry, single_writer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding.dedup import MAX_ID
from repro_torch.obs.metrics import harvest

# Env slots prepare() attaches; ModelFeed.make_step(extra_slots=WS_SLOTS)
# forwards them verbatim into the train step's batch.
WS_SLOTS: Tuple[str, ...] = ("_ws_rows", "_ws_accum", "_ws_unique", "_ws_inverse")
# Companion slot holding the host-side PsBatchMeta (never enters the step).
WS_META = "_ws_meta"

_STOP = object()


class HierarchyFeedError(RuntimeError):
    """The PS feed could not build or write back a working set."""


def collect_gids_np(cfg, sparse: np.ndarray,
                    seq: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Host twin of :func:`repro_torch.models.recsys.collect_gids`.

    Same site keys, layouts, and packed-offset arithmetic, in numpy int64
    (integer math, so values match the device path exactly); site shapes
    agree with :func:`repro_torch.models.recsys.gid_site_shapes` by
    construction.
    """
    offsets = cfg.multi_table().offsets  # np.int64 per-field row offsets
    gids: Dict[str, np.ndarray] = {}
    if cfg.kind == "bst":
        if seq is None:
            raise HierarchyFeedError("bst batch is missing the seq block")
        seq_plus = np.concatenate(
            [seq, sparse[:, cfg.item_field][:, None]], axis=1)
        gids["seq"] = seq_plus.astype(np.int64) + int(offsets[cfg.item_field])
        other = np.delete(sparse, cfg.item_field, axis=1)
        other_offs = np.delete(offsets, cfg.item_field)
        gids["other"] = other.astype(np.int64) + other_offs[None, :]
    else:
        gids["sparse"] = sparse.astype(np.int64) + offsets[None, :]
    return gids


@dataclasses.dataclass
class PsFeedStats:
    """The PS-feed tier: where the pull/push seam's time went."""

    batches: int = 0          # working sets prepared
    pull_seconds: float = 0.0  # host time inside ps.pull (overlaps train)
    wait_seconds: float = 0.0  # prepare() blocked on predecessor write-backs
    fixups: int = 0            # batches that re-read rows pushed after pull
    fixup_rows: int = 0        # rows re-read by the consistency fixup
    push_seconds: float = 0.0  # write-back thread time inside ps.push
    completed: int = 0         # steps whose write-back was enqueued

    def as_metrics(self) -> Dict[str, float]:
        return harvest(self)


@guarded_by("_cond", "_applied", "_recent", "_error", "_closed", "stats")
@shared_entry("ps:prepare", "main:complete", "main:drain", "main:close")
@single_writer("_seq", "_drained")
class HierarchyFeed:
    """Pull-ahead / write-back engine between a :class:`HierarchicalPS`
    and the hierarchy train step.

    Call it like a stage: ``env -> env + WS_SLOTS`` (the pipelined runner's
    ``ps_feed`` hook does exactly that on its prefetch thread, with
    :attr:`stream` as its current stream). ``device`` is where the working
    set goes: the card unless the caller asks for ``"cpu"``.
    """

    def __init__(self, ps, model_feed, *, capacity: Optional[int] = None,
                 pad_accum: float = 0.1, max_pending: int = 2,
                 history: int = 16, device: DeviceLike = None) -> None:
        cfg = model_feed.config
        self.ps = ps
        self.mf = model_feed
        self.cfg = cfg
        self.embed_dim = int(cfg.embed_dim)
        if ps.dim != self.embed_dim + 1:
            raise HierarchyFeedError(
                f"PS table dim {ps.dim} != embed_dim+1 ({self.embed_dim + 1}) "
                f"— the feed colocates the Adagrad accumulator as the last "
                f"column")
        self.capacity = int(capacity or cfg.dedup_capacity)
        if self.capacity <= 0:
            raise HierarchyFeedError(
                "working-set capacity is 0: tune cfg.dedup_capacity (e.g. "
                "via the loader rows hint) before building the feed")
        self.pad_accum = float(pad_accum)
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # the prefetch thread's stream, and the write-back copies' stream
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._d2h_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.stats = PsFeedStats()
        self._seq = 0                      # prepare() calls issued (ps thread)
        self._cond = threading.Condition()
        self._applied = 0                  # write-backs applied, in step order
        self._recent: "collections.deque" = collections.deque(maxlen=history)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._drained = False
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_pending))
        self._writer = threading.Thread(
            target=self._writer_loop, daemon=True, name="ps-writer")
        self._writer.start()

    # ----------------------------------------------------------- tier views
    @property
    def tier(self):
        """The PS's :class:`~repro_torch.embedding.hierarchy.TierStats`."""
        return self.ps.stats

    @property
    def pull_seconds(self) -> float:
        return self.stats.pull_seconds

    @property
    def wait_seconds(self) -> float:
        return self.stats.wait_seconds

    @property
    def host_hit_rate(self) -> float:
        return self.tier.host_hit_rate

    @property
    def evictions(self) -> int:
        return self.tier.evictions

    def as_metrics(self) -> Dict[str, float]:
        """Feed counters + the PS tier's stats, one flat dict (the ``ps``
        tier of :class:`repro_torch.obs.MetricsRegistry`)."""
        out = self.tier.as_metrics()
        out.update(harvest(self.stats))
        return out

    def summary(self) -> str:
        s = self.stats
        return (f"{self.tier.summary()} pull={s.pull_seconds:.3f}s "
                f"wait={s.wait_seconds:.3f}s fixups={s.fixups} "
                f"({s.fixup_rows} rows) push={s.push_seconds:.3f}s")

    # -------------------------------------------------------------- prepare
    def __call__(self, env):
        return self.prepare(env)

    def prepare(self, env) -> Dict[str, Any]:
        """Pull batch ``env``'s working set; returns env + ``WS_SLOTS``.

        Runs on the runner's ps-feeder thread: the pull overlaps the
        previous batch's train step, then the consistency wait/fixup makes
        the released rows identical to a serial execution.
        """
        seq = self._seq
        self._seq += 1

        sparse, seq_ids = self.mf.model_ids_np(env)
        gids = collect_gids_np(self.cfg, sparse, seq_ids)
        flat = np.concatenate([gids[s].reshape(-1) for s in sorted(gids)])

        t0 = time.perf_counter()
        with self._cond:
            self._check_live()
            ver0 = self._applied
            rows, unique, inverse = self.ps.pull(flat)
            self.stats.pull_seconds += time.perf_counter() - t0
            self.stats.batches += 1
        n_unique = len(unique)
        if n_unique > self.capacity:
            raise HierarchyFeedError(
                f"working set overflow: {n_unique} unique ids > capacity "
                f"{self.capacity} — raise the rows hint / dedup_capacity")

        t1 = time.perf_counter()
        with self._cond:
            while self._applied < seq:
                self._check_live()
                self._cond.wait(timeout=0.2)
            self._check_live()
            self.stats.wait_seconds += time.perf_counter() - t1
            if ver0 < self._applied:
                # Rows pushed after our pull snapshot are stale in `rows`:
                # re-read exactly those (or everything, if the push history
                # no longer covers the snapshot).
                stale = self._pushed_since(ver0)
                if stale is None:
                    fresh_ids = unique
                    pos = np.arange(n_unique)
                else:
                    fresh_ids, pos, _ = np.intersect1d(
                        unique, stale, assume_unique=True,
                        return_indices=True)
                if len(fresh_ids):
                    rows[pos] = self.ps.read_rows(fresh_ids)
                    self.stats.fixups += 1
                    self.stats.fixup_rows += len(fresh_ids)

        out = dict(env)
        out.update(self._pack(rows, unique, inverse))
        out[WS_META] = (seq, unique)
        return out

    def _pushed_since(self, version: int) -> Optional[np.ndarray]:
        """Union of unique-id sets pushed at step index >= ``version``
        (sorted), or None when the bounded history no longer reaches back
        to ``version`` (caller must then re-read everything). Lock held."""
        if self._recent and self._recent[0][0] > version:
            return None  # history window slid past the snapshot
        sets = [ids for s, ids in self._recent if s >= version]
        if not sets:
            return np.empty((0,), np.int64)
        return np.unique(np.concatenate(sets))

    def _pack(self, rows: np.ndarray, unique: np.ndarray,
              inverse: np.ndarray) -> Dict[str, torch.Tensor]:
        """FILL-pad the pulled working set to the static capacity on
        ``device``: rows (zeros past the live ones), accumulators
        (``pad_accum``), ids (``MAX_ID``) and the int32 inverse.

        On the card: pinned host tensors take the pulled block (rows with
        their accumulator column), the ids and the inverse; three
        ``non_blocking`` copies on the current stream move the live part,
        and the padding is written on the card."""
        cap, d = self.capacity, self.embed_dim
        n = len(unique)
        if not self._cuda:
            ws_rows = np.zeros((cap, d), np.float32)
            ws_rows[:n] = rows[:, :d]
            ws_accum = np.full((cap,), self.pad_accum, np.float32)
            ws_accum[:n] = rows[:, d]
            ws_unique = np.full((cap,), MAX_ID, np.int32)
            ws_unique[:n] = unique
            arrays = (ws_rows, ws_accum, ws_unique, inverse.astype(np.int32))
            return dict(zip(WS_SLOTS, (torch.from_numpy(a) for a in arrays)))

        # Fresh pinned tensors on every call, as in _fetch: the caching host
        # allocator records an event on each non_blocking copy and hands a
        # block out again only once that copy has completed.
        block = torch.empty((n, d + 1), dtype=torch.float32, pin_memory=True)
        np.copyto(block.numpy(), rows, casting="no")
        ids = torch.empty((n,), dtype=torch.int32, pin_memory=True)
        ids.numpy()[:] = unique
        inv = torch.empty((inverse.size,), dtype=torch.int32, pin_memory=True)
        inv.numpy()[:] = inverse.reshape(-1)

        dev = self.device
        live = block.to(dev, non_blocking=True)
        ws_unique = torch.full((cap,), MAX_ID, dtype=torch.int32, device=dev)
        ws_unique[:n].copy_(ids, non_blocking=True)
        ws_inverse = inv.to(dev, non_blocking=True)
        ws_rows = torch.zeros((cap, d), dtype=torch.float32, device=dev)
        ws_rows[:n] = live[:, :d]
        ws_accum = torch.full((cap,), self.pad_accum, dtype=torch.float32, device=dev)
        ws_accum[:n] = live[:, d]
        return dict(zip(WS_SLOTS, (ws_rows, ws_accum, ws_unique, ws_inverse)))

    # ------------------------------------------------------------- complete
    def complete(self, meta: Tuple[int, np.ndarray], ws_rows, ws_accum) -> None:
        """Enqueue step ``meta``'s updated rows for async write-back.

        ``ws_rows``/``ws_accum`` are the train step's outputs. On the card
        their live rows start copying to pinned host memory on the feed's
        copy stream behind an event recorded on the current stream; the
        write-back thread waits on the copy and pushes — training continues
        immediately.
        """
        with self._cond:
            self._check_live()
        seq, unique = meta
        self._queue.put((seq, unique) + self._fetch(ws_rows, ws_accum, len(unique)))
        with self._cond:
            self.stats.completed += 1

    def _fetch(self, ws_rows, ws_accum, n: int) -> Tuple[Any, Any, Optional[torch.cuda.Event]]:
        """Start bringing the first ``n`` updated rows and accumulators to
        the host; returns them and the event the writer waits on (None
        off the card)."""
        if not (isinstance(ws_rows, torch.Tensor) and ws_rows.device.type == "cuda"):
            return ws_rows, ws_accum, None
        step_done = torch.cuda.Event()
        step_done.record(torch.cuda.current_stream(ws_rows.device))
        rows = torch.empty((n, self.embed_dim), dtype=torch.float32, pin_memory=True)
        accum = torch.empty((n,), dtype=torch.float32, pin_memory=True)
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(step_done)
            rows.copy_(ws_rows[:n], non_blocking=True)
            accum.copy_(ws_accum[:n], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._d2h_stream)
        # the caching allocator must not hand their memory to the train
        # stream before the copy stream has read them
        ws_rows.record_stream(self._d2h_stream)
        ws_accum.record_stream(self._d2h_stream)
        return rows, accum, copied

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _STOP:
                    return
                seq, unique, ws_rows, ws_accum, copied = item
                with self._cond:
                    if self._error is not None:
                        # A failed write-back poisons the feed; later rows
                        # must not land on top of a hole in step order.
                        continue
                try:
                    n = len(unique)
                    t0 = time.perf_counter()
                    if copied is not None:
                        copied.synchronize()    # the step's rows are on the host
                    rows = np.asarray(ws_rows)[:n]
                    accum = np.asarray(ws_accum)[:n]
                    payload = np.concatenate([rows, accum[:, None]], axis=1)
                    with self._cond:
                        self.ps.push(unique, payload)
                        self._applied = seq + 1
                        self._recent.append((seq, unique))
                        self.stats.push_seconds += time.perf_counter() - t0
                        self._cond.notify_all()
                except BaseException as e:
                    with self._cond:
                        self._error = e
                        self._cond.notify_all()
            finally:
                self._queue.task_done()

    # ---------------------------------------------------------------- drain
    def drain(self) -> PsFeedStats:
        """Epoch-end handshake: wait for every write-back, stop the writer,
        flush the SSD tier. Idempotent; does not raise — write-back errors
        surface through the next ``prepare``/``complete`` (or :attr:`error`)."""
        if not self._drained:
            self._drained = True
            self.close()
            self._queue.join()
            self._queue.put(_STOP)
            self._writer.join(timeout=30.0)
            self.ps.flush()
        return self.stats

    def close(self) -> None:
        """Unblock any prepare() waiting on a write-back that will never
        come (pipeline teardown). Idempotent, never raises — the runner
        calls this duck-typed from its ``finally``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def error(self) -> Optional[BaseException]:
        with self._cond:
            return self._error

    def _check_live(self) -> None:
        """Lock held: raise if the feed was poisoned or torn down."""
        if self._error is not None:
            raise HierarchyFeedError(
                f"hierarchical PS write-back failed: {self._error!r}"
            ) from self._error
        if self._closed:
            raise HierarchyFeedError("hierarchy feed closed during teardown")
