"""Device-feed stage: arena-staged H2D transfers through pinned host buffers.

The stage between feature extraction and training. A :class:`DeviceFeeder`
stages each batch's ``batch_*`` output slots through a flat byte arena
(paper §V, Alg. 1): per batch one placement by the ``mempool_alloc`` kernel,
one head bump of the host :class:`~repro_torch.core.mempool.ArenaPool`, an
O(1) rewind, and **one** asynchronous copy of the arena's used bytes to the
card. The staged tensors are typed views of a device arena at the planned
offsets, bit for bit the batch's values.

Staging layout is static: :class:`FeedLayout` (from
``FeaturePlan.feed_layout()``) fixes per-slot row widths and dtypes, so the
arenas are sized once and a batch larger than the hint regrows them.

On the card the JAX package's readiness and donation handshake becomes CUDA
events on a side stream:

* the host ring holds ``buffers`` pinned, 128-byte-aligned buffers; one is
  rewritten only after the copy out of it has completed (its event);
* the copy runs on the feeder's own stream; the caller's (compute) stream
  waits on the copy's event before anything it enqueues next reads the
  staged tensors;
* a device arena is rewritten only after the step that read its batch has
  recorded its event: the consumer passes that event to
  :meth:`DeviceFeeder.donation_fence` after every step, in the order the
  batches were staged (``ModelFeed.make_step(fence_cb=...)`` does), and the
  feeder's stream waits on it before the next copy into the arena. A batch
  staged ahead of its consumer (more batches in flight than ``buffers``)
  never has its arena rewritten: its ring slot gets a fresh arena, and the
  old one lives as long as the staged tensors do (``record_stream`` keeps
  the caching allocator from reusing it while either stream may touch it).
  A consumer that does not donate (``make_step(donate=False)``) passes no
  fence, so each batch after the first ring's goes to a fresh arena and
  ``FeedStats.donated`` stays 0.

On the CPU (``device="cpu"``, the tests) the same path runs with plain host
buffers and synchronous copies.

Two entry forms, one transfer tail:

* the copy path, ``stage(env)`` with the plan's ``batch_*`` slots: each
  slot is checked against the layout and copied into the claimed pinned
  buffer. A slot that arrives as a CUDA tensor (the FE device layer's
  output) comes back to the host here, as the JAX feeder's ``np.asarray``
  does;
* the arena form, with a ``binding`` (``FeaturePlan.arena_binding()``)
  and a batch in pre-assembly form: the binding writes the ``batch_*``
  outputs straight into the claimed views (``FeedStats.copies_elided``).
  Its CUDA sources come back to the host in that write, on the current
  stream, synchronously, so the pinned bytes are complete before the H2D
  that reads them is queued.

``FeedStats.d2h_seconds`` counts the time of either form's copies of CUDA
slots back to the host.

Threads: in :class:`~repro_torch.core.pipeline.PipelinedRunner` the
``h2d-feeder`` thread drives :meth:`DeviceFeeder.stage` (and so
``claim_views``) with :attr:`DeviceFeeder.stream` as its current stream,
while the train thread calls :meth:`DeviceFeeder.donation_fence` after
each step and :meth:`DeviceFeeder.flush` once the feeder thread is gone.
The fence queue, the staging sequence and the copy events they share are
guarded by one lock (the decorators on the class state the contract).

Left out, with the reason: the JAX feeder's zero-copy probe and
``_aliases_host`` guard against ``device_put`` aliasing the host arena; a
copy from pinned memory into a device arena never aliases. The
``stage(env, claim=)`` form (a producer filling some slots of a claim
itself) has no caller on the port's paths.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.check.annotations import guarded_by, shared_entry, single_writer
from repro_torch.core.mempool import ALIGN, Allocation, ArenaPool, align_up, plan_offsets
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.mempool_alloc.ops import plan_block
from repro_torch.obs.metrics import harvest
from repro_torch.obs.trace import get_tracer


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One staged output slot: fixed per-row width and element dtype."""

    name: str
    width: int          # elements per row ([rows, width]; rank1 -> [rows])
    dtype: str          # numpy dtype name (itemsize divides the alignment)
    rank1: bool = False

    @property
    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, np.dtype(self.dtype).name)

    def nbytes(self, rows: int) -> int:
        return int(rows) * self.width * self.itemsize

    def shape(self, rows: int) -> Tuple[int, ...]:
        return (rows,) if self.rank1 else (rows, self.width)


@dataclasses.dataclass(frozen=True)
class FeedLayout:
    """Static staging layout: the compile-time contract of the feed stage.

    Sizes depend only on the batch row count, so arena capacity and slot
    placement are known before the first batch arrives.
    """

    slots: Tuple[SlotSpec, ...]
    align: int = ALIGN  # byte alignment of slot starts inside the arena

    def __post_init__(self) -> None:
        if not self.slots:
            raise ValueError("FeedLayout needs at least one slot")
        names = [s.name for s in self.slots]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slot names: {names}")

    @property
    def slot_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.slots)

    def sizes(self, rows: int) -> List[int]:
        """Per-slot byte sizes for a batch of ``rows`` instances."""
        return [s.nbytes(rows) for s in self.slots]

    def bytes_per_batch(self, rows: int) -> int:
        """Payload bytes staged per batch (before arena alignment)."""
        return sum(self.sizes(rows))

    def arena_bytes(self, rows: int) -> int:
        """Aligned arena capacity one batch of ``rows`` instances needs."""
        return int(align_up(sum(align_up(n, self.align)
                                for n in self.sizes(rows)), self.align))

    def plan(self, rows: int, *, use_kernel: bool = False,
             device: DeviceLike = None) -> Tuple[np.ndarray, int]:
        """Alg. 1 placement plan: per-slot arena offsets + total bytes.

        ``use_kernel=False`` runs :func:`repro_torch.core.mempool.
        plan_offsets` on the host; ``use_kernel=True`` runs the allocator
        kernel through :func:`repro_torch.kernels.mempool_alloc.ops.
        plan_block` on ``device`` (the card unless the caller asks for
        ``"cpu"``, which takes its plain version).
        """
        sizes = self.sizes(rows)
        if use_kernel:
            return plan_block(sizes, align=self.align, device=device)
        need = sum(align_up(n, self.align) for n in sizes)
        if need > np.iinfo(np.int32).max:
            raise OverflowError(
                f"feed layout needs {need} aligned bytes for rows={rows}, "
                f"which overflows the planner's int32 offsets; split the "
                f"batch")
        offsets, total = plan_offsets(torch.tensor(sizes, dtype=torch.int64),
                                      align=self.align)
        return offsets.numpy(), int(total)


@dataclasses.dataclass
class FeedStats:
    """Where the feed tier's time and bytes went."""

    batches: int = 0
    bytes_staged: int = 0       # payload bytes copied host->device
    h2d_seconds: float = 0.0    # env->arena copy + transfer dispatch
    d2h_seconds: float = 0.0    # the part of it bringing CUDA slots to the host arena
    place_seconds: float = 0.0  # Alg. 1 placement through the kernel, round trip included
    stall_seconds: float = 0.0  # waiting for a pinned buffer's copy to finish (ring reclaim + flush)
    arena_capacity: int = 0     # bytes per arena
    buffers: int = 0
    rewinds: int = 0            # O(1) arena resets (one per staged batch)
    reallocs: int = 0           # capacity regrows (batch exceeded the hint)
    fresh_arenas: int = 0       # device arenas replaced because their batch had no fence yet
    copies_elided: int = 0      # slots the arena binding wrote straight into the claimed views
    donated: int = 0            # staged tensors given back through the consumer's fence
    #   (a device arena rewritten after the fence of the step that consumed its
    #   batch: one for each of that batch's slots, as the JAX feeder counts the
    #   staged arrays a donating step deleted; 0 when the step does not donate)

    @property
    def h2d_bytes_per_second(self) -> float:
        return self.bytes_staged / max(self.h2d_seconds, 1e-9)

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro_torch.obs.MetricsRegistry`."""
        return harvest(self)

    def summary(self) -> str:
        return (f"batches={self.batches} "
                f"staged={self.bytes_staged / 2**20:.1f}MiB "
                f"h2d={self.h2d_seconds:.3f}s (d2h={self.d2h_seconds:.3f}s) "
                f"place={self.place_seconds:.3f}s "
                f"stall={self.stall_seconds:.3f}s "
                f"arena={self.arena_capacity / 2**10:.0f}KiB x{self.buffers} "
                f"rewinds={self.rewinds} reallocs={self.reallocs} "
                f"fresh_arenas={self.fresh_arenas} elided={self.copies_elided} "
                f"donated={self.donated}")


class FeedError(RuntimeError):
    """A batch violated the feed layout's static shape contract."""


@dataclasses.dataclass
class ArenaClaim:
    """One batch's claimed ring slot: typed host-arena views at the planned
    offsets, awaiting the payload."""

    buffer_index: int
    rows: int
    views: Dict[str, torch.Tensor]
    allocs: List[Allocation]


Source = Union[torch.Tensor, np.ndarray]


# Thread contract: the h2d-feeder thread drives stage()/claim_views(); the
# train thread calls donation_fence() and, after the feeder thread is gone,
# flush(). The fence queue, the staging sequence and the copy events are
# guarded by _lock; the rest is written by the staging thread only.
@guarded_by("_lock", "_fences", "_consumed_seq", "_seq", "_copied", "_orphans",
            "stats.stall_seconds", "stats.donated")
@shared_entry("feeder:stage", "feeder:claim_views",
              "main:donation_fence", "main:flush")
@single_writer("pool", "last_allocs", "_rewinds_prior", "_host", "_dev", "_seq_in",
               "_next", "stats.batches", "stats.bytes_staged", "stats.h2d_seconds",
               "stats.d2h_seconds", "stats.place_seconds", "stats.rewinds",
               "stats.reallocs", "stats.fresh_arenas", "stats.copies_elided",
               "stats.arena_capacity")
class DeviceFeeder:
    """Stage feature batches into device memory through a ring of arenas.

    Used as ``env = feeder.stage(env)``; pair with a step that calls
    :meth:`donation_fence` after each batch it consumes, so device arenas
    are reused in place.

    Parameters
    ----------
    layout:
        The static :class:`FeedLayout` (``FeaturePlan.feed_layout()``).
    rows_hint:
        Expected batch row count; sizes the arenas at construction. Larger
        batches still work — the arenas regrow and ``FeedStats.reallocs``
        counts the event.
    buffers:
        Ring size: pinned host buffers and device arenas, used round-robin.
    device:
        Where staged tensors live: the card unless the caller asks for
        ``"cpu"``.
    binding:
        Optional output binding (``FeaturePlan.arena_binding().binding``)
        with ``ready(env)`` / ``rows_of(env)`` / ``write(env, views)``. When
        set and a batch arrives in pre-assembly form, :meth:`stage` claims
        ring views and has the binding write the ``batch_*`` outputs
        straight into them.
    """

    def __init__(self, layout: FeedLayout, *, rows_hint: Optional[int] = None,
                 buffers: int = 3, device: DeviceLike = None, binding=None) -> None:
        if buffers < 1:
            raise ValueError(f"buffers must be >= 1, got {buffers}")
        self.layout = layout
        self.buffers = buffers
        self.binding = binding
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # the feeder's own stream (placement and copies; None on the CPU); a
        # thread that stages batches runs with it as its current stream, so
        # its copies never wait behind the compute stream
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.stats = FeedStats(buffers=buffers)
        self.pool: Optional[ArenaPool] = None
        self.last_allocs: List[Allocation] = []  # placement of the last batch
        self._rewinds_prior = 0  # resets of pools replaced by a regrow
        self._host: List[torch.Tensor] = []
        self._dev: List[torch.Tensor] = []
        # copy out of host buffer b (None once awaited, and always on the CPU)
        self._copied: List[Optional[torch.cuda.Event]] = []
        self._seq_in: List[int] = []          # stage seq of the batch in arena b
        self._orphans: List[torch.cuda.Event] = []  # copies from pre-regrow buffers
        self._fences: Dict[int, Optional[torch.cuda.Event]] = {}  # seq -> step event
        self._consumed_seq = 0
        self._seq = 0                                  # batches staged
        self._next = 0
        self._lock = threading.Lock()
        if rows_hint is not None:
            self._ensure_capacity(int(rows_hint))

    # ------------------------------------------------------------ arena mgmt
    def _aligned(self, nbytes: int, *, host: bool) -> torch.Tensor:
        """A zeroed byte buffer whose base is layout-aligned: pinned host
        memory (``host``) or a device arena, allocated on the feeder's
        stream."""
        a = self.layout.align
        if host:
            raw = torch.zeros(nbytes + a, dtype=torch.uint8, pin_memory=self._cuda)
        elif self._cuda:
            with torch.cuda.stream(self.stream):
                raw = torch.zeros(nbytes + a, dtype=torch.uint8, device=self.device)
        else:
            raw = torch.zeros(nbytes + a, dtype=torch.uint8)
        off = (-raw.data_ptr()) % a
        return raw[off:off + nbytes]

    def _ensure_capacity(self, rows: int) -> None:
        need = self.layout.arena_bytes(rows)
        if self.pool is not None:
            if need <= self.pool.capacity:
                return
            self.stats.reallocs += 1
            self._rewinds_prior += self.pool.n_resets
            get_tracer().instant("arena.regrow", old=self.pool.capacity, new=need)
        self.pool = ArenaPool(need, align=self.layout.align)
        # Copies out of the old host buffers may still be in flight; the
        # caching host allocator keeps their memory until they finish, and
        # flush() still awaits them.
        with self._lock:
            self._orphans.extend(e for e in self._copied if e is not None)
            self._copied = [None] * self.buffers
        self._host = [self._aligned(need, host=True) for _ in range(self.buffers)]
        self._dev = [self._aligned(need, host=False) for _ in range(self.buffers)]
        self._seq_in = [0] * self.buffers
        self._next = 0
        self.stats.arena_capacity = need

    def _claim_buffer(self) -> int:
        """Next ring slot; its pinned buffer is rewritten only after the copy
        out of it has completed."""
        b = self._next
        self._next = (b + 1) % self.buffers
        with self._lock:
            done, self._copied[b] = self._copied[b], None
        if done is not None:
            tracer = get_tracer()
            w0 = tracer.now_ns() if tracer.enabled else 0
            t0 = time.perf_counter()
            done.synchronize()
            with self._lock:
                self.stats.stall_seconds += time.perf_counter() - t0
            if tracer.enabled:
                w1 = tracer.now_ns()
                if w1 - w0 > 100_000:  # record real waits only (>0.1 ms): the
                    # ring slot could not be rewritten until its copy completed
                    tracer.complete("h2d.reclaim_stall", w0, w1, buffer=b)
        return b

    def _device_arena(self, b: int) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Arena ``b`` for the next copy, and the consumer event the copy
        must wait for. An arena whose batch has not been fenced yet is
        replaced, never rewritten."""
        prev = self._seq_in[b]
        if prev == 0:
            return self._dev[b], None
        with self._lock:
            if prev <= self._consumed_seq:
                self.stats.donated += len(self.layout.slots)
                return self._dev[b], self._fences.pop(prev, None)
        self._dev[b] = self._aligned(self.pool.capacity, host=False)
        self.stats.fresh_arenas += 1
        return self._dev[b], None

    def donation_fence(self, fence: Optional[torch.cuda.Event] = None) -> None:
        """Register the event of the step that consumed the next staged
        batch (called once per step, in staging order). The feeder's stream
        waits on it before rewriting that batch's device arena. On the card
        ``None`` records an event on the current stream; on the CPU, where
        steps are synchronous, no event is needed."""
        if fence is None and self._cuda:
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._consumed_seq += 1
            self._fences[self._consumed_seq] = fence
            # a fence is needed only while its batch's slot can still be reclaimed
            stale = self._seq - self.buffers
            self._fences = {s: e for s, e in self._fences.items() if s > stale}
            seq = self._consumed_seq
        get_tracer().instant("h2d.donation_fence", seq=seq)

    # --------------------------------------------------------------- staging
    def _rows(self, env: Mapping[str, Any]) -> int:
        name = self.layout.slots[0].name
        try:
            return int(env[name].shape[0])
        except KeyError:
            raise FeedError(
                f"batch is missing staged slot {name!r} "
                f"(layout slots: {self.layout.slot_names})") from None

    @staticmethod
    def _slot_source(env: Mapping[str, Any], spec: SlotSpec, rows: int) -> Source:
        """A slot's values as given (host array or tensor on any device),
        checked against the layout. Per-field ``batch_field_NN`` slots are
        derived from a packed ``batch_sparse`` when the env carries that."""
        field = (int(spec.name[len("batch_field_"):])
                 if spec.name.startswith("batch_field_") else None)
        if spec.name in env:
            src = env[spec.name]
        elif field is not None and "batch_sparse" in env \
                and field < env["batch_sparse"].shape[1]:
            src = env["batch_sparse"][:, field]
        else:
            raise FeedError(
                f"batch is missing staged slot {spec.name!r} "
                f"(batch slots: {sorted(k for k in env if k.startswith('batch_'))})")
        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)
        dtype = src.dtype if isinstance(src, np.ndarray) else \
            np.dtype(str(src.dtype).removeprefix("torch."))
        if dtype != np.dtype(spec.dtype):
            raise FeedError(
                f"slot {spec.name!r}: dtype {dtype} != layout "
                f"{spec.dtype} (pass a custom FeedLayout)")
        if tuple(src.shape) != spec.shape(rows):
            raise FeedError(
                f"slot {spec.name!r}: shape {tuple(src.shape)} != layout {spec.shape(rows)}")
        return src

    def claim_views(self, rows: int) -> ArenaClaim:
        """Claim the next ring slot and place a batch of ``rows`` in it.

        Alg. 1 runs here: the ``mempool_alloc`` kernel places the layout's
        slots (on the feeder's stream, waiting for nothing else), then the
        host pool rewinds and advances its head by the placed total. Returns
        one aligned typed view of the pinned host buffer per slot.
        """
        rows = int(rows)
        if rows < 0:
            raise FeedError(f"rows must be >= 0, got {rows}")
        self._ensure_capacity(rows)
        b = self._claim_buffer()
        t0 = time.perf_counter()
        sizes = self.layout.sizes(rows)
        offsets, total = plan_block(sizes, align=self.layout.align,
                                    device=self.device, stream=self.stream)
        self.pool.reset()
        get_tracer().instant("arena.rewind", buffer=b)
        allocs = self.pool.commit_block(offsets, sizes, total)
        self.stats.place_seconds += time.perf_counter() - t0
        self.last_allocs = allocs
        self.stats.rewinds = self._rewinds_prior + self.pool.n_resets
        views = {spec.name: _typed(self._host[b], a, spec, rows)
                 for spec, a in zip(self.layout.slots, allocs)}
        return ArenaClaim(buffer_index=b, rows=rows, views=views, allocs=allocs)

    def stage(self, env: Mapping[str, Any]) -> Dict[str, Any]:
        """Stage one batch: validate -> place -> copy into the host arena ->
        one async H2D of the arena's used bytes.

        With a ``binding`` and a batch in pre-assembly form, the binding
        writes the ``batch_*`` outputs into the claimed host views instead
        of the validate-and-copy step (:meth:`_stage_direct`).

        Returns the environment with the layout's slots replaced by typed
        views of a device arena (bit-equal values); all other slots pass
        through. The caller's current stream is made to wait for the copy.
        """
        with get_tracer().span("h2d.stage", batch=self.stats.batches):
            if self.binding is not None and self.binding.ready(env):
                return self._stage_direct(env)
            return self._stage_copy(env)

    def _stage_copy(self, env: Mapping[str, Any]) -> Dict[str, Any]:
        rows = self._rows(env)
        # Validate the whole batch BEFORE claiming a buffer: a FeedError
        # mid-batch must not leave a half-filled ring slot behind.
        srcs = [self._slot_source(env, spec, rows) for spec in self.layout.slots]
        claim = self.claim_views(rows)
        t0 = time.perf_counter()
        for spec, src in zip(self.layout.slots, srcs):
            view = claim.views[spec.name]
            if isinstance(src, torch.Tensor):
                view.copy_(src)   # a CUDA slot comes back to the host here
            else:
                np.copyto(view.numpy(), src, casting="no")
        if any(_on_card(s) for s in srcs):
            self.stats.d2h_seconds += time.perf_counter() - t0
        return self._finish(env, claim, t0)

    def _stage_direct(self, env: Mapping[str, Any]) -> Dict[str, Any]:
        """Arena form: the binding assembles the ``batch_*`` outputs straight
        into the claimed views; no ``batch_*`` tensors and no env->arena
        copy exist. Sources checked before anything is written (FeedError)."""
        claim = self.claim_views(self.binding.rows_of(env))
        t0 = time.perf_counter()
        self.binding.write(env, {k: v.numpy() for k, v in claim.views.items()})
        if any(_on_card(env[s]) for s in self.binding.input_slots):
            self.stats.d2h_seconds += time.perf_counter() - t0
        self.stats.copies_elided += len(self.layout.slots)
        return self._finish(env, claim, t0)

    def _finish(self, env: Mapping[str, Any], claim: ArenaClaim, t0: float) -> Dict[str, Any]:
        out = dict(env)
        out.update(self._transfer(claim))
        self.stats.h2d_seconds += time.perf_counter() - t0
        self.stats.batches += 1
        self.stats.bytes_staged += self.layout.bytes_per_batch(claim.rows)
        return out

    def _transfer(self, claim: ArenaClaim) -> Dict[str, torch.Tensor]:
        """One copy of the claimed buffer's used bytes into a device arena;
        returns the staged slots as typed views of that arena."""
        b = claim.buffer_index
        used = self.pool.head
        with self._lock:
            self._seq += 1
            seq = self._seq
        arena, fence = self._device_arena(b)
        self._seq_in[b] = seq
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                if fence is not None:
                    self.stream.wait_event(fence)
                arena[:used].copy_(self._host[b][:used], non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            compute.wait_event(done)
            arena.record_stream(compute)
            with self._lock:
                self._copied[b] = done
        else:
            arena[:used].copy_(self._host[b][:used])
        return {spec.name: _typed(arena, a, spec, claim.rows)
                for spec, a in zip(self.layout.slots, claim.allocs)}

    def flush(self) -> None:
        """Block until every staged copy has completed, including copies
        out of buffers a regrow replaced, and the feeder's stream is idle.
        Call it only when no thread is staging."""
        with self._lock:
            pending = [e for e in self._copied if e is not None] + self._orphans
            self._copied = [None] * len(self._copied)
            self._orphans = []
        t0 = time.perf_counter()
        for e in pending:
            e.synchronize()
        if self._cuda:
            self.stream.synchronize()
        with self._lock:
            self.stats.stall_seconds += time.perf_counter() - t0


def _on_card(val: Any) -> bool:
    return isinstance(val, torch.Tensor) and val.device.type == "cuda"


def _typed(buf: torch.Tensor, alloc: Allocation, spec: SlotSpec, rows: int) -> torch.Tensor:
    """The typed ``[rows, width]`` (or ``[rows]``) view of a slot's bytes."""
    raw = buf[alloc.offset:alloc.offset + spec.nbytes(rows)]
    return raw.view(spec.torch_dtype).reshape(spec.shape(rows))
