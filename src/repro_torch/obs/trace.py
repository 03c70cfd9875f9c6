"""Span tracing with Chrome trace-event / Perfetto JSON export.

The pipeline's "know where every microsecond went" layer: each pipeline
thread (shard readers, the FE worker, the H2D feeder, the train loop)
becomes a *track*, each unit of work a *span* on that track, and the
exported JSON opens directly in https://ui.perfetto.dev (or
``chrome://tracing``), so overlap between stages — the paper's central
claim — is visually inspectable instead of inferred from aggregate
seconds.

Design constraints, in priority order:

* **zero cost when disabled** — the hot paths call
  ``tracer.span("fe.extract", batch=i)`` unconditionally; a disabled
  tracer answers with a shared no-op singleton after one flag check, no
  allocation, no lock (``tests/test_obs.py`` asserts the singleton);
* **bit-effect-free** — tracing records wall-clock only; it never touches
  batch data, so the runner-equivalence property holds with tracing on;
* **thread-safe** — events append under one lock; tracks are assigned per
  thread on first use, named after ``threading.current_thread().name``
  (which the pipeline already names: ``fe-worker``, ``h2d-feeder``,
  ``shard-reader-N``);
* **exceptions don't lose spans** — spans are recorded as separate B/E
  events at ``__enter__``/``__exit__``, so everything recorded before a
  pipeline failure survives to :meth:`Tracer.export`, and the span open
  when an exception unwinds is closed (tagged ``error``) by its context
  manager. Spans a dead thread never closed are end-capped at export;
* **one clock with the device trace** — while a ``torch.profiler`` session
  records, every span also opens a profiler range of its name
  (so the profiler's trace holds the program's spans on its own clock and
  names the device's idle gaps by them), and the tracer records its spans
  even when it is not ``enabled``: a profiler session is how a traced run
  turns them on. ``to_dict()`` gives the tracer's epoch on both clocks
  (``perf_counter_ns``, which stamps the spans, and Unix ns, the
  profiler's), so a ``--trace`` export can be laid over the profiler's;
* **device time where the work is** — ``span(name, device=t)`` with ``t`` a
  CUDA tensor also records a CUDA event on the current stream of ``t``'s
  device at enter and at exit; :meth:`Tracer.summary` gives each span
  name's median host and device milliseconds, resolving the events only
  then.

Typical use::

    from repro_torch.obs import Tracer, set_tracer, get_tracer

    set_tracer(Tracer(enabled=True))
    ...
    with get_tracer().span("fe.extract", batch=3):
        run_layers(...)
    with get_tracer().span("sparse.backward", device=rows):   # also device-timed
        torch.autograd.grad(...)
    get_tracer().instant("arena.rewind", buffer=0)
    get_tracer().counter("io.queue_depth", 2)
    ...
    get_tracer().export("trace.json")
    get_tracer().summary()   # {name: {"count", "host_ms", "device_ms"}}
"""

from __future__ import annotations

import collections
import json
import statistics
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# A profiler range opened from C++: about 2 us to open and close under a
# profiler, where ``record_function`` takes about 17 through the
# dispatcher. It is an op range of the profiler's host timeline, not a user
# annotation mirrored on the device's.
_Range = torch._C._profiler._RecordFunctionFast

# The single pid all tracks share (one process; tracks are threads).
PID = 1

# Event record layout (tuples keep the hot path allocation-light):
#   (phase, tid, ts_ns, name, args_or_None)
_B, _E, _I, _C = "B", "E", "i", "C"


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's only answer."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _DeviceTime:
    """The two CUDA events of a device-timed span; :meth:`ms` resolves
    them once (waiting for the end event) and lets them go."""

    __slots__ = ("start", "end", "_ms")

    def __init__(self, start: Any, end: Any) -> None:
        self.start, self.end, self._ms = start, end, None

    def ms(self) -> float:
        if self._ms is None:
            self.end.synchronize()
            self._ms = float(self.start.elapsed_time(self.end))
            self.start = self.end = None
        return self._ms


def _cuda_device(like: Any) -> Optional[torch.device]:
    """The device of tensor ``like`` where it is a CUDA one, else None."""
    dev = getattr(like, "device", None)
    return dev if isinstance(dev, torch.device) and dev.type == "cuda" else None


class _Span:
    """Live span: records a B event on enter, an E event on exit.

    Recording B/E separately (instead of one complete event at exit)
    keeps per-track file order identical to program order — monotone
    timestamps for free — and preserves the B even when the body raises
    and the process dies before ``__exit__`` could run anywhere else.
    Under a profiler session the span also holds a profiler range of its
    name, opened first and closed last so that the tracer's own work falls
    inside it; with a CUDA ``device`` it records a timing event on that
    device's current stream at each end.
    """

    __slots__ = ("_tracer", "_name", "_args", "_device", "_t0", "_range", "_stream",
                 "_start")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]], device: Any = None) -> None:
        self._tracer = tracer
        self._name = name
        self._args = args
        self._device = device
        self._range = self._stream = self._start = None

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(self._name)
            self._range.__enter__()
        self._t0 = self._tracer._record(_B, self._name, self._args)
        dev = _cuda_device(self._device)
        if dev is not None:
            self._stream = torch.cuda.current_stream(dev)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        timing = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            timing = _DeviceTime(self._start, end)
        args: Optional[Dict[str, Any]] = None
        if exc_type is not None:
            args = {"error": exc_type.__name__}
        if timing is not None:
            args = dict(args or {}, device_ms=timing)
        t1 = self._tracer._record(_E, self._name, args)
        self._tracer._timed(self._name, t1 - self._t0, timing)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """Thread-safe span/instant/counter recorder with Perfetto export.

    One instance is installed process-wide via :func:`set_tracer`; the
    pipeline hot paths fetch it with :func:`get_tracer` and call
    :meth:`span` unconditionally — when ``enabled`` is False and no
    profiler session records, every recording entry point returns
    immediately after the flag checks.
    """

    def __init__(self, *, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[Tuple[str, int, int, str, Optional[Dict]]] = []
        # (name, host ns, _DeviceTime or None) of every closed span
        self._spans: List[Tuple[str, int, Optional[_DeviceTime]]] = []
        # thread (its Thread object: an ident is reused once its thread
        # ends) or "virtual:<name>" (str) -> (tid, track name)
        self._tracks: Dict[Any, Tuple[int, str]] = {}
        self._set_epoch()

    def _set_epoch(self) -> None:
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix_ns = time.time_ns()

    # ------------------------------------------------------------ recording
    @property
    def recording(self) -> bool:
        """Whether :meth:`span` records: the tracer is enabled or a
        ``torch.profiler`` session is recording. Callers that build span
        args gate on it."""
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, device: Any = None, **args: Any) -> Any:
        """Context manager timing one unit of work on this thread's track.

        ``device``: a tensor the span's work runs beside; where it is on a
        CUDA device the span is also timed there, by CUDA events on that
        device's current stream.

        A disabled tracer with no profiler session recording returns the
        shared :data:`NULL_SPAN` singleton after one flag check and one
        module-flag read: no lock, no CUDA event. (Keyword args are only
        materialized by the caller when :attr:`recording`; callers on the
        hottest paths pass none.)
        """
        if not self.enabled and not _autograd_profiler._is_profiler_enabled:
            return NULL_SPAN
        return _Span(self, name, args or None, device)

    def instant(self, name: str, **args: Any) -> None:
        """Mark a point event (arena rewind, donation fence, stall)."""
        if not self.enabled:
            return
        self._record(_I, name, args or None)

    def counter(self, name: str, value: float) -> None:
        """Sample a counter series (queue depth, bytes in flight)."""
        if not self.enabled:
            return
        self._record(_C, name, {name: value})

    def complete(self, name: str, t0_ns: int, t1_ns: int, **args: Any) -> None:
        """Record a span retroactively from explicit perf_counter_ns stamps.

        For conditional spans (e.g. a queue stall only worth recording
        when it exceeded a threshold). Safe for per-track monotonicity as
        long as the calling thread recorded nothing between ``t0_ns`` and
        now — true for a thread that was blocked for that whole window.
        """
        if not self.enabled:
            return
        a = args or None
        with self._lock:
            tid = self._track_locked()
            self._events.append((_B, tid, t0_ns, name, a))
            self._events.append((_E, tid, t1_ns, name, None))

    def complete_on(self, track: str, name: str, t0_ns: int, t1_ns: int,
                    **args: Any) -> None:
        """Record a retroactive span on a named *virtual* track.

        :meth:`complete` reuses the calling thread's track, which is only
        monotonicity-safe when that thread recorded nothing inside the
        window. Work that happens *inside* another span — e.g. the
        collective phases of a fused train step, which execute within the
        step's own ``train.step`` span — would interleave non-monotone
        B/E pairs on the thread track. A virtual track (one per ``track``
        name, lazily allocated, keyed separately from threads)
        gives each such series its own monotone timeline in the exported
        timeline — the ``comm.*`` spans of the mesh train loop live here.
        """
        if not self.enabled:
            return
        a = args or None
        with self._lock:
            key = f"virtual:{track}"
            entry = self._tracks.get(key)
            if entry is None:
                entry = (len(self._tracks), track)
                self._tracks[key] = entry
            tid = entry[0]
            self._events.append((_B, tid, t0_ns, name, a))
            self._events.append((_E, tid, t1_ns, name, None))

    def now_ns(self) -> int:
        """Monotonic stamp compatible with :meth:`complete` (cheap enough
        to call even when disabled; callers gate on ``enabled``)."""
        return time.perf_counter_ns()

    def _record(self, phase: str, name: str,
                args: Optional[Dict[str, Any]]) -> int:
        ts = time.perf_counter_ns()
        with self._lock:
            self._events.append((phase, self._track_locked(), ts, name, args))
        return ts

    def _timed(self, name: str, host_ns: int, timing: Optional[_DeviceTime]) -> None:
        with self._lock:
            self._spans.append((name, host_ns, timing))

    def _track_locked(self) -> int:
        thread = threading.current_thread()
        entry = self._tracks.get(thread)
        if entry is None:
            entry = (len(self._tracks), thread.name)
            self._tracks[thread] = entry
        return entry[0]

    # ------------------------------------------------------------- querying
    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    def track_names(self) -> Dict[int, str]:
        """tid -> thread name for every track that recorded an event."""
        with self._lock:
            return {tid: name for tid, name in self._tracks.values()}

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """``{name: {"count", "host_ms", "device_ms"}}`` over the closed
        spans of each name: their number, and the medians of their host
        milliseconds and of their device milliseconds (None where no span
        of the name was device-timed). Resolves the CUDA events, which
        waits for the last of them."""
        with self._lock:
            spans = list(self._spans)
        host: Dict[str, List[float]] = collections.defaultdict(list)
        device: Dict[str, List[float]] = collections.defaultdict(list)
        for name, host_ns, timing in spans:
            host[name].append(host_ns / 1e6)
            if timing is not None:
                device[name].append(timing.ms())
        return {name: {"count": len(ms), "host_ms": statistics.median(ms),
                       "device_ms": statistics.median(device[name]) if device[name] else None}
                for name, ms in host.items()}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._tracks.clear()
            self._set_epoch()

    # -------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event object (``traceEvents`` list).

        Timestamps are microseconds relative to the tracer's epoch, which
        ``otherData`` gives on both clocks (``epoch_perf_counter_ns``, the
        spans' clock, and ``epoch_unix_ns``, the profiler's); a
        device-timed span's E event carries its ``device_ms``. Spans left
        open by a thread that died mid-span are end-capped at the trace's
        last timestamp so every B has a matching E.
        """
        with self._lock:
            events = list(self._events)
            tracks = dict(self._tracks)
        out: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": PID, "tid": 0,
            "args": {"name": "featurebox-pipeline"},
        }]
        for tid, name in sorted(tracks.values()):
            out.append({"ph": "M", "name": "thread_name", "pid": PID,
                        "tid": tid, "args": {"name": name}})
        open_stacks: Dict[int, List[str]] = {}
        last_ts: Dict[int, int] = {}
        for phase, tid, ts_ns, name, args in events:
            ev: Dict[str, Any] = {
                "ph": phase, "name": name, "pid": PID, "tid": tid,
                "ts": (ts_ns - self._epoch_ns) / 1e3,
            }
            if phase == _I:
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = {k: v.ms() if isinstance(v, _DeviceTime) else v
                              for k, v in args.items()}
            out.append(ev)
            last_ts[tid] = ts_ns
            if phase == _B:
                open_stacks.setdefault(tid, []).append(name)
            elif phase == _E and open_stacks.get(tid):
                open_stacks[tid].pop()
        for tid, stack in open_stacks.items():
            for name in reversed(stack):  # end-cap spans a dead thread left open
                out.append({"ph": _E, "name": name, "pid": PID, "tid": tid,
                            "ts": (last_ts[tid] - self._epoch_ns) / 1e3,
                            "args": {"capped": True}})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"epoch_perf_counter_ns": self._epoch_ns,
                              "epoch_unix_ns": self._epoch_unix_ns}}

    def export(self, path: str) -> Dict[str, Any]:
        """Write the Chrome trace-event JSON to ``path`` (returns the dict).

        Open the file in https://ui.perfetto.dev — loader / FE / H2D /
        train appear as separate named tracks.
        """
        trace = self.to_dict()
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
        return trace


# -------------------------------------------------------- process-wide tracer
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The installed process-wide tracer (a disabled one by default)."""
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` process-wide; returns the previous tracer so
    callers (tests, drivers) can restore it."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def enable_tracing() -> Tracer:
    """Install and return a fresh enabled tracer (driver ``--trace``)."""
    tracer = Tracer(enabled=True)
    set_tracer(tracer)
    return tracer
