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
  manager. Spans a dead thread never closed are end-capped at export.

Typical use::

    from repro_torch.obs import Tracer, set_tracer, get_tracer

    set_tracer(Tracer(enabled=True))
    ...
    with get_tracer().span("fe.extract", batch=3):
        run_layers(...)
    get_tracer().instant("arena.rewind", buffer=0)
    get_tracer().counter("io.queue_depth", 2)
    ...
    get_tracer().export("trace.json")
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

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


class _Span:
    """Live span: records a B event on enter, an E event on exit.

    Recording B/E separately (instead of one complete event at exit)
    keeps per-track file order identical to program order — monotone
    timestamps for free — and preserves the B even when the body raises
    and the process dies before ``__exit__`` could run anywhere else.
    """

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._tracer._record(_B, self._name, self._args)
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        args = None
        if exc_type is not None:
            args = {"error": exc_type.__name__}
        self._tracer._record(_E, self._name, args)
        return False


class Tracer:
    """Thread-safe span/instant/counter recorder with Perfetto export.

    One instance is installed process-wide via :func:`set_tracer`; the
    pipeline hot paths fetch it with :func:`get_tracer` and call
    :meth:`span` unconditionally — when ``enabled`` is False every
    recording entry point returns immediately after the flag check.
    """

    def __init__(self, *, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[Tuple[str, int, int, str, Optional[Dict]]] = []
        # thread (its Thread object: an ident is reused once its thread
        # ends) or "virtual:<name>" (str) -> (tid, track name)
        self._tracks: Dict[Any, Tuple[int, str]] = {}
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------ recording
    def span(self, name: str, **args: Any) -> Any:
        """Context manager timing one unit of work on this thread's track.

        Disabled tracers return the shared :data:`NULL_SPAN` singleton —
        the no-allocation guarantee the hot paths rely on. (Keyword args
        are only materialized by the caller when tracing is on; callers
        on the hottest paths pass none.)
        """
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args or None)

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
                args: Optional[Dict[str, Any]]) -> None:
        ts = time.perf_counter_ns()
        with self._lock:
            self._events.append((phase, self._track_locked(), ts, name, args))

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

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tracks.clear()
            self._epoch_ns = time.perf_counter_ns()

    # -------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event object (``traceEvents`` list).

        Timestamps are microseconds relative to the tracer's epoch. Spans
        left open by a thread that died mid-span are end-capped at the
        trace's last timestamp so every B has a matching E.
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
                ev["args"] = args
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
        return {"traceEvents": out, "displayTimeUnit": "ms"}

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
