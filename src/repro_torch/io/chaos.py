"""Deterministic fault injection for the ingest tier.

A :class:`ChaosInjector` is threaded into :class:`repro_torch.io.stream
.StreamingLoader`; reader threads call :meth:`ChaosInjector.trip` at three
well-defined points of the lease lifecycle and the injector decides — from
a schedule that is a pure function of its construction (spec string or
seed) — whether to fail them there. The chaos tests in
``tests/test_chaos.py`` use it to prove the recovery story end to end:
kill a reader mid-epoch and the consumed stream is bit-identical to the
failure-free run.

Injection points (``point`` argument to :meth:`trip`):

``acquire``
    Immediately after a reader leases the shard, before any read — models
    a worker dying with a fresh lease (pure reap/reissue path).
``read``
    Between payload read and commit — models mid-read death, transient
    filesystem errors (``ChaosTransientIOError``, an ``OSError`` the
    loader's bounded retry absorbs), injected latency, and corrupt
    payloads (``ShardFormatError`` — must fail fast, never retry).
``commit``
    After a successful read, immediately *before* ``ShardServer.commit`` —
    the worst kill point: work done but unacknowledged, so the shard is
    reaped and fully re-read elsewhere.

Kills are delivered as :class:`ChaosKill`, a ``BaseException`` subclass so
neither the retry loop's ``except OSError`` nor any blanket ``except
Exception`` in the read path can absorb it — it unwinds the reader like a
real thread death. The loader intentionally does *not* call
``fail_worker`` for it: recovery must come from the lease timeout + reaper,
the path a genuine silent death would take.

Schedules come from :func:`parse_chaos_spec` (the driver's ``--chaos``
flag, e.g. ``"kill@3,transient@1:read:2,delay@2:read:0.05"``) or
:func:`random_schedule` (seeded, for soak-style tests).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.check.annotations import guarded_by, shared_entry
from repro_torch.io.shardfmt import ShardFormatError

KINDS = ("kill", "delay", "transient", "corrupt")
POINTS = ("acquire", "read", "commit")


class ChaosKill(BaseException):
    """Simulated reader-thread death.

    Deliberately *not* an ``Exception``: it must sail through the retry
    loop and the reader's error wrapper so the only observer is the lease
    reaper — exactly like a SIGKILL'd worker process.
    """


class ChaosTransientIOError(OSError):
    """Injected transient read failure (retryable, unlike corruption)."""


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: fire ``kind`` at (``shard``, ``point``),
    ``count`` times; ``delay_seconds`` only applies to ``kind='delay'``."""

    kind: str
    shard: int
    point: str = "read"
    count: int = 1
    delay_seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} (want {KINDS})")
        if self.point not in POINTS:
            raise ValueError(
                f"unknown chaos point {self.point!r} (want {POINTS})")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.kind == "delay" and self.delay_seconds <= 0:
            raise ValueError("delay event needs delay_seconds > 0")


# `trip` is called concurrently from every reader thread; the schedule's
# remaining-count bookkeeping and the fired log are the shared state.
@guarded_by("_lock", "_remaining", "fired")
@shared_entry("trip", "exhausted")
class ChaosInjector:
    """Fires scheduled faults when readers pass injection points.

    Deterministic: which (shard, point) pairs fire, what they raise, and
    how many times is fixed at construction. *Which reader thread* trips a
    given shard still depends on runtime scheduling — irrelevant to the
    exactly-once guarantees under test, which quantify over shards.
    """

    def __init__(self, events: Sequence[ChaosEvent] = ()):
        self.events = tuple(events)
        # (shard, point) -> [event, fires_left] in schedule order
        self._remaining: Dict[Tuple[int, str], List[List[object]]] = {}
        for ev in self.events:
            self._remaining.setdefault((ev.shard, ev.point), []).append(
                [ev, ev.count])
        self.fired: Dict[str, int] = {k: 0 for k in KINDS}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosInjector":
        return cls(parse_chaos_spec(spec))

    @classmethod
    def random(cls, seed: int, n_shards: int, *, p_kill: float = 0.05,
               p_transient: float = 0.1, p_delay: float = 0.1,
               max_delay: float = 0.02) -> "ChaosInjector":
        return cls(random_schedule(seed, n_shards, p_kill=p_kill,
                                   p_transient=p_transient, p_delay=p_delay,
                                   max_delay=max_delay))

    def trip(self, point: str, shard: int, worker_id: str = "?") -> None:
        """Fire any scheduled faults for (shard, point).

        Raises :class:`ChaosKill` / :class:`ChaosTransientIOError` /
        :class:`ShardFormatError` per the schedule; delays sleep and
        return. Sleeping/raising happens outside the lock.
        """
        to_fire: List[ChaosEvent] = []
        with self._lock:
            for slot in self._remaining.get((shard, point), ()):
                ev, left = slot
                if left > 0:
                    slot[1] = left - 1
                    self.fired[ev.kind] += 1
                    to_fire.append(ev)
        delay = 0.0
        raising: Optional[ChaosEvent] = None
        for ev in to_fire:
            if ev.kind == "delay":
                delay += ev.delay_seconds
            elif raising is None:
                raising = ev
        if delay:
            time.sleep(delay)
        if raising is None:
            return
        if raising.kind == "transient":
            raise ChaosTransientIOError(
                f"chaos: transient I/O error on shard {shard} at {point} "
                f"(worker {worker_id})")
        if raising.kind == "corrupt":
            raise ShardFormatError(
                f"chaos: corrupt payload on shard {shard} (worker {worker_id})")
        raise ChaosKill(f"chaos: killed {worker_id} at {point} of shard {shard}")

    def exhausted(self) -> bool:
        """True when every scheduled fault has fired."""
        with self._lock:
            return all(slot[1] == 0
                       for slots in self._remaining.values()
                       for slot in slots)


def parse_chaos_spec(spec: str) -> List[ChaosEvent]:
    """Parse the driver's ``--chaos`` mini-language.

    Comma-separated events, each ``kind@shard[:point][:arg]``:

    - ``kill@3`` — kill the reader holding shard 3 mid-read
    - ``kill@3:commit`` — kill it after the read, before the commit
    - ``transient@1:read:2`` — two transient I/O errors on shard 1
    - ``delay@2:read:0.05`` — 50 ms of injected latency on shard 2
    - ``corrupt@5`` — corrupt shard 5's payload (must fail fast)

    The numeric third field means ``count`` for transient/kill and
    ``delay_seconds`` for delay.
    """
    events: List[ChaosEvent] = []
    for raw in spec.split(","):
        item = raw.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(f"bad chaos event {item!r}: expected kind@shard")
        kind, _, rest = item.partition("@")
        parts = rest.split(":")
        if not parts[0]:
            raise ValueError(f"bad chaos event {item!r}: missing shard id")
        try:
            shard = int(parts[0])
        except ValueError:
            raise ValueError(
                f"bad chaos event {item!r}: shard must be an int") from None
        point = parts[1] if len(parts) > 1 and parts[1] else "read"
        count, delay_seconds = 1, 0.0
        if len(parts) > 2 and parts[2]:
            if kind == "delay":
                delay_seconds = float(parts[2])
            else:
                count = int(parts[2])
        elif kind == "delay":
            delay_seconds = 0.01
        if len(parts) > 3:
            raise ValueError(f"bad chaos event {item!r}: too many fields")
        events.append(ChaosEvent(kind=kind, shard=shard, point=point,
                                 count=count, delay_seconds=delay_seconds))
    return events


def random_schedule(seed: int, n_shards: int, *, p_kill: float = 0.05,
                    p_transient: float = 0.1, p_delay: float = 0.1,
                    max_delay: float = 0.02) -> List[ChaosEvent]:
    """Seeded random fault schedule over ``n_shards`` (soak tests).

    Never schedules ``corrupt`` — corruption is unrecoverable by design,
    so random soaks stay completable.
    """
    rng = np.random.default_rng(seed)
    events: List[ChaosEvent] = []
    for sid in range(n_shards):
        if rng.random() < p_kill:
            point = POINTS[int(rng.integers(len(POINTS)))]
            events.append(ChaosEvent("kill", sid, point))
        if rng.random() < p_transient:
            events.append(ChaosEvent("transient", sid, "read",
                                     count=int(rng.integers(1, 3))))
        if rng.random() < p_delay:
            events.append(ChaosEvent(
                "delay", sid, "read",
                delay_seconds=float(rng.uniform(0.001, max_delay))))
    return events
