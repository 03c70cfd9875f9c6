"""The device trace of a traced run, reduced to what the per-layer metrics
read.

A traced segment runs ``units + 2`` units of work (steps or batches) under
``torch.profiler`` with the CPU and CUDA activities; the harness opens a
``record_function`` range named ``MARK`` at the start of every unit. The
window runs from the second unit's start to the last one's, so it holds
``units`` whole units and leaves out the profiler's start and the first
unit. Within it:

* ``busy_s``: the seconds in which at least one kernel, copy or memset ran
  on the device (concurrent streams count once);
* ``kernels``: each device op's name, its seconds and its launches;
* ``idle_gaps``: the gaps between device work, each named by the innermost
  host op that was running at its middle.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

MARK = "portbench.unit"
BREAKDOWN_ROWS = 10
NAME_CHARS = 120        # a breakdown row's name, cut (templated kernel names run to 1,000s)
NAMED_GAPS = 500        # the longest gaps that are named by their host op


@dataclasses.dataclass
class Event:
    name: str
    device: bool        # ran on the device (kernel, copy, memset)
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceSummary:
    units: int
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]        # name -> (seconds, launches)
    idle_gaps: List[Tuple[str, float]]           # host op -> seconds, longest first

    def kernel_seconds(self, names: Sequence[str]) -> Tuple[float, int]:
        """Seconds and launches of the device ops whose name holds any of
        ``names``."""
        s, n = 0.0, 0
        for k, (sec, cnt) in self.kernels.items():
            if any(x in k for x in names):
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:BREAKDOWN_ROWS]
        return {"device_ops": [[k[:NAME_CHARS], sec] for k, (sec, _) in ops],
                "idle_gaps": [[k[:NAME_CHARS], sec] for k, sec in self.idle_gaps[:BREAKDOWN_ROWS]]}


def union_us(spans: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` covered by at least one span (as
    ``chip_smoke._union_ms`` counts them: concurrent spans count once)."""
    covered, end = 0.0, lo
    for start, stop in sorted(spans):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            covered += stop - start
            end = stop
    return covered


def gaps_us(spans: Sequence[Tuple[float, float]], lo: float, hi: float
            ) -> List[Tuple[float, float]]:
    """The intervals of ``[lo, hi]`` that no span covers."""
    out, end = [], lo
    for start, stop in sorted(spans):
        if start > end and start > lo:
            out.append((end, min(start, hi)))
        end = max(end, stop)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def reduce(events: Sequence[Event], units: int) -> TraceSummary:
    """The summary of a segment of ``units + 2`` units (see the module's
    docstring)."""
    starts = sorted(e.start_us for e in events if e.name == MARK and not e.device)
    if len(starts) != units + 2:
        raise RuntimeError(f"trace: {len(starts)} {MARK} ranges for {units + 2} units")
    lo, hi = starts[1], starts[-1]
    device = [e for e in events if e.device and not e.name.startswith("portbench.")
              and e.end_us > lo and e.start_us < hi]
    spans = [(max(e.start_us, lo), min(e.end_us, hi)) for e in device]
    kernels: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for e, (a, b) in zip(device, spans):
        kernels[e.name][0] += (b - a) / 1e6
        kernels[e.name][1] += 1
    gaps = sorted(gaps_us(spans, lo, hi), key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    host = [e for e in events if not e.device and e.end_us > lo and e.start_us < hi
            and e.name != MARK]
    h_start = np.array([e.start_us for e in host])
    h_end = np.array([e.end_us for e in host])
    named: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        inside = np.nonzero((h_start <= mid) & (h_end >= mid))[0] if host else []
        name = host[max(inside, key=lambda i: h_start[i])].name if len(inside) else "(no host op)"
        named[name] += (b - a) / 1e6
    return TraceSummary(units=units, window_s=(hi - lo) / 1e6,
                        busy_s=union_us(spans, lo, hi) / 1e6,
                        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                        idle_gaps=sorted(named.items(), key=lambda kv: -kv[1]))


def profiler_events(prof) -> List[Event]:
    """The profiler's events as :class:`Event`, from kineto's raw results
    (building ``prof.events()`` takes minutes on a long segment)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if on_device and getattr(e, "is_user_annotation", lambda: False)():
            continue        # a host range mirrored on the device's timeline
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), on_device, start, start + e.duration_ns() / 1e3))
    return out


def capture(run, units: int, device) -> TraceSummary:
    """Profile ``run()``, which does ``units + 2`` units of work, each opened
    by a ``record_function(MARK)`` range, and ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run()
    return reduce(profiler_events(prof), units)
