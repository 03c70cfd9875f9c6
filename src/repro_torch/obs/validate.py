"""Structural validation of exported Chrome trace-event JSON.

Shared by the trace-export tests and the CI trace-smoke step (``python -m
repro_torch.obs.validate trace.json --require-tracks 4``): a trace the tooling
would silently mis-render (unmatched B/E, time running backwards inside a
track, events missing required keys) fails loudly here instead.

Checks:

* the file is valid JSON with a ``traceEvents`` list;
* every event carries ``ph``/``pid``/``tid`` (+ ``ts``/``name`` for
  non-metadata events) with numeric timestamps;
* per track (pid, tid), timestamps are monotone non-decreasing in file
  order (the exporter writes events in program order per thread);
* B/E events form matched, properly nested pairs per track (same name on
  push and pop, empty stack at end of trace).

:func:`span_intervals` and :func:`overlap_seconds` additionally turn the
validated B/E pairs back into intervals so tests can assert the pipeline
property the trace exists to show: spans on different tracks *overlap*.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union


class TraceError(ValueError):
    """The trace violates the Chrome trace-event structural contract."""


def load_trace(obj: Union[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """Accept a path or an already-parsed trace dict."""
    if isinstance(obj, str):
        with open(obj) as f:
            try:
                obj = json.load(f)
            except json.JSONDecodeError as e:
                raise TraceError(f"not valid JSON: {e}") from e
    if not isinstance(obj, Mapping) or "traceEvents" not in obj:
        raise TraceError("trace must be an object with a 'traceEvents' list")
    if not isinstance(obj["traceEvents"], list):
        raise TraceError("'traceEvents' must be a list")
    return dict(obj)


def validate_trace(obj: Union[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """Validate; return a summary dict (raises :class:`TraceError`).

    Summary: ``n_events``, ``n_spans``, ``n_instants``, ``n_counters``,
    ``tracks`` ({tid: thread name}), ``span_names`` (sorted).
    """
    trace = load_trace(obj)
    events = trace["traceEvents"]
    tracks: Dict[int, str] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    stacks: Dict[Tuple[int, int], List[str]] = {}
    n_spans = n_instants = n_counters = 0
    span_names = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, Mapping):
            raise TraceError(f"event {i} is not an object: {ev!r}")
        ph = ev.get("ph")
        if ph is None or "pid" not in ev or "tid" not in ev:
            raise TraceError(f"event {i} missing ph/pid/tid: {ev!r}")
        if ph == "M":
            if ev.get("name") == "thread_name":
                tracks[ev["tid"]] = ev.get("args", {}).get("name", "")
            continue
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            raise TraceError(f"event {i} has no numeric ts: {ev!r}")
        if not ev.get("name"):
            raise TraceError(f"event {i} has no name: {ev!r}")
        key = (ev["pid"], ev["tid"])
        prev = last_ts.get(key)
        if prev is not None and ev["ts"] < prev:
            raise TraceError(
                f"event {i} ({ev['name']!r}): ts {ev['ts']} < {prev} — "
                f"time ran backwards on track {key}")
        last_ts[key] = ev["ts"]
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
            span_names.add(ev["name"])
            n_spans += 1
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise TraceError(
                    f"event {i}: E {ev['name']!r} with no open B on "
                    f"track {key}")
            top = stack.pop()
            if top != ev["name"]:
                raise TraceError(
                    f"event {i}: E {ev['name']!r} closes B {top!r} on "
                    f"track {key} (improper nesting)")
        elif ph == "i":
            n_instants += 1
        elif ph == "C":
            n_counters += 1
        elif ph not in ("X", "M"):
            raise TraceError(f"event {i}: unsupported phase {ph!r}")
    unclosed = {k: s for k, s in stacks.items() if s}
    if unclosed:
        raise TraceError(f"unmatched B events at end of trace: {unclosed}")
    return {
        "n_events": len(events),
        "n_spans": n_spans,
        "n_instants": n_instants,
        "n_counters": n_counters,
        "tracks": tracks,
        "span_names": sorted(span_names),
    }


def span_intervals(obj: Union[str, Mapping[str, Any]],
                   name_prefix: str = "") -> List[Tuple[float, float, str, int]]:
    """Matched (start_us, end_us, name, tid) intervals, optionally
    filtered to span names starting with ``name_prefix``."""
    trace = load_trace(obj)
    stacks: Dict[Tuple[int, int], List[Tuple[str, float]]] = {}
    out: List[Tuple[float, float, str, int]] = []
    for ev in trace["traceEvents"]:
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append((ev["name"], ev["ts"]))
        elif ph == "E" and stacks.get(key):
            name, t0 = stacks[key].pop()
            if name.startswith(name_prefix):
                out.append((t0, ev["ts"], name, ev["tid"]))
    return out


def _merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def overlap_seconds(obj: Union[str, Mapping[str, Any]],
                    prefix_a: str, prefix_b: str) -> float:
    """Total wall-clock during which a span named ``prefix_a*`` and a span
    named ``prefix_b*`` were simultaneously open — the pipelining the
    trace exists to make visible (e.g. ``overlap_seconds(t, "fe.",
    "train.") > 0`` means FE genuinely hid behind training)."""
    trace = load_trace(obj)
    a = _merge([(t0, t1) for t0, t1, _, _ in span_intervals(trace, prefix_a)])
    b = _merge([(t0, t1) for t0, t1, _, _ in span_intervals(trace, prefix_b)])
    total_us = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total_us += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total_us / 1e6


def main(argv: Sequence[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate an exported Chrome trace-event JSON file")
    ap.add_argument("trace", help="path to the trace JSON")
    ap.add_argument("--require-tracks", type=int, default=0, metavar="N",
                    help="fail unless at least N named tracks recorded spans")
    ap.add_argument("--require-overlap", nargs=2, metavar=("A", "B"),
                    default=None,
                    help="fail unless spans with these two name prefixes "
                         "overlap in time (e.g. fe. train.)")
    args = ap.parse_args(argv)
    try:
        summary = validate_trace(args.trace)
    except TraceError as e:
        print(f"INVALID trace: {e}", file=sys.stderr)
        return 1
    print(f"{args.trace}: {summary['n_events']} events, "
          f"{summary['n_spans']} spans, {summary['n_instants']} instants, "
          f"{summary['n_counters']} counter samples")
    for tid, name in sorted(summary["tracks"].items()):
        print(f"  track {tid}: {name}")
    print(f"  span names: {', '.join(summary['span_names'])}")
    if args.require_tracks and len(summary["tracks"]) < args.require_tracks:
        print(f"FAIL: {len(summary['tracks'])} tracks < required "
              f"{args.require_tracks}", file=sys.stderr)
        return 1
    if args.require_overlap:
        a, b = args.require_overlap
        ov = overlap_seconds(args.trace, a, b)
        print(f"  overlap({a}*, {b}*) = {ov * 1e3:.1f} ms")
        if ov <= 0:
            print(f"FAIL: no overlap between {a}* and {b}* spans",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
