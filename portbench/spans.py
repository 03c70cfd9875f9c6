"""The program's own spans, as its tracer sums them up after a traced
segment (``repro_torch.obs.trace.get_tracer().summary()``).

A traced run's profiler session turns the program's spans on: while
``torch.profiler`` records, the tracer records every span, and a span
given a CUDA tensor also times itself with CUDA events on that tensor's
stream. Each reader of a span metric returns None where the program has
no such span, no ``summary`` (a program older than its spans) or no
device time for it (a run on the CPU), so no number of the host's clock
alone is written under a metric of the card.
"""

from __future__ import annotations

import math
from typing import Optional


def summary() -> dict:
    """``{span: {"count", "host_ms", "device_ms"}}`` of the program's
    tracer, or ``{}`` where the program gives none."""
    try:
        from repro_torch.obs.trace import get_tracer
    except ImportError:
        return {}
    read = getattr(get_tracer(), "summary", None)
    return read() if callable(read) else {}


def _positive(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def _median_ms(span: str, key: str) -> Optional[float]:
    s = summary().get(span)
    if not s or not _positive(s.get("device_ms")) or not _positive(s.get(key)):
        return None
    return float(s[key])


def device_ms(span: str) -> Optional[float]:
    """The median device milliseconds of ``span`` (one a unit of work)."""
    return _median_ms(span, "device_ms")


def host_ms(span: str) -> Optional[float]:
    """The median host milliseconds of ``span``, where it was also timed on
    the device (so the run was on the card)."""
    return _median_ms(span, "host_ms")
