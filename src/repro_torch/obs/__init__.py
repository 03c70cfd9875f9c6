"""``repro_torch.obs`` — span tracing, the metrics registry and the trace
validator.

Copies of the JAX package's ``repro.obs.trace``, ``repro.obs.metrics`` and
``repro.obs.validate`` (jax-free), imports renamed:

* :mod:`repro_torch.obs.trace` — thread-tracked span tracer with zero-cost
  disabled paths and Chrome trace-event / Perfetto JSON export; beyond
  JAX's, its spans are ``torch.profiler`` ranges while a profiler session
  records, are timed on the device when given a CUDA tensor, and
  ``Tracer.summary()`` gives their median host and device ms;
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` over the
  per-tier ``*Stats`` dataclasses, and the ``harvest`` helper the stats
  tiers use;
* :mod:`repro_torch.obs.validate` — structural trace validation (also a
  CLI: ``python -m repro_torch.obs.validate trace.json --require-tracks N
  --require-overlap A B``).
"""

from repro_torch.obs.metrics import MetricsRegistry, harvest, pipeline_rollup
from repro_torch.obs.trace import (
    NULL_SPAN,
    Tracer,
    enable_tracing,
    get_tracer,
    set_tracer,
)
from repro_torch.obs.validate import (
    TraceError,
    overlap_seconds,
    span_intervals,
    validate_trace,
)

__all__ = [
    "MetricsRegistry",
    "harvest",
    "pipeline_rollup",
    "NULL_SPAN",
    "Tracer",
    "enable_tracing",
    "get_tracer",
    "set_tracer",
    "TraceError",
    "overlap_seconds",
    "span_intervals",
    "validate_trace",
]
