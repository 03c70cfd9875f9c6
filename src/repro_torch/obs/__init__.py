"""``repro_torch.obs`` — span tracing and the metrics registry.

Copies of the JAX package's ``repro.obs.trace`` and ``repro.obs.metrics``
(jax-free), imports renamed:

* :mod:`repro_torch.obs.trace` — thread-tracked span tracer with zero-cost
  disabled paths and Chrome trace-event / Perfetto JSON export;
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` over the
  per-tier ``*Stats`` dataclasses, and the ``harvest`` helper the stats
  tiers use.

The trace validator (``repro.obs.validate``) is not ported.
"""

from repro_torch.obs.metrics import MetricsRegistry, harvest, pipeline_rollup
from repro_torch.obs.trace import (
    NULL_SPAN,
    Tracer,
    enable_tracing,
    get_tracer,
    set_tracer,
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
]
