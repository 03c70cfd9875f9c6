"""Feature-extraction substrate: declarative specs + compiler, column store,
views, joins, FE ops, datagen.

``featureplan.compile(spec)`` returns a :class:`~repro_torch.fe.featureplan.
FeaturePlan` bundling the lowered OpGraph, fixed schedule, layer executables,
output layout, and the per-view column projection (``required_columns``).
"""

from repro_torch.fe.specs import get_spec, list_specs

__all__ = ["get_spec", "list_specs"]
