"""The one-call front door: FeatureSpec -> ready-to-run FeaturePlan.

``compile(spec)`` bundles ``lower -> build_schedule -> compile_layers`` plus
the output-layout constants into a single object:

    plan = featureplan.compile(get_spec("dlrm"))
    env = plan.run(raw_views)                  # one batch through the FE, on the card
    batch = plan.outputs(env)                  # just the batch_* slots
    runner = PipelinedRunner.from_plan(plan, step, feed="arena")  # the streaming form

``plan.required_columns`` is the per-view column projection derived from
the spec, so columns no transform touches need never be decoded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, MutableMapping, Optional, Tuple

from repro_torch.core.metakernel import LayerExecutable, compile_layers, run_layers
from repro_torch.core.opgraph import OpGraph
from repro_torch.core.scheduler import (
    DEFAULT_DEVICE_BYTES_BUDGET,
    Schedule,
    build_schedule,
)
from repro_torch.device import resolve_device
from repro_torch.fe import compiler
from repro_torch.fe.compiler import OutputLayout
from repro_torch.fe.spec import DEFAULT_FIELD_SIZE, FeatureSpec


@dataclasses.dataclass
class ArenaBinding:
    """Arena-feed bundle for one plan: everything a runner needs to have FE
    write its ``batch_*`` outputs straight into the staging arena.

    * :attr:`layers` — the plan's executables with the device
      ``final_batch`` assembly dropped (its work moves into the binding);
    * :attr:`binding` — the host assembler writing into claimed arena views
      (:class:`repro_torch.fe.compiler.OutputBinding`);
    * :attr:`layout` — the matching :class:`~repro_torch.core.devicefeed.FeedLayout`.

    Typical wiring (or just ``PipelinedRunner.from_plan(..., feed="arena")``)::

        ab = plan.arena_binding(split_sparse_fields=True)
        runner = PipelinedRunner(ab.layers, step,
                                 device_feed=ab.make_feeder(rows_hint=rows))
    """

    layers: List[LayerExecutable]
    binding: compiler.OutputBinding
    layout: Any  # repro_torch.core.devicefeed.FeedLayout

    def make_feeder(self, *, rows_hint: Optional[int] = None, buffers: int = 3,
                    device=None):
        from repro_torch.core.devicefeed import DeviceFeeder
        return DeviceFeeder(self.layout, rows_hint=rows_hint, buffers=buffers,
                            device=device, binding=self.binding)


@dataclasses.dataclass
class FeaturePlan:
    """A compiled feature pipeline: graph + schedule + layers + layout."""

    spec: FeatureSpec
    graph: OpGraph
    schedule: Schedule
    layers: List[LayerExecutable]
    layout: OutputLayout
    required_columns: Dict[str, Tuple[str, ...]]
    device_budget: int

    @property
    def output_slots(self) -> Tuple[str, ...]:
        """The ``batch_*`` slots this plan produces, in a stable order."""
        final = self.graph.ops["final_batch"]
        return tuple(sorted(final.outputs))

    def run(self, batch: Mapping[str, Any], *, device=None,
            stats=None) -> Dict[str, Any]:
        """Run one raw batch ``{view: columns}`` through the compiled layers
        on ``device`` (the card unless the caller asks for ``"cpu"``).

        Returns the full slot environment (inputs, intermediates, and the
        ``batch_*`` outputs as tensors on ``device``); use :meth:`outputs`
        for just the batch dict.
        """
        env: MutableMapping[str, Any] = dict(batch)
        run_layers(self.layers, env, device=resolve_device(device), stats=stats)
        return dict(env)

    def outputs(self, env: Mapping[str, Any]) -> Dict[str, Any]:
        """Filter an environment down to this plan's ``batch_*`` outputs."""
        return {k: env[k] for k in self.output_slots}

    def feed_layout(self, *, split_sparse_fields: bool = False):
        """Static H2D staging layout for this plan's ``batch_*`` outputs.

        Derived from :attr:`layout` at compile time, so a
        :class:`~repro_torch.core.devicefeed.DeviceFeeder` can size its
        arenas before the first batch arrives:

            feeder = DeviceFeeder(plan.feed_layout(), rows_hint=batch_rows)

        ``split_sparse_fields=True`` replaces the packed ``batch_sparse``
        slot with one rank-1 ``batch_field_NN`` id vector per sparse field;
        total staged bytes are unchanged, and the feeder derives the field
        columns from a packed ``batch_sparse``.
        """
        from repro_torch.core.devicefeed import FeedLayout, SlotSpec
        emitted = set(self.output_slots)
        slots = []
        for name, width, dtype, rank1 in self.layout.feed_slots():
            if name not in emitted:
                continue
            if name == "batch_sparse" and split_sparse_fields:
                slots.extend(SlotSpec(compiler.field_slot(i), 1, dtype, rank1=True)
                             for i in range(width))
            else:
                slots.append(SlotSpec(name, width, dtype, rank1=rank1))
        return FeedLayout(slots=tuple(slots))

    def arena_binding(self, *, split_sparse_fields: bool = False) -> ArenaBinding:
        """Compile this plan's arena-feed form (see :class:`ArenaBinding`).

        The bundle's layers run everything up to (and excluding) the device
        ``final_batch`` assembly; the binding assembles the ``batch_*``
        outputs on the host **directly into arena views** that a
        :class:`~repro_torch.core.devicefeed.DeviceFeeder` claims per batch,
        so the copy path's ``batch_*`` tensors and its env->arena copy never
        exist (``FeedStats.copies_elided`` counts the slots). Staged
        tensors are bit for bit :attr:`layers` + ``feeder.stage(env)``'s.
        """
        binding = compiler.output_binding(
            self.spec, split_sparse_fields=split_sparse_fields)
        return ArenaBinding(
            layers=compile_layers(self.schedule, drop=(binding.final_op,)),
            binding=binding,
            layout=self.feed_layout(split_sparse_fields=split_sparse_fields),
        )

    def model_feed(self, cfg, *, split_sparse_fields: bool = False,
                   rows_hint=None, **kw):
        """Compile the stage->model adaptation plan for this plan x ``cfg``
        (see :mod:`repro_torch.fe.modelfeed`), with the sparse working-set
        capacity tuned from ``rows_hint``."""
        from repro_torch.fe import modelfeed
        return modelfeed.compile(self, cfg,
                                 split_sparse_fields=split_sparse_fields,
                                 rows_hint=rows_hint, **kw)

    def summary(self) -> str:
        s = self.schedule
        lay = self.layout
        return (f"plan {self.spec.name!r}: {s.n_layers} layers "
                f"({len(s.superlayers)} super-layers), "
                f"{s.n_coalesced_dispatches} coalesced device dispatches "
                f"(vs {s.n_device_dispatches} per-layer, "
                f"{s.n_unfused_dispatches} unfused); "
                f"outputs: {lay.n_sparse_fields} sparse fields x "
                f"{lay.field_size} slots, {lay.n_dense_feats} dense, "
                f"seq_len {lay.seq_len}")


def compile(spec: FeatureSpec, *,
            device_budget: int = DEFAULT_DEVICE_BYTES_BUDGET,
            field_size: int = DEFAULT_FIELD_SIZE) -> FeaturePlan:
    """Lower ``spec`` and build its fixed schedule + layer executables."""
    graph = compiler.lower(spec, field_size=field_size)
    schedule = build_schedule(graph, device_bytes_budget=device_budget)
    return FeaturePlan(
        spec=spec,
        graph=graph,
        schedule=schedule,
        layers=compile_layers(schedule),
        layout=compiler.output_layout(spec, field_size=field_size),
        required_columns=compiler.required_columns(spec),
        device_budget=device_budget,
    )
