"""Layer-wise heterogeneous operator scheduling (paper §IV, Fig. 4(c)).

Given an :class:`~repro_torch.core.opgraph.OpGraph`, produce an execution
:class:`Schedule`:

1. Topologically sort the DAG and assign each operator to the layer equal to
   its depth from the root operators (ASAP levels). Operators in the same
   layer have no mutual dependencies, so the whole layer is issued together
   with one synchronization barrier at layer end — exactly Fig. 4(c).

2. Assign each ``AUTO`` operator to DEVICE unless its static memory footprint
   exceeds the device budget (the paper's heuristic: "prefer to execute
   operators on GPUs unless an operator requires a significant memory
   footprint" — e.g. the word-embedding dictionary lookup goes to CPU with an
   explicit H2D move of its results).

The schedule is computed once before training and stays fixed (paper:
"we determine the operator execution order before the actual training phase
and keep the scheduling fixed"), which is what lets ``metakernel.py`` build
one fused executable per layer ahead of time.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.opgraph import Device, Operator, OpGraph

# Paper setting: GPU ops must fit alongside the training working set. We use a
# conservative default device budget; callers override per deployment.
DEFAULT_DEVICE_BYTES_BUDGET = 2 * 1024**3


@dataclasses.dataclass(frozen=True)
class PlacedOp:
    op: Operator
    device: Device  # resolved HOST or DEVICE


@dataclasses.dataclass(frozen=True)
class Layer:
    index: int
    host_ops: Tuple[PlacedOp, ...]
    device_ops: Tuple[PlacedOp, ...]

    @property
    def ops(self) -> Tuple[PlacedOp, ...]:
        return self.host_ops + self.device_ops


@dataclasses.dataclass(frozen=True)
class SuperLayer:
    """A maximal run of consecutive layers with no interleaving host ops.

    Only the first member layer may carry host ops (any later host op would
    have started a new super-layer), so execution is: host prologue -> one
    fused device dispatch covering every member layer's device ops. This is
    the true analogue of the paper's one-launch-per-layer meta-kernel: a
    dispatch is only *required* where a host barrier
    interrupts device work, so per batch the device pays
    ``n_host_barriers + 1`` dispatches instead of one per layer.
    """

    index: int
    layers: Tuple[Layer, ...]

    @property
    def layer_indices(self) -> Tuple[int, ...]:
        return tuple(layer.index for layer in self.layers)

    @property
    def host_ops(self) -> Tuple[PlacedOp, ...]:
        return tuple(p for layer in self.layers for p in layer.host_ops)

    @property
    def device_ops(self) -> Tuple[PlacedOp, ...]:
        """Member device ops in layer order (dependency-safe trace order)."""
        return tuple(p for layer in self.layers for p in layer.device_ops)

    @property
    def ops(self) -> Tuple[PlacedOp, ...]:
        return self.host_ops + self.device_ops


def coalesce_layers(layers: Tuple[Layer, ...]) -> Tuple[SuperLayer, ...]:
    """Group layers into super-layers, breaking before every host-op layer.

    A layer with host ops must start a new group: its host ops impose a
    host barrier (device results of earlier layers must be visible before
    the host code runs), so its device ops cannot join the previous fused
    dispatch. Layers with no host ops extend the current group.
    """
    groups: List[List[Layer]] = []
    for layer in layers:
        if layer.host_ops or not groups:
            groups.append([layer])
        else:
            groups[-1].append(layer)
    return tuple(SuperLayer(index=i, layers=tuple(g))
                 for i, g in enumerate(groups))


@dataclasses.dataclass(frozen=True)
class Schedule:
    layers: Tuple[Layer, ...]
    depth_of: Dict[str, int]

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_device_dispatches(self) -> int:
        """One fused dispatch per layer that has any device op (meta-kernel)."""
        return sum(1 for layer in self.layers if layer.device_ops)

    @property
    def n_unfused_dispatches(self) -> int:
        """What a naive per-op launcher would pay (Table I comparison)."""
        return sum(len(layer.device_ops) for layer in self.layers)

    @property
    def superlayers(self) -> Tuple[SuperLayer, ...]:
        """Maximal host-barrier-free layer runs (see :func:`coalesce_layers`)."""
        return coalesce_layers(self.layers)

    @property
    def n_host_barriers(self) -> int:
        """Host stages that interrupt device work (split the device run).

        Host stages *before* the first device op (clean/join/extract) don't
        count: they delay the first dispatch but don't force an extra one.
        Consecutive host-only layers collapse into one barrier (their
        super-layers carry no device ops, so they force no extra dispatch),
        which is why this is counted over the coalesced structure: it is
        the number of device-op-bearing super-layers beyond the first —
        exactly the dispatches a host interruption costs.
        """
        return max(0, self.n_coalesced_dispatches - 1)

    @property
    def n_coalesced_dispatches(self) -> int:
        """Fused dispatches per batch after super-layer coalescing
        (``n_host_barriers + 1`` whenever the schedule has device ops)."""
        return sum(1 for sl in self.superlayers if sl.device_ops)


def assign_device(op: Operator, device_bytes_budget: int) -> Device:
    """The paper's placement heuristic for AUTO ops."""
    if op.device is not Device.AUTO:
        return op.device
    if op.cost.bytes_touched > device_bytes_budget:
        return Device.HOST
    return Device.DEVICE


def build_schedule(
    graph: OpGraph,
    *,
    device_bytes_budget: int = DEFAULT_DEVICE_BYTES_BUDGET,
    expand: bool = True,
) -> Schedule:
    """Expand call sites, layer the DAG, and place every operator."""

    if expand:
        graph = graph.expand_calls()
    graph.validate()

    ops = graph.ops
    depth: Dict[str, int] = {}

    # Kahn-style longest-path layering: depth(op) = 1 + max(depth(deps)).
    indeg: Dict[str, int] = {}
    dependents: Dict[str, List[str]] = {name: [] for name in ops}
    for name, op in ops.items():
        deps = graph.dependencies(op)
        indeg[name] = len(deps)
        for d in deps:
            dependents[d.name].append(name)

    frontier = sorted(name for name, deg in indeg.items() if deg == 0)
    for name in frontier:
        depth[name] = 0
    queue = collections.deque(frontier)
    processed = 0
    while queue:
        name = queue.popleft()
        processed += 1
        for child in dependents[name]:
            depth[child] = max(depth.get(child, 0), depth[name] + 1)
            indeg[child] -= 1
            if indeg[child] == 0:
                queue.append(child)
    if processed != len(ops):
        raise ValueError("operator graph has a cycle (topological sort failed)")

    n_layers = 1 + max(depth.values(), default=-1)
    layers: List[Layer] = []
    for i in range(n_layers):
        host_ops: List[PlacedOp] = []
        device_ops: List[PlacedOp] = []
        for name in sorted(n for n, d in depth.items() if d == i):
            op = ops[name]
            placed = PlacedOp(op=op, device=assign_device(op, device_bytes_budget))
            (device_ops if placed.device is Device.DEVICE else host_ops).append(placed)
        layers.append(Layer(index=i, host_ops=tuple(host_ops), device_ops=tuple(device_ops)))
    return Schedule(layers=tuple(layers), depth_of=depth)


def validate_schedule(graph: OpGraph, schedule: Schedule, *, expanded: bool = True) -> None:
    """Invariants used by the property tests:

    * every operator appears exactly once;
    * no operator is in the same or an earlier layer than any dependency;
    * layer indices are contiguous from 0.
    """
    g = graph.expand_calls() if expanded else graph
    seen: Dict[str, int] = {}
    for layer in schedule.layers:
        for placed in layer.ops:
            if placed.op.name in seen:
                raise AssertionError(f"{placed.op.name} scheduled twice")
            seen[placed.op.name] = layer.index
    if set(seen) != set(g.ops):
        missing = set(g.ops) - set(seen)
        extra = set(seen) - set(g.ops)
        raise AssertionError(f"schedule mismatch: missing={missing} extra={extra}")
    for name, op in g.ops.items():
        for dep in g.dependencies(op):
            if seen[dep.name] >= seen[name]:
                raise AssertionError(
                    f"dependency violated: {dep.name} (layer {seen[dep.name]}) "
                    f"must precede {name} (layer {seen[name]})"
                )
