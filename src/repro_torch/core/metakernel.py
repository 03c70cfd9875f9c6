"""Per-layer device executables (paper §IV "Inner-GPU operator launching").

The paper amortizes CUDA launch overhead (~3.5 µs/launch, Table I) by running
all same-layer operators as one meta-kernel, so each layer costs one launch.

Here a maximal run of consecutive layers with no interleaving host ops
(``Schedule.superlayers``) is one :class:`LayerExecutable`: its HOST
operators run as Python callables first, then its DEVICE operators run
eagerly in schedule order, as one device dispatch in the accounting
(``ExecutionStats.n_device_dispatches``, ``n_host_barriers + 1`` per batch).
The hash/cross operators of a layer are the paper's meta-kernel proper: each
group runs as one launch of the ``feature_hash`` CUDA kernel, whose wrapper
counts its own launches. The schedule is fixed ahead of time, so
:func:`compile_layers` runs once per plan.

Host-op outputs stay on the host in the environment, so later host ops read
them without a device round trip; the slots a super-layer's device ops
consume are copied host-to-device explicitly right before its dispatch (the
paper's H2D copy of CPU-op outputs). With tracing on, each super-layer is
one ``fe.layer`` span (args ``layer``, ``host_ops``, ``dispatches``).

:func:`run_unfused` is the per-operator baseline (the paper's Table I
comparison point): the same results, one dispatch per device op. Eager
PyTorch has no compile step, so the JAX executable's ``op_jits`` (per-op
jitted wrappers built ahead of time) has no counterpart: the baseline calls
each op's function directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, MutableMapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import PlacedOp, Schedule
from repro_torch.obs.metrics import harvest
from repro_torch.obs.trace import NULL_SPAN, get_tracer


@dataclasses.dataclass
class LayerExecutable:
    """One super-layer of the schedule, ready to run with one dispatch."""

    index: int
    host_ops: Tuple[PlacedOp, ...]
    device_ops: Tuple[PlacedOp, ...]
    fused_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]]  # None if no device ops
    # slots the fused fn consumes from the environment, in order
    device_input_slots: Tuple[str, ...]
    # schedule layers folded into this executable (coalescing accounting)
    layer_indices: Tuple[int, ...]

    @property
    def n_dispatches(self) -> int:
        return 1 if self.fused_fn is not None else 0

    @property
    def n_source_layers(self) -> int:
        return len(self.layer_indices) if self.layer_indices else 1


def _build_fused_fn(device_ops: Tuple[PlacedOp, ...]) -> Tuple[Callable, Tuple[str, ...]]:
    """Run all device ops of a super-layer in schedule order, env->outputs.

    Schedule order is dependency-safe: within one layer ops are independent
    (scheduler invariant), and across coalesced layers every producer
    precedes its consumers. Slots produced inside the body are fed forward
    directly, so the only inputs are externally-produced slots.
    """
    input_slots: List[str] = []
    seen = set()
    produced = set()
    for placed in device_ops:
        for slot in placed.op.inputs:
            if slot not in seen and slot not in produced:
                seen.add(slot)
                input_slots.append(slot)
        produced.update(placed.op.outputs)

    def fused(env: Dict[str, Any]) -> Dict[str, Any]:
        scope = dict(env)
        out: Dict[str, Any] = {}
        for placed in device_ops:
            res = placed.op.fn(**{s: scope[s] for s in placed.op.inputs})
            for slot in placed.op.outputs:
                scope[slot] = res[slot]
                out[slot] = res[slot]
        return out

    return fused, tuple(input_slots)


def compile_layers(schedule: Schedule, *,
                   drop: Tuple[str, ...] = ()) -> List[LayerExecutable]:
    """Ahead-of-time build of every super-layer's executable.

    ``drop`` removes named operators from the build (the arena binding
    replaces the device ``final_batch`` assembly with a host assembler that
    writes straight into the staging arena).
    """
    dropped = set(drop)
    layers: List[LayerExecutable] = []
    for i, group in enumerate(schedule.superlayers):
        device_ops = tuple(p for p in group.device_ops if p.op.name not in dropped)
        fused_fn, slots = _build_fused_fn(device_ops) if device_ops else (None, ())
        layers.append(LayerExecutable(
            index=i,
            host_ops=tuple(p for p in group.host_ops if p.op.name not in dropped),
            device_ops=device_ops,
            fused_fn=fused_fn,
            device_input_slots=slots,
            layer_indices=group.layer_indices,
        ))
    return layers


@dataclasses.dataclass
class ExecutionStats:
    n_layers: int = 0             # executables run (super-layers)
    n_source_layers: int = 0      # schedule layers they cover (coalescing gain)
    n_device_dispatches: int = 0
    n_host_ops: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0   # host time to issue the device ops (async)

    @property
    def n_layers_coalesced(self) -> int:
        """Schedule layers folded into an already-dispatched super-layer."""
        return self.n_source_layers - self.n_layers

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro_torch.obs.MetricsRegistry`."""
        return harvest(self)


def _to_device(val: Any, device: torch.device) -> Any:
    """Explicit H2D copy of a host slot (numpy arrays); tensors and host
    structures (column dicts) pass through."""
    if isinstance(val, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(val)).to(device)
    return val


def run_layers(
    layers: List[LayerExecutable],
    env: MutableMapping[str, Any],
    *,
    device: torch.device,
    stats: Optional[ExecutionStats] = None,
) -> MutableMapping[str, Any]:
    """Execute a compiled schedule over an environment of named slots.

    Layer order gives the barrier semantics of Fig. 4(c): the host ops of a
    super-layer run, the slots its device ops consume are copied to
    ``device``, then its device ops run; only then does the next start.
    """
    tracer = get_tracer()
    for layer in layers:
        # Span args are only materialized when tracing is on, keeping the
        # disabled hot path at one flag check per layer.
        span = (tracer.span("fe.layer", layer=layer.index,
                            host_ops=len(layer.host_ops),
                            dispatches=layer.n_dispatches)
                if tracer.recording else NULL_SPAN)
        with span:
            t0 = time.perf_counter()
            for placed in layer.host_ops:
                res = placed.op.fn(**{s: env[s] for s in placed.op.inputs})
                for slot in placed.op.outputs:
                    env[slot] = res[slot]
            t1 = time.perf_counter()
            if layer.fused_fn is not None:
                env.update(layer.fused_fn(
                    {s: _to_device(env[s], device) for s in layer.device_input_slots}))
            t2 = time.perf_counter()
        if stats is not None:
            stats.n_layers += 1
            stats.n_source_layers += layer.n_source_layers
            stats.n_host_ops += len(layer.host_ops)
            stats.n_device_dispatches += layer.n_dispatches
            stats.host_seconds += t1 - t0
            stats.device_seconds += t2 - t1
    return env


def run_unfused(
    layers: List[LayerExecutable],
    env: MutableMapping[str, Any],
    *,
    device: torch.device,
    stats: Optional[ExecutionStats] = None,
) -> MutableMapping[str, Any]:
    """Baseline executor: one dispatch per operator (no meta-kernel).

    This is the Table I comparison point: identical results to
    :func:`run_layers`, but every device op is its own dispatch, counted in
    ``stats.n_device_dispatches``. Each op reads its inputs from the
    environment, host slots copied to ``device`` first.
    """
    for layer in layers:
        t0 = time.perf_counter()
        for placed in layer.host_ops:
            res = placed.op.fn(**{s: env[s] for s in placed.op.inputs})
            env.update({slot: res[slot] for slot in placed.op.outputs})
        t1 = time.perf_counter()
        for placed in layer.device_ops:
            res = placed.op.fn(**{s: _to_device(env[s], device) for s in placed.op.inputs})
            for slot in placed.op.outputs:
                env[slot] = res[slot]
            if stats is not None:
                stats.n_device_dispatches += 1
        t2 = time.perf_counter()
        if stats is not None:
            stats.n_layers += 1
            stats.n_source_layers += layer.n_source_layers
            stats.n_host_ops += len(layer.host_ops)
            stats.host_seconds += t1 - t0
            stats.device_seconds += t2 - t1
    return env
