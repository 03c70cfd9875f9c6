"""Operator DAG for FeatureBox feature-extraction pipelines.

Implements the paper's Fig. 4(a)->(b) transformation: coarse operators that
*call* shared functions are expanded into fine-granularity operators (one per
function call), producing a DAG whose nodes can be scheduled layer-by-layer
(see ``scheduler.py``).

An :class:`Operator` is a named unit of work with:
  * ``fn`` — the callable. Device ops take/return dicts of torch tensors on one
    device and run eagerly; host ops may do arbitrary python (string parsing, disk
    reads, huge dictionary lookups).
  * ``inputs`` / ``outputs`` — named column/tensor slots. Dependencies are
    derived from producer->consumer slot matching, so graph wiring is by data,
    not by hand-maintained edge lists.
  * ``device`` — placement hint (``AUTO`` lets the scheduler decide using the
    paper's heuristic: GPU unless the op's memory footprint is too large).
  * ``cost`` — optional static estimate (bytes touched, flops) used by the
    placement heuristic and the memory-pool planner.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple


class Device(enum.Enum):
    AUTO = "auto"
    HOST = "host"      # CPU worker (paper: memory-intensive ops)
    DEVICE = "device"  # GPU (paper: compute-intensive ops)


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Static cost estimate for placement + arena planning."""

    bytes_touched: int = 0     # working set (dictionary sizes, table sizes)
    flops: int = 0             # arithmetic volume
    out_bytes_per_row: int = 8  # dynamic-allocation need per instance (Alg. 1)


@dataclasses.dataclass
class Operator:
    name: str
    fn: Callable[..., Mapping[str, Any]]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    device: Device = Device.AUTO
    cost: OpCost = dataclasses.field(default_factory=OpCost)
    # Function-call expansion metadata (Fig 4a): names of shared functions
    # this operator invokes, split into pre-processing and post-processing
    # calls. ``expand_calls`` turns each into its own Operator.
    pre_calls: Tuple[str, ...] = ()
    post_calls: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.inputs = tuple(self.inputs)
        self.outputs = tuple(self.outputs)
        if not self.outputs:
            raise ValueError(f"operator {self.name!r} must produce at least one output")

    def __call__(self, **kwargs: Any) -> Mapping[str, Any]:
        return self.fn(**kwargs)


@dataclasses.dataclass(frozen=True)
class FuncDef:
    """A shared function referenced by operators' pre/post calls (Fig 4a)."""

    name: str
    fn: Callable[..., Mapping[str, Any]]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    device: Device = Device.AUTO
    cost: OpCost = OpCost()


class OpGraph:
    """A DAG of operators with data-slot based dependency wiring."""

    def __init__(self) -> None:
        self._ops: Dict[str, Operator] = {}
        self._funcs: Dict[str, FuncDef] = {}
        self._external_inputs: set[str] = set()

    # ------------------------------------------------------------------ build
    def add(self, op: Operator) -> Operator:
        if op.name in self._ops:
            raise ValueError(f"duplicate operator name {op.name!r}")
        for out in op.outputs:
            producer = self.producer_of(out)
            if producer is not None:
                raise ValueError(
                    f"slot {out!r} already produced by {producer.name!r}"
                )
        self._ops[op.name] = op
        return op

    def add_func(self, func: FuncDef) -> FuncDef:
        if func.name in self._funcs:
            raise ValueError(f"duplicate function name {func.name!r}")
        self._funcs[func.name] = func
        return func

    def mark_external(self, *slots: str) -> None:
        """Declare slots provided from outside the graph (pipeline inputs)."""
        self._external_inputs.update(slots)

    # ---------------------------------------------------------------- queries
    @property
    def ops(self) -> Dict[str, Operator]:
        return dict(self._ops)

    @property
    def external_inputs(self) -> set:
        return set(self._external_inputs)

    def producer_of(self, slot: str) -> Optional[Operator]:
        for op in self._ops.values():
            if slot in op.outputs:
                return op
        return None

    def dependencies(self, op: Operator) -> List[Operator]:
        deps: List[Operator] = []
        seen = set()
        for slot in op.inputs:
            producer = self.producer_of(slot)
            if producer is None:
                if slot not in self._external_inputs:
                    raise KeyError(
                        f"operator {op.name!r} consumes slot {slot!r} which is "
                        "neither produced by another operator nor marked external"
                    )
                continue
            if producer.name not in seen:
                seen.add(producer.name)
                deps.append(producer)
        return deps

    def edges(self) -> List[Tuple[str, str]]:
        out = []
        for op in self._ops.values():
            for dep in self.dependencies(op):
                out.append((dep.name, op.name))
        return out

    # ------------------------------------------------- Fig 4(a)->(b) expansion
    def expand_calls(self) -> "OpGraph":
        """Expand operators' function calls into fine-granularity operators.

        Mirrors the paper's example: Op2 calling Func1 (pre) and Func3 (post)
        becomes three operators: ``Func1@Op2`` -> ``Op2`` -> ``Func3@Op2``.
        Pre-calls run before the operator body (their outputs become extra
        operator inputs); post-calls run after (consuming the operator's
        outputs). Each call site is its *own* operator — Func3 called from
        three operators yields three nodes, as in Fig. 4(b).
        """

        g = OpGraph()
        g._external_inputs = set(self._external_inputs)
        g._funcs = dict(self._funcs)
        for op in self._ops.values():
            body_inputs = list(op.inputs)
            for fname in op.pre_calls:
                func = self._require_func(fname, op)
                call_name = f"{fname}@{op.name}"
                outs = tuple(f"{o}@{op.name}" for o in func.outputs)
                g.add(
                    Operator(
                        name=call_name,
                        fn=_rename_outputs(func.fn, func.outputs, outs),
                        inputs=func.inputs,
                        outputs=outs,
                        device=func.device,
                        cost=func.cost,
                    )
                )
                body_inputs.extend(outs)
            if op.post_calls:
                body_outs = tuple(f"{o}~body" for o in op.outputs)
                g.add(
                    Operator(
                        name=op.name,
                        fn=_rename_outputs(op.fn, op.outputs, body_outs),
                        inputs=tuple(body_inputs),
                        outputs=body_outs,
                        device=op.device,
                        cost=op.cost,
                    )
                )
                prev_outs = body_outs
                for i, fname in enumerate(op.post_calls):
                    func = self._require_func(fname, op)
                    call_name = f"{fname}@{op.name}"
                    last = i == len(op.post_calls) - 1
                    outs = (
                        op.outputs
                        if last
                        else tuple(f"{o}~post{i}" for o in op.outputs)
                    )
                    # Post-call contract: the function receives the operator's
                    # outputs under their ORIGINAL names and returns the same
                    # names (it is a per-output post-processing pass, like the
                    # paper's Func3 applied to each caller's result).
                    g.add(
                        Operator(
                            name=call_name,
                            fn=_rename_io(func.fn, op.outputs, prev_outs, op.outputs, outs),
                            inputs=prev_outs,
                            outputs=outs,
                            device=func.device,
                            cost=func.cost,
                        )
                    )
                    prev_outs = outs
            else:
                g.add(
                    Operator(
                        name=op.name,
                        fn=op.fn,
                        inputs=tuple(body_inputs),
                        outputs=op.outputs,
                        device=op.device,
                        cost=op.cost,
                    )
                )
        return g

    def _require_func(self, fname: str, op: Operator) -> FuncDef:
        if fname not in self._funcs:
            raise KeyError(f"operator {op.name!r} calls unknown function {fname!r}")
        return self._funcs[fname]

    # ------------------------------------------------------------- validation
    def validate(self) -> None:
        """Check the graph is a DAG and every input slot resolves."""
        for op in self._ops.values():
            self.dependencies(op)  # raises on unresolved slots
        # cycle check via DFS colouring
        WHITE, GREY, BLACK = 0, 1, 2
        colour = {name: WHITE for name in self._ops}

        def visit(name: str, stack: List[str]) -> None:
            colour[name] = GREY
            for dep in self.dependencies(self._ops[name]):
                if colour[dep.name] == GREY:
                    cyc = " -> ".join(stack + [name, dep.name])
                    raise ValueError(f"operator graph has a cycle: {cyc}")
                if colour[dep.name] == WHITE:
                    visit(dep.name, stack + [name])
            colour[name] = BLACK

        for name in self._ops:
            if colour[name] == WHITE:
                visit(name, [])


def _rename_outputs(fn, old: Sequence[str], new: Sequence[str]):
    mapping = dict(zip(old, new))

    def wrapped(**kwargs):
        res = fn(**kwargs)
        return {mapping.get(k, k): v for k, v in res.items()}

    return wrapped


def _rename_io(fn, old_in: Sequence[str], new_in: Sequence[str],
               old_out: Sequence[str], new_out: Sequence[str]):
    in_map = dict(zip(new_in, old_in))
    out_map = dict(zip(old_out, new_out))

    def wrapped(**kwargs):
        remapped = {in_map.get(k, k): v for k, v in kwargs.items()}
        res = fn(**remapped)
        return {out_map.get(k, k): v for k, v in res.items()}

    return wrapped
