"""Per-step cost of a train step, counted op by op on meta tensors.

The port's counterpart of the JAX package's ``launch/hlo_stats.py``, which
re-derives a step's cost from XLA's compiled HLO text. Eager PyTorch
compiles nothing, so :func:`step_cost` runs the step once on ``meta``
copies of its arguments (no data is read and no device memory is
allocated) under a ``TorchDispatchMode`` that sees every aten and ``c10d``
op the step dispatches, with loops already unrolled by Python (a loop of 8
counts its body 8 times, which is what the JAX module's trip-count
expansion recovers from a ``while``):

* FLOPs = ``2 * prod(output) * prod(contracted dims)`` per matrix product
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``),
  the rule of XLA's ``dot``; elementwise ops count none, as in JAX;
* op bytes = operand + output bytes per op (views and allocations move
  nothing), except that an indexed read or write moves only the rows its
  index addresses: a gather (``index``, ``index_select``, ``gather``,
  ``embedding``, ``take``) counts its other operands, its output and the
  rows it reads (the output's size) but not the whole source, and an
  in-place scatter (``index_copy_``, ``index_put_``, ``scatter_``,
  ``index_add_``, ``scatter_add_``) its index, its values and the rows it writes (and
  reads first, when it accumulates) but not the whole target: the
  embedding table's 25.8 GiB are not traffic of a step that touches its
  working set. The JAX module applies the same slice-side rule to XLA's
  gathers and dynamic slices. There is no fusion in eager torch, so this
  counts each op's operands and outputs once, unfused, where XLA's count
  is that of its fused kernels. It is a count at the ops' boundaries, not
  the card's memory traffic (caches, a kernel's own re-reads, the fusion
  that eager torch does not do), so it is named ``op_bytes`` and not the
  JAX module's ``bytes``, and it is no time bound;
* collective bytes = the output bytes of each collective, by kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``).

The CUDA kernels are launched through ``ctypes`` and no dispatch mode sees
them, so each kernel wrapper's meta branch charges its kernel's work (from
a formula in the wrapper) through :mod:`repro_torch.kernels.cost`, and
:func:`step_cost` adds it to the totals.

:class:`PeakMode`, given to :func:`step_cost` in the same pass, follows
the step's memory: the largest sum of live storages' bytes, the arguments
included (the dry run's ``step_peak_bytes``).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.kernels import cost
from repro_torch.obs.metrics import harvest

# c10d ops -> XLA's names of the collective kinds (another op keeps its own)
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}

# aten ops that allocate without reading or writing any element
_ALLOCATIONS = frozenset({"aten::empty", "aten::empty_like", "aten::empty_strided",
                          "aten::new_empty", "aten::new_empty_strided"})
# reads of the rows an index addresses in the first operand
_GATHERS = frozenset({"aten::index", "aten::index_select", "aten::gather",
                      "aten::embedding", "aten::take"})
# in-place writes of the rows an index addresses in the first operand:
# {op: (position of the values, whether the rows are read first)}
_SCATTERS = {"aten::index_copy_": (3, False), "aten::index_put_": (2, False),
             "aten::_index_put_impl_": (2, False), "aten::scatter_": (3, False),
             "aten::index_add_": (3, True), "aten::scatter_add_": (3, True)}


@dataclasses.dataclass
class Totals:
    """A step's count. The JAX module's ``artifact_bytes`` (XLA's CPU
    promotion copies) and ``bytes_tpu_corrected`` have no source in eager
    torch and are left out."""
    flops: float = 0.0
    op_bytes: float = 0.0
    collective: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def collective_total(self) -> float:
        return sum(self.collective.values())

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro_torch.obs.MetricsRegistry`.

        The per-kind ``collective`` dict is summarized by the
        ``collective_total`` property; kind breakdown stays on the object.
        """
        return harvest(self)


def abstractify(tree):
    """Map the tensors of a pytree to empty ``meta`` tensors of the same
    shape and dtype; other leaves pass through.

    No data is read and no transfers happen, so this is safe to call on
    live training state (the meta copies share nothing with it)."""
    def _one(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    return tree_map(_one, tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _op_bytes(name: str, args, kwargs, out) -> int:
    """Bytes one op moves (the module docstring's rules)."""
    if name in _GATHERS:
        return _nbytes((args[1:], kwargs)) + 2 * _nbytes(out)
    if name in _SCATTERS:
        at, accumulates = _SCATTERS[name]
        if name in ("aten::index_put_", "aten::_index_put_impl_"):
            accumulates = bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        values = args[at] if len(args) > at else None
        rows = (_nbytes(values) if isinstance(values, torch.Tensor)
                else args[2].numel() * args[0].element_size())   # a scalar scattered
        return _nbytes((args[1:], kwargs)) + rows * (2 if accumulates else 1)
    return _nbytes((args, kwargs)) + _nbytes(out)


def _dot_flops(name: str, args) -> float:
    """``2 * prod(out) * prod(contracted)`` for a matrix product, else 0."""
    if name in ("aten::mm", "aten::bmm"):
        a, b = args[0], args[1]
    elif name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        a, b = args[1], args[2]
    elif name in ("aten::mv", "aten::dot", "aten::vdot"):
        a, b = args[0], args[1]
    else:
        return 0.0
    k = a.shape[-1]
    if name in ("aten::dot", "aten::vdot"):
        return 2.0 * k
    if name in ("aten::mv", "aten::addmv"):
        return 2.0 * a.shape[0] * k
    out = math.prod(a.shape[:-1]) * b.shape[-1]
    return 2.0 * out * k


class CostMode(TorchDispatchMode):
    """Count FLOPs, op bytes and collective bytes of every op dispatched while
    it is active (see the module docstring for the rules)."""

    def __init__(self) -> None:
        super().__init__()
        self.totals = Totals()
        self.dispatches = 0      # ops counted, kernel launches included

    def charge(self, kernel: str, flops: float, nbytes: float) -> None:
        self.dispatches += 1
        self.totals.flops += flops
        self.totals.op_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.is_view or name in _ALLOCATIONS:
            return out
        self.dispatches += 1
        t = self.totals
        t.op_bytes += _op_bytes(name, args, kwargs, out)
        t.flops += _dot_flops(name, args)
        namespace, _, op = name.partition("::")
        if namespace == "c10d":
            kind = _C10D_KINDS.get(op, op)
            t.collective[kind] = t.collective.get(kind, 0.0) + _nbytes(args[0])
        return out


# the CUDA caching allocator serves a request of more than this from its
# large pool, whose blocks may be handed out with up to this much unsplit
LARGE_BLOCK = 1 << 20


class PeakMode(TorchDispatchMode):
    """The largest sum of live storages' bytes while it is active.

    A storage counts its ``nbytes`` from the moment one of its tensors is
    first seen (an argument given to :meth:`track`, or the output of an op)
    until it dies (a ``weakref.finalize`` on the storage object). Storages
    are told apart by the storage object, never by the pointer: every
    ``meta`` tensor's ``data_ptr()`` is 0. Views and in-place ops add
    nothing. Only storages on ``device_type`` count (a host tensor made
    along the way is not device memory). ``peak_bytes`` is the largest sum,
    ``live_at_peak`` how many storages were live then, ``max_live`` the
    most that were live at once and ``max_live_large`` the most of more
    than ``LARGE_BLOCK`` bytes that were.
    """

    def __init__(self, device_type: str = "meta") -> None:
        super().__init__()
        self.device_type = device_type
        self.live_bytes = self.live = self.live_large = 0
        self.peak_bytes = self.live_at_peak = self.max_live = self.max_live_large = 0
        self._ids: set = set()

    def track(self, tree) -> "PeakMode":
        """Count the tensors of ``tree`` as live from now on."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return self

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)      # unique among live objects; dropped when `st` dies
        if key in self._ids:
            return
        n = st.nbytes()
        self._ids.add(key)
        self.live_bytes += n
        self.live += 1
        self.live_large += n > LARGE_BLOCK
        weakref.finalize(st, self._drop, key, n)
        self.max_live = max(self.max_live, self.live)
        self.max_live_large = max(self.max_live_large, self.live_large)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self.live_at_peak = self.live_bytes, self.live

    def _drop(self, key: int, n: int) -> None:
        self._ids.discard(key)
        self.live_bytes -= n
        self.live -= 1
        self.live_large -= n > LARGE_BLOCK

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def step_cost(fn, *args, peak: Optional[PeakMode] = None) -> Totals:
    """Per-call cost of ``fn`` on arguments shaped like ``args``.

    Runs ``fn`` once on :func:`abstractify`'d arguments under
    :class:`CostMode`, with the kernels' meta-branch charges added. ``fn``
    may be a boundary step (``ModelFeed.make_step(...).boundary``) or any
    callable of tensors that runs on meta tensors; its in-place updates
    touch only the meta copies. Costs one extra run of the step's Python,
    so callers gate it behind an opt-in flag (``--metrics``). With ``peak``
    (a :class:`PeakMode` on ``meta``) the same pass also follows the
    step's live memory, the meta arguments tracked from the start.
    """
    mode = CostMode()
    shaped = abstractify(args)
    with cost.counting(mode.charge), mode:
        if peak is None:
            fn(*shaped)
        else:
            with peak.track(shaped):
                fn(*shaped)
    return mode.totals


def dispatch_count(fn, *args) -> int:
    """The device ops one call of ``fn`` dispatches on arguments shaped like
    ``args``: the ops :class:`CostMode` counts (views and allocations move
    nothing and are left out; a kernel launch counts one), from one run on
    :func:`abstractify`'d arguments."""
    mode = CostMode()
    with cost.counting(mode.charge), mode:
        fn(*abstractify(args))
    return mode.dispatches

