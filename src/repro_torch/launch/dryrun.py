"""Dry run: build every (arch x shape x variant) cell and reckon its cost.

The port's counterpart of the JAX package's ``launch/dryrun.py``. For each
cell of :mod:`repro_torch.configs` on the production mesh (16x16, or
2x16x16 with ``--multi-pod``) it records, with no device allocated:

* ``memory.state_bytes_exact``: one device's bytes of the params, the
  optimizer state and the batch, from the declared shardings — a leaf
  whose shard shape raises counts at its full size, and an argument whose
  sharding tree does not line up with its leaves counts nothing, as in
  JAX;
* ``model_flops``: the analytic 6·N·D (train) / 2·N·D (serve) of the cell;
* ``step_flops`` and ``step_op_bytes``: the whole (global, single-device)
  step's matrix-product FLOPs and op bytes, counted op by op on ``meta``
  tensors by :func:`repro_torch.launch.hlo_stats.step_cost`, the kernels'
  meta branches charged;
* ``step_peak_bytes``: the largest sum of live storages during that call,
  the arguments included (:class:`repro_torch.launch.hlo_stats.PeakMode`),
  with ``step_peak_live`` storages live at that moment, at most
  ``step_max_live`` (``step_max_live_large`` of over 1 MiB) at once, and
  ``step_workspace``, the largest CUDA workspace one op may add unseen:
  what one device running the whole step needs (:func:`transient_bound`
  is how far a card's measurement may exceed it).

The first two equal the JAX dry run's on every mesh. The step figures are
the global program's, counted once per cell and reused for the second mesh
where the cell's program and inputs are the same on both (the LM cells; a
recsys or gnn cell whose dedup capacity or edge list rounds up to a
different multiple of the device count is counted again).

One device's figures, JAX's ``*_per_device`` (:func:`per_device_figures`):
where the cell has a per-device call (``Cell.per_device``: the LM cells'
mesh forms, PNA's node-sharded step on the shapes past 100,000 nodes),
rank 0's program runs once on meta under torch's fake process group of
the mesh's size (:func:`repro_torch.launch.mesh.fake_mesh`: no
communication, no other process), counted as the global one is:
``step_flops_per_device``, ``step_op_bytes_per_device``,
``step_peak_bytes_per_device`` (with its live counts and workspace),
``collective_bytes_per_device`` (the output bytes of the rank's
collectives by XLA's kind, JAX's meaning) and ``collective_total_bytes``,
and ``per_device_arg_bytes``, the bytes of the arguments the rank holds,
with their factor over ``state_bytes_exact`` where they differ (only the
LM's global token batch, which the mesh forms cut themselves: the decode
cache is the ``cache_specs`` block). Rows that do not split evenly over
the data ranks are padded, as GSPMD pads them (``models/transformer.py``):
qwen2.5-32b's and deepseek-v2-236b's ``train_4k`` on 2x16x16, 16
microbatches of 16 rows over 32 data ranks, give rank 0 one row a
microbatch, and v2's MoE layers a block of 2,048 tokens of it, moved there
by the port's own all-to-all (GSPMD's reshard in JAX is implicit, so
those bytes are held to real gloo ranks, not to JAX's compiled ones). A
cell whose shapes the mesh form cannot take (a ``puredp`` leaf over 512
ranks, an MoE token count not evenly divisible over the data ranks) keeps
its global figures, and its record says why it has no per-device ones.
The other cells (recsys, the small gnn shapes) have none: their JAX
program is the global one that GSPMD partitions by its input shardings,
and eager PyTorch has no partitioner (``per_device: null`` with that
reason). The per-device figures are never
reused across meshes: the rank's program differs with the mesh's size.
What they mean here: eager ops, unfused, so ``op_bytes`` is a count at the
ops' boundaries and not HBM traffic (as ``step_op_bytes``); the peak is the
tracker's largest sum of live storages, not XLA's ``memory_analysis``.

JAX's keys with no source in eager torch are left out: ``lower_s`` and
``compile_s`` (nothing is lowered or compiled), ``raw_cost_analysis`` and
``hlo_flops_per_device``/``hlo_bytes_per_device`` (XLA's counts of the
partitioned HLO, whose eager counterparts are the ``step_*_per_device``
figures), and the ``memory_analysis`` fields ``argument_bytes``,
``output_bytes``, ``temp_bytes``, ``alias_bytes`` and
``peak_estimate_bytes`` (XLA's buffer assignment).

:func:`materialize` draws a cell's arguments on a device (params from the
port's ``init_params``, ids in range) and :func:`measure_on_device` runs
the cell there, for checking these predictions on a card at a 1x1 mesh;
:func:`measure_rank_on_device` runs rank 0 of a production mesh on a card
(its shards drawn there, :func:`materialize_rank`, under a fake group on
``cuda``) against its per-device prediction.

Results land in ``build/dryrun/dryrun_<single|multi>_<variant>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pna --shape molecule
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import Cell, leaves_by_path, map_by_path
from repro_torch.launch.hlo_stats import LARGE_BLOCK, PeakMode, step_cost
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R

ROUND = 512        # the CUDA caching allocator rounds every block up to this
# step figures per cell program, reused across meshes (see the module docstring)
_STEP_CACHE: Dict[Tuple, Dict[str, Any]] = {}


def leaf_bytes(leaf: torch.Tensor, sharding) -> int:
    """One device's bytes of ``leaf`` under ``sharding``: its shard shape's,
    or its full size where the shard shape raises (JAX's rule)."""
    n = int(np.prod(leaf.shape)) if leaf.dim() else 1
    try:
        shard_shape = sharding.shard_shape(tuple(leaf.shape))
        n = int(np.prod(shard_shape)) if shard_shape else 1
    except Exception:  # noqa: BLE001 — an uneven leaf counts whole, as in JAX
        pass
    return n * leaf.element_size()


def _state_bytes(arg, sharding) -> int:
    leaves, shardings = leaves_by_path(arg), leaves_by_path(sharding)
    if sorted(leaves) != sorted(shardings):
        return 0
    return sum(leaf_bytes(leaves[k], shardings[k]) for k in leaves)


def state_bytes_exact(cell: Cell) -> int:
    """Per-device bytes of the cell's arguments from their shardings; an
    argument whose sharding tree's paths are not its leaves' counts 0."""
    return sum(_state_bytes(a, sh) for a, sh in zip(cell.args, cell.in_shardings))


def _signature(cell: Cell) -> Tuple:
    args = tuple((i, k, tuple(v.shape), str(v.dtype)) for i, a in enumerate(cell.args)
                 for k, v in leaves_by_path(a).items())
    mesh = tuple(sorted(cell.fn_mesh.items())) if cell.fn_mesh else None
    return (repr(cell.config), args, mesh)


def hidden_workspace(name: str, args, kwargs) -> int:
    """Bytes a CUDA op may allocate for itself beyond its outputs, which its
    meta version does not show: a sort's int64 iota and cub's alternate key
    and value buffers ((16 + 2e) bytes per element of e bytes); an
    accumulating ``index_put_`` (the backward of an indexed read) its
    linear, sorted and original int64 indices and cub's buffers (48 bytes
    per index); each plus 1 MiB of cub scratch. Any other op: 0."""
    if name == "aten::sort":
        x = args[0]
        return x.numel() * (16 + 2 * x.element_size()) + (1 << 20)
    if name in ("aten::index_put_", "aten::_index_put_impl_", "aten::index_put"):
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if accumulate:
            return 48 * max(i.numel() for i in args[1] if i is not None) + (1 << 20)
    return 0


# Backward formulas that write into a fresh zeros tensor in place when no
# dispatch mode is on, and out of place under one (autograd's
# ``isTensorSubclassLike`` holds while a mode is active): the index
# backward's ``index_put_`` and the gather backward's ``scatter_add_``.
FUNCTIONAL_FORMS = frozenset({"aten::index_put", "aten::scatter_add"})


class StepMemory(PeakMode):
    """:class:`PeakMode` on ``meta`` that also keeps the largest
    :func:`hidden_workspace` of one op of the step (1 MiB at least: the
    reductions' and scans' working space), and the largest output of one of the
    :data:`FUNCTIONAL_FORMS` (``functional``): the tracker sees that output
    as a new storage beside its zeros, where a run without a dispatch mode
    writes the zeros in place, so its peak may exceed such a run's by up to
    that much."""

    def __init__(self) -> None:
        super().__init__("meta")
        self.workspace = 1 << 20
        self.functional = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        self.workspace = max(self.workspace, hidden_workspace(name, args, kwargs))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if name in FUNCTIONAL_FORMS:
            self.functional = max(self.functional, out.numel() * out.element_size())
        return out


def call_figures(fn, args, suffix: str = "") -> Dict[str, Any]:
    """``step_flops``, ``step_op_bytes``, ``step_peak_bytes``,
    ``step_peak_live``, ``step_max_live``, ``step_max_live_large``,
    ``step_workspace`` and ``step_functional`` (each name with ``suffix``;
    :class:`StepMemory`), ``cost_s`` and the
    :class:`~repro_torch.launch.hlo_stats.Totals` of one call of ``fn`` on
    meta copies of ``args`` (one pass)."""
    mem = StepMemory()
    t0 = time.perf_counter()
    totals = step_cost(fn, *args, peak=mem)
    fig = {"step_flops": totals.flops, "step_op_bytes": totals.op_bytes,
           "step_peak_bytes": mem.peak_bytes, "step_peak_live": mem.live_at_peak,
           "step_max_live": mem.max_live, "step_max_live_large": mem.max_live_large,
           "step_workspace": mem.workspace, "step_functional": mem.functional}
    return {**{k + suffix: v for k, v in fig.items()},
            "cost_s": time.perf_counter() - t0, "totals": totals}


def step_figures(cell: Cell) -> Dict[str, Any]:
    """The global program's figures: :func:`call_figures` of the cell's
    ``fn`` on its arguments, and ``cost_s``."""
    fig = call_figures(cell.fn, cell.args)
    del fig["totals"]
    return fig


def arg_bytes(args) -> int:
    """The bytes of every tensor leaf of ``args``."""
    return sum(t.numel() * t.element_size() for a in args for t in leaves_by_path(a).values())


def per_device_figures(cell: Cell, mesh_shape: Dict[str, int]) -> Dict[str, Any]:
    """Rank 0's figures on a ``mesh_shape`` mesh: the cell's ``per_device``
    call once on meta under a fake process group of the mesh's size
    (:func:`repro_torch.launch.mesh.fake_mesh`), counted as
    :func:`step_figures` counts the global program (the names with
    ``_per_device``), with ``collective_bytes_per_device`` (the output
    bytes of the rank's collectives by XLA's kind, as JAX's dry run counts
    them) and ``collective_total_bytes``; ``per_device_arg_bytes``, the
    bytes of the rank's arguments, and where they are not
    ``state_bytes_exact``, their ratio (``per_device_arg_factor``) and each
    argument that differs (``per_device_args_differ``: position -> [the
    rank's bytes, the bytes its shardings give]). ``per_device`` says how
    the pass ran. Where the mesh form cannot take the cell's shapes (a
    dimension that does not split over its ranks, an MoE token count not
    evenly divisible over the data ranks) it is None and
    ``per_device_reason`` says why."""
    rec: Dict[str, Any] = {"per_device_note": cell.per_device_note}
    t0 = time.perf_counter()
    with fake_mesh(mesh_shape) as dmesh:
        try:
            fn, args = cell.per_device(dmesh)
            fig = call_figures(fn, args, "_per_device")
        except ValueError as e:
            if "does not split" not in str(e) and "not evenly divisible" not in str(e):
                raise
            rec.update(per_device=None, per_device_reason=str(e))
            return rec
    totals = fig.pop("totals")
    rec["per_device"] = {"rank": 0, "group": "fake", "world": math.prod(mesh_shape.values()),
                         "cost_s": time.perf_counter() - t0}
    del fig["cost_s"]
    rec.update(fig)
    rec["collective_bytes_per_device"] = dict(sorted(totals.collective.items()))
    rec["collective_total_bytes"] = totals.collective_total
    rank = [arg_bytes((a,)) for a in args]
    spec = [_state_bytes(a, sh) for a, sh in zip(cell.args, cell.in_shardings)]
    rec["per_device_arg_bytes"] = sum(rank)
    if sum(rank) != sum(spec):
        rec["per_device_arg_factor"] = sum(rank) / sum(spec)
        rec["per_device_args_differ"] = {i: [r, w] for i, (r, w) in enumerate(zip(rank, spec))
                                         if r != w}
    return rec


def transient_bound(figures: Dict[str, Any], suffix: str = "") -> int:
    """How far a card's measured transient peak (``max_memory_allocated()``
    of the call less what was allocated before it) may exceed the
    predicted one (``step_peak_bytes`` less the arguments' bytes): the
    CUDA caching allocator rounds every block up to 512 B, and may hand a
    large-pool block (over 1 MiB) out with up to 1 MiB unsplit, for each
    storage live at once; and one op at a time takes its hidden workspace.
    The prediction is never above the measurement of a step whose
    backward runs no :data:`FUNCTIONAL_FORMS` (every block is at least the
    bytes asked for); one that does may read below it by up to
    ``step_functional`` (:class:`StepMemory`). ``suffix``:
    ``"_per_device"`` for a rank's figures."""
    return (ROUND * figures["step_max_live" + suffix]
            + LARGE_BLOCK * figures["step_max_live_large" + suffix]
            + figures["step_workspace" + suffix])


def allocation_slack(leaves) -> int:
    """How far the CUDA caching allocator's count of ``leaves`` may exceed
    their bytes: ``ROUND`` B of rounding each, and ``LARGE_BLOCK`` more for
    each one over ``LARGE_BLOCK`` (a large-pool block is not split when at
    most that much of it would remain)."""
    return sum(ROUND + (LARGE_BLOCK if t.numel() * t.element_size() > LARGE_BLOCK else 0)
               for t in leaves)


def measure_call(fn, make_args, device) -> Dict[str, Any]:
    """Run ``fn`` on a CUDA device on the arguments ``make_args()`` draws
    there, once as a warm-up and once measured. Returns the arguments'
    bytes (``arg_bytes``), what allocating them added to
    ``memory_allocated()`` (``arg_allocated``) and its
    :func:`allocation_slack` (``arg_slack``), their leaves (``n_leaves``),
    the measured call's transient peak (``max_memory_allocated()`` less
    what was allocated before it) and its wall ``ms``. The arguments are
    freed before it returns."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(device)
    args = make_args()
    torch.cuda.synchronize(device)
    leaves = [t for a in args for t in leaves_by_path(a).values()]
    rec = {"arg_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "arg_allocated": torch.cuda.memory_allocated(device) - before,
           "arg_slack": allocation_slack(leaves), "n_leaves": len(leaves)}
    del leaves
    out = fn(*args)                            # warm-up: libraries' handles and workspaces
    del out
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize(device)
    rec["ms"] = (time.perf_counter() - t0) * 1e3
    rec["transient"] = torch.cuda.max_memory_allocated(device) - base
    del out, args
    torch.cuda.empty_cache()
    return rec


def measure_on_device(cell: Cell, device, seed: int = 0) -> Dict[str, Any]:
    """Check a cell's predictions on a CUDA device at a 1x1 mesh:
    :func:`measure_call` of ``fn`` on :func:`materialize`'d arguments."""
    return measure_call(cell.fn, lambda: materialize(cell, device, seed), device)


def measure_rank_on_device(cell: Cell, mesh_shape: Dict[str, int], device,
                           seed: int = 0) -> Dict[str, Any]:
    """One device of a ``mesh_shape`` mesh on the card: rank 0's
    ``per_device`` call under a fake process group of the mesh's size on
    ``cuda``, its arguments drawn there shard by shard
    (:func:`materialize_rank`), measured by :func:`measure_call`. One rank's
    compute, no communication: the fake group's collectives return at once
    (their outputs uninitialised), so this reads bytes and time, never
    values."""
    with fake_mesh(mesh_shape, "cuda") as dmesh:
        fn, args = cell.per_device(dmesh)
        return measure_call(fn, lambda: materialize_rank(
            cell, args, device, shards=math.prod(mesh_shape.values()), seed=seed), device)


def per_device_record(arch_id: str, shape: str, multi_pod: bool = False,
                      variant: str = "base") -> Dict[str, Any]:
    """:func:`per_device_figures` of one cell on its production mesh, with
    the cell's names and the pass's ``seconds``: a picklable job for a
    worker process (the figures of many cells in parallel)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = get_arch(arch_id).build_cell(shape, mesh, variant=variant)
    t0 = time.perf_counter()
    rec = per_device_figures(cell, mesh.shape)
    return {"arch": arch_id, "shape": shape, "variant": variant,
            "mesh": "2x16x16" if multi_pod else "16x16", **rec,
            "seconds": time.perf_counter() - t0}


def run_cell(arch_id: str, shape: str, *, multi_pod: bool = False,
             variant: str = "base", verbose: bool = True) -> Dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = get_arch(arch_id).build_cell(shape, mesh, variant=variant)
    rec: Dict = {
        "arch": arch_id, "shape": shape, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "model_flops": cell.model_flops,
    }
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        if verbose:
            print(f"[SKIP] {arch_id} x {shape}: {cell.skip}")
        return rec

    key = (arch_id, shape, variant, _signature(cell))
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = step_figures(cell)
    rec.update(_STEP_CACHE[key])
    rec["status"] = "ok"
    rec["memory"] = {"state_bytes_exact": state_bytes_exact(cell)}
    if cell.per_device is None:
        rec.update(per_device=None, per_device_reason=cell.per_device_note)
    else:
        rec.update(per_device_figures(cell, mesh.shape))
    if verbose:
        print(f"[OK] {arch_id} x {shape} ({rec['mesh']}, {variant}) "
              f"cost pass {rec['cost_s']:.1f}s")
        print(f"     state/device={rec['memory']['state_bytes_exact'] / 2**30:.3f}GiB "
              f"model_flops={cell.model_flops:.3e}")
        print(f"     whole step: flops={rec['step_flops']:.3e} "
              f"op_bytes={rec['step_op_bytes']:.3e} "
              f"peak={rec['step_peak_bytes'] / 2**30:.2f}GiB")
        if rec["per_device"] is None:
            print(f"     per device: none ({rec['per_device_reason']})")
        else:
            print(f"     per device ({rec['per_device']['cost_s']:.1f}s): "
                  f"flops={rec['step_flops_per_device']:.3e} "
                  f"op_bytes={rec['step_op_bytes_per_device']:.3e} "
                  f"peak={rec['step_peak_bytes_per_device'] / 2**30:.2f}GiB "
                  f"collectives={rec['collective_total_bytes']:.3e}B "
                  f"args={rec['per_device_arg_bytes'] / 2**30:.3f}GiB")
    return rec


def materialize(cell: Cell, device, seed: int = 0) -> Tuple[Any, ...]:
    """A recsys or gnn cell's arguments on ``device``: params from the
    port's ``init_params`` (a ``torch.Generator`` seeded with ``seed``), ids
    in range per field (recsys) and below the node count (gnn), labels in
    range, and zeros for the optimizer state. Raises if a materialised
    leaf's shape or dtype is not the meta argument's. (No LM cell fits one
    card at 1x1: their meta peaks are 199-425 GiB for yi-9b.)"""
    cfg = cell.config
    if not isinstance(cfg, (R.RecsysConfig, G.PNAConfig)):
        raise ValueError(f"materialize takes recsys and gnn cells, not {type(cfg).__name__}")
    gen = torch.Generator(device=device).manual_seed(seed)
    init = R.init_params if isinstance(cfg, R.RecsysConfig) else G.init_params

    def ints(high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=gen, device=device,
                             dtype=torch.int32)

    def rand(shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=gen, device=device)

    def leaf(name: str, t: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        # `name` is the leaf's key, or argN for a lone tensor argument;
        # `batch` the meta leaves of its argument
        if isinstance(cfg, R.RecsysConfig):
            if name == "sparse":
                return torch.stack([ints(v, t.shape[:1]) for v in cfg.vocab_sizes], 1)
            if name in ("seq", "arg2"):                  # the item field's ids
                return ints(cfg.vocab_sizes[cfg.item_field], t.shape)
            if name == "dense":
                return rand(t.shape)
            if name == "label":
                return (rand(t.shape) < 0.3).to(torch.float32)
        else:
            if name == "features":
                return torch.randn(tuple(t.shape), generator=gen, device=device)
            if name in ("src", "dst"):
                return ints(batch["features"].shape[0], t.shape)
            if name == "graph_ids":                      # contiguous graphs
                n_nodes, n_graphs = batch["features"].shape[0], batch["labels"].shape[0]
                return (torch.arange(n_nodes, device=device) * n_graphs // n_nodes
                        ).to(torch.int32)
            if name == "labels":
                return ints(cfg.n_classes, t.shape)
            if name == "label_mask":
                return torch.ones(tuple(t.shape), device=device)
        return torch.zeros(tuple(t.shape), dtype=t.dtype, device=device)

    out = [init(cfg, gen)]
    for i, arg in enumerate(cell.args[1:], start=1):
        flat = leaves_by_path(arg)
        out.append(map_by_path(arg, lambda path, t: leaf(
            path.rsplit(".", 1)[-1] or f"arg{i}", t, flat)))
    for i, (got, want) in enumerate(zip(out, cell.args)):
        g, w = leaves_by_path(got), leaves_by_path(want)
        bad = [k for k in w if k not in g or g[k].shape != w[k].shape or g[k].dtype != w[k].dtype]
        if bad or len(g) != len(w):
            raise ValueError(f"{cell.arch_id} x {cell.shape_name}: argument {i} does not "
                             f"match its meta form at {bad[:4]}")
    return tuple(out)


def materialize_rank(cell: Cell, args, device, *, shards: int, seed: int = 0
                     ) -> Tuple[Any, ...]:
    """Rank 0's arguments of a cell's ``per_device`` call (its meta
    ``args``) drawn on ``device``, each shard on its own: no global param
    is made. The first argument (params) ``N(0, 0.02**2)`` in its dtype;
    later ones zeros (the optimizer state, the decode cache, ``cache_len``)
    but the batch's ids in range: tokens below the vocabulary; PNA's
    ``src`` below the node count and ``dst`` in the node range of the shard
    its edge belongs to (``partition_edges``' layout over ``shards``
    shards, none padding), labels below the classes, features ``N(0, 1)``,
    ``label_mask`` ones. For bytes and time, not values."""
    cfg = cell.config
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = leaves_by_path(args[-1]) if isinstance(args[-1], dict) else {}

    def ints(high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=gen, device=device,
                             dtype=torch.int32)

    def leaf(i: int, name: str, t: torch.Tensor) -> torch.Tensor:
        shape = tuple(t.shape)
        if i == 0:
            return (torch.randn(shape, generator=gen, device=device) * 0.02).to(t.dtype)
        if isinstance(cfg, G.PNAConfig):
            n_nodes = batch["features"].shape[0]
            if name == "features":
                return torch.randn(shape, generator=gen, device=device)
            if name == "src":
                return ints(n_nodes, shape)
            if name == "dst":
                per, rows = shape[0] // shards, n_nodes // shards
                owner = torch.arange(shape[0], device=device) // per
                return (owner * rows + ints(rows, shape)).to(torch.int32)
            if name == "labels":
                return ints(cfg.n_classes, shape)
            if name == "label_mask":
                return torch.ones(shape, device=device)
        elif name in ("tokens", "labels", f"arg{i}") and not t.dtype.is_floating_point and t.dim():
            return ints(cfg.vocab, shape)
        return torch.zeros(shape, dtype=t.dtype, device=device)

    return tuple(map_by_path(a, lambda path, t, i=i: leaf(i, path.rsplit(".", 1)[-1]
                                                          or f"arg{i}", t))
                 for i, a in enumerate(args))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--all", action="store_true", help="run every arch x shape")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)

    if args.all:
        targets = [(a, s) for a in list_archs() for s in get_arch(a).shapes]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else list(get_arch(args.arch).shapes)
        targets = [(args.arch, s) for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    failures = 0
    for multi_pod in meshes:
        for arch_id, shape in targets:
            try:
                records.append(run_cell(arch_id, shape, multi_pod=multi_pod,
                                        variant=args.variant))
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                traceback.print_exc()
                records.append({
                    "arch": arch_id, "shape": shape,
                    "mesh": "2x16x16" if multi_pod else "16x16",
                    "variant": args.variant,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                })
    out = args.out or os.path.join(
        "build", "dryrun",
        f"dryrun_{'multi' if args.multi_pod or args.both_meshes else 'single'}"
        f"_{args.variant}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    skipped = sum(1 for r in records if r["status"] == "skipped")
    print(f"\n== dry-run summary: {ok} ok, {skipped} skipped, {failures} failed "
          f"-> {out}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
