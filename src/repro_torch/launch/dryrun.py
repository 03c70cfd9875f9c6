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
the global program's: eager PyTorch has no SPMD partitioner, so the port
cannot split a step over 256 devices to cost one device's part; they are
counted once per cell and reused for the second mesh where the cell's
program and inputs are the same on both (the LM cells; a recsys or gnn
cell whose dedup capacity or edge list rounds up to a different multiple
of the device count is counted again). JAX's keys with no source in eager torch are left out:
``lower_s`` and ``compile_s`` (nothing is lowered or compiled),
``raw_cost_analysis`` and ``hlo_flops_per_device``/``hlo_bytes_per_device``
(XLA's per-device counts of the partitioned HLO), the ``memory_analysis``
fields ``argument_bytes``, ``output_bytes``, ``temp_bytes``,
``alias_bytes`` and ``peak_estimate_bytes`` (XLA's buffer assignment), and
``collective_bytes_per_device``/``collective_total_bytes`` (the
partitioner's collectives).

:func:`materialize` draws a cell's arguments on a device (params from the
port's ``init_params``, ids in range) and :func:`measure_on_device` runs
the cell there, for checking these predictions on a card at a 1x1 mesh.

Results land in ``build/dryrun/dryrun_<single|multi>_<variant>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pna --shape molecule
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import Cell, leaves_by_path, map_by_path
from repro_torch.launch.hlo_stats import LARGE_BLOCK, PeakMode, step_cost
from repro_torch.launch.mesh import make_production_mesh
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


def state_bytes_exact(cell: Cell) -> int:
    """Per-device bytes of the cell's arguments from their shardings; an
    argument whose sharding tree's paths are not its leaves' counts 0."""
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves, shardings = leaves_by_path(arg), leaves_by_path(sh)
        if sorted(leaves) == sorted(shardings):
            total += sum(leaf_bytes(leaves[k], shardings[k]) for k in leaves)
    return total


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


class StepMemory(PeakMode):
    """:class:`PeakMode` on ``meta`` that also keeps the largest
    :func:`hidden_workspace` of one op of the step (1 MiB at least: the
    reductions' and scans' scratch)."""

    def __init__(self) -> None:
        super().__init__("meta")
        self.workspace = 1 << 20

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.workspace = max(self.workspace, hidden_workspace(func._schema.name, args, kwargs))
        return super().__torch_dispatch__(func, types, args, kwargs)


def step_figures(cell: Cell) -> Dict[str, Any]:
    """``step_flops``, ``step_op_bytes``, ``step_peak_bytes``,
    ``step_peak_live``, ``step_max_live``, ``step_max_live_large``,
    ``step_workspace`` and ``cost_s`` of one call of the cell's ``fn`` on
    meta copies of its arguments (one pass)."""
    mem = StepMemory()
    t0 = time.perf_counter()
    totals = step_cost(cell.fn, *cell.args, peak=mem)
    return {"step_flops": totals.flops, "step_op_bytes": totals.op_bytes,
            "step_peak_bytes": mem.peak_bytes, "step_peak_live": mem.live_at_peak,
            "step_max_live": mem.max_live, "step_max_live_large": mem.max_live_large,
            "step_workspace": mem.workspace, "cost_s": time.perf_counter() - t0}


def transient_bound(figures: Dict[str, Any]) -> int:
    """How far a card's measured transient peak (``max_memory_allocated()``
    of the call less what was allocated before it) may exceed the
    predicted one (``step_peak_bytes`` less the arguments' bytes): the
    CUDA caching allocator rounds every block up to 512 B, and may hand a
    large-pool block (over 1 MiB) out with up to 1 MiB unsplit, for each
    storage live at once; and one op at a time takes its hidden workspace.
    The prediction is never above the measurement: every block is at
    least the bytes asked for."""
    return (ROUND * figures["step_max_live"] + LARGE_BLOCK * figures["step_max_live_large"]
            + figures["step_workspace"])


def allocation_slack(leaves) -> int:
    """How far the CUDA caching allocator's count of ``leaves`` may exceed
    their bytes: ``ROUND`` B of rounding each, and ``LARGE_BLOCK`` more for
    each one over ``LARGE_BLOCK`` (a large-pool block is not split when at
    most that much of it would remain)."""
    return sum(ROUND + (LARGE_BLOCK if t.numel() * t.element_size() > LARGE_BLOCK else 0)
               for t in leaves)


def measure_on_device(cell: Cell, device, seed: int = 0) -> Dict[str, Any]:
    """Check a cell's predictions on a CUDA device: materialise its
    arguments (:func:`materialize`), run ``fn`` once as a warm-up and once
    measured. Returns the arguments' bytes (``arg_bytes``), what allocating
    them added to ``memory_allocated()`` (``arg_allocated``) and its
    :func:`allocation_slack` (``arg_slack``), the measured call's transient
    peak (``max_memory_allocated()`` less what was allocated before it) and
    its wall ``ms``. The arguments are freed before it returns."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(device)
    args = materialize(cell, device, seed)
    torch.cuda.synchronize(device)
    leaves = [t for a in args for t in leaves_by_path(a).values()]
    rec = {"arg_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "arg_allocated": torch.cuda.memory_allocated(device) - before,
           "arg_slack": allocation_slack(leaves), "n_leaves": len(leaves)}
    del leaves
    out = cell.fn(*args)                       # warm-up: libraries' handles and workspaces
    del out
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = cell.fn(*args)
    torch.cuda.synchronize(device)
    rec["ms"] = (time.perf_counter() - t0) * 1e3
    rec["transient"] = torch.cuda.max_memory_allocated(device) - base
    del out, args
    torch.cuda.empty_cache()
    return rec


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
    if verbose:
        print(f"[OK] {arch_id} x {shape} ({rec['mesh']}, {variant}) "
              f"cost pass {rec['cost_s']:.1f}s")
        print(f"     state/device={rec['memory']['state_bytes_exact'] / 2**30:.3f}GiB "
              f"model_flops={cell.model_flops:.3e}")
        print(f"     whole step: flops={rec['step_flops']:.3e} "
              f"op_bytes={rec['step_op_bytes']:.3e} "
              f"peak={rec['step_peak_bytes'] / 2**30:.2f}GiB")
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
