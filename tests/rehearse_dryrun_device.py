"""Where the dry run's per-device peak and a run without the tracker part.

Rank 0 of ``pna x ogb_products`` on the 16x16 mesh (its per-device call
under a fake process group of 256, on the CPU, arguments drawn by
``dryrun.materialize_rank``) three ways:

* the meta prediction (``step_peak_bytes_per_device`` less the arguments);
* the same call on real CPU tensors under ``PeakMode`` (the tracker);
* the same call with no dispatch mode, its allocations read from torch's
  profiler (``profile_memory``): the largest sum of the allocator's live
  bytes during the call.

Under any dispatch mode autograd's index and gather backwards write a new
output beside their zeros (``index_put``, ``scatter_add``), where a run
without one writes the zeros in place; the last figure is what a card's
``max_memory_allocated`` follows. Prints the three transients, their gap
and ``step_functional_per_device`` (the largest such output). About 30 s
and 5 GB on the CPU:

  PYTHONPATH=src python tests/rehearse_dryrun_device.py
"""

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.configs.base import leaves_by_path
from repro_torch.core.sharding import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_stats import PeakMode
from repro_torch.launch.mesh import fake_mesh

SHAPE = {"data": 16, "model": 16}


def allocator_peak(fn, args) -> int:
    """The largest sum of live bytes the CPU allocator reports during
    ``fn(*args)`` (no dispatch mode is active)."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn(*args)
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "[memory]"),
                    key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return peak


def main() -> None:
    cell = get_arch("pna").build_cell("ogb_products", Mesh(SHAPE))
    fig = D.per_device_figures(cell, SHAPE)
    predicted = fig["step_peak_bytes_per_device"] - fig["per_device_arg_bytes"]
    with fake_mesh(SHAPE, "cpu") as mesh:
        fn, args = cell.per_device(mesh)
        real = D.materialize_rank(cell, args, "cpu", shards=256)
        fn(*real)                                  # warm-up
        n_args = sum(t.numel() * t.element_size() for a in real
                     for t in leaves_by_path(a).values())
        tracker = PeakMode("cpu").track(real)
        with tracker:
            fn(*real)
        plain = allocator_peak(fn, real)
    print(f"pna x ogb_products rank 0 of 16x16, transient bytes: meta prediction {predicted:,}, "
          f"tracker on the CPU {tracker.peak_bytes - n_args:,}, no dispatch mode {plain:,} "
          f"(gap {plain - predicted:,}); step_functional_per_device "
          f"{fig['step_functional_per_device']:,}")


if __name__ == "__main__":
    main()
