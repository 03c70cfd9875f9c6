"""Mesh streaming train: the --mesh / --compress flags end to end.

Drives the port's streaming train driver on a 2x4 ('pod', 'data') mesh
(the port of ``examples/mesh_train.py``): embedding rows + Adagrad
accumulators sharded over all 8 ranks, two-stage local->global id dedup,
and bf16-compressed hierarchical gradient reduction across the pod axis.
The comm plan/summary lines show the modeled inter-pod bytes per step next
to what a flat fp32 all-reduce would move.

One process is one rank: on the CPU, 2x4 spawns 8 gloo ranks (the JAX
example forces 8 simulated host devices). One card holds one NCCL rank,
so on a one-card machine pass ``--mesh 1x1``; a mesh larger than the
visible cards is refused, as the driver refuses it. Arguments given on the
command line are appended to the example's own, so a later flag wins:

  PYTHONPATH=src python -m repro_torch.examples.mesh_train --device cpu
  PYTHONPATH=src python -m repro_torch.examples.mesh_train --mesh 1x1      # one card
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional, Sequence

from repro_torch.launch import train


def driver_argv(data_dir: str) -> List[str]:
    """The JAX example's ``sys.argv`` for the driver, ``argv[0]`` first."""
    return [
        "train",
        "--arch", "dlrm-mlperf",
        "--spec", "ads_ctr",
        "--data-dir", data_dir,
        "--gen-shards", "4",
        "--steps", "12",
        "--batch", "256",          # must split over the 8 mesh devices
        "--mesh", "2x4",
        "--compress", "bf16",
        "--device-feed", "off",    # the mesh jit splits the host batch itself
        "--metrics",
    ]


def main(argv: Optional[Sequence[str]] = None):
    """Run the driver on the example's arguments, then ``argv`` (the
    command line's by default); returns what the driver returns."""
    data_dir = os.path.join(tempfile.mkdtemp(prefix="meshlog_"), "shards")
    extra = list(sys.argv[1:] if argv is None else argv)
    out = train.main(driver_argv(data_dir)[1:] + extra)
    print("mesh_train OK")
    return out


if __name__ == "__main__":
    main()
