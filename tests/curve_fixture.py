"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``) and the
port's chains that are held to them. Imports nothing of JAX or of the JAX
package, so ``chip_smoke.py`` and the card's tests use it on a machine
without JAX; ``tests/jax_curves.py`` writes the file with JAX.

The fixture carries four JAX curves, each from the smoke config of its
arch, JAX's init params (``init_params(cfg, PRNGKey(0))``), AdamW at ``LR``
and ``STEPS`` steps:

* ``stream/dlrm-mlperf``: the JAX driver's streaming chain (``--spec dlrm
  --device-feed arena --fault-tolerant``) over the shards that
  ``write_log_shards`` writes with ``STREAM`` (seed, shard count, rows per
  shard), three epochs of 8 shards;
* ``loop/dlrm-mlperf``, ``loop/dcn-v2``, ``loop/autoint``: JAX
  ``run_training`` over ``synthetic_batch`` batches of ``LOOP_BATCH`` rows
  (the JAX driver's in-memory path).

Each curve stores its params, ``lr``, ``batch``, ``steps`` and ``losses``
(the stream curve also ``seed``, ``n_shards`` and ``rows_per_shard``).
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_loss_curves.npz"
CURVES = ("stream/dlrm-mlperf", "loop/dlrm-mlperf", "loop/dcn-v2", "loop/autoint")
STEPS = 24
LR = 1e-3                     # --lr default of both drivers
LOOP_BATCH = 64               # --batch default of both drivers
STREAM = {"seed": 0, "n_shards": 8, "rows_per_shard": 128}


def load(path: Path = FIXTURE) -> Dict[str, Dict[str, Any]]:
    """The fixture as ``{curve: {"params": {name: array}, field: value}}``."""
    curves: Dict[str, Dict[str, Any]] = {}
    with np.load(path) as f:
        for key in f.files:
            kind, arch, *rest = key.split("/")
            entry = curves.setdefault(f"{kind}/{arch}", {"params": {}})
            if rest[0] == "params":
                entry["params"][rest[1]] = f[key]
            else:
                entry[rest[0]] = f[key][()] if f[key].ndim == 0 else f[key]
    return curves


def port_losses(curve: str, entry: Dict[str, Any], device, params=None) -> List[float]:
    """The port's chain of ``curve`` on ``device`` from the fixture's params
    (or ``params``, a ``{name: tensor}`` dict already on ``device``): the
    in-memory driver's ``run_in_memory``, or ``run_streaming`` over shards
    that the port's ``write_log_shards`` writes with the curve's seed and
    sizes. Returns its losses."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    kind, arch = curve.split("/")
    spec = get_arch(arch)
    cfg = spec.smoke()
    opt = adamw(float(entry["lr"]))
    if params is None:
        params = R.params_from_jax(entry["params"], device)
    state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
    argv = ["--arch", arch, "--steps", str(int(entry["steps"])),
            "--batch", str(int(entry["batch"])), "--device", device.type]
    if kind == "loop":
        return train.run_in_memory(train.parse_args(argv), spec, cfg, state, opt)[1]
    from repro_torch.fe.datagen import write_log_shards
    with tempfile.TemporaryDirectory() as d:
        write_log_shards(d, seed=int(entry["seed"]), n_shards=int(entry["n_shards"]),
                         rows_per_shard=int(entry["rows_per_shard"]))
        args = train.parse_args(argv + ["--data-dir", d, "--spec", "dlrm",
                                        "--device-feed", "arena", "--fault-tolerant"])
        return train.run_streaming(args, spec, cfg, state, opt)[1]
