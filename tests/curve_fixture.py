"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``) and the
port's chains that are held to them. Imports nothing of JAX or of the JAX
package, so ``chip_smoke.py`` and the card's tests use it on a machine
without JAX; ``tests/jax_curves.py`` writes the file with JAX.

The fixture carries seven JAX curves, AdamW at ``LR``. Six are at the smoke
config of their arch, from JAX's init params (``init_params(cfg,
PRNGKey(0))``), ``STEPS`` steps each (``SMOKE_CURVES``):

* ``stream/dlrm-mlperf`` and ``stream/bst``: the JAX driver's streaming
  chain (``--spec dlrm`` or ``--spec bst`` (``STREAM_SPEC``),
  ``--device-feed arena --fault-tolerant``) over the shards that
  ``write_log_shards`` writes with ``STREAM`` (seed, shard count, rows per
  shard), three epochs of 8 shards;
* ``loop/dlrm-mlperf``, ``loop/dcn-v2``, ``loop/autoint``, ``loop/bst``:
  JAX ``run_training`` over ``synthetic_batch`` batches of ``LOOP_BATCH``
  rows (the JAX driver's in-memory path).

``full/bst`` is BST at its published width: ``FULL["steps"]`` steps of
``run_training`` over ``synthetic_batch`` batches of ``FULL["batch"]``
rows, from the params that :func:`numpy_params` draws with ``FULL["seed"]``
(numpy, so the card's chain starts from the same bits without JAX).

Each smoke curve stores its params, ``lr``, ``batch``, ``steps`` and
``losses`` (the stream curves also ``seed``, ``n_shards`` and
``rows_per_shard``); ``full/bst`` stores no params but their ``seed`` and a
float64 sum of each (``sums``), so that a change to :func:`numpy_params`
shows as a stale fixture.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_loss_curves.npz"
SMOKE_CURVES = ("stream/dlrm-mlperf", "loop/dlrm-mlperf", "loop/dcn-v2", "loop/autoint",
                "stream/bst", "loop/bst")
FULL_CURVES = ("full/bst",)
CURVES = SMOKE_CURVES + FULL_CURVES
STEPS = 24
LR = 1e-3                     # --lr default of both drivers
LOOP_BATCH = 64               # --batch default of both drivers
STREAM = {"seed": 0, "n_shards": 8, "rows_per_shard": 128}
STREAM_SPEC = {"dlrm-mlperf": "dlrm", "bst": "bst"}   # the scenario each stream curve runs
FULL = {"seed": 0, "batch": 8192, "steps": 8}


def numpy_params(cfg, seed: int) -> Dict[str, np.ndarray]:
    """Params of ``cfg`` drawn with numpy, with the distributions of the JAX
    package's ``init_params``: uniform ±1/√D for ``embed``, He-normal for
    matrices, zeros for biases, ones for the layer-norm scales. Param ``i``
    of ``param_shapes`` draws from ``default_rng((seed, i))``, in float32."""
    from repro_torch.models.recsys import param_shapes

    out: Dict[str, np.ndarray] = {}
    for i, (name, shape) in enumerate(param_shapes(cfg).items()):
        rng = np.random.default_rng((seed, i))
        if name == "embed":
            scale = np.float32(1.0 / np.sqrt(cfg.embed_dim))
            x = rng.random(shape, dtype=np.float32)
            x *= 2 * scale
            x -= scale
        elif "ln" in name and name.endswith("_w"):
            x = np.ones(shape, np.float32)
        elif len(shape) == 1:
            x = np.zeros(shape, np.float32)
        else:
            x = rng.standard_normal(shape, dtype=np.float32)
            x *= np.float32(np.sqrt(2.0 / max(shape[0], 1)))
        out[name] = x
    return out


def load(path: Path = FIXTURE) -> Dict[str, Dict[str, Any]]:
    """The fixture as ``{curve: {"params": {name: array}, "sums": {name:
    float}, field: value}}``."""
    curves: Dict[str, Dict[str, Any]] = {}
    with np.load(path) as f:
        for key in f.files:
            kind, arch, *rest = key.split("/")
            entry = curves.setdefault(f"{kind}/{arch}", {"params": {}})
            value = f[key][()] if f[key].ndim == 0 else f[key]
            if len(rest) == 2:                  # params/<name>, sums/<name>
                entry.setdefault(rest[0], {})[rest[1]] = value
            else:
                entry[rest[0]] = value
    return curves


def curve_config(curve: str):
    """The config a curve runs: the published one for ``full/``, else the
    smoke config."""
    from repro_torch.configs import get_arch

    kind, arch = curve.split("/")
    spec = get_arch(arch)
    return spec.config if kind == "full" else spec.smoke()


def port_losses(curve: str, entry: Dict[str, Any], device, params=None,
                steps: Optional[int] = None) -> List[float]:
    """The port's chain of ``curve`` on ``device`` from the fixture's params
    (``full/``: :func:`numpy_params` of its seed), or from ``params``, a
    ``{name: tensor}`` dict already on ``device``: the in-memory driver's
    ``run_in_memory``, or ``run_streaming`` over shards that the port's
    ``write_log_shards`` writes with the curve's seed and sizes. ``steps``
    cuts the chain short. Returns its losses."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    kind, arch = curve.split("/")
    spec = get_arch(arch)
    cfg = curve_config(curve)
    opt = adamw(float(entry["lr"]))
    if params is None:
        params = R.params_from_jax(numpy_params(cfg, int(entry["seed"])) if kind == "full"
                                   else entry["params"], device)
    state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
    argv = ["--arch", arch, "--steps", str(steps or int(entry["steps"])),
            "--batch", str(int(entry["batch"])), "--device", device.type]
    if kind in ("loop", "full"):
        return train.run_in_memory(train.parse_args(argv), spec, cfg, state, opt)[1]
    from repro_torch.fe.datagen import write_log_shards
    with tempfile.TemporaryDirectory() as d:
        write_log_shards(d, seed=int(entry["seed"]), n_shards=int(entry["n_shards"]),
                         rows_per_shard=int(entry["rows_per_shard"]))
        args = train.parse_args(argv + ["--data-dir", d, "--spec", STREAM_SPEC[arch],
                                        "--device-feed", "arena", "--fault-tolerant"])
        return train.run_streaming(args, spec, cfg, state, opt)[1]
