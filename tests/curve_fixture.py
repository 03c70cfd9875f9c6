"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``) and the
port's chains that are held to them. Imports nothing of JAX or of the JAX
package, so ``chip_smoke.py`` and the card's tests use it on a machine
without JAX; ``tests/jax_curves.py`` writes the file with JAX.

The fixture carries nine JAX curves, AdamW at ``LR``. Eight are at the smoke
config of their arch, ``STEPS`` steps each (``SMOKE_CURVES``); the recsys
ones from JAX's init params (``init_params(cfg, PRNGKey(0))``):

* ``stream/dlrm-mlperf`` and ``stream/bst``: the JAX driver's streaming
  chain (``--spec dlrm`` or ``--spec bst`` (``STREAM_SPEC``),
  ``--device-feed arena --fault-tolerant``) over the shards that
  ``write_log_shards`` writes with ``STREAM`` (seed, shard count, rows per
  shard), three epochs of 8 shards;
* ``loop/dlrm-mlperf``, ``loop/dcn-v2``, ``loop/autoint``, ``loop/bst``:
  JAX ``run_training`` over ``synthetic_batch`` batches of ``LOOP_BATCH``
  rows (the JAX driver's in-memory path);
* ``loop/yi-9b`` and ``loop/qwen2.5-14b``: the same for the LM family, the
  transformer's ``make_train_step`` over ``LOOP_BATCH`` sequences of 64
  tokens (the JAX driver's lm branch), from the params that
  :func:`lm_numpy_params` draws with ``LM_SEED`` (JAX's init params would
  add 855 KB of incompressible floats and take the file past 1 MB).

``full/bst`` is BST at its published width: ``FULL["steps"]`` steps of
``run_training`` over ``synthetic_batch`` batches of ``FULL["batch"]``
rows, from the params that :func:`numpy_params` draws with ``FULL["seed"]``
(numpy, so the card's chain starts from the same bits without JAX).

Each recsys smoke curve stores its params, ``lr``, ``batch``, ``steps`` and
``losses`` (the stream curves also ``seed``, ``n_shards`` and
``rows_per_shard``); ``full/bst`` and the LM curves store no params but
their ``seed`` and a float64 sum of each (``sums``, an LM's under dotted
names such as ``dense_layers.attn_wq``), so that a change to
:func:`numpy_params` or :func:`lm_numpy_params` shows as a stale fixture.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_loss_curves.npz"
SMOKE_CURVES = ("stream/dlrm-mlperf", "loop/dlrm-mlperf", "loop/dcn-v2", "loop/autoint",
                "stream/bst", "loop/bst", "loop/yi-9b", "loop/qwen2.5-14b")
LM_CURVES = ("loop/yi-9b", "loop/qwen2.5-14b")
FULL_CURVES = ("full/bst",)
CURVES = SMOKE_CURVES + FULL_CURVES
STEPS = 24
LR = 1e-3                     # --lr default of both drivers
LOOP_BATCH = 64               # --batch default of both drivers
STREAM = {"seed": 0, "n_shards": 8, "rows_per_shard": 128}
STREAM_SPEC = {"dlrm-mlperf": "dlrm", "bst": "bst"}   # the scenario each stream curve runs
FULL = {"seed": 0, "batch": 8192, "steps": 8}
LM_SEED = 0


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


def lm_numpy_params(cfg, seed: int) -> Dict[str, np.ndarray]:
    """LM params of ``cfg`` drawn with numpy, flat under dotted names, with
    the distributions of the JAX package's ``init_params``: normal(0, 1)
    times 0.02 in float32, the norms at 1. Leaf ``i`` of the sorted names
    draws from ``default_rng((seed, i))``."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.optimizer import flatten

    out: Dict[str, np.ndarray] = {}
    for i, (name, shape) in enumerate(sorted(flatten(param_shapes(cfg)).items())):
        if "norm" in name.rsplit(".", 1)[-1]:
            out[name] = np.ones(shape, np.float32)
            continue
        x = np.random.default_rng((seed, i)).standard_normal(shape, dtype=np.float32)
        x *= np.float32(0.02)
        out[name] = x
    return out


def drawn_params(curve: str, entry: Dict[str, Any]) -> Optional[Dict[str, np.ndarray]]:
    """The numpy-drawn start of a curve that stores only its seed
    (``full/bst``, the LM curves); None for one that stores its params."""
    if curve in LM_CURVES:
        return lm_numpy_params(curve_config(curve), int(entry["seed"]))
    if curve.startswith("full/"):
        return numpy_params(curve_config(curve), int(entry["seed"]))
    return None


def start_params(curve: str, entry: Dict[str, Any], device):
    """The chain's first params on ``device``: the fixture's (JAX's init) or
    the numpy-drawn ones of its seed."""
    drawn = drawn_params(curve, entry)
    if curve in LM_CURVES:
        from repro_torch.models.transformer import params_from_jax
        return params_from_jax(drawn, device)
    from repro_torch.models.recsys import params_from_jax
    return params_from_jax(entry["params"] if drawn is None else drawn, device)


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
    (:func:`start_params`), or from ``params``, a ``{name: tensor}`` dict
    already on ``device`` (an LM's nested, or flat under dotted names): the
    in-memory driver's ``run_in_memory``, or
    ``run_streaming`` over shards that the port's ``write_log_shards``
    writes with the curve's seed and sizes. ``steps`` cuts the chain short.
    Returns its losses."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw, flatten, unflatten

    kind, arch = curve.split("/")
    spec = get_arch(arch)
    cfg = curve_config(curve)
    opt = adamw(float(entry["lr"]))
    argv = ["--arch", arch, "--steps", str(steps or int(entry["steps"])),
            "--batch", str(int(entry["batch"])), "--device", device.type]
    if params is None:
        params = start_params(curve, entry, device)
    if spec.family == "lm":
        params = unflatten(flatten(params))
        state = {"params": params, "opt": opt.init(params)}
        return train.run_in_memory(train.parse_args(argv), spec, cfg, state, opt)[1]
    state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
    if kind in ("loop", "full"):
        return train.run_in_memory(train.parse_args(argv), spec, cfg, state, opt)[1]
    from repro_torch.fe.datagen import write_log_shards
    with tempfile.TemporaryDirectory() as d:
        write_log_shards(d, seed=int(entry["seed"]), n_shards=int(entry["n_shards"]),
                         rows_per_shard=int(entry["rows_per_shard"]))
        args = train.parse_args(argv + ["--data-dir", d, "--spec", STREAM_SPEC[arch],
                                        "--device-feed", "arena", "--fault-tolerant"])
        return train.run_streaming(args, spec, cfg, state, opt)[1]
