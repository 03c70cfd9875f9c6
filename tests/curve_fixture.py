"""The committed JAX loss curves (``tests/data/jax_loss_curves.npz``) and the
port's chains that are held to them. Imports nothing of JAX or of the JAX
package, so ``chip_smoke.py`` and the card's tests use it on a machine
without JAX; ``tests/jax_curves.py`` writes the file with JAX.

The fixture carries thirteen JAX curves, AdamW at ``LR``. Eleven are at the
smoke config of their arch, ``STEPS`` steps each (``SMOKE_CURVES``); the
recsys ones and ``loop/pna`` from JAX's init params (``init_params(cfg,
PRNGKey(0))``):

* ``stream/dlrm-mlperf`` and ``stream/bst``: the JAX driver's streaming
  chain (``--spec dlrm`` or ``--spec bst`` (``STREAM_SPEC``),
  ``--device-feed arena --fault-tolerant``) over the shards that
  ``write_log_shards`` writes with ``STREAM`` (seed, shard count, rows per
  shard), three epochs of 8 shards;
* ``loop/dlrm-mlperf``, ``loop/dcn-v2``, ``loop/autoint``, ``loop/bst``:
  JAX ``run_training`` over ``synthetic_batch`` batches of ``LOOP_BATCH``
  rows (the JAX driver's in-memory path);
* ``loop/yi-9b``, ``loop/qwen2.5-14b``, ``loop/deepseek-moe-16b`` and
  ``loop/deepseek-v2-236b``: the same for the LM family, the transformer's
  ``make_train_step`` over ``LOOP_BATCH`` sequences of 64 tokens (the JAX
  driver's lm branch), from the params that :func:`lm_numpy_params` draws
  with ``LM_SEED`` (JAX's init params would add 855 KB of incompressible
  floats and take the file past 1 MB);
* ``loop/pna``: the gnn family's ``make_train_step`` over the JAX driver's
  ``synthetic_batch("gnn")`` graphs (200 nodes, 800 edges a step).

``full/bst`` is BST at its published width: ``FULL["steps"]`` steps of
``run_training`` over ``synthetic_batch`` batches of ``FULL["batch"]``
rows, from the params that :func:`numpy_params` draws with ``FULL["seed"]``
(numpy, so the card's chain starts from the same bits without JAX).
``full/pna`` is PNA at its published width (4 layers, d_hidden 75) on a
Cora-size graph, ``random_graph(*FULL_PNA["graph"], seed=FULL_PNA
["graph_seed"])`` (2,708 nodes, 10,556 edges, 1,433 features, 7 classes),
full-graph training: ``FULL_PNA["steps"]`` steps of ``run_training`` on
that one graph, from the params that :func:`gnn_numpy_params` draws with
``FULL_PNA["seed"]``.

Each recsys smoke curve stores its params, ``lr``, ``batch``, ``steps`` and
``losses`` (the stream curves also ``seed``, ``n_shards`` and
``rows_per_shard``); ``full/bst`` and the LM curves store no params but
their ``seed`` and a float64 sum of each (``sums``, an LM's under dotted
names such as ``dense_layers.attn_wq``), so that a change to
:func:`numpy_params`, :func:`lm_numpy_params` or :func:`gnn_numpy_params`
shows as a stale fixture; ``full/pna`` also stores ``graph`` and
``graph_seed``.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_loss_curves.npz"
SMOKE_CURVES = ("stream/dlrm-mlperf", "loop/dlrm-mlperf", "loop/dcn-v2", "loop/autoint",
                "stream/bst", "loop/bst", "loop/yi-9b", "loop/qwen2.5-14b",
                "loop/deepseek-moe-16b", "loop/deepseek-v2-236b", "loop/pna")
LM_CURVES = ("loop/yi-9b", "loop/qwen2.5-14b", "loop/deepseek-moe-16b",
             "loop/deepseek-v2-236b")
FULL_CURVES = ("full/bst", "full/pna")
CURVES = SMOKE_CURVES + FULL_CURVES
STEPS = 24
LR = 1e-3                     # --lr default of both drivers
LOOP_BATCH = 64               # --batch default of both drivers
STREAM = {"seed": 0, "n_shards": 8, "rows_per_shard": 128}
STREAM_SPEC = {"dlrm-mlperf": "dlrm", "bst": "bst"}   # the scenario each stream curve runs
FULL = {"seed": 0, "batch": 8192, "steps": 8}
FULL_PNA = {"seed": 0, "steps": 5, "graph": (2708, 10556, 1433, 7), "graph_seed": 0}
# The PNA curves part from any other fp32 run of the same chain within a few
# steps (a chaotic trajectory, ROADMAP C24): each loss is held within 4x the
# largest reading of tests/rehearse_pna.py (JAX's and the port's fp32 chains
# against the port's float64 one, threaded runs against each other and one
# thread, port against JAX), which every param 1e-3 off exceeds 12.1x
# (loop/pna) and 2.85x (full/pna), one matrix 1e-3 off 3.24x and 1.39x; the
# first loss, before any step, within PNA_FIRST_RTOL (it reads 1.2e-7 and
# 1.8e-7, one matrix 1e-3 off 7.8e-4 and 5.9e-4). full/pna is cut to 5
# steps: by step 12 two fp32 runs part by 0.2.
PNA_RTOL = {"loop/pna": 4.21e-3, "full/pna": 8.86e-3}
PNA_FIRST_RTOL = 1e-5
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


def gnn_numpy_params(cfg, seed: int) -> Dict[str, np.ndarray]:
    """PNA params of ``cfg`` drawn with numpy, with the distributions of the
    JAX package's ``init_params``: He-normal matrices, zero biases. Param
    ``i`` of ``param_shapes`` draws from ``default_rng((seed, i))``, in
    float32."""
    from repro_torch.models.gnn import param_shapes

    out: Dict[str, np.ndarray] = {}
    for i, (name, shape) in enumerate(param_shapes(cfg).items()):
        if name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
            continue
        x = np.random.default_rng((seed, i)).standard_normal(shape, dtype=np.float32)
        x *= np.float32(np.sqrt(2.0 / max(shape[0], 1)))
        out[name] = x
    return out


def full_pna_graph() -> Dict[str, np.ndarray]:
    """The one graph ``full/pna`` trains on, every step."""
    from repro_torch.models.gnn import random_graph
    return random_graph(*FULL_PNA["graph"], seed=FULL_PNA["graph_seed"])


def drawn_params(curve: str, entry: Dict[str, Any]) -> Optional[Dict[str, np.ndarray]]:
    """The numpy-drawn start of a curve that stores only its seed
    (``full/bst``, ``full/pna``, the LM curves); None for one that stores
    its params."""
    if curve in LM_CURVES:
        return lm_numpy_params(curve_config(curve), int(entry["seed"]))
    if curve == "full/pna":
        return gnn_numpy_params(curve_config(curve), int(entry["seed"]))
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
    if curve.endswith("/pna"):
        from repro_torch.models.gnn import params_from_jax
        return params_from_jax(entry["params"] if drawn is None else drawn, device)
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
    writes with the curve's seed and sizes, or (``full/pna``)
    ``run_training`` on :func:`full_pna_graph`. ``steps`` cuts the chain
    short. Returns its losses."""
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
    if curve == "full/pna":
        import torch

        from repro_torch.models.gnn import make_train_step
        from repro_torch.train.loop import LoopConfig, run_training
        graph = {k: torch.from_numpy(v).to(device) for k, v in full_pna_graph().items()}
        step = make_train_step(cfg, opt)

        def step_wrapper(state, batch):
            p, o, m = step(state["params"], state["opt"], batch)
            return {"params": p, "opt": o}, m

        _, stats = run_training(cfg=LoopConfig(n_steps=steps or int(entry["steps"])),
                                state={"params": params, "opt": opt.init(params)},
                                train_step=step_wrapper, batch_source=lambda s: graph)
        return stats.losses
    if spec.family == "gnn":
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
