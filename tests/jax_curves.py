"""Writes the JAX loss curves of ``tests/curve_fixture.py`` (the fixture
``tests/data/jax_loss_curves.npz``) with JAX on the CPU (about a minute;
``full/bst`` trains the published BST with its 0.6 GiB table, ``full/pna``
the published PNA on a Cora-size graph):

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_curves.py
"""

from __future__ import annotations

import itertools
import tempfile
from typing import Dict, List

import numpy as np

from curve_fixture import (CURVES, FIXTURE, FULL, FULL_PNA, LM_CURVES, LM_SEED, LOOP_BATCH, LR,
                           STEPS, STREAM, STREAM_SPEC, curve_config, full_pna_graph,
                           gnn_numpy_params, lm_numpy_params, numpy_params)


def _jax_config(curve: str):
    import importlib

    from repro.configs import get_arch

    kind, arch = curve.split("/")
    if curve == "full/pna":       # the published width at the full_graph_sm shape
        from repro.configs.base import gnn_config_for
        return gnn_config_for("pna", "full_graph_sm")
    if kind == "full":
        return importlib.import_module(f"repro.configs.{arch.replace('-', '_')}").CONFIG
    return get_arch(arch).smoke()


def _jax_loop_losses(curve: str, jparams, batch: int, steps: int) -> List[float]:
    import jax

    from repro.configs import get_arch
    from repro.launch.train import synthetic_batch
    from repro.models import recsys as JR
    from repro.train.loop import LoopConfig, run_training
    from repro.train.optimizer import adamw

    spec = get_arch(curve.split("/")[1])
    cfg = _jax_config(curve)
    if spec.family == "lm":       # the JAX driver's lm branch
        from repro.models import transformer as JT
        opt = adamw(LR)
        step, init = jax.jit(JT.make_train_step(cfg, opt)), opt.init
    elif spec.family == "gnn":    # its gnn branch
        from repro.models import gnn as JG
        opt = adamw(LR)
        step, init = jax.jit(JG.make_train_step(cfg, opt)), opt.init
    else:
        step_fn, init, _ = JR.make_sparse_train_step(cfg, adamw(LR))
        step = jax.jit(step_fn)

    def step_wrapper(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    if curve == "full/pna":       # full-graph training: one graph, every step
        import jax.numpy as jnp
        graph = {k: jnp.asarray(v) for k, v in full_pna_graph().items()}
        source = lambda s: graph  # noqa: E731
    else:
        source = lambda s: synthetic_batch(spec.family, cfg, batch, s)  # noqa: E731
    _, stats = run_training(
        cfg=LoopConfig(n_steps=steps), state={"params": jparams, "opt": init(jparams)},
        train_step=step_wrapper, batch_source=source)
    return stats.losses


def _jax_stream_losses(arch: str, jparams, data_dir: str) -> List[float]:
    """The chain that the JAX driver's ``run_streaming`` wires for ``--spec
    STREAM_SPEC[arch] --device-feed arena --fault-tolerant``."""
    import dataclasses

    from repro.configs import get_arch
    from repro.core import PipelinedRunner
    from repro.fe import featureplan, get_spec
    from repro.fe.datagen import write_log_shards
    from repro.io.dataset import ShardDataset
    from repro.io.stream import StreamingLoader
    from repro.models import recsys as JR
    from repro.train.optimizer import adamw

    write_log_shards(data_dir, **STREAM)
    cfg = get_arch(arch).smoke()
    plan = featureplan.compile(get_spec(STREAM_SPEC[arch]))
    ds = ShardDataset(data_dir)
    loader = StreamingLoader(ds, workers=2, prefetch=4, epochs=-(-STEPS // len(ds)),
                             shuffle=True, seed=0, columns=plan.required_columns, ordered=True)
    mf = plan.model_feed(dataclasses.replace(cfg, dedup_capacity=0),
                         split_sparse_fields=True, rows_hint=loader.rows_hint)
    raw, init, _ = JR.make_sparse_train_step(mf.config, adamw(LR))
    ab = plan.arena_binding(split_sparse_fields=True)
    feeder = ab.make_feeder(rows_hint=loader.rows_hint)
    fused = mf.make_step(raw, fence_cb=feeder.donation_fence)
    losses: List[float] = []

    def step(state, env):
        p, o, m = fused(state["params"], state["opt"], env)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    step.feed_stats = mf.stats
    runner = PipelinedRunner(ab.layers, step, prefetch=4, device_feed=feeder)
    try:
        runner.run({"params": jparams, "opt": init(jparams)},
                   itertools.islice(iter(loader), STEPS))
    finally:
        loader.close()
    return losses


def generate() -> Dict[str, np.ndarray]:
    """Run the JAX chains; returns the fixture's arrays, keyed
    ``<curve>/<field>``, ``<curve>/params/<name>`` and (``full/``)
    ``<curve>/sums/<name>``."""
    import jax
    import jax.numpy as jnp

    from repro.models import gnn as JG
    from repro.models import recsys as JR

    out: Dict[str, np.ndarray] = {}
    for curve in CURVES:
        kind, arch = curve.split("/")
        if curve == "full/pna":
            drawn = gnn_numpy_params(curve_config(curve), FULL_PNA["seed"])
            for k, v in drawn.items():
                out[f"{curve}/sums/{k}"] = np.float64(v.sum(dtype=np.float64))
            jparams = {k: jnp.asarray(v) for k, v in drawn.items()}
            steps = FULL_PNA["steps"]
            batch = FULL_PNA["graph"][0]
            losses = _jax_loop_losses(curve, jparams, batch, steps)
            out[f"{curve}/seed"] = np.int64(FULL_PNA["seed"])
            out[f"{curve}/graph"] = np.asarray(FULL_PNA["graph"], np.int64)
            out[f"{curve}/graph_seed"] = np.int64(FULL_PNA["graph_seed"])
        elif kind == "full":
            drawn = numpy_params(curve_config(curve), FULL["seed"])
            for k, v in drawn.items():
                out[f"{curve}/sums/{k}"] = np.float64(v.sum(dtype=np.float64))
            jparams = {k: jnp.asarray(v) for k, v in drawn.items()}
            del drawn
            losses = _jax_loop_losses(curve, jparams, FULL["batch"], FULL["steps"])
            del jparams
            out[f"{curve}/seed"] = np.int64(FULL["seed"])
            batch, steps = FULL["batch"], FULL["steps"]
        elif curve in LM_CURVES:
            drawn = lm_numpy_params(curve_config(curve), LM_SEED)
            for k, v in drawn.items():
                out[f"{curve}/sums/{k}"] = np.float64(v.sum(dtype=np.float64))
            jparams = {}
            for k, v in drawn.items():          # the JAX tree, nested as JAX's init makes it
                *path, leaf = k.split(".")
                node = jparams
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(v)
            losses = _jax_loop_losses(curve, jparams, LOOP_BATCH, STEPS)
            out[f"{curve}/seed"] = np.int64(LM_SEED)
            batch, steps = LOOP_BATCH, STEPS
        else:
            init = JG.init_params if arch == "pna" else JR.init_params
            jparams = init(_jax_config(curve), jax.random.PRNGKey(0))
            for k, v in jparams.items():
                out[f"{curve}/params/{k}"] = np.asarray(v)
            steps = STEPS
            if kind == "stream":
                with tempfile.TemporaryDirectory() as d:
                    losses = _jax_stream_losses(arch, jparams, d)
                batch = STREAM["rows_per_shard"]
                for k, v in STREAM.items():
                    out[f"{curve}/{k}"] = np.int64(v)
            else:
                losses = _jax_loop_losses(curve, jparams, LOOP_BATCH, STEPS)
                batch = LOOP_BATCH
        out[f"{curve}/lr"] = np.float64(LR)
        out[f"{curve}/batch"] = np.int64(batch)
        out[f"{curve}/steps"] = np.int64(steps)
        out[f"{curve}/losses"] = np.asarray(losses, np.float64)
    return out


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **generate())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size:,} bytes)")
