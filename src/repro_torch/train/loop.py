"""Production training loop: FeatureBox pipeline -> train_step, with
checkpoint/restart.

A port of the JAX package's ``repro.train.loop``: ``batch_source(step)``
yields each step's raw batch (deterministic per step, so a restart replays
the data exactly), the compiled layer-wise FE schedule optionally runs on
it, and the train step consumes it; checkpoints are written asynchronously
every ``checkpoint_every`` steps, and on restart the loop resumes from the
latest step. The in-memory branch of ``repro_torch.launch.train`` drives it
with ``synthetic_batch``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.core.metakernel import LayerExecutable, run_layers
from repro_torch.obs.metrics import harvest
from repro_torch.obs.trace import NULL_SPAN, get_tracer
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    n_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None


@dataclasses.dataclass
class LoopStats:
    steps: int = 0
    restarts: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    fe_seconds: float = 0.0
    train_seconds: float = 0.0

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro_torch.obs.metrics.MetricsRegistry`."""
        return harvest(self)


def run_training(
    *,
    cfg: LoopConfig,
    state: Any,
    train_step: Callable[[Any, Mapping[str, Any]], Any],
    batch_source: Callable[[int], Mapping[str, Any]],
    fe_layers: Optional[List[LayerExecutable]] = None,
    device: Optional[torch.device] = None,
    ckpt: Optional[CheckpointManager] = None,
    finalize: Optional[Callable[[], Any]] = None,
) -> tuple:
    """Run (or resume) a training job; returns ``(state, LoopStats)``.

    ``state`` is a nested dict of tensors (params, opt, ...);
    ``train_step(state, batch)`` returns ``(state, metrics)``, and a
    ``"loss"`` metric is read to the host after every step.
    ``batch_source(step)`` yields the raw batch for a step; ``fe_layers``
    optionally runs the FeatureBox schedule on it, with the device ops on
    ``device``. ``finalize`` (if given) runs on every exit path, after the
    loop but before the final checkpoint. A restored checkpoint is written
    into ``state``'s tensors in place.
    """
    stats = LoopStats()
    if ckpt is None and cfg.checkpoint_dir:
        ckpt = CheckpointManager(cfg.checkpoint_dir)
    if fe_layers is not None and device is None:
        raise ValueError("run_training: fe_layers need the device their ops run on")

    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start_step, state = restored
            start_step += 1
            stats.restarts += 1

    tracer = get_tracer()
    try:
        for step in range(start_step, cfg.n_steps):
            t0 = time.perf_counter()
            with (tracer.span("fe.batch", step=step)
                  if tracer.enabled else NULL_SPAN):
                batch = dict(batch_source(step))
                if fe_layers is not None:
                    batch = run_layers(fe_layers, batch, device=device)
            t1 = time.perf_counter()
            with (tracer.span("train.step", step=step)
                  if tracer.enabled else NULL_SPAN):
                state, metrics = train_step(state, batch)
            t2 = time.perf_counter()
            stats.fe_seconds += t1 - t0
            stats.train_seconds += t2 - t1
            stats.steps += 1
            if metrics and "loss" in metrics:
                stats.losses.append(float(metrics["loss"]))
            if ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
                ckpt.save_async(step, state)
    finally:
        if finalize is not None:
            finalize()
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(cfg.n_steps - 1, state)
    return state, stats


__all__ = ["LoopConfig", "LoopStats", "run_training"]
