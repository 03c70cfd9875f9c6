"""Serving example: batched request scoring through the FeatureBox pipeline.

Scoring requests arrive as raw view rows; the SAME layer-wise FE schedule
used in training extracts features (one fused device dispatch per layer),
then a trained CTR model scores the batch. Reports latency percentiles and
the pipeline's dispatch accounting. The port of ``examples/serve_ctr.py``:
its scoring pass pools the behaviour sequence with the ``embedding_bag``
kernel (``bag_lookup``, the mask as the weights); the warm-up steps take a
gradient, which the kernel has none of, so they keep the plain gather.

  PYTHONPATH=src python -m repro_torch.examples.serve_ctr [--requests 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.metakernel import ExecutionStats
from repro_torch.device import resolve_device
from repro_torch.fe import featureplan, get_spec
from repro_torch.fe.datagen import gen_views
from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.models.common import sigmoid_bce
from repro_torch.train.optimizer import adamw

TABLE = 64 * 1024
DIM = 16

Params = Dict[str, torch.Tensor]


def make_model(generator: torch.Generator, layout,
               params: Optional[Mapping[str, Any]] = None) -> Params:
    """The tiny CTR model's params on ``generator``'s device: drawn from
    ``generator`` (the JAX example's shapes and scales, the port's own bits),
    or ``params`` (arrays keyed as the JAX example's, e.g. carried over from
    JAX) copied there. Each leaf requires grad."""
    dev = generator.device
    if params is not None:
        out = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
               for k, v in params.items()}
    else:
        d_in = layout.n_dense_feats + layout.n_sparse_fields * DIM + DIM

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev) * 0.05

        out = {"embed": normal(TABLE, DIM), "w1": normal(d_in, 64),
               "b1": torch.zeros(64, device=dev), "w2": normal(64, 1),
               "b2": torch.zeros(1, device=dev)}
    return {k: v.requires_grad_() for k, v in out.items()}


def gather_pool(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked sequence sum as the JAX example writes it: gather, weight,
    sum over the sequence (differentiable)."""
    return (table[ids] * mask[..., None]).sum(1)


def bag_pool(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The same sum through the ``embedding_bag`` kernel (no gradient): the
    CUDA kernel on the card, its plain version on the CPU."""
    return bag_lookup(ids.to(torch.int32).contiguous(), mask.contiguous(), table)


def forward(p: Params, batch: Mapping[str, torch.Tensor],
            pool: Callable = gather_pool) -> torch.Tensor:
    sp = torch.remainder(batch["batch_sparse"], TABLE)
    emb = p["embed"][sp].reshape(sp.shape[0], -1)
    seq = pool(p["embed"], torch.remainder(batch["batch_seq_ids"], TABLE),
               batch["batch_seq_mask"])
    x = torch.cat([batch["batch_dense"], emb, seq], dim=1)
    h = torch.relu(x @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[:, 0]


def loss_fn(p: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return sigmoid_bce(forward(p, batch), batch["batch_label"]).mean()


def train(params: Params, batch: Mapping[str, torch.Tensor], steps: int, *,
          lr: float = 1e-2, log_every: int = 0) -> Tuple[Params, List[float]]:
    """``steps`` AdamW steps on one batch (params updated in place); returns
    the params and each step's loss, printed every ``log_every`` steps."""
    opt = adamw(lr)
    state = opt.init(params)
    names = sorted(params)
    losses = []
    for i in range(steps):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        params, state = opt.update(params, dict(zip(names, grads)), state)
        losses.append(loss.detach())
        if log_every and i % log_every == 0:
            print(f"step {i:3d} loss {float(losses[-1]):.4f}")
    return params, [float(v) for v in torch.stack(losses).cpu()]


@torch.no_grad()
def score(p: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """pCTR of a request batch, the sequence pooled by the kernel."""
    return torch.sigmoid(forward(p, batch, pool=bag_pool))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Warm the model, score the request batches; returns the warm-up
    losses, the warmed params, the last request batch with its scores and
    the latencies in ms."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    plan = featureplan.compile(get_spec("ads_ctr"))
    params = make_model(torch.Generator(device=dev).manual_seed(0), plan.layout)

    # brief training so scores are meaningful
    env = plan.outputs(plan.run(gen_views(1024, seed=1), device=dev))
    params, losses = train(params, env, 20)
    print(f"warm model, train loss {losses[-1]:.4f}")

    stats = ExecutionStats()
    lat = []
    n_batches = args.requests // args.batch
    for i in range(n_batches):
        reqs = gen_views(args.batch, seed=100 + i)
        t0 = time.perf_counter()
        env_i = plan.outputs(plan.run(reqs, device=dev, stats=stats))
        s = score(params, env_i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    print(f"scored {args.requests} requests in {n_batches} batches: "
          f"p50={np.percentile(lat_ms, 50):.1f}ms p99={np.percentile(lat_ms, 99):.1f}ms")
    print(f"pipeline: {stats.n_device_dispatches} fused dispatches over "
          f"{stats.n_layers} layer executions; host {stats.host_seconds:.2f}s "
          f"device {stats.device_seconds:.2f}s")
    print("serve_ctr OK")
    return {"losses": losses, "params": params, "batch": env_i, "scores": s,
            "latency_ms": lat_ms}


if __name__ == "__main__":
    main()
