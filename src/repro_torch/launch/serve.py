"""Serving driver: batched CTR scoring with the FeatureBox pipeline.

Runs the smoke config of a recsys arch as an online scorer: requests arrive
as raw view rows, are micro-batched, run through the FE schedule of the
``dlrm`` spec (host layers, then the device super-layer with the
``feature_hash`` kernel), adapted by the compiled ``ModelFeed`` and scored
by ``serve_step`` (with the ``interaction_dot`` kernel); latency
percentiles are reported. Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --requests 2000
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.metakernel import ExecutionStats
from repro_torch.device import resolve_device
from repro_torch.fe import featureplan, get_spec
from repro_torch.fe.datagen import gen_views
from repro_torch.models import recsys as R

SPEC = "dlrm"   # the feature spec shaped like the recsys archs this slice serves


def serve_requests(plan, feed, params, cfg, requests: Iterable[Mapping[str, Any]], *,
                   device: torch.device, stats: Optional[ExecutionStats] = None
                   ) -> Tuple[List[torch.Tensor], List[float]]:
    """Score each raw request batch: ``plan.run`` -> ``feed.apply`` ->
    ``serve_step``. Returns the pCTR tensors and each batch's latency in
    seconds, measured on the host clock up to a device synchronize."""
    scores, latency = [], []
    for views in requests:
        t0 = time.perf_counter()
        env = plan.run(views, device=device, stats=stats)
        batch = feed.apply(feed.select(env))
        p = R.serve_step(params, cfg, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        latency.append(time.perf_counter() - t0)
        scores.append(p)
    return scores, latency


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "recsys":
        raise SystemExit("serve.py scores recsys archs")
    device = resolve_device(args.device)
    cfg = spec.smoke()
    params = R.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    plan = featureplan.compile(get_spec(SPEC))
    feed = plan.model_feed(cfg)

    n_batches = args.requests // args.batch
    stats = ExecutionStats()
    scores, lat = serve_requests(
        plan, feed, params, cfg,
        (gen_views(args.batch, seed=100 + i) for i in range(n_batches)),
        device=device, stats=stats)
    lat_ms = np.asarray(lat) * 1e3
    mean_score = float(sum(float(s.sum()) for s in scores)) / max(n_batches * args.batch, 1)
    print(f"arch={args.arch} device={device.type} batches={n_batches} "
          f"batch={args.batch} p50={np.percentile(lat_ms, 50):.2f}ms "
          f"p99={np.percentile(lat_ms, 99):.2f}ms mean_score={mean_score:.4f} "
          f"fe_dispatches={stats.n_device_dispatches}")


if __name__ == "__main__":
    main()
