"""Streaming training driver of the port: raw-log shards -> pipelined FE ->
arena feed -> sparse train step, with checkpoints.

The streaming branch of the JAX package's ``repro.launch.train``
(``--data-dir``): reader threads of a :class:`~repro_torch.io.stream.
StreamingLoader` pull ``.fbshard`` shards off disk (decoding only the
plan's ``required_columns``), the FE worker of a :class:`~repro_torch.core.
pipeline.PipelinedRunner` extracts features for batch i+1 while the card
trains on batch i, and with ``--device-feed arena`` FE writes the
``batch_*`` outputs straight into the claimed staging arena. The CLI runs
the smoke config of ``--arch`` (as the JAX driver does), on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --data-dir /tmp/adslog --gen-shards 4 --batch 256 --spec dlrm \\
      --device-feed arena --steps 4 --device cpu

Same flags and defaults as the JAX driver, plus ``--device``. Not ported
yet, and refused: the in-memory synthetic path (no ``--data-dir``; it runs
``train/loop.py``), the ``ads_ctr`` and ``bst`` specs (the JAX default is
``ads_ctr``), and the flags of later ROADMAP items (:data:`NOT_PORTED`).

Unlike the JAX driver, ``--resume`` skips the batches the restored steps
already trained on, so a resumed run continues the uninterrupted run's
stream.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.pipeline import PipelinedRunner, PipelineStats
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw

# Flags of the JAX driver that belong to later slices, with their ROADMAP item.
NOT_PORTED = {
    "--mesh": "A8", "--compress": "A8", "--pod-size": "A8",
    "--embedding": "A7", "--ps-dir": "A7", "--host-cache-rows": "A7",
    "--device-budget-mb": "A7",
    "--adapt": "A6 (the JAX eager adapter)", "--no-donate": "A6 (the JAX donation opt-out)",
    "--metrics": "A10", "--check": "A10",
}
PORTED_SPECS = ("dlrm",)


def run_streaming(args, spec, cfg, state, opt) -> Tuple[PipelineStats, List[float]]:
    """Stream raw-log shards from disk through FE into the train step.

    The working-set capacity is tuned from the dataset manifest's rows
    hint; without one it stays 0, so the step keeps its batch-sized bound
    (streaming batches are shard-sized: a capacity sized from ``--batch``
    could undersize the working set and drop ids). ``--device-feed arena``
    stages per-field id vectors straight into the ring arena. ``state``
    (``{"params", "opt"}``) is updated in place.

    Returns the runner's :class:`PipelineStats` and the loss of every step.
    """
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.stream import StreamingLoader
    from repro_torch.models import recsys as R

    if spec.family != "recsys":
        raise SystemExit(
            f"--data-dir streaming runs the FeatureBox FE pipeline and is "
            f"only wired for recsys archs (got family={spec.family!r})")
    if args.spec not in PORTED_SPECS:
        raise SystemExit(
            f"spec {args.spec!r} is not ported yet (ROADMAP A2); pass --spec dlrm")
    dev = resolve_device(args.device)

    if args.gen_shards:
        from repro_torch.fe.datagen import write_log_shards
        paths = write_log_shards(args.data_dir, n_shards=args.gen_shards,
                                 rows_per_shard=args.batch, seed=0)
        print(f"wrote {len(paths)} shards to {args.data_dir}")

    ds = ShardDataset(args.data_dir, host_id=args.host_id, n_hosts=args.n_hosts)
    if not len(ds):
        raise SystemExit(
            f"host {args.host_id}/{args.n_hosts} got no shards: the dataset "
            f"has only {len(ds.shards)} shard(s); generate more or use "
            f"fewer hosts")
    plan = featureplan.compile(get_spec(args.spec))
    print(plan.summary())

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    if args.resume:
        if ckpt is None:
            raise SystemExit("--resume requires --checkpoint-dir")
        restored = ckpt.restore_latest(state)
        if restored is None:
            print("resume: no checkpoint found; starting fresh")
        else:
            step0, restored_state = restored
            state.update(restored_state)
            start_step = step0 + 1
            print(f"resume: restored step {step0}; skipping the {start_step} "
                  f"batch(es) it trained on")

    chaos = None
    if args.chaos:
        if not args.fault_tolerant:
            raise SystemExit(
                "--chaos injects faults into the lease-based reader pool "
                "and needs the ordered fault-tolerant yield contract: "
                "pass --fault-tolerant")
        from repro_torch.io.chaos import ChaosInjector
        chaos = ChaosInjector.from_spec(args.chaos)
        print(f"chaos: {len(chaos.events)} scheduled fault(s) ({args.chaos})")
    # Enough passes for the skipped and the new steps. Shards are leased
    # from a ShardServer; --fault-tolerant re-sequences completions into
    # plan order (a run with failures yields the same data as one without).
    epochs = -(-(start_step + args.steps) // len(ds))
    loader = StreamingLoader(ds, workers=args.stream_workers,
                             prefetch=args.stream_prefetch, epochs=epochs,
                             shuffle=True, seed=0,
                             columns=plan.required_columns,
                             lease_timeout=args.lease_timeout,
                             chaos=chaos, ordered=args.fault_tolerant)

    split = args.device_feed == "arena"
    if cfg.dedup_capacity:
        cfg = dataclasses.replace(cfg, dedup_capacity=0)  # re-tuned from the data
    mf = plan.model_feed(cfg, split_sparse_fields=split, rows_hint=loader.rows_hint)
    cfg = mf.config
    raw_step, _ = R.make_sparse_train_step(cfg, opt)

    layers, feeder = plan.layers, None
    if args.device_feed == "arena":
        ab = plan.arena_binding(split_sparse_fields=True)
        layers, feeder = ab.layers, ab.make_feeder(rows_hint=loader.rows_hint, device=dev)
    elif args.device_feed == "on":
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=loader.rows_hint, device=dev)
    fused = mf.make_step(raw_step, fence_cb=(feeder.donation_fence
                                             if feeder is not None else None))

    losses: List[float] = []

    def step_fn(state, env):
        p, o, m = fused(state["params"], state["opt"], env)
        losses.append(float(m["loss"]))  # blocks until the step lands
        state = {"params": p, "opt": o}
        if ckpt is not None and len(losses) % args.checkpoint_every == 0:
            ckpt.save_async(start_step + len(losses) - 1, state)
        return state

    step_fn.feed_stats = mf.stats  # the runner adopts the train-feed tier

    runner = PipelinedRunner(layers, step_fn, prefetch=args.stream_prefetch,
                             device=dev, device_feed=feeder)
    shard_iter = iter(loader)  # kept so the generator can be closed below
    t0 = time.perf_counter()
    try:
        final = runner.run(state, itertools.islice(shard_iter, start_step,
                                                   start_step + args.steps))
        state.update(final)
    finally:
        # Close the generator (its finally finalizes the loader's stats)
        # before stopping the reader pool.
        try:
            shard_iter.close()
        except ValueError:  # the FE worker still holds it (join timed out)
            pass
        loader.close()
        if ckpt is not None:
            ckpt.wait()
    # islice hides the loader from the runner's duck-typed stats capture
    runner.stats.ingest = loader.stats
    runner.stats.fault = loader.fault_stats
    dt = time.perf_counter() - t0
    s = runner.stats
    if not losses:
        raise SystemExit("streaming run consumed no batches")
    print(f"arch={args.arch} spec={args.spec} mode=streaming steps={s.batches} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({dt:.1f}s, {dt / max(s.batches, 1) * 1e3:.1f} ms/step; "
          f"fe={s.fe_seconds:.2f}s train={s.train_net_seconds:.2f}s "
          f"adapt={s.adapt_seconds:.3f}s wall={s.wall_seconds:.2f}s)")
    print(f"ingest: {loader.stats.summary()}")
    fs = loader.fault_stats
    if args.fault_tolerant or fs.reissued or fs.retries or fs.failed_workers:
        print(f"fault: {fs.summary()}")
    if chaos is not None:
        fired = {k: v for k, v in chaos.fired.items() if v}
        print(f"chaos: fired {fired or 'nothing'}"
              f"{'' if chaos.exhausted() else ' (schedule NOT exhausted)'}")
    if s.feed is not None:
        print(f"device-feed: {s.feed.summary()}")
    if s.train_feed is not None:
        print(f"train-feed: {s.train_feed.summary()} (capacity={cfg.dedup_capacity})")
    return s, losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX driver's flags for the streaming path, plus ``--device``;
    the flags of later slices are refused with their ROADMAP item."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64,
                    help="rows per generated shard (--gen-shards)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --checkpoint-dir "
                         "and continue the stream after the steps it holds")
    ap.add_argument("--fault-tolerant", action="store_true",
                    help="ordered fault-tolerant streaming: yield shards in "
                         "plan order through a reorder buffer, so a run with "
                         "worker failures (or several readers) sees the same "
                         "batches in the same order as one without")
    ap.add_argument("--lease-timeout", type=float, default=30.0,
                    help="seconds without a heartbeat before the reaper "
                         "returns a shard reader's lease to the queue")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="inject scheduled faults into the reader pool "
                         "(requires --fault-tolerant), e.g. "
                         "'kill@3,transient@1:read:2' — see repro_torch.io.chaos")
    ap.add_argument("--data-dir", default=None,
                    help="stream .fbshard raw-log shards (required: the "
                         "in-memory synthetic path is not ported)")
    ap.add_argument("--spec", default="ads_ctr", choices=["ads_ctr", "bst", "dlrm"],
                    help="feature spec compiled for --data-dir streaming "
                         "(only dlrm is ported)")
    ap.add_argument("--gen-shards", type=int, default=0,
                    help="generate this many shards into --data-dir first")
    ap.add_argument("--device-feed", default="off", choices=["on", "off", "arena"],
                    help="stage batches through the device-feed ring on a "
                         "third pipeline stage; 'arena' has FE write the "
                         "batch_* outputs straight into the arena as "
                         "per-field id vectors")
    ap.add_argument("--vocab-scale", type=float, default=1.0,
                    help="scale every sparse vocab by this factor")
    ap.add_argument("--stream-workers", type=int, default=2)
    ap.add_argument("--stream-prefetch", type=int, default=4)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome trace-event / Perfetto timeline "
                         "of the run to PATH (readers, FE worker, H2D "
                         "feeder and train loop on their own tracks)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the FE device layer and the step run "
                         "(default: the card; the CPU only on request)")
    later = sorted({a.split("=", 1)[0] for a in (argv or [])} & set(NOT_PORTED))
    if later:
        ap.error(f"{later[0]} is not ported yet (ROADMAP {NOT_PORTED[later[0]]})")
    return ap.parse_args(argv)


def _run(args) -> Tuple[PipelineStats, List[float]]:
    from repro_torch.models import recsys as R

    if not args.data_dir:
        raise SystemExit(
            "the in-memory synthetic path (train/loop.py) is not ported yet "
            "(ROADMAP A6): pass --data-dir to run the streaming path")
    spec = get_arch(args.arch)
    cfg = spec.smoke()
    if args.vocab_scale != 1.0:
        if args.vocab_scale <= 0:
            raise SystemExit("--vocab-scale must be > 0")
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            max(1, int(v * args.vocab_scale)) for v in cfg.vocab_sizes))
    dev = resolve_device(args.device)
    opt = adamw(args.lr)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    _, init = R.make_sparse_train_step(cfg, opt)
    state = {"params": params, "opt": init(params)}
    return run_streaming(args, spec, cfg, state, opt)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import sys

    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.trace:
        from repro_torch.obs.trace import enable_tracing
        enable_tracing()
    try:
        _run(args)
    finally:
        if args.trace:
            from repro_torch.obs.trace import get_tracer
            tracer = get_tracer()
            out = tracer.export(args.trace)
            print(f"trace: {len(out['traceEvents'])} events on "
                  f"{len(tracer.track_names())} tracks -> {args.trace}")


if __name__ == "__main__":
    main()
