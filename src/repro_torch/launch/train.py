"""Training driver of the port: the in-memory synthetic path, and streaming
raw-log shards -> pipelined FE -> arena feed -> sparse train step, with
checkpoints.

Two batch sources, as in the JAX package's ``repro.launch.train``:

* default — in-memory ``synthetic_batch`` per step (no disk in the loop),
  driven by :func:`repro_torch.train.loop.run_training` with
  ``make_sparse_train_step``; checkpoints every ``--checkpoint-every``
  steps into ``--checkpoint-dir``, and a restart resumes from the latest;
* ``--data-dir DIR`` — reader threads of a :class:`~repro_torch.io.stream.
  StreamingLoader` pull ``.fbshard`` shards off disk (decoding only the
  plan's ``required_columns``), the FE worker of a :class:`~repro_torch.
  core.pipeline.PipelinedRunner` extracts features for batch i+1 while the
  card trains on batch i, and with ``--device-feed arena`` FE writes the
  ``batch_*`` outputs straight into the claimed staging arena. With
  ``--embedding hierarchy`` the embedding rows live in the hierarchical
  parameter server (an SSD file ``{ps_dir}/{arch}.{spec}.ps.f32`` <- a host
  row cache <- the per-batch working set on the card), and a ``ps-feeder``
  thread pulls batch i+1's working set while batch i trains; the step
  pushes its updated rows back asynchronously.

The CLI runs the smoke config of ``--arch`` (as the JAX driver does), on the
card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --steps 4 \\
      --batch 256 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --data-dir /tmp/adslog --gen-shards 4 --batch 256 --spec dlrm \\
      --device-feed arena --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch bst \\
      --data-dir /tmp/bstlog --gen-shards 4 --batch 256 --spec bst \\
      --device-feed arena --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --data-dir /tmp/adslog --gen-shards 4 --batch 256 --spec dlrm \\
      --device-feed on --embedding hierarchy --host-cache-rows 64 --steps 4 \\
      --device cpu

Same flags and defaults as the JAX driver, plus ``--device``. Not ported
yet, and refused with their ROADMAP item: the JAX package's other archs
(the lm and gnn families; :data:`repro_torch.configs.NOT_PORTED`) and the
flags of later ROADMAP items (:data:`NOT_PORTED`).

Unlike the JAX driver, ``--resume`` skips the batches the restored steps
already trained on, so a resumed run continues the uninterrupted run's
stream.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import NOT_PORTED as NOT_PORTED_ARCHS
from repro_torch.configs import get_arch, list_archs, refuse_unported
from repro_torch.core.pipeline import PipelinedRunner, PipelineStats
from repro_torch.device import resolve_device
from repro_torch.fe.specs import list_specs
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, LoopStats, run_training
from repro_torch.train.optimizer import adamw

# Flags of the JAX driver that belong to later slices, with their ROADMAP item.
NOT_PORTED = {
    "--mesh": "A8", "--compress": "A8", "--pod-size": "A8",
    "--adapt": "A6 (the JAX eager adapter)", "--no-donate": "A6 (the JAX donation opt-out)",
    "--metrics": "A10", "--check": "A10",
}


def synthetic_batch(family: str, cfg, batch: int, step: int, *,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The in-memory path's batch for ``step``, on ``device``: the JAX
    driver's ``synthetic_batch`` draws (``default_rng(step)``), bit for bit.
    Only the recsys family is ported."""
    if family != "recsys":
        raise SystemExit(f"synthetic {family} batches are not ported yet (ROADMAP A11)")
    rng = np.random.default_rng(step)
    b = {
        "sparse": np.stack([rng.integers(0, v, batch) for v in cfg.vocab_sizes[:cfg.n_sparse]],
                           axis=1).astype(np.int32),
        "label": (rng.random(batch) < 0.25).astype(np.float32),
    }
    if cfg.n_dense:
        b["dense"] = rng.exponential(1.0, (batch, cfg.n_dense)).astype(np.float32)
    if cfg.kind == "bst":
        b["seq"] = rng.integers(0, cfg.vocab_sizes[0], (batch, cfg.seq_len)).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def open_ps(args, cfg):
    """Open the hierarchical PS of a ``--embedding hierarchy`` run, the file
    ``{ps_dir}/{arch}.{spec}.ps.f32`` (``ps_dir`` defaults to
    ``<data-dir>/_ps``), creating it when it is missing: one row per packed
    id, ``embed_dim`` uniform ±1/√D values drawn from the chunked
    ``default_rng(0)`` stream and the Adagrad accumulator (0.1, the sparse
    step's init) as the last column, byte for byte the JAX driver's file."""
    from repro_torch.embedding.hierarchy import HierarchicalPS

    ps_dir = args.ps_dir or os.path.join(args.data_dir, "_ps")
    path = os.path.join(ps_dir, f"{args.arch}.{args.spec}.ps.f32")
    dim = cfg.embed_dim + 1  # Adagrad accumulator colocated (last col)
    scale = 1.0 / float(np.sqrt(cfg.embed_dim))

    def ps_init(s, e, rng):
        block = np.empty((e - s, dim), np.float32)
        block[:, :-1] = rng.uniform(-scale, scale, (e - s, cfg.embed_dim))
        block[:, -1] = 0.1  # make_sparse_train_step's embed_accum init
        return block

    return HierarchicalPS(path, total_rows=int(cfg.multi_table().total_rows),
                          dim=dim, host_cache_rows=args.host_cache_rows, init_fn=ps_init)


def run_streaming(args, spec, cfg, state, opt) -> Tuple[PipelineStats, List[float]]:
    """Stream raw-log shards from disk through FE into the train step.

    The working-set capacity is tuned from the dataset manifest's rows
    hint; without one it stays 0, so the step keeps its batch-sized bound
    (streaming batches are shard-sized: a capacity sized from ``--batch``
    could undersize the working set and drop ids). ``--device-feed arena``
    stages per-field id vectors straight into the ring arena. ``state``
    (``{"params", "opt"}``) is updated in place. With ``--embedding
    hierarchy`` the params and optimizer state are the dense ones
    (``init_params(include_embed=False)``, ``{"dense": ...}``) and the rows
    live in the PS file (:func:`open_ps`).

    Returns the runner's :class:`PipelineStats` (``stats.ps`` is the
    :class:`~repro_torch.embedding.psfeed.HierarchyFeed` of a hierarchy
    run) and the loss of every step.
    """
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.embedding.psfeed import WS_META, WS_SLOTS, HierarchyFeed, HierarchyFeedError
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.stream import StreamingLoader
    from repro_torch.models import recsys as R

    if spec.family != "recsys":
        raise SystemExit(
            f"--data-dir streaming runs the FeatureBox FE pipeline and is "
            f"only wired for recsys archs (got family={spec.family!r})")
    if args.embedding == "hierarchy" and args.device_feed == "arena":
        raise SystemExit(
            "--embedding hierarchy is incompatible with --device-feed "
            "arena (the zero-copy arena assembles per-field id vectors "
            "for the in-memory dedup'd lookup); use on/off")
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
    if args.embedding == "hierarchy":
        # Embedding rows come from the hierarchical PS (SSD <- host cache
        # <- per-batch working set), pulled a batch ahead on a dedicated
        # pipeline stage; the train step consumes them via WS_SLOTS.
        if not cfg.dedup_capacity:
            raise SystemExit(
                "--embedding hierarchy needs a tuned working-set capacity "
                "and the dataset manifest has no rows hint — regenerate the "
                "shards (repro_torch.fe.datagen writes the manifest)")
        raw_step, _ = R.make_hierarchy_train_step(cfg, opt)
        extra_slots = WS_SLOTS
    else:
        raw_step, _ = R.make_sparse_train_step(cfg, opt)
        extra_slots = ()

    layers, feeder = plan.layers, None
    if args.device_feed == "arena":
        ab = plan.arena_binding(split_sparse_fields=True)
        layers, feeder = ab.layers, ab.make_feeder(rows_hint=loader.rows_hint, device=dev)
    elif args.device_feed == "on":
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=loader.rows_hint, device=dev)
    fused = mf.make_step(raw_step, fence_cb=(feeder.donation_fence
                                             if feeder is not None else None),
                         extra_slots=extra_slots)

    hier = None
    if args.embedding == "hierarchy":
        ps = open_ps(args, cfg)
        hier = HierarchyFeed(ps, mf, device=dev)
        table_mb = ps.total_rows * ps.dim * 4 / 2**20
        line = (f"ps: table {table_mb:.1f} MiB ({ps.total_rows} rows x {ps.dim} "
                f"f32), host cache {args.host_cache_rows} rows, "
                f"SSD tier {ps.path}")
        if args.device_budget_mb:
            rel = ("EXCEEDS" if table_mb > args.device_budget_mb
                   else "fits in")
            line += (f" — {rel} the simulated device budget "
                     f"{args.device_budget_mb:.1f} MiB")
        print(line)

    losses: List[float] = []

    def step_fn(state, env):
        p, o, m = fused(state["params"], state["opt"], env)
        if hier is not None:
            # Async write-back: hand the updated working set to the PS
            # writer thread; the pull for batch i+2 waits on it, not us.
            hier.complete(env[WS_META], m.pop("ws_rows"), m.pop("ws_accum"))
        losses.append(float(m["loss"]))  # blocks until the step lands
        state = {"params": p, "opt": o}
        if ckpt is not None and len(losses) % args.checkpoint_every == 0:
            ckpt.save_async(start_step + len(losses) - 1, state)
        return state

    step_fn.feed_stats = mf.stats  # the runner adopts the train-feed tier

    runner = PipelinedRunner(layers, step_fn, prefetch=args.stream_prefetch,
                             device=dev, device_feed=feeder, ps_feed=hier)
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
        if hier is not None:
            # Drain/flush handshake: every enqueued write-back lands on the
            # SSD tier before we read stats or exit (idempotent, no-raise).
            hier.drain()
        if ckpt is not None:
            ckpt.wait()
    if hier is not None and hier.error is not None:
        raise HierarchyFeedError(
            f"hierarchical PS write-back failed: {hier.error!r}") from hier.error
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
    if hier is not None:
        print(f"ps: {hier.summary()} ps_stage={s.ps_seconds:.2f}s")
    return s, losses


def run_in_memory(args, spec, cfg, state, opt) -> Tuple[LoopStats, List[float]]:
    """Train on in-memory ``synthetic_batch`` batches of ``args.batch`` rows
    through :func:`run_training` and ``make_sparse_train_step(cfg, opt)``,
    checkpointing every ``args.checkpoint_every`` steps into
    ``args.checkpoint_dir`` (a restart resumes from the latest).
    ``state`` (``{"params", "opt"}``) is updated in place. Returns the
    loop's :class:`LoopStats` and the loss of every step it ran."""
    from repro_torch.models import recsys as R

    dev = resolve_device(args.device)
    raw_step, _ = R.make_sparse_train_step(cfg, opt)

    def step_wrapper(state, batch):
        p, o, m = raw_step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    loop_cfg = LoopConfig(n_steps=args.steps, checkpoint_every=args.checkpoint_every,
                          checkpoint_dir=args.checkpoint_dir)
    t0 = time.perf_counter()
    final, stats = run_training(
        cfg=loop_cfg, state=state, train_step=step_wrapper,
        batch_source=lambda s: synthetic_batch(spec.family, cfg, args.batch, s, device=dev))
    state.update(final)
    dt = time.perf_counter() - t0
    if not stats.losses:
        raise SystemExit("the in-memory run trained no steps")
    print(f"arch={args.arch} steps={stats.steps} "
          f"loss {stats.losses[0]:.4f} -> {stats.losses[-1]:.4f} "
          f"({dt:.1f}s, {dt / max(stats.steps, 1) * 1e3:.1f} ms/step)")
    return stats, stats.losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX driver's flags, plus ``--device``; the flags of later slices
    are refused with their ROADMAP item."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs() + sorted(NOT_PORTED_ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64,
                    help="rows per synthetic batch, or per generated shard "
                         "(--gen-shards)")
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
                    help="stream .fbshard raw-log shards instead of "
                         "in-memory synthetic batches")
    ap.add_argument("--spec", default="ads_ctr", choices=list_specs(),
                    help="feature spec compiled for --data-dir streaming")
    ap.add_argument("--gen-shards", type=int, default=0,
                    help="generate this many shards into --data-dir first")
    ap.add_argument("--device-feed", default="off", choices=["on", "off", "arena"],
                    help="stage batches through the device-feed ring on a "
                         "third pipeline stage; 'arena' has FE write the "
                         "batch_* outputs straight into the arena as "
                         "per-field id vectors")
    ap.add_argument("--embedding", default="table", choices=["table", "hierarchy"],
                    help="embedding backend: 'table' keeps the full table "
                         "in device memory; 'hierarchy' serves it from the "
                         "hierarchical PS (SSD memmap <- host LRU cache <- "
                         "per-batch working set) with the pull for batch "
                         "i+1 overlapping batch i's train step")
    ap.add_argument("--ps-dir", default=None,
                    help="directory for the hierarchical PS table file "
                         "(default: <data-dir>/_ps)")
    ap.add_argument("--host-cache-rows", type=int, default=100_000,
                    help="hierarchical PS host-DRAM cache capacity in rows")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="simulated device-memory budget: print whether the "
                         "PS table exceeds it")
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
                    help="where the batches, the FE device layer and the step run "
                         "(default: the card; the CPU only on request)")
    later = sorted({a.split("=", 1)[0] for a in (argv or [])} & set(NOT_PORTED))
    if later:
        ap.error(f"{later[0]} is not ported yet (ROADMAP {NOT_PORTED[later[0]]})")
    return ap.parse_args(argv)


def _run(args):
    from repro_torch.models import recsys as R

    refuse_unported(args.arch)
    spec = get_arch(args.arch)
    cfg = spec.smoke()
    if args.vocab_scale != 1.0:
        if args.vocab_scale <= 0:
            raise SystemExit("--vocab-scale must be > 0")
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            max(1, int(v * args.vocab_scale)) for v in cfg.vocab_sizes))
    if args.embedding == "hierarchy" and not args.data_dir:
        raise SystemExit(
            "--embedding hierarchy runs on the streaming pipeline: "
            "pass --data-dir (the PS pull is a pipeline stage)")
    if (args.resume or args.fault_tolerant or args.chaos) and not args.data_dir:
        raise SystemExit(
            "--resume/--fault-tolerant/--chaos operate on the streaming "
            "ingest tier: pass --data-dir")
    dev = resolve_device(args.device)
    opt = adamw(args.lr)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.embedding == "hierarchy":
        # Embedding rows live in the PS file, not in params: dense tree
        # only, bit for bit the dense params of the full init.
        params = R.init_params(cfg, gen, include_embed=False)
        _, init = R.make_hierarchy_train_step(cfg, opt)
    else:
        params = R.init_params(cfg, gen)
        _, init = R.make_sparse_train_step(cfg, opt)
    state = {"params": params, "opt": init(params)}
    if args.data_dir:
        return run_streaming(args, spec, cfg, state, opt)
    stats, losses = run_in_memory(args, spec, cfg, state, opt)
    assert losses[-1] < losses[0], "training must reduce loss"
    return stats, losses


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
