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

With ``--mesh PODSxDATA`` (or ``auto``) the streaming loop trains
data-parallel on a ``('pod', 'data')`` mesh (``make_mesh_train_step``): the
table and its accumulators row-sharded over the devices, a two-stage dedup,
and the gradients reduced hierarchically with ``--compress off|bf16|int8``
on the inter-pod wire. A mesh of more than one device starts one process
per device (``torch.multiprocessing``, spawn, a ``FileStore`` in a
temporary directory; NCCL on the card, gloo on the CPU); every rank reads
the same shards in the same order and runs FE on the global batch, the
step takes its own rows, and rank 0 alone prints. ``--fault-tolerant
--chaos SPEC`` works on such a mesh too: every rank builds its own
injector from the same spec, whose faults are keyed by shard and point,
and leases the global shard order, so every rank meets the same faults and
yields the same batches as a run without them. A fault that ends the run
(a corrupt shard) ends every rank, each with its error on stderr: a
failing rank waits, at most ``RANK_GRACE_S`` seconds, for the others to
fail too, and once one has exited the parent terminates the rest.
A 1x1 mesh runs in the driver's own process, on a process group of one:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --data-dir /tmp/adslog --gen-shards 4 --batch 64 --spec dlrm \\
      --device-feed off --mesh 2x2 --compress bf16 --steps 4 --device cpu

``--check`` runs the static analyzers of :mod:`repro_torch.check` on
``--spec`` x ``--arch`` before any data is touched and refuses to train on
an error finding; ``--metrics`` prints the run's
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot at exit, with
the ``check`` tier and the ``hlo`` tier, the step's FLOPs and op bytes that
:func:`~repro_torch.launch.hlo_stats.step_cost` counts on meta copies of
the first step's arguments (training itself is not touched).

The lm family (yi, qwen and the MoE DeepSeek LMs) and the gnn family
(``pna``) train in memory only, as in the JAX driver: the lm archs with
``make_train_step`` of :mod:`repro_torch.models.transformer` and AdamW over
``synthetic_batch("lm")`` (``--batch`` sequences of 64 tokens), its
``grad_accum`` microbatches inside the step; ``pna`` with
:mod:`repro_torch.models.gnn`'s ``make_train_step`` and AdamW over
``synthetic_batch("gnn")`` (a random graph of 200 nodes and 800 edges a
step). The recsys-only flags (``--data-dir``, ``--embedding hierarchy``,
``--mesh``, ``--check``, ``--vocab-scale``) are refused for both with the
JAX driver's messages:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 4 \\
      --batch 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch pna --steps 6 --device cpu

Same flags and defaults as the JAX driver, plus ``--device``:
``--adapt eager`` runs the model feed's adaptation on its own before each
step and counts its dispatches (``train_feed.adapt_dispatches_per_step``),
and ``--no-donate`` steps on clones of the params and optimizer state and
hands no staged batch back to the feeder (``ModelFeed.make_step(fused=,
donate=)``); the losses are the default's bit for bit.

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

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.pipeline import PipelinedRunner, PipelineStats
from repro_torch.device import resolve_device
from repro_torch.fe.specs import list_specs
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, LoopStats, run_training
from repro_torch.train.optimizer import adamw


def synthetic_batch(family: str, cfg, batch: int, step: int, *,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The in-memory path's batch for ``step``, on ``device``: the JAX
    driver's ``synthetic_batch`` draws (``default_rng(step)``), bit for bit:
    recsys rows; lm ``batch`` sequences of 64 tokens, the labels the tokens
    themselves; gnn ``random_graph(200, 800, d_in, n_classes, seed=step)``
    (``batch`` unused)."""
    rng = np.random.default_rng(step)
    if family == "lm":
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 64)).astype(np.int32)).to(device)
        return {"tokens": toks, "labels": toks}
    if family == "gnn":
        from repro_torch.models.gnn import random_graph
        g = random_graph(200, 800, cfg.d_in, cfg.n_classes, seed=step)
        return {k: torch.from_numpy(v).to(device) for k, v in g.items()}
    if family != "recsys":
        raise SystemExit(f"no synthetic batches for the {family!r} family")
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


def resolve_mesh_shape(args) -> Tuple[int, int]:
    """``(pods, data)`` of ``--mesh``: ``PODSxDATA`` as given, or with
    ``auto`` the largest mesh :func:`~repro_torch.train.fault.elastic_remesh`
    makes of the healthy devices (``torch.cuda.device_count()`` on the card,
    one on the CPU, as JAX sees one CPU device), ``--pod-size`` per pod."""
    from repro_torch.launch.mesh import parse_mesh_spec

    if args.mesh != "auto":
        return parse_mesh_spec(args.mesh)
    from repro_torch.train.fault import elastic_remesh

    dev = resolve_device(args.device)
    n_healthy = torch.cuda.device_count() if dev.type == "cuda" else 1
    shape, _axes, n_used = elastic_remesh(n_healthy, model_parallel=1, pod_size=args.pod_size)
    n_pods, n_data = (shape[0], shape[1]) if len(shape) == 3 else (1, shape[0])
    print(f"elastic mesh: {n_healthy} healthy device(s) -> {n_pods}x{n_data} ({n_used} used)")
    return n_pods, n_data


def check_mesh_flags(args, n_devices: int) -> None:
    """The JAX driver's refusals of ``--mesh``, and the port's own for a
    mesh of more than one rank (each rank reads the stream itself)."""
    if not args.data_dir:
        raise SystemExit("--mesh runs the streaming pipeline: pass --data-dir")
    if args.embedding == "hierarchy":
        raise SystemExit(
            "--mesh is incompatible with --embedding hierarchy (the PS "
            "pull path assumes a single device holds the working set); "
            "pick one scale-out axis")
    if n_devices > 1 and args.device_feed != "off":
        raise SystemExit(
            "--mesh with more than one device requires --device-feed "
            "off: the staging arena is single-device; the mesh step "
            "splits the host batch across the row shards itself")


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

    With ``--mesh`` the step is ``make_mesh_train_step`` on the mesh the
    process group resolves (this process is one rank of it): ``state``
    arrives full and leaves as this rank's shards
    (:func:`~repro_torch.models.recsys.shard_train_state`); checkpoints
    hold the full table, accumulators and residual
    (:func:`~repro_torch.models.recsys.unshard_train_state`, written by
    rank 0 with the mesh in their meta), so any mesh restores them. A mesh
    of more than one rank reads the shards in plan order, as
    ``--fault-tolerant`` does, so that every rank sees the same batches.

    With ``--metrics`` the first step's ``(params, opt_state, feed)`` are
    captured as meta copies and costed after the run
    (:func:`_print_metrics`, with ``args.check_report`` as the ``check``
    tier).

    Returns the runner's :class:`PipelineStats` (``stats.ps`` is the
    :class:`~repro_torch.embedding.psfeed.HierarchyFeed` of a hierarchy
    run, ``stats.comm`` the mesh's
    :class:`~repro_torch.train.compression.CommStats`) and the loss of
    every step.
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
    mesh, n_pods, n_data = None, 1, 1
    if args.mesh:
        from repro_torch.launch.mesh import make_train_mesh
        from repro_torch.train.compression import codec_name

        n_pods, n_data = resolve_mesh_shape(args)
        check_mesh_flags(args, n_pods * n_data)
        mesh = make_train_mesh(n_pods, n_data, device=dev)
        if codec_name(args.compress) is not None and "comm_residual" not in state["opt"]:
            # the codec's error feedback rides in the optimizer state
            state["opt"]["comm_residual"] = R.comm_residual_init(cfg, n_pods, n_data, device=dev)
    rank = torch.distributed.get_rank() if mesh is not None else 0
    n_mesh_dev = n_pods * n_data

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
            saved = (f" (saved mesh {ckpt.latest_meta().get('mesh')}, current "
                     f"[{n_pods}, {n_data}])" if mesh is not None else "")
            print(f"resume: restored step {step0}{saved}; skipping the {start_step} "
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
                             chaos=chaos, ordered=args.fault_tolerant or n_mesh_dev > 1)

    split = args.device_feed == "arena"
    comm = None
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
    elif mesh is not None:
        # Data-parallel scale-out: table rows + Adagrad accumulators
        # sharded over the ('pod', 'data') mesh, two-stage dedup, and
        # hierarchical (compressed across pods) gradient reduction. On a
        # 1x1 mesh with --compress off this path is bitwise-identical to
        # the single-device step.
        from repro_torch.fe.modelfeed import dedup_capacity_hint
        from repro_torch.train.compression import CommPlan, CommStats

        local_cap = 0
        if n_mesh_dev > 1 and loader.rows_hint:
            # stage-1 capacity: sized like the global working set, but for
            # one device's share of the batch rows
            local_cap = dedup_capacity_hint(cfg, max(1, loader.rows_hint // n_mesh_dev))
        raw_step, _ = R.make_mesh_train_step(cfg, opt, mesh=mesh, compress=args.compress,
                                             local_dedup_capacity=local_cap)
        state["params"], state["opt"] = R.shard_train_state(mesh, state["params"], state["opt"])
        rows_dev = max(1, (loader.rows_hint or args.batch) // n_mesh_dev)
        ids_dev = R.batch_id_count(cfg, rows_dev)
        comm = CommStats(plan=CommPlan.for_step(
            n_pods=n_pods, inner=n_data, compress=args.compress, hierarchical=True,
            capacity=cfg.dedup_capacity or ids_dev * n_mesh_dev, embed_dim=cfg.embed_dim,
            n_dense_elems=R.dense_param_elems(cfg), local_capacity=local_cap or ids_dev,
            ids_per_device=ids_dev))
        print(f"comm plan: {comm.summary()}")
        extra_slots = ()
    else:
        raw_step, _ = R.make_sparse_train_step(cfg, opt)
        extra_slots = ()

    layers, feeder = plan.layers, None
    if args.device_feed == "arena":
        ab = plan.arena_binding(split_sparse_fields=True)
        layers, feeder = ab.layers, ab.make_feeder(rows_hint=loader.rows_hint, device=dev)
    elif args.device_feed == "on":
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=loader.rows_hint, device=dev)
    fused = mf.make_step(
        raw_step, fused=(args.adapt == "fused"), donate=not args.no_donate,
        fence_cb=(feeder.donation_fence if feeder is not None else None),
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
    cost_args = []  # meta copies of the first step's (params, opt, feed), --metrics
    from repro_torch.obs.trace import get_tracer
    tracer = get_tracer()

    def step_fn(state, env):
        if args.metrics and not cost_args:
            from repro_torch.launch.hlo_stats import abstractify
            feed = abstractify(fused.select_feed(env))
            if args.adapt == "eager":      # the boundary takes the adapted batch
                extras = {k: feed.pop(k) for k in extra_slots}
                feed = mf.apply(feed)
                feed.update(extras)
            cost_args.append(abstractify((state["params"], state["opt"])) + (feed,))
        w0 = tracer.now_ns() if (tracer.enabled and comm is not None) else 0
        p, o, m = fused(state["params"], state["opt"], env)
        if hier is not None:
            # Async write-back: hand the updated working set to the PS
            # writer thread; the pull for batch i+2 waits on it, not us.
            hier.complete(env[WS_META], m.pop("ws_rows"), m.pop("ws_accum"))
        losses.append(float(m["loss"]))  # blocks until the step lands
        if comm is not None:
            comm.on_step()
            if tracer.enabled:
                # The collectives run inside the step, so their spans cover
                # the step window on virtual tracks of their own, with the
                # plan's inter-pod bytes (exchange = working set + dedup pool).
                w1 = tracer.now_ns()
                cp = comm.plan
                tracer.complete_on("comm.exchange", "comm.exchange", w0, w1,
                                   interpod_bytes=(cp.exchange_interpod_bytes
                                                   + cp.dedup_interpod_bytes))
                tracer.complete_on("comm.allreduce", "comm.allreduce", w0, w1,
                                   interpod_bytes=cp.allreduce_interpod_bytes,
                                   codec=cp.codec or "off")
        state = {"params": p, "opt": o}
        if ckpt is not None and len(losses) % args.checkpoint_every == 0:
            full = state
            if mesh is not None:   # every rank gathers; rank 0 writes
                full = dict(zip(("params", "opt"), R.unshard_train_state(mesh, p, o)))
            if rank == 0:
                ckpt.save_async(start_step + len(losses) - 1, full,
                                meta={"mesh": [n_pods, n_data]})
        return state

    step_fn.feed_stats = mf.stats  # the runner adopts the train-feed tier
    step_fn.comm_stats = comm      # and the comm tier (mesh only)

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
    if comm is not None:
        print(f"comm: {comm.summary()}")
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        _print_metrics(MetricsRegistry.from_pipeline(s), args.check_report,
                       fused.boundary, cost_args[0] if cost_args else None)
    return s, losses


def run_in_memory(args, spec, cfg, state, opt) -> Tuple[LoopStats, List[float]]:
    """Train on in-memory ``synthetic_batch`` batches of ``args.batch`` rows
    through :func:`run_training` and ``make_sparse_train_step(cfg, opt)``
    (the lm family: the transformer's ``make_train_step(cfg, opt)``; the
    gnn family: ``models.gnn.make_train_step(cfg, opt)``),
    checkpointing every ``args.checkpoint_every`` steps into
    ``args.checkpoint_dir`` (a restart resumes from the latest).
    ``state`` (``{"params", "opt"}``) is updated in place; with
    ``--metrics`` the first step's ``(params, opt_state, batch)`` are
    captured as meta copies and costed after the run. Returns the loop's :class:`LoopStats` and the loss
    of every step it ran."""
    dev = resolve_device(args.device)
    if spec.family == "lm":
        from repro_torch.models import transformer as LM
        raw_step = LM.make_train_step(cfg, opt)
    elif spec.family == "gnn":
        from repro_torch.models import gnn as G
        raw_step = G.make_train_step(cfg, opt)
    else:
        from repro_torch.models import recsys as R
        raw_step, _ = R.make_sparse_train_step(cfg, opt)
    cost_args = []  # meta copies of the first step's (params, opt, batch), --metrics

    def step_wrapper(state, batch):
        if args.metrics and not cost_args:
            from repro_torch.launch.hlo_stats import abstractify
            cost_args.append(abstractify((state["params"], state["opt"], batch)))
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
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        reg.register("loop", stats)
        _print_metrics(reg, args.check_report, raw_step, cost_args[0])
    return stats, stats.losses


def _print_metrics(reg, check_report, step, step_args) -> None:
    """``--metrics``: register the ``check`` tier and the ``hlo`` tier
    (:func:`~repro_torch.launch.hlo_stats.step_cost` of ``step`` on meta
    copies of ``step_args``; none without them), print the step's cost
    line, then the registry's JSON."""
    if check_report is not None:
        reg.register("check", check_report)
    if step_args is not None:
        from repro_torch.launch.hlo_stats import step_cost
        tot = step_cost(step, *step_args)
        reg.register("hlo", tot)
        _print_hlo_cost(tot)
    print("metrics:")
    print(reg.to_json())


def _print_hlo_cost(tot) -> None:
    """Per-step summary of :func:`step_cost`'s count. ``op_bytes`` is the
    operand and output bytes of each op, unfused: a count at the ops'
    boundaries, not the card's memory traffic."""
    print(f"hlo/step: {tot.flops / 1e9:.3f} GFLOP "
          f"op_bytes={tot.op_bytes / 2**20:.1f}MiB "
          f"collective={tot.collective_total / 2**20:.1f}MiB")


def refuse_recsys_flags(args, family: str) -> None:
    """The JAX driver's refusals of the recsys-only flags for another
    family (the lm and gnn archs)."""
    if family == "recsys":
        return
    if args.vocab_scale != 1.0:
        raise SystemExit("--vocab-scale only applies to recsys archs")
    if args.embedding == "hierarchy":
        raise SystemExit("--embedding hierarchy is a recsys embedding backend "
                         f"(got family={family!r})")
    if args.mesh:
        raise SystemExit("--mesh data-parallel training shards the embedding table "
                         f"and is wired for recsys archs (got family={family!r})")
    if args.check:
        raise SystemExit("--check verifies the FE feed pipeline, which only recsys "
                         f"archs consume (got family={family!r})")
    if args.data_dir:
        raise SystemExit("--data-dir streaming runs the FeatureBox FE pipeline and is "
                         f"only wired for recsys archs (got family={family!r})")


def _preflight(args):
    """``--check``: run the static analyzers before touching any data.

    Returns the :class:`repro_torch.check.Report` (registered under the
    ``check`` metrics tier) or raises ``SystemExit`` with the report's
    exit code on error findings / analyzer crashes — the 0/1/2 contract
    of ``python -m repro_torch.check``.
    """
    from repro_torch.check import run_check
    report = run_check(args.spec, args.arch, device=args.device)
    print(report.render())
    if report.exit_code:
        raise SystemExit(report.exit_code)
    return report


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX driver's flags, plus ``--device``; the flags of later slices
    are refused with their ROADMAP item."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
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
    ap.add_argument("--adapt", default="fused", choices=["fused", "eager"],
                    help="spec->arch batch adaptation: 'fused' runs the "
                         "compiled ModelFeed plan inside the train step (one "
                         "call per step); 'eager' runs its ops on their own "
                         "before the step (the measurable baseline)")
    ap.add_argument("--no-donate", action="store_true",
                    help="do not donate params/optimizer/staged batch "
                         "through the train step (it steps on clones)")
    ap.add_argument("--stream-workers", type=int, default=2)
    ap.add_argument("--stream-prefetch", type=int, default=4)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--mesh", default=None, metavar="PODSxDATA",
                    help="run the streaming train loop data-parallel on a "
                         "('pod', 'data') mesh of devices, e.g. 2x4, or 'auto' "
                         "to let elastic_remesh size the mesh from the healthy "
                         "device count (see --pod-size, --resume): embedding "
                         "rows + Adagrad accumulators sharded over all devices, "
                         "two-stage (local->global) id dedup, hierarchical "
                         "cross-pod gradient reduction; one process per device "
                         "(streaming --data-dir mode)")
    ap.add_argument("--compress", default="off", choices=["bf16", "int8", "off"],
                    help="codec for the inter-pod gradient wire of --mesh "
                         "(error feedback carried in the optimizer state, "
                         "accumulation stays fp32); 'off' keeps the 1x1 "
                         "path bitwise-identical to single-device")
    ap.add_argument("--pod-size", type=int, default=None,
                    help="devices per pod for --mesh auto: lets "
                         "elastic_remesh pick a 3-axis (pod, data, model) "
                         "topology when enough devices are healthy")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome trace-event / Perfetto timeline "
                         "of the run to PATH (readers, FE worker, H2D "
                         "feeder and train loop on their own tracks)")
    ap.add_argument("--check", action="store_true",
                    help="preflight the run with repro_torch.check (static plan "
                         "verifier, arena aliasing, host-sync effects, lockset "
                         "audit) and refuse to train on error findings; the "
                         "report lands in the --metrics snapshot under 'check.*'")
    ap.add_argument("--metrics", action="store_true",
                    help="print the consolidated MetricsRegistry snapshot (JSON) "
                         "plus the step's FLOPs / op bytes per step at exit (counted "
                         "on meta copies of the first step's arguments)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the batches, the FE device layer and the step run "
                         "(default: the card; the CPU only on request)")
    ap.set_defaults(check_report=None)    # main()'s --check preflight sets it
    return ap.parse_args(argv)


def _run(args):
    """Train as the flags say. ``args.check_report`` is the report of the
    ``--check`` preflight, which :func:`main` has run (None without it)."""
    from repro_torch.models import recsys as R

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
    if args.mesh:
        check_mesh_flags(args, 1)
    if (args.resume or args.fault_tolerant or args.chaos) and not args.data_dir:
        raise SystemExit(
            "--resume/--fault-tolerant/--chaos operate on the streaming "
            "ingest tier: pass --data-dir")
    dev = resolve_device(args.device)
    opt = adamw(args.lr)
    gen = torch.Generator(device=dev).manual_seed(0)
    if spec.family == "lm":       # in memory only: main() refused the recsys-only flags
        from repro_torch.models import transformer as LM
        params, init = LM.init_params(cfg, gen), opt.init
    elif spec.family == "gnn":    # likewise
        from repro_torch.models import gnn as G
        params, init = G.init_params(cfg, gen), opt.init
    elif args.embedding == "hierarchy":
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


RANK_GRACE_S = 30.0     # how long a failing rank of a mesh waits for the others to fail


def _rank_main(rank: int, args, store_path: str, world_size: int) -> None:
    """One rank of a ``--mesh`` run of more than one device (a process of
    its own): join the process group, train, and leave it; rank 0 alone
    prints and writes the trace."""
    import sys

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    if rank:
        sys.stdout = open(os.devnull, "w")
        args.trace = None
    ended = dist.FileStore(store_path + ".ended", world_size)
    init_ranks(rank, world_size, store_path, args.device)
    try:
        _traced_run(args)
    except BaseException as e:
        # one write of the whole line: print() writes the message and its
        # newline apart, and ranks that fail together would interleave them
        sys.stderr.write(f"rank {rank} of {world_size} failed: {type(e).__name__}: {e}\n")
        sys.stderr.flush()
        _end_with_peers(ended, world_size)
        raise
    finally:
        dist.destroy_process_group()


def _end_with_peers(store, world_size: int) -> None:
    """Count this rank's failure in ``store`` and wait, at most
    ``RANK_GRACE_S``, until every rank has failed: a fault that every rank
    meets at the same batch (a corrupt shard) then ends them together, and
    no rank is left inside a collective whose peer has gone."""
    store.add("failed", 1)
    deadline = time.monotonic() + RANK_GRACE_S
    while store.add("failed", 0) < world_size and time.monotonic() < deadline:
        time.sleep(0.05)


def _traced_run(args):
    if args.trace:
        from repro_torch.obs.trace import enable_tracing
        enable_tracing()
    try:
        return _run(args)
    finally:
        if args.trace:
            from repro_torch.obs.trace import get_tracer
            tracer = get_tracer()
            out = tracer.export(args.trace)
            print(f"trace: {len(out['traceEvents'])} events on "
                  f"{len(tracer.track_names())} tracks -> {args.trace}")


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, run the ``--check`` preflight once, before any data
    is touched or a rank started, and train. Returns what the run returns
    (the stats and the losses; None from the parent of a multi-rank
    mesh)."""
    import sys
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import check_visible

    args = parse_args(sys.argv[1:] if argv is None else argv)
    refuse_recsys_flags(args, get_arch(args.arch).family)
    world = 1
    if args.mesh:
        n_pods, n_data = resolve_mesh_shape(args)
        args.mesh = f"{n_pods}x{n_data}"
        world = n_pods * n_data
        if world > 1:
            check_mesh_flags(args, world)
            check_visible(n_pods, n_data, args.device)    # before any shard or rank
    # before any shard is written or a rank holds a process group (the
    # effects scan runs the 1x1 mesh step on a group of one of its own)
    args.check_report = _preflight(args) if args.check else None
    if world > 1:
        if args.gen_shards:   # once, before the ranks read them
            from repro_torch.fe.datagen import write_log_shards
            paths = write_log_shards(args.data_dir, n_shards=args.gen_shards,
                                     rows_per_shard=args.batch, seed=0)
            print(f"wrote {len(paths)} shards to {args.data_dir}")
            args.gen_shards = 0
        from repro_torch.launch import train as driver   # picklable by name

        store = os.path.join(tempfile.mkdtemp(prefix="fbranks_"), "store")
        torch.multiprocessing.spawn(driver._rank_main, args=(args, store, world),
                                    nprocs=world, join=True)
        return None
    owned = args.mesh is not None and not dist.is_initialized()
    try:
        return _traced_run(args)
    finally:
        if owned and dist.is_initialized():   # the 1x1 mesh's group of one
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
