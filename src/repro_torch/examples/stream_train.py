"""Streaming-ingest demo: on-disk raw-log shards -> FeaturePlan -> training.

The minimal end-to-end tour of ``repro_torch.io`` + the declarative FE front
end (the port of ``examples/stream_train.py``):

1. materialize the synthetic raw ads log as ``.fbshard`` files
   (``write_log_shards``) — the stand-in for the paper's 15-25 TB log store;
2. compile a FeatureSpec preset into a ``FeaturePlan`` and stream the shards
   back with a multi-worker ``StreamingLoader``, decoding only the plan's
   ``required_columns`` (projection pushdown);
3. feed the loader straight into ``PipelinedRunner`` with a ``DeviceFeeder``
   third stage, so disk read + feature extraction for batch i+1 overlap
   training on batch i and the H2D hop is staged through a buffer-ring
   device arena (placed by the ``mempool_alloc`` kernel) off the training
   critical path (``--device-feed off`` reverts to the two-stage pipeline).

Run (``--device cpu`` for the plain PyTorch path on the CPU):
  PYTHONPATH=src python -m repro_torch.examples.stream_train [--spec ads_ctr|dlrm|bst]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from repro_torch.core.devicefeed import DeviceFeeder
from repro_torch.core.pipeline import PipelinedRunner
from repro_torch.device import resolve_device
from repro_torch.fe import featureplan, get_spec, list_specs
from repro_torch.fe.datagen import write_log_shards
from repro_torch.io.dataset import ShardDataset
from repro_torch.io.stream import StreamingLoader


def train_step(state, env):
    """Checksum "training" keeps the demo free of model boilerplate (see
    ``python -m repro_torch.launch.train --data-dir`` for the real model
    path); the sum is read on the host, as the JAX example reads it."""
    s = float(env["batch_sparse"].cpu().numpy().sum())
    return {"sum": state["sum"] + s, "batches": state["batches"] + 1}


def main(argv: Optional[Sequence[str]] = None):
    """Run the demo; returns the final ``{"sum", "batches"}`` state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--spec", default="ads_ctr", choices=list_specs())
    ap.add_argument("--device-feed", default="on", choices=["on", "off"])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="adslog_")

    print(f"== writing {args.shards} raw-log shards to {data_dir}")
    paths = write_log_shards(data_dir, n_shards=args.shards,
                             rows_per_shard=args.rows, seed=0)
    ds = ShardDataset(data_dir)
    print(f"   {len(paths)} shards, {ds.total_bytes/2**20:.1f} MiB, "
          f"{ds.total_rows} instances")

    print(f"== compiling the {args.spec!r} feature spec")
    plan = featureplan.compile(get_spec(args.spec))
    print(f"   {plan.summary()}")
    print(f"   projection: {({v: len(c) for v, c in plan.required_columns.items()})}")

    print("== streaming through the compiled plan into training")
    loader = StreamingLoader(ds, workers=args.workers, prefetch=4,
                             columns=plan.required_columns)
    feeder = None
    if args.device_feed == "on":
        # Arena sized at compile time: slot widths from the plan's
        # OutputLayout, row count from the dataset manifest.
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=loader.rows_hint, device=dev)
    runner = PipelinedRunner(plan.layers, train_step, prefetch=2, device=dev,
                             device_feed=feeder)
    state = runner.run({"sum": 0.0, "batches": 0}, loader)

    st = runner.stats
    assert state["batches"] == len(paths)
    print(f"   {state['batches']} batches; wall={st.wall_seconds:.2f}s "
          f"(fe={st.fe_seconds:.2f}s + train={st.train_seconds:.2f}s "
          f"overlapped)")
    print(f"   ingest: {loader.stats.summary()}")
    if st.feed is not None:
        print(f"   device-feed: {st.feed.summary()}")
    print("stream_train OK")
    return state


if __name__ == "__main__":
    main()
