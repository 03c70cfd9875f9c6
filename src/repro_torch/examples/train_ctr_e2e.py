"""End-to-end driver: pipelined feature extraction + CTR training (~100M params).

The paper's Fig. 1 (lower) at laptop scale, with every production layer
engaged (the port of ``examples/train_ctr_e2e.py``, in its order of
operations):

  raw logs (column store) -> lease shards -> FeatureBox FE schedule
  -> hierarchical-PS working-set embedding (~100M parameters on "SSD")
  -> DLRM-style CTR model -> sparse Adagrad + dense Adam
  -> async checkpoints + restart

Trains a few hundred steps; loss is reported. Run:

  PYTHONPATH=src python -m repro_torch.examples.train_ctr_e2e [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.embedding.hierarchy import HierarchicalPS
from repro_torch.fe import featureplan, get_spec
from repro_torch.fe.colstore import ColumnStore
from repro_torch.fe.datagen import gen_views, write_views
from repro_torch.models.common import sigmoid_bce
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import ShardServer
from repro_torch.train.optimizer import adamw

EMBED_DIM = 64
TABLE_ROWS = 1_600_000  # x64 dim = 102.4M embedding params ("10TB model" stand-in)

Params = Dict[str, torch.Tensor]


def build_model(generator: torch.Generator, layout,
                params: Optional[Mapping[str, Any]] = None) -> Params:
    """The dense params on ``generator``'s device: drawn from ``generator``
    (the JAX example's shapes and scales, the port's own bits), or
    copies of ``params`` (arrays keyed as the JAX example's) there. Each leaf
    requires grad."""
    dev = generator.device
    if params is not None:
        out = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
               for k, v in params.items()}
    else:
        d_in = layout.n_dense_feats + (layout.n_sparse_fields + 1) * EMBED_DIM

        def normal(scale, *shape):
            return torch.randn(shape, generator=generator, device=dev) * scale

        out = {"w1": normal(0.03, d_in, 256), "b1": torch.zeros(256, device=dev),
               "w2": normal(0.05, 256, 64), "b2": torch.zeros(64, device=dev),
               "w3": normal(0.05, 64, 1), "b3": torch.zeros(1, device=dev)}
    return {k: v.requires_grad_() for k, v in out.items()}


def forward(dense_p, working_rows, inverse_sp, inverse_seq, seq_mask, dense_feats):
    emb_sp = working_rows[inverse_sp]                             # (B, F, D)
    b = emb_sp.shape[0]
    emb_seq = working_rows[inverse_seq]                           # (B, L, D)
    seq_pooled = (emb_seq * seq_mask[..., None]).sum(1)           # (B, D)
    x = torch.cat([dense_feats, emb_sp.reshape(b, -1), seq_pooled], dim=1)
    h = torch.relu(x @ dense_p["w1"] + dense_p["b1"])
    h = torch.relu(h @ dense_p["w2"] + dense_p["b2"])
    return (h @ dense_p["w3"] + dense_p["b3"])[:, 0]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns the losses, the PS and the Adagrad state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--instances", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="featurebox_")

    # ---------------------------------------------------------------- data
    print("== generating raw views ->", workdir)
    store = ColumnStore(os.path.join(workdir, "colstore"))
    views = gen_views(args.instances, seed=0)
    write_views(store, views, chunk_rows=args.batch)
    n_chunks = len(store.chunks("impressions"))

    # ------------------------------------------------------------ pipeline
    plan = featureplan.compile(get_spec("ads_ctr"))
    print(plan.summary())
    shard_server = ShardServer(n_shards=n_chunks, lease_timeout=60.0)

    # ------------------------------------------------- hierarchical PS tier
    ps = HierarchicalPS(os.path.join(workdir, "embed.bin"),
                        total_rows=TABLE_ROWS, dim=EMBED_DIM,
                        host_cache_rows=200_000)
    accum = np.full(TABLE_ROWS, 0.1, np.float32)  # Adagrad per-row state

    dense = build_model(torch.Generator(device=dev).manual_seed(0), plan.layout)
    names = sorted(dense)
    opt = adamw(2e-3)
    opt_state = opt.init(dense)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), keep=2)

    def train_step(working, inv_sp, inv_seq, mask, dense_f, label):
        """Autograd over the dense params and the working rows, then AdamW
        on the dense params; returns the loss and the rows' gradient."""
        nonlocal dense, opt_state
        logits = forward(dense, working, inv_sp, inv_seq, mask, dense_f)
        loss = sigmoid_bce(logits, label).mean()
        *gd, gw = torch.autograd.grad(loss, [dense[k] for k in names] + [working])
        dense, opt_state = opt.update(dense, dict(zip(names, gd)), opt_state)
        return loss.detach(), gw

    # ------------------------------------------------------------ training
    print(f"== training {args.steps} steps over {n_chunks} leased shards "
          f"({TABLE_ROWS*EMBED_DIM/1e6:.0f}M embedding params on SSD tier)")
    losses = []
    t0 = time.perf_counter()
    step = 0
    while step < args.steps:
        shard = shard_server.acquire("worker0")
        if shard is None:
            shard_server = ShardServer(n_shards=n_chunks)  # next epoch
            continue
        # read this shard's views — projection pushdown: the column store
        # only touches the columns the compiled plan actually reads
        env = {}
        for vname, cols in plan.required_columns.items():
            cid = shard % max(1, len(store.chunks(vname)))
            env[vname] = store.read_columns(vname, cid, list(cols))
        env = plan.run(env, device=dev)

        sp = env["batch_sparse"].cpu().numpy() % TABLE_ROWS
        seq = env["batch_seq_ids"].cpu().numpy() % TABLE_ROWS
        all_ids = np.concatenate([sp.reshape(-1), seq.reshape(-1)])
        working, uniq, inverse = ps.pull(all_ids)
        inv_sp = inverse[: sp.size].reshape(sp.shape)
        inv_seq = inverse[sp.size:].reshape(seq.shape)

        loss, gw = train_step(
            torch.from_numpy(working).to(dev).requires_grad_(),
            torch.from_numpy(inv_sp.astype(np.int64)).to(dev),
            torch.from_numpy(inv_seq.astype(np.int64)).to(dev),
            env["batch_seq_mask"], env["batch_dense"], env["batch_label"])

        # sparse Adagrad on the working set; push back to the PS tiers
        gw = gw.cpu().numpy()
        gsq = (gw * gw).sum(axis=1)
        accum[uniq] += gsq
        working = working - (0.05 / (np.sqrt(accum[uniq]) + 1e-10))[:, None] * gw
        ps.push(uniq, working)

        shard_server.commit("worker0", shard)
        losses.append(float(loss))
        if (step + 1) % 50 == 0:
            ckpt.save_async(step, {"dense": dense, "opt": opt_state})
            print(f"step {step+1:4d} loss {np.mean(losses[-50:]):.4f} "
                  f"ps(host_hits={ps.stats.host_hits}, ssd={ps.stats.ssd_reads})")
        step += 1
    ckpt.wait()
    dt = time.perf_counter() - t0
    print(f"== done: loss {np.mean(losses[:20]):.4f} -> {np.mean(losses[-20:]):.4f} "
          f"in {dt:.1f}s ({dt/args.steps*1e3:.0f} ms/step)")
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    print("train_ctr_e2e OK")
    return {"losses": losses, "ps": ps, "accum": accum}


if __name__ == "__main__":
    main()
