"""Where ``chip_smoke.py`` phase 21's bounds come from (``MP_*``, ``OGB_TOL``).

Each check of phase 21 runs here on the CPU through the phase's own helpers,
fp32, at a reduced width (``--full`` keeps the published widths: it needs
a host with about 60 GB free), and beside it:

* ``reorder``: the same function in another legitimate summation order
  (flash attention and the chunked cross entropy at half their blocks, the
  graph's edges shuffled, or float64 against fp32): how far two correct
  programs part (PNA's check runs in float64: in fp32 its He-init logits in
  the hundreds and the std aggregator's cancellation part two correct
  orders by 1e-4 in the logits and 6e-3 in the gradients, above a 1e-3
  fault's reading, ROADMAP C28);
* planted faults, each a fault the check exists to catch: a norm weight or
  one expert's ``w2`` 1e-3 off in the mesh's copy of the params, an EP body
  with the wrong experts (its ``local_offset`` + 1) or dropped from the
  psum, a TP body's query heads rotated or its ``wo`` shard 1e-3 off, a PNA
  matrix 1e-3 off, and PNA's check run in fp32 where it runs in float64;
  for the split decode bodies a body's ``wo`` shard 1e-3 off and a body
  taking the next rank's slice of the head_dim or latent (its heads' too),
  and for the blocks they write the latter and a body's key (GQA) or
  latent (MLA) projection 1e-3 off (on the output that one reads through
  one slot of thousands). The decode's reorder is the layer in float64
  against fp32.

Each reading is max |diff| over max |reference| (a gradient: the worst
leaf). The rule of the bounds: 4x the larger of the correct and the
reorder reading, rounded up to 1 or 5 x 10^k (``stated``); TP's bound is
instead the geometric mean of that side and the smallest planted fault's
(``geomean``), since the card's GEMMs part two fp32 orders further than
the CPU's. Both are printed beside the phase's own constant. The script
fails if a correct side reads above the phase's bound or a planted fault
at or below it. The decode bodies keep their layers' published widths and
cut the cache to 2,048 slots (``--full``: phase 21's 32,768).

  PYTHONPATH=src python tests/rehearse_model_parallel.py     # about 5 min, 6 GB, one thread
  PYTHONPATH=src python tests/rehearse_model_parallel.py --parts decode   # about 1 min
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "src")]

import chip_smoke as S  # noqa: E402
import model_parallel_ranks as MR  # noqa: E402

CPU = torch.device("cpu")


def stated(side):
    """4x ``side``, rounded up to 1 or 5 x 10^k."""
    k = math.floor(math.log10(4 * max(side, 1e-300)))
    return next(m * 10.0 ** e for e in (k, k + 1) for m in (1, 5) if m * 10.0 ** e >= 4 * side)


def geomean(side, faults):
    """The geometric mean of ``side`` and the smallest fault, 3 digits."""
    return float(f"{math.sqrt(max(side, 1e-300) * min(faults)):.2e}")


# each row's bound in phase 21 (chip_smoke.py)
PHASE_BOUND = {"step": S.MP_STEP_GRAD_TOL, "decode": S.MP_DECODE_TOL,
               "pna logits": S.MP_PNA_TOL, "pna grads": S.MP_PNA_GRAD_TOL,
               "ep bodies": S.MP_EP_TOL, "tp bodies": S.MP_TP_TOL, "ogb forward": S.OGB_TOL,
               "decode bodies": S.MP_DECODE_BODY_TOL, "decode cache": S.MP_DECODE_CACHE_TOL}


def scaled(w, idx=()):
    """``w`` with ``w[idx]`` (a whole matrix, or one element) 1e-3 off."""
    w = w.clone()
    w[idx] *= 1 + 1e-3
    return w


def step_part(full, mesh, rows):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = S.mp_config(torch, get_arch(S.MOE_ARCH).config, S.MP_STEP_LAYERS)
    if not full:
        cfg = dataclasses.replace(
            cfg, d_model=256, n_heads=4, n_kv=4, head_dim=64, d_ff=512, vocab=4096,
            moe=dataclasses.replace(cfg.moe, d_ff_expert=96), q_block=128, kv_block=128,
            loss_chunk=256)
    params = T.init_params(cfg, torch.Generator().manual_seed(S.MP_SEED))
    b, s = S.MP_STEP_BATCH
    tok = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok, "labels": tok}
    loss_rel, grad_rel, worst, flips, _ = S.mp_step_against_global(torch, params, cfg, batch,
                                                                   mesh)
    rows["step"] = {"correct": max(loss_rel, grad_rel), "loss": loss_rel, "grad": grad_rel,
                    "flips": flips}
    # reorder: the global step with flash's blocks and the CE's chunk halved
    half = dataclasses.replace(cfg, q_block=cfg.q_block // 2, kv_block=cfg.kv_block // 2,
                               loss_chunk=cfg.loss_chunk // 2)
    l0, g0 = S.mp_lm_step(torch, params, cfg, batch)
    l1, g1 = S.mp_lm_step(torch, params, half, batch)
    rows["step"]["reorder"] = max(abs(l1 - l0) / abs(l0), S.grads_rel(torch, g1, g0)[0])
    faults = {
        "norm element 1e-3": lambda p: p["dense_layers"].__setitem__(
            "norm1", scaled(p["dense_layers"]["norm1"], (0, 5))),
        "expert w2 1e-3": lambda p: p["moe_layers"].__setitem__(
            "moe_w2", scaled(p["moe_layers"]["moe_w2"], (0, 3))),
    }
    rows["step"]["faults"] = {}
    for name, mutate in faults.items():
        lr, gr, _, _, _ = S.mp_step_against_global(torch, params, cfg, batch, mesh, mutate)
        rows["step"]["faults"][name] = max(lr, gr)
    # decode at the no-drop factor
    toks = tok[:S.MP_DECODE_BATCH, :S.MP_DECODE_STEPS]
    rel, flips, _ = S.mp_decode_against_plain(torch, params, cfg, toks, S.MP_DECODE_SLOTS, mesh)
    rows["decode"] = {"correct": rel, "flips": flips, "reorder": rows["step"]["reorder"],
                      "faults": {"expert w2 1e-3": S.mp_decode_against_plain(
                          torch, params, cfg, toks, S.MP_DECODE_SLOTS, mesh,
                          faults["expert w2 1e-3"])[0]}}


def pna_part(mesh, rows):
    from repro_torch.models import gnn as G

    cfg, params, batch = S.mp_pna_inputs(torch, CPU)
    p_rel, g_rel, _ = S.mp_pna_against_forward(torch, params, cfg, batch, mesh)
    # reorder: the same graph with its edges in another order (every segment
    # sum in another order, as the card's atomics may add them)
    perm = torch.randperm(batch["src"].shape[0], generator=torch.Generator().manual_seed(5))
    shuffled = dict(batch, src=batch["src"][perm], dst=batch["dst"][perm])
    with torch.no_grad():
        f0, f1 = G.forward(params, cfg, batch), G.forward(params, cfg, shuffled)
    g0, _, _ = G.make_train_step(cfg, MR.Capture())(dict(params), {}, batch)
    g1, _, _ = G.make_train_step(cfg, MR.Capture())(dict(params), {}, shuffled)
    faults = {f"{k} 1e-3": S.mp_pna_against_forward(
        torch, params, cfg, batch, mesh, lambda p, k=k: p.__setitem__(k, scaled(p[k])))
        for k in ("in_w", "l1_upd_w")}
    # the check in fp32: the precision its float64 exists to keep out (C28)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    b32 = dict(batch, features=batch["features"].float())
    with torch.no_grad():
        f32 = G.forward(p32, cfg32, b32).double()
    g32, _, _ = G.make_train_step(cfg32, MR.Capture())(p32, {}, b32)
    faults["fp32 step"] = (S.lm_rel(torch, f32, f0),
                           S.grads_rel(torch, {k: v.double() for k, v in g32.items()}, g0)[0])
    rows["pna logits"] = {"correct": p_rel, "reorder": S.lm_rel(torch, f1, f0),
                          "faults": {k: v[0] for k, v in faults.items()}}
    rows["pna grads"] = {"correct": g_rel, "reorder": S.grads_rel(torch, g1, g0)[0],
                         "faults": {k: v[1] for k, v in faults.items()}}


def ep_part(full, rows):
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MO

    v2 = get_arch(S.MLA_ARCH).config
    c, d = v2.moe, v2.d_model
    if not full:
        c = dataclasses.replace(c, n_experts=16)       # d 5120 and f 1536 kept
    tokens = S.MP_EP_TOKENS if full else 512
    params = S.mp_ep_params(torch, c, d, CPU)
    x = torch.randn((tokens, d), generator=torch.Generator().manual_seed(S.MP_SEED + 1))
    rel, _, _ = S.mp_ep_in_turn(torch, params, x, c, S.MP_EP_SHAPE)
    rows_d = tokens // S.MP_EP_SHAPE["data"]
    with torch.no_grad():
        p64 = {k: v.double() for k, v in params.items()}
        reorder = max(S.lm_rel(torch, MO.moe_ffn(params, x[i * rows_d:(i + 1) * rows_d], c)[0],
                               MO.moe_ffn(p64, x[i * rows_d:(i + 1) * rows_d].double(), c)[0])
                      for i in range(S.MP_EP_SHAPE["data"]))
    faults = {
        "offset + 1": lambda m, lp, off: (lp, (off + 1) % 4 if m == 1 else off, True),
        "body dropped": lambda m, lp, off: (lp, off, m != 3),
        "expert w2 1e-3": lambda m, lp, off: (
            dict(lp, w2=scaled(lp["w2"], (3,))) if m == 0 else lp, off, True),
    }
    rows["ep bodies"] = {"correct": rel, "reorder": reorder, "faults": {
        k: S.mp_ep_in_turn(torch, params, x, c, S.MP_EP_SHAPE, f)[0] for k, f in faults.items()}}


def tp_part(full, rows):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    yi = dataclasses.replace(get_arch(S.LM_ARCH).config, n_layers=1, dtype=torch.float32)
    seq = S.MP_TP_SEQ if full else 512
    params = T.init_params(yi, torch.Generator().manual_seed(S.MP_SEED))
    layer = {k: v[0] for k, v in params["dense_layers"].items()}
    del params
    x = torch.randn((1, seq, yi.d_model), generator=torch.Generator().manual_seed(3))
    rel, _, _ = S.mp_tp_in_turn(torch, layer, x, yi, S.MP_TP)
    half = dataclasses.replace(yi, q_block=yi.q_block // 2, kv_block=yi.kv_block // 2)
    with torch.no_grad():
        reorder = S.lm_rel(torch, T._dense_block(layer, x, half)[0] - x,
                           T._dense_block(layer, x, yi)[0] - x)
    hd = yi.head_dim
    faults = {
        "q heads rotated": lambda m, hs, lp: (hs, dict(
            lp, attn_wq=torch.roll(lp["attn_wq"], hd, dims=1)) if m == 1 else lp),
        "wo shard 1e-3": lambda m, hs, lp: (hs, dict(lp, attn_wo=scaled(lp["attn_wo"]))
                                            if m == 0 else lp),
    }
    rows["tp bodies"] = {"correct": rel, "reorder": reorder, "faults": {
        k: S.mp_tp_in_turn(torch, layer, x, yi, S.MP_TP, f)[0] for k, f in faults.items()}}


def decode_part(full, rows):
    """Phase 21(b)'s split decode: per arch one layer at its published
    width, ``MP_DECODE_ROWS`` rows against a cache of ``slots`` slots."""
    from repro_torch.models import transformer as T

    slots = S.LM_DECODE_SLOTS if full else 2048
    cache_len = slots - (S.LM_DECODE_SLOTS - S.LM_DECODE_LEN)
    body = rows["decode bodies"] = {"correct": 0.0, "reorder": 0.0, "faults": {}}
    kept = rows["decode cache"] = {"correct": 0.0, "reorder": 0.0, "faults": {}}
    for arch, n_tp in S.MP_DECODE_BODIES:
        cfg, layer = S.mp_decode_layer(torch, arch, CPU)
        x, cache = S.mp_decode_inputs(torch, cfg, S.MP_DECODE_ROWS, slots, CPU)

        def run(mutate=None):
            return S.mp_decode_in_turn(torch, layer, x, {k: v.clone() for k, v in cache.items()},
                                       cfg, n_tp, cache_len, mutate)[:2]

        rel, crel = run()
        body["correct"], kept["correct"] = max(body["correct"], rel), max(kept["correct"], crel)
        # reorder: the global layer in float64 against fp32 (its output, the slot it writes)
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        outs = []
        for c, dt in ((cfg, torch.float32), (c64, torch.float64)):
            written = {k: v.to(dt) for k, v in cache.items()}
            with torch.no_grad():
                y = T._decode_layer({k: v.to(dt) for k, v in layer.items()}, x.to(dt), written, 0,
                                    cache_len, c)
            outs.append((y - x.to(dt), {k: v[:, :, cache_len] for k, v in written.items()}))
        body["reorder"] = max(body["reorder"], S.lm_rel(torch, outs[0][0], outs[1][0]))
        kept["reorder"] = max(kept["reorder"], max(S.lm_rel(torch, outs[0][1][k], outs[1][1][k])
                                                   for k in cache))
        proj = "attn_wdkv" if cfg.attn == "mla" else "attn_wk"
        faults = {
            "wo shard 1e-3": lambda m, hs, lp: (hs, dict(lp, attn_wo=scaled(lp["attn_wo"]))
                                                if m == 0 else lp),
            "next rank's slice": lambda m, hs, lp: (
                dataclasses.replace(hs, m=(hs.m + 1) % hs.n) if m == 1 else hs, lp),
            f"{proj} 1e-3": lambda m, hs, lp: (hs, dict(lp, **{proj: scaled(lp[proj])})
                                               if m == 0 else lp),
        }
        for name, mutate in faults.items():
            rel, crel = run(mutate)
            # a projection of the new token's key enters the output through
            # one slot of the cache's thousands: the cache's row catches it;
            # wo is the output's weight, no cache fault
            if name != f"{proj} 1e-3":
                body["faults"][f"{arch} {name}"] = rel
            if name != "wo shard 1e-3":
                kept["faults"][f"{arch} {name}"] = crel
        del layer, cache


def ogb_part(full, rows):
    from repro_torch.configs.base import GNN_SHAPES, gnn_config_for

    info = GNN_SHAPES["ogb_products"]
    cfg = gnn_config_for("pna", "ogb_products")
    n = info["n_nodes"] if full else 40_000
    e = info["n_edges"] if full else round(40_000 * info["n_edges"] / info["n_nodes"])
    graph = S.ogb_graph(n, e, S.OGB_SHARDS)
    _, rels, _ = S.ogb_forward(torch, CPU, cfg, graph)
    _, bad, _ = S.ogb_forward(torch, CPU, cfg, graph, mutate=lambda i, lp: (
        dict(lp, msg_w=scaled(lp["msg_w"])) if i == 0 else lp))
    rows["ogb forward"] = {"correct": max(rels), "reorder": 0.0, "per_layer": rels,
                           "faults": {"msg_w 1e-3 (layer 0)": bad[0]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the published widths (about 60 GB)")
    ap.add_argument("--parts", default="step,pna,ep,tp,ogb,decode",
                    help="comma-separated parts to run")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    torch.manual_seed(0)
    torch.set_num_threads(1)        # threaded CPU sums do not repeat (ROADMAP C16)
    from repro_torch.launch import mesh as M

    mesh = M.make_model_mesh(1, 1, device="cpu")
    rows = {}
    if "step" in parts:
        step_part(args.full, mesh, rows)
    if "pna" in parts:
        pna_part(mesh, rows)
    if "ep" in parts:
        ep_part(args.full, rows)
    if "tp" in parts:
        tp_part(args.full, rows)
    if "ogb" in parts:
        ogb_part(args.full, rows)
    if "decode" in parts:
        decode_part(args.full, rows)
    ok = True
    for name, r in rows.items():
        side = max(r["correct"], r["reorder"])
        bound = PHASE_BOUND[name]
        caught = {k: v > bound for k, v in r["faults"].items()}
        ok &= side <= bound and all(caught.values())
        print(f"{name:12s} correct {r['correct']:.3e}  reorder {r['reorder']:.3e}  stated "
              f"{stated(side):.0e}, geomean {geomean(side, r['faults'].values()):.2e}; phase "
              f"{bound:.2e}{'' if side <= bound else ' EXCEEDED'};  faults "
              + ", ".join(f"{k} {v:.3e}{'' if caught[k] else ' MISSED'}"
                          for k, v in r["faults"].items()))
    print(json.dumps(rows, default=float))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
