"""Where ``chip_smoke.py`` phase 18's and 19's LM bounds come from: their
checks rehearsed on the CPU at the published width (phase 18: yi-9b, d
4096, 32 heads over 4 KV heads of 128, d_ff 11,008, vocab 64,000; phase 19,
``--arch``: deepseek-moe-16b and deepseek-v2-236b) and a cut depth, the low
precision against the high one (bf16 against fp32, fp32 against fp64):

It runs ``chip_smoke.py``'s own helpers (``lm_greedy_decode``,
``lm_first_step``, ``lm_flash_errors``) on the CPU:

1. **decode against prefill** (phase 18a): from bf16 params, two prompts
   of ``LM_PROMPT`` tokens fed to ``serve_step`` one by one from an empty
   cache, then ``LM_GREEDY`` greedy steps; at each of those steps the decode
   logits against ``prefill`` of the prefix at its last position, both in
   bf16 (``dec-pre``), and each against the fp32 prefill of the same
   params (``dec-ref``, ``pre-ref``); all as max |difference| over max
   |reference logit|. At 1 layer also fp32 decode against the fp64
   prefill. With ``--faults``, the same greedy tokens are decoded again
   (teacher forced) by a ``gqa_decode_step`` with one planted fault each
   (:data:`DECODE_FAULTS`) and read against the same prefills. The phase
   runs at 48 layers, so its bound comes from readings at 48 layers in
   bf16 (``--layers 48 --bf16-only``; 16.45 GiB of params): the geometric
   mean of the largest correct reading and the smallest fault reading, an
   equal factor from each.
2. **the first training step** (phase 18b): at 1 layer, bf16 params, the
   driver's first batch at ``--batch 8`` (8 sequences of 64), the loss and
   each tensor's gradient norm in bf16 against fp32 from the same params;
   the card's bf16 step is held to the CPU's fp32 step within 4x the
   largest reading.
3. **flash attention against float64** (phase 18d): phase 18's shapes in
   fp32 against ``attention_ref`` in float64, forward and the three
   gradients, each as max |difference| over max |reference|, read twice:
   with the CPU's GEMMs (blocked sums), and with every GEMM of the flash
   path summed over its K one product after another in fp32
   (:func:`sequential_matmul`), the order of a GPU GEMM's k-loop, whose
   error grows with K (a KV block's dK and dV sum 4,096 products); the
   card's check allows 4x the larger reading.

For the MoE archs (``--arch deepseek-moe-16b`` or ``deepseek-v2-236b``,
phase 19):

4. **decode against prefill at the no-drop capacity factor**
   (``chip_smoke.no_drop``: ``n_experts / top_k``, where decode's calls of
   B tokens and prefill's of B x S compute the same function, ROADMAP C25)
   through ``chip_smoke.moe_decode_against_prefill``: the reading and the
   ``(token, layer)`` routes that flip between decode and prefill (a near
   tie in the fp32 router scores of bf16 inputs that differ, C26). With
   ``--faults`` the greedy tokens are decoded again (teacher forced) with
   one planted fault each (:data:`MOE_FAULTS`, and for MLA
   :data:`MLA_FAULTS`), read against the same prefills. The bound is the
   geometric mean of the largest correct reading and the smallest fault
   reading, at phase 19's depths (28 layers of deepseek-moe-16b, 30.50 GiB
   in bf16; 5 of deepseek-v2-236b, 32.18 GiB: a host with 96 GiB);
5. **the first training step** at 1 dense + 1 MoE layer of
   deepseek-moe-16b (``--arch deepseek-moe-16b --layers 2``, not
   ``--skip-first``): bf16 against fp32, the loss and each gradient norm,
   and the routes that flip between the two (``chip_smoke.moe_first_routes``);
   the card's check allows 4x the largest reading.

  PYTHONPATH=src python tests/rehearse_lm.py              # about 3 min, 9 GB
  PYTHONPATH=src python tests/rehearse_lm.py --layers 1 2 --seeds 0 --skip-flash
  # the decode bound: 48 layers, bf16 only, with the planted faults (a host
  # with 32 GiB free; not the first step or flash)
  PYTHONPATH=src python tests/rehearse_lm.py --layers 48 --bf16-only --faults \
      --skip-first --skip-flash
  # phase 19 (on a host with 96 GiB): the first step, then each arch's decode
  PYTHONPATH=src python tests/rehearse_lm.py --arch deepseek-moe-16b --layers 2 \
      --bf16-only --skip-flash
  PYTHONPATH=src python tests/rehearse_lm.py --arch deepseek-moe-16b --layers 28 \
      --bf16-only --faults --skip-first --skip-flash
  PYTHONPATH=src python tests/rehearse_lm.py --arch deepseek-v2-236b --layers 5 \
      --bf16-only --faults --skip-first --skip-flash
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as S  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = torch.device("cpu")
CONFIG = get_arch("yi-9b").config           # phase 18's arch


# Planted decode faults, each one line of a stage of ``gqa_decode_step``
# changed: (function, old line, new line). (The RoPE position off by one for
# q and k alike is no fault: attention sees only the distance between
# positions, so it is left out.)
DECODE_FAULTS = {
    "cache slot + 1": ("gqa_decode_scores",
                       "    _, slot = _cache_index(cache_len, s_cache, q.device)\n",
                       "    _, slot = _cache_index(cache_len, s_cache, q.device)\n"
                       "    slot = (slot + 1).clamp(max=s_cache - 1)\n"),
    "q RoPE position + 1": ("gqa_decode_qkv", "    q = apply_rope(q, pos, base=rope_base)\n",
                            "    q = apply_rope(q, pos + 1, base=rope_base)\n"),
    "one extra valid slot": ("gqa_decode_values", " <= _cache_pos(cache_len, scores.device)\n",
                             " <= _cache_pos(cache_len, scores.device) + 1\n"),
}


# Planted faults of the MoE layer and of MLA decode, each one line of a
# function changed: (module, function, old line, new line).
MOE_FAULTS = {
    "combine weights not renormalised": (
        M, "_route",
        "    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)\n", ""),
    "first routed expert's slot + 1": (
        M, "_experts_local",
        "    back = ye.reshape(-1, d)[torch.clamp_max(safe_slot, n_local * cap - 1)]\n",
        "    back = ye.reshape(-1, d)[torch.clamp_max(\n"
        "        safe_slot + (sorted_e == sorted_e[0]).to(torch.int64), n_local * cap - 1)]\n"),
}
MLA_FAULTS = {
    "latent written one slot late": (
        A, "mla_decode_scores", "    cache_ckv.index_copy_(1, slot, ",
        "    cache_ckv.index_copy_(1, (slot + 1).clamp(max=s_cache - 1), "),
}


def patched(module, name: str, old: str, new: str):
    """``module.name`` with the line ``old`` replaced by ``new``."""
    src = inspect.getsource(getattr(module, name))
    assert src.count(old) == 1, (name, old)
    namespace = dict(vars(module))
    exec(compile(src.replace(old, new), module.__file__, "exec"), namespace)
    return namespace[name]


def faulty_decode(fault: str):
    """The stage of ``gqa_decode_step`` that ``fault`` plants into, patched
    in ``attention`` (``gqa_decode_step`` calls it by its name there)."""
    name, old, new = DECODE_FAULTS[fault]
    return mock.patch.object(A, name, patched(A, name, old, new))


def forced_decode(params, cfg, toks, prompt_len: int):
    """``serve_step`` over ``toks`` from an empty cache (teacher forced): the
    logits at positions ``prompt_len - 1`` to the last but one."""
    b, n = toks.shape
    cache = T.make_cache(cfg, b, n, device=CPU)
    logits = []
    for t in range(n - 1):
        lg, cache = T.serve_step(params, toks[:, t:t + 1], cache, t, cfg)
        if t >= prompt_len - 1:
            logits.append(lg)
    return logits


def moe_decode_readings(config, layers: int, seed: int, faults=()):
    """Phase 19's decode against prefill at ``layers`` of ``config``, bf16,
    at the no-drop capacity factor: the reading, the flipped routes and the
    planted faults' readings."""
    cfg = S.no_drop(dataclasses.replace(config, n_layers=layers))
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, S.LM_PROMPT)).astype(np.int32))
    r = S.moe_decode_against_prefill(torch, params, cfg, prompt, S.LM_GREEDY)
    out = {"dec-pre": r["rel"], "flips": r["flips"], "routes": r["routes"]}
    for fault in faults:
        module, name, old, new = {**MOE_FAULTS, **MLA_FAULTS}[fault]
        with mock.patch.object(module, name, patched(module, name, old, new)):
            bad = forced_decode(params, cfg, r["toks"], S.LM_PROMPT)
        out[fault] = max(S.lm_rel(torch, lg, pre) for lg, pre in zip(bad, r["prefills"]))
    return out


def moe_first_step_readings(config, seed: int):
    """Phase 19's first step at 1 dense + 1 MoE layer: bf16 against fp32,
    and the routes that flip between the two."""
    cfg = dataclasses.replace(config, n_layers=S.MOE_FIRST_LAYERS, grad_accum=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    batch = synthetic_batch("lm", cfg, S.LM_FIRST_BATCH, 0, device=CPU)
    loss16, norms16 = S.lm_first_step(torch, params, cfg, batch)
    routes = S.moe_first_routes(torch, params, cfg, batch["tokens"])
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), S.lm_cast(params, torch.float32)
    with S.forced_routes(routes):
        loss32, norms32 = S.lm_first_step(torch, p32, cfg32, batch)
    flips = S.route_flips(torch, routes, S.moe_first_routes(torch, p32, cfg32, batch["tokens"]))
    worst = max(norms32, key=lambda k: abs(norms16[k] - norms32[k]) / norms32[k])
    return {"loss": abs(loss16 - loss32) / loss32, "loss_fp32": loss32,
            "grad_norm": abs(norms16[worst] - norms32[worst]) / norms32[worst],
            "grad_norm_worst": worst, "flips": flips}


def decode_readings(layers: int, seed: int, fp64: bool, ref32: bool = True, faults=()):
    cfg = dataclasses.replace(CONFIG, n_layers=layers)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, S.LM_PROMPT)).astype(np.int32))
    toks, dec = S.lm_greedy_decode(torch, params, cfg, prompt, S.LM_GREEDY)
    pres = [T.prefill(params, toks[:, :S.LM_PROMPT + i], cfg) for i in range(len(dec))]
    out = {"dec-pre": max(S.lm_rel(torch, lg, pre) for lg, pre in zip(dec, pres))}
    for fault in faults:
        with faulty_decode(fault):
            bad = forced_decode(params, cfg, toks, S.LM_PROMPT)
        out[fault] = max(S.lm_rel(torch, lg, pre) for lg, pre in zip(bad, pres))
    if not ref32:
        return out
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = S.lm_cast(params, torch.float32)
    out.update({"dec-ref": 0.0, "pre-ref": 0.0})
    for i, (lg, pre) in enumerate(zip(dec, pres)):
        ref = T.prefill(p32, toks[:, :S.LM_PROMPT + i], cfg32)
        out["dec-ref"] = max(out["dec-ref"], S.lm_rel(torch, lg, ref))
        out["pre-ref"] = max(out["pre-ref"], S.lm_rel(torch, pre, ref))
    if fp64:
        del params
        _, dec32 = S.lm_greedy_decode(torch, p32, cfg32, toks[:, :S.LM_PROMPT], 1)
        p64 = S.lm_cast(p32, torch.float64)
        del p32
        ref64 = T.prefill(p64, toks[:, :S.LM_PROMPT], dataclasses.replace(cfg, dtype=torch.float64))
        out["fp32-fp64"] = S.lm_rel(torch, dec32[0], ref64)
    return out


def first_step_readings(seed: int):
    cfg = dataclasses.replace(CONFIG, n_layers=1, grad_accum=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    batch = synthetic_batch("lm", cfg, S.LM_FIRST_BATCH, 0, device=CPU)
    loss16, norms16 = S.lm_first_step(torch, params, cfg, batch)
    loss32, norms32 = S.lm_first_step(torch, S.lm_cast(params, torch.float32),
                                      dataclasses.replace(cfg, dtype=torch.float32), batch)
    worst = max(norms32, key=lambda k: abs(norms16[k] - norms32[k]) / norms32[k])
    return {"loss": abs(loss16 - loss32) / loss32, "loss_fp32": loss32,
            "grad_norm": abs(norms16[worst] - norms32[worst]) / norms32[worst],
            "grad_norm_worst": worst}


def sequential_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with each output summed over K one product after another
    in fp32 (the error model of a GPU GEMM's k-loop)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out.addcmul_(a[..., :, k:k + 1], b[..., k:k + 1, :])
    return out


def moe_main(args, config):
    """``--arch`` of an MoE LM: phase 19's readings and bounds."""
    bounds = {}
    faults = tuple(MOE_FAULTS) + (tuple(MLA_FAULTS) if config.attn == "mla" else ())
    first = []
    for seed in ([] if args.skip_first else args.seeds):
        t0 = time.perf_counter()
        r = moe_first_step_readings(config, seed)
        first.append(r)
        print(f"first step at 1 dense + 1 MoE layer, seed {seed}: loss bf16 vs fp32 "
              f"{r['loss']:.3e} (fp32 {r['loss_fp32']:.6f}), worst gradient norm "
              f"{r['grad_norm']:.3e} ({r['grad_norm_worst']}), {r['flips']} routes flipped "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if first:
        bounds["MOE_FIRST_LOSS_RTOL"] = 4 * max(r["loss"] for r in first)
        bounds["MOE_FIRST_NORM_RTOL"] = 4 * max(r["grad_norm"] for r in first)
    decode = []
    for layers in args.layers:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = moe_decode_readings(config, layers, seed, faults if args.faults else ())
            decode.append(r)
            print(f"decode vs prefill (no drops), {layers} layers, seed {seed}: "
                  + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in r.items())
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    if decode and args.faults:
        good = max(r["dec-pre"] for r in decode)
        bad = min(r[f] for r in decode for f in faults)
        bounds["MOE_DECODE_TOL"] = math.sqrt(good * bad)
        print(f"decode: the largest correct reading {good:.3e}, the smallest fault reading "
              f"{bad:.3e}; bound, their geometric mean: {bounds['MOE_DECODE_TOL']:.3e} "
              f"({bounds['MOE_DECODE_TOL'] / max(good, 1e-30):.2f}x the one, "
              f"{bad / bounds['MOE_DECODE_TOL']:.2f}x under the other)")
    print("bounds: " + json.dumps({k: float(f"{v:.3g}") for k, v in bounds.items()}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b",
                    choices=["yi-9b", "deepseek-moe-16b", "deepseek-v2-236b"])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--bf16-only", action="store_true",
                    help="no fp32 references (dec-ref, pre-ref): a 48-layer fp32 copy is 33 GiB")
    ap.add_argument("--faults", action="store_true", help="read the planted decode faults")
    ap.add_argument("--skip-first", action="store_true")
    ap.add_argument("--skip-flash", action="store_true")
    args = ap.parse_args(argv)
    if args.arch != "yi-9b":
        return moe_main(args, get_arch(args.arch).config)
    bounds = {}
    decode = {}
    for layers in args.layers:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = decode_readings(layers, seed, fp64=(layers == 1 and seed == args.seeds[0]
                                                    and not args.bf16_only),
                                ref32=not args.bf16_only,
                                faults=tuple(DECODE_FAULTS) if args.faults else ())
            decode[(layers, seed)] = r
            print(f"decode vs prefill, {layers} layer(s), seed {seed}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    full = [r for (layers, _), r in decode.items() if layers == CONFIG.n_layers]
    if full:
        good = max(r["dec-pre"] for r in full)
        print(f"decode at {CONFIG.n_layers} layers: the largest correct reading {good:.3e}")
        if args.faults:
            bad = min(r[f] for r in full for f in DECODE_FAULTS)
            bounds["LM_DECODE_TOL"] = math.sqrt(good * bad)
            print(f"decode at {CONFIG.n_layers} layers: the smallest fault reading {bad:.3e}; "
                  f"bound, their geometric mean: {bounds['LM_DECODE_TOL']:.3e} "
                  f"({bounds['LM_DECODE_TOL'] / good:.2f}x the one, "
                  f"{bad / bounds['LM_DECODE_TOL']:.2f}x under the other)")
    first = []
    for seed in ([] if args.skip_first else args.seeds):
        t0 = time.perf_counter()
        r = first_step_readings(seed)
        first.append(r)
        print(f"first step at 1 layer, seed {seed}: loss bf16 vs fp32 {r['loss']:.3e} "
              f"(fp32 {r['loss_fp32']:.6f}), worst gradient norm {r['grad_norm']:.3e} "
              f"({r['grad_norm_worst']}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    if first:
        bounds["LM_FIRST_LOSS_RTOL"] = 4 * max(r["loss"] for r in first)
        bounds["LM_FIRST_NORM_RTOL"] = 4 * max(r["grad_norm"] for r in first)
    if not args.skip_flash:
        worst = 0.0
        for shape in S.LM_FLASH_SHAPES:
            for order in ("blocked", "sequential"):
                t0 = time.perf_counter()
                matmul = sequential_matmul if order == "sequential" else torch.matmul
                with mock.patch.object(torch, "matmul", matmul):
                    r = S.lm_flash_errors(torch, shape, CPU)
                worst = max(worst, *r.values())
                print(f"flash fp32 vs float64 at {shape}, {order} sums: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                      + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        bounds["FLASH64_TOL"] = 4 * worst
    print("bounds: " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in bounds.items()}))


if __name__ == "__main__":
    main()
