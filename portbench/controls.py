"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.controls --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2]

For each of ``--seeds``, a sound run: the cell as ``portbench.run`` runs
it, with a window of ``--seconds``, and its numbers (the lower readings).
For each of ``--control-seeds``, the reference put in the program's place
and judged by the same numbers: computed with TF32 (``control``, the
nearest precision below the configurations' fp32), on the first half of
each batch (``half``), and for scoring with one answer altered
(``altered``). Each reading is one JSON line on standard output. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_controls(cell, seed: int, device) -> dict:
    import torch

    from portbench import judge, reference, traffic, weights

    cfg, mix, model = cell.config, cell.mix, cell.model
    k = int(mix["check_steps"])
    batches = traffic.make_batches(cfg, dict(mix, batches=k), seed, device)
    offs = weights.offsets(cfg)
    union = torch.unique(torch.cat([
        traffic.global_ids(cfg, b["sparse"].to(device), offs).reshape(-1) for b in batches]))
    p0 = weights.make(cfg, model, seed, device)
    rows0 = p0.pop("embed")[union]
    args = (model, cfg, mix["optimizer"], p0, rows0, union, batches, device)
    ref = reference.train(*args)
    return {"control": judge.train_numbers(reference.train(*args, tf32=True), ref),
            "half": judge.train_numbers(reference.train(*args, fault="half"), ref)}


def score_controls(cell, seed: int, device) -> dict:
    from portbench import judge, reference, traffic, weights

    cfg, mix, model = cell.config, cell.mix, cell.model
    batches = traffic.make_batches(cfg, dict(mix, batches=int(mix["check_batches"])), seed,
                                   device)
    p0 = weights.make(cfg, model, seed, device)
    ref = [reference.score(model, cfg, p0, b, device) for b in batches]
    control = [reference.score(model, cfg, p0, b, device, tf32=True) for b in batches]
    half = [reference.score(model, cfg, p0, reference.half_batch(b), device) for b in batches]
    half = [h.repeat(2)[:r.shape[0]] for h, r in zip(half, ref)]
    altered = [r.clone() for r in ref]
    altered[0][0] = 1.0 - altered[0][0]
    return {"control": judge.score_numbers(control, ref),
            "half": judge.score_numbers(half, ref),
            "altered": judge.score_numbers(altered, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import time

    import torch

    from portbench import run, spec
    from portbench.harness import free_device

    cell = spec.load_cell(args.workload, spec.load_benchmark(ROOT))
    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        line, _, detail = run.run_cell(cell, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"workload": cell.name, "seed": seed, "reading": "sound",
                          "numbers": {k: v["value"] for k, v in line["check"].items()},
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "peak": line["device"]["memory_peak_bytes"], "detail": detail}),
              flush=True)
        free_device(device)
    controls = train_controls if cell.mix["kind"] == "train" else score_controls
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for reading, numbers in controls(cell, seed, device).items():
            print(json.dumps({"workload": cell.name, "seed": seed, "reading": reading,
                              "numbers": numbers}), flush=True)
        free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
