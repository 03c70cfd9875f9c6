"""The ``score`` kind: bulk scoring of pre-extracted batches through the
program's ``repro_torch.models.recsys.serve_step``, closed loop, one batch
in flight: each batch is copied to the card, scored, and synchronized.

The check samples the window's batches from the seed (about
``check_batches`` of them, at most twice that, and always the last), keeps
the program's pCTR of each, and once the window has closed and the
program's state is freed, scores the same batches with the reference from
the weights made again from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import devtrace, judge, program, reference, traffic, weights
from portbench.harness import Feed, KindResult, Stopwatch, free_device, memory_peak, sync
from portbench.seeds import substream


def run(cell, seed: int, seconds: float, trace: bool, device, on_window_closed) -> KindResult:
    from repro_torch.models import recsys as R

    cfg, mix, model = cell.config, cell.mix, cell.model
    sw = Stopwatch()
    params = weights.make(cfg, model, seed, device)
    sync(device)
    sw.mark("weights")
    batches = traffic.make_batches(cfg, mix, seed, device)
    sw.mark("batches")
    pcfg = program.recsys_config(cfg)
    feed = Feed(batches, device)
    bad = torch.zeros((), dtype=torch.int64, device=device)

    def score_one():
        p = R.serve_step(params, pcfg, feed())
        bad.add_(~torch.isfinite(p).all())
        sync(device)
        return p

    for _ in range(int(mix["warmup_batches"])):
        t = time.perf_counter()
        score_one()
        warm_s = time.perf_counter() - t
    sw.mark("warm-up batches")
    setup_end = time.perf_counter()

    want = int(mix["check_batches"])
    keep_rate = min(1.0, want * warm_s / seconds)
    draws = np.random.default_rng(substream(seed, "check.sample"))
    bad.zero_()
    kept, n = [], 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        index = feed.next % len(batches)
        p = score_one()
        n += 1
        if draws.random() < keep_rate and len(kept) < 2 * want:
            kept.append((n, index, p))
    window_s = now - t0
    if not kept or kept[-1][0] != n:
        kept.append((n, index, p))
    failed = int(bad)
    on_window_closed()

    summary = None
    if trace:
        units = int(mix["trace_units"])

        def segment():
            for _ in range(units + 2):
                with torch.profiler.record_function(devtrace.MARK):
                    score_one()

        summary = devtrace.capture(segment, units, device)
    peak = memory_peak(device)

    del params, p
    free_device(device)
    p0 = weights.make(cfg, model, seed, device)
    ref = [reference.score(model, cfg, p0, batches[i], device) for _, i, _ in kept]
    rows = int(mix["rows"])
    return KindResult(
        setup_end=setup_end, setup_parts=sw.parts, excluded_s=0.0,
        end_to_end={"score_examples_per_s": n * rows / window_s},
        attempted=n, failed=failed, memory_peak_bytes=peak,
        numbers=judge.score_numbers([p for _, _, p in kept], ref),
        window={"units": n, "seconds": window_s, "rows": rows}, trace=summary)
