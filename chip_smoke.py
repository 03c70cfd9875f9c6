#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which raises (exit code != 0) on failure:

1. device — the card's name and power limit from ``nvidia-smi``;
2. build — ``nvcc`` builds ``src/repro_torch/csrc/*.cu`` for sm_90a; prints
   each kernel's ``-Xptxas -v`` spill and register lines and fails if an
   instance of the interaction_dot forward or backward kernel spills, if
   one of ``hash_layer_kernel`` or ``alloc_offsets_kernel`` has a stack
   frame or spills, or if any of them has no report;
3. feature_hash — both ``dlrm`` FE programs (cross_features: 8 columns,
   16 ops; sparse_ids: 10 columns, 10 ops) at N = 512, 8,192, 262,144 and
   1,048,576 rows and field sizes 2**20 and 1000, on ids with negatives and
   values >= 2**31 before narrowing: kernel == plain version exactly. The
   launch floor (the device time of ``zero_()`` on one element) and each
   program's time above it; times (per call, median of 21 groups of 10
   calls: device-only, and with the Python wrapper), bounds, and at
   N = 8,192 a second turn of kernel, floor, floor, kernel in the same
   call. Each program's share of its byte bound is read at N = 1,048,576
   with its inputs rotated over at least 3 column blocks and 150 MB, so no
   call finds them in the 50 MB L2; at 262,144 (19-25 MB a call, which the
   L2 holds) no share is read. A share above 100 % anywhere fails the phase;
4. interaction_dot — B = 512, 8,192 and 65,536, F = 27, D = 128: kernel within
   rtol/atol 1e-5 of the plain version (another fp32 summation order);
   times, byte bound, and ``torch.bmm`` + tril gather as the library
   yardstick; the kernel's share of its bound and its ratio to the library,
   and a second turn of kernel, library, library, kernel in the same call;
5. interaction_dot backward — B = 8,192 and 65,536, F = 27, D = 128: kernel
   within 1e-5 of the plain version, relative to the largest gradient;
   times, byte bound, and the scatter of dy + ``torch.bmm`` as the library
   yardstick; the kernel's share of its bound and its ratio to the library,
   and a second turn of kernel, library, library, kernel in the same call;
6. mempool_alloc — N = 1, 5 (the device feed's block at 8,192 rows), 1,024,
   1,025, 1,000,000 and 2**23: kernel == plain version bit for bit; times,
   bound, ``torch.cumsum`` of the aligned sizes as the library yardstick,
   at N = 1,000,000 a second turn of kernel, library, library, kernel in
   the same call, and the host entry ``plan_block`` and
   ``ArenaPool.alloc_block`` per call. The share of the byte bound and the
   ratio to ``torch.cumsum`` are read at N = 2**23 with the sizes rotated
   over at least 3 blocks and 150 MB, past the L2; a share above 100 %
   fails the phase;
7. serving, full width — ``dlrm-mlperf`` with every vocabulary capped at
   10,000,000 rows (a 25.8 GiB fp32 table on the card; the full Criteo-1TB
   table is 89.5 GiB and does not fit in 80 GB), weights from a seeded
   ``torch.Generator``, 8 requests of 512 rows through ``FeaturePlan.run`` ->
   ``ModelFeed.apply`` -> ``serve_step``: pCTR finite and in (0, 1), the
   kernels launched 2 and 1 times per batch, and the first batch equal to
   the same path with every kernel swapped for its plain version (atol 1e-5);
8. training, full width — the same capped ``dlrm-mlperf``, 8,192 rows per
   step, through ``FeaturePlan.run`` -> ``DeviceFeeder.stage`` ->
   ``ModelFeed.make_step(make_sparse_train_step(cfg, adamw(1e-3)))``: staged
   slots bit-equal to the plan's output and to the plan's output with
   ``feature_hash`` swapped for its plain version; on the first batch the
   kernel path against the plain path (interaction forward and backward
   swapped for autograd of the plain forward) — loss within rtol 1e-5, working-row
   gradients within 1e-5 of the largest and not zero, updated working rows
   within 1e-6; then 1 warm-up and 8 timed steps with finite losses,
   launches per step (feature_hash 2, interaction forward 1, backward 1,
   mempool_alloc 1 per staged batch), ms per step with its breakdown, and
   the device's idle share under the profiler;
9. embedding_bag — the JAX package's six test shapes and the training
   batch's interest bag (B = 8,192 rows, L = 16 ``batch_seq_ids`` deduped
   into a working set of U rows, weights ``batch_seq_mask``, D = 128):
   kernel == plain version for L = 1, else within 1e-5 of the largest
   output; device and call times, the byte bound, the plain version and
   ``F.embedding_bag`` as the library yardstick (the byte bound counts
   each distinct row that a live slot reads once); one ``bag_lookup`` call
   at the full-width shape is the launch count of its path. The share of
   the bound and the ratio to ``F.embedding_bag`` are read at B = 65,536,
   L = 16, U = 2**20 (a 512 MiB table), D = 128, uniform ids with 80 % of
   slots live, ids and weights rotated over 3 blocks: past the L2; a share
   above 100 % fails the phase;
10. streaming, full width — the main path: ``launch.train.run_streaming``
   (``--device-feed arena``) over 10 raw-log shards of 8,192 rows written
   by ``write_log_shards``: shard readers, the FE worker on its own stream,
   the feeder thread writing FE output into the arena, the sparse step.
   One warm-up step (its loss equal to the slice-2 plain loop's on the
   same first shard with the same params, rtol 1e-6), then runs of 8
   steps in turns with a serial loop that does the runner's work in one
   thread (the same loader, arena feed and step; order serial, stream,
   stream, serial, serial, stream), then two of each with the
   interpreter's switch interval cut to 0.5 ms (the GIL probe): losses
   finite, launches per step equal to the plain loop's, wall ms per step
   (the runner's ``wall_seconds``; the serial loop's from its first read
   to its last sync), the runner's FE / train / wall seconds and overlap,
   the feed's counts, and each loop's device idle share under the
   profiler over steps 2-9 of one 10-step epoch, and at its unprofiled
   wall; then a checkpoint round trip at the smoke config.

The line before the last is the ``kernels`` JSON record. Each kernel's
record gives its launches on the streaming path (``embedding_bag``: on its
own entry point's path) and its times at that path's shape (8,192 rows;
N = 5 for ``mempool_alloc``), with every path's launches under
``launches_by_path``, and, for the kernels whose bound is read past the
L2, ``share_of_bound`` with its ``share_of_bound_shape``; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.

  python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), dense, at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12                      # FMA counted as 2, outside the tensor cores
INT32_OPS = 132 * 64 * 1.98e9           # 64 INT32 lanes per SM x 132 SMs x 1.98 GHz
# 32-bit integer operations per row of each feature_hash op (modulo as one):
# fmix32 is 3 shifts + 3 xors + 2 multiplies.
HASH_OPS_PER_ROW = {"cross": 2 * 8 + 3, "hash": 8 + 1, "mod": 3}

VOCAB_CAP = 10_000_000
BATCH = 512                             # serve_p99 request batch of the JAX configs
N_BATCHES = 8
LARGE_B = 65_536                        # the interaction kernels' large-batch check
TRAIN_ROWS = 8192                       # per-card share of a 65,536-row global batch on 8 cards
TRAIN_STEPS = 8                         # timed, after one warm-up step
STREAM_SHARDS = 10                      # raw-log shards of TRAIN_ROWS rows for the streaming path
BAG_SHAPES = ((4, 3, 10, 8), (300, 16, 700, 64), (256, 48, 512, 128),   # the JAX package's
              (33, 5, 1, 16), (1, 1, 2, 8), (1024, 4, 2000, 32))        # tests: (B, L, U, D)
ALLOC_NS = (1, 5, 1024, 1025, 1_000_000)  # mempool_alloc request counts checked and timed
ALLOC_HBM_N = 1 << 23                   # mempool_alloc's HBM bound is read at this N
BAG_HBM_SHAPE = (65_536, 16, 1 << 20, 128)  # embedding_bag's (B, L, U, D), a 512 MiB table
LR = 1e-3                               # --lr default of the JAX package's launch/train.py
HBM_ROWS = 1 << 20                      # feature_hash's HBM bound is read at this N,
HBM_ROTATION_BYTES = 150e6              # its inputs rotated over >= 3 blocks and this many bytes
TIMING_GROUPS = 21                      # times are medians over 21 groups
CALLS_PER_GROUP = 10                    # of 10 calls each
SLEEP_CYCLES_PER_S = 1.98e9             # torch.cuda._sleep counts SM clock cycles


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _median_ms(torch, fn, groups: int, per: int) -> float:
    """Median over ``groups`` groups of ``per`` calls each of the time per
    call between CUDA events recorded on the stream around each group (a
    group amortizes the event's own cost over ``per`` calls)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(groups + 1)]
    events[0].record()
    for g in range(groups):
        for _ in range(per):
            fn()
        events[g + 1].record()
    events[-1].synchronize()
    return statistics.median(events[g].elapsed_time(events[g + 1]) / per
                             for g in range(groups))


def call_ms(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """What a caller pays per call, launch overhead included: calls issued
    one after another from an idle device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _median_ms(torch, fn, groups, per)


def device_ms(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """Device time per call: the calls are queued behind a sleep kernel that
    outlasts their host time, so their kernels run back to back and the
    events between them see device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    sleep_s = min(3.0 * groups * per * host_s + 1e-3, 4.0)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    return _median_ms(torch, fn, groups, per)


def timings(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP):
    return device_ms(torch, fn, groups, per), call_ms(torch, fn, groups, per)


def host_ms(fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """Median over groups of the host wall time per call (for host code and
    calls that end in their own synchronization)."""
    fn()
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / per)
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_feature_hash(torch, dev):
    import numpy as np
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.ops import narrow_int32
    from repro_torch.kernels.feature_hash.ops import run_hash_layer
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref

    # the launch floor: the device time of a launch that does almost nothing
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = device_ms(torch, one.zero_)
    print(f"feature_hash launch floor (zero_ of one element) ms={floor_ms:.7f}")

    def share_of(what: str, b_ms: float, ms: float) -> float:
        share = b_ms / ms
        check(share <= 1.0, f"feature_hash {what}: {share:.3f} of its bound, above 100 %: "
                            "the timing or the count is wrong")
        return share

    main = dict.fromkeys(("ms", "call_ms", "plain_ms", "plain_call_ms", "bytes", "ops"), 0.0)
    pair_turns, floors = [0.0] * 3, [floor_ms]
    hbm = {}
    for field_size in (1 << 20, 1000):
        plan = featureplan.compile(get_spec("dlrm"), field_size=field_size)
        for op in ("cross_features", "sparse_ids"):
            slots, prog = plan.graph.ops[op].fn.hash_layer
            for n in (BATCH, TRAIN_ROWS, 262_144, HBM_ROWS):
                rng = np.random.default_rng(n + field_size)
                ids = rng.integers(-(2**33), 2**33, (len(slots), n)).astype(np.int64)
                ids[:, :4] = [5, -7, 2**31 + 5, 2**32 + 3]
                cols = narrow_int32(torch.from_numpy(ids).to(dev))
                got = run_hash_layer(cols, prog)
                want = hash_layer_ref(cols, program=prog)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"feature_hash {op} N={n} field_size={field_size} != plain version")
                del got, want
                nbytes = (len(slots) + len(prog)) * n * 4
                ops = sum(HASH_OPS_PER_ROW[k] for k, *_ in prog) * n
                b_ms, b_by = bound(nbytes, ops, INT32_OPS)
                head = (f"feature_hash {op:<14} K={len(slots):<2} ops={len(prog):<2} N={n:<7} "
                        f"field_size={field_size:<7} exact=True")
                if n == HBM_ROWS:
                    # each call reads a column block that the L2 no longer
                    # holds: the blocks are rotated, at least 3 of them and
                    # HBM_ROTATION_BYTES in all
                    k = max(3, math.ceil(HBM_ROTATION_BYTES / cols.nbytes))
                    blocks = [cols] + [cols.roll(4097 * r, dims=1) for r in range(1, k)]
                    rotation = itertools.cycle(blocks)
                    ms = device_ms(torch, lambda: run_hash_layer(next(rotation), prog))
                    share = share_of(f"{op} N={n}", b_ms, ms)
                    print(f"{head} ms={ms:.7f} bound_ms={b_ms:.7f} ({b_by}) "
                          f"share_of_bound={share:.3f} (inputs rotated over {k} column blocks, "
                          f"{k * cols.nbytes / 1e6:.1f} MB, past the L2) "
                          f"above_floor_ms={ms - floor_ms:.7f}")
                    if field_size == 1 << 20:
                        hbm[op] = {"ms": ms, "bound_ms": b_ms, "share_of_bound": share,
                                   "blocks": k, "mb": k * cols.nbytes / 1e6}
                    del blocks, rotation, cols
                    torch.cuda.empty_cache()
                    continue

                def kernel():
                    return run_hash_layer(cols, prog)

                ms, c_ms = timings(torch, kernel)
                # some 400 small launches per plain call: 2 calls stay inside
                # the launch queue while the sleep kernel holds the device
                plain_ms, plain_c_ms = timings(
                    torch, lambda: hash_layer_ref(cols, program=prog), groups=2, per=1)
                times = (f"ms={ms:.7f} call_ms={c_ms:.7f} plain_ms={plain_ms:.5f} "
                         f"plain_call_ms={plain_c_ms:.5f} bound_ms={b_ms:.7f} ({b_by})")
                if n == 262_144:
                    # 19-25 MB per call: the L2 keeps it from one call to the
                    # next, so no share of the HBM bound is read here
                    print(f"{head} {times} (inputs L2-resident) "
                          f"above_floor_ms={ms - floor_ms:.7f}")
                    continue
                print(f"{head} {times} share_of_bound={share_of(f'{op} N={n}', b_ms, ms):.3f} "
                      f"above_floor_ms={ms - floor_ms:.7f}")
                if n == TRAIN_ROWS and field_size == 1 << 20:
                    # a second turn in the same call: kernel, floor, floor, kernel
                    turn = [device_ms(torch, fn) for fn in (kernel, one.zero_, one.zero_, kernel)]
                    print(f"feature_hash {op:<14} N={n} turns (kernel, floor, floor, kernel after "
                          f"the first pair): kernel_ms={[ms, turn[0], turn[3]]} "
                          f"floor_ms={[floor_ms, turn[1], turn[2]]}")
                    for t, k_ms in enumerate((ms, turn[0], turn[3])):
                        pair_turns[t] += k_ms
                    floors += turn[1:3]
                    for key, val in (("ms", ms), ("call_ms", c_ms), ("plain_ms", plain_ms),
                                     ("plain_call_ms", plain_c_ms), ("bytes", nbytes),
                                     ("ops", ops)):
                        main[key] += val
    b_ms, b_by = bound(main["bytes"], main["ops"], INT32_OPS)
    print(f"feature_hash pair N={TRAIN_ROWS} field_size={1 << 20}: ms={main['ms']:.7f} "
          f"call_ms={main['call_ms']:.7f} bound_ms={b_ms:.7f} ({b_by}) "
          f"share_of_bound={share_of('pair', b_ms, main['ms']):.3f} "
          f"floor_ms={floor_ms:.7f} above_two_floors_ms={main['ms'] - 2 * floor_ms:.7f} "
          f"pair_turns_ms={pair_turns} floors_ms={floors}")
    return {"name": "feature_hash", "route": "cuda",
            "source": "src/repro_torch/csrc/feature_hash.cu",
            "replaces": "src/repro/kernels/feature_hash/kernel.py:66",
            "max_abs_err": 0, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "call_ms": main["call_ms"], "plain_call_ms": main["plain_call_ms"],
            "shape": f"N={TRAIN_ROWS}: cross_features + sparse_ids, one launch each",
            "floor_ms": floor_ms, "turns_kernel_ms": pair_turns, "turns_floor_ms": floors,
            "share_of_bound": {op: rec["share_of_bound"] for op, rec in hbm.items()},
            "share_of_bound_shape": (f"N={HBM_ROWS}, field_size={1 << 20}, inputs rotated "
                                     "past the L2: " + ", ".join(
                                         f"{op} over {rec['blocks']} column blocks "
                                         f"({rec['mb']:.1f} MB)" for op, rec in hbm.items())),
            "hbm_ms": {op: rec["ms"] for op, rec in hbm.items()},
            "hbm_bound_ms": {op: rec["bound_ms"] for op, rec in hbm.items()}}


def phase_interaction_dot(torch, dev):
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref

    f, d = 27, 128
    p = f * (f - 1) // 2
    rows, cols = torch.tril_indices(f, f, -1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    record, worst = None, 0.0
    for b in (BATCH, TRAIN_ROWS, LARGE_B):
        x = torch.randn((b, f, d), generator=gen, device=dev)
        got = pairwise_dots(x)
        want = dot_interaction_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got - want).abs().max())
        worst = max(worst, err)

        def library():  # one batched product, then the triangle's gather
            return torch.bmm(x, x.mT)[:, rows, cols]

        ms, c_ms = timings(torch, lambda: pairwise_dots(x))
        plain_ms, plain_c_ms = timings(torch, lambda: dot_interaction_ref(x))
        library_ms, library_c_ms = timings(torch, library)
        # a second turn in the same call: kernel, library, library, kernel
        turn = [device_ms(torch, fn) for fn in (lambda: pairwise_dots(x), library, library,
                                                lambda: pairwise_dots(x))]
        kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
        b_ms, b_by = bound(b * f * d * 4 + b * p * 4, 2 * b * p * d, FP32_FLOPS)
        print(f"interaction_dot B={b:<6} F={f} D={d} max_abs_err={err:.3e} ms={ms:.5f} "
              f"call_ms={c_ms:.5f} plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.5f} library_call_ms={library_c_ms:.5f} "
              f"bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} vs_library={ms / library_ms:.3f}")
        print(f"interaction_dot B={b:<6} turns (kernel, library, library, kernel "
              f"after the first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
              f"library_ms={[round(t, 7) for t in lib_ms]} "
              f"kernel_below_library_in_every_turn={max(kernel_ms) < min(lib_ms)}")
        if b == TRAIN_ROWS:
            record = {"name": "interaction_dot", "route": "cuda",
                      "source": "src/repro_torch/csrc/interaction_dot.cu",
                      "replaces": "src/repro/kernels/interaction_dot/kernel.py:43",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library_ms, "call_ms": c_ms,
                      "plain_call_ms": plain_c_ms, "library_call_ms": library_c_ms,
                      "shape": f"B={b} F={f} D={d}",
                      "share_of_bound": b_ms / ms, "vs_library": ms / library_ms,
                      "turns_kernel_ms": kernel_ms, "turns_library_ms": lib_ms}
        del x, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return record


def phase_interaction_bwd(torch, dev):
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots_backward
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_bwd_ref

    f, d = 27, 128
    p = f * (f - 1) // 2
    rows, cols = torch.tril_indices(f, f, -1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    record, worst = None, 0.0
    for b in (TRAIN_ROWS, LARGE_B):
        x = torch.randn((b, f, d), generator=gen, device=dev)
        dy = torch.randn((b, p), generator=gen, device=dev)
        got = pairwise_dots_backward(x, dy)
        want = dot_interaction_bwd_ref(x, dy)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * scale,
              f"interaction_dot backward B={b}: max abs err {err} > 1e-5 x {scale}")
        worst = max(worst, err)

        def library():  # scatter dy into G, then one batched product
            g = torch.zeros((b, f, f), device=dev)
            g[:, rows, cols] = dy
            return torch.bmm(g + g.mT, x)

        ms, c_ms = timings(torch, lambda: pairwise_dots_backward(x, dy))
        plain_ms, plain_c_ms = timings(torch, lambda: dot_interaction_bwd_ref(x, dy))
        library_ms, library_c_ms = timings(torch, library)
        # a second turn in the same call: kernel, library, library, kernel
        turn = [device_ms(torch, fn) for fn in (lambda: pairwise_dots_backward(x, dy),
                                                library, library,
                                                lambda: pairwise_dots_backward(x, dy))]
        kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
        b_ms, b_by = bound(b * (2 * f * d + p) * 4, 2 * b * f * (f - 1) * d, FP32_FLOPS)
        print(f"interaction_dot_backward B={b:<6} F={f} D={d} max_abs_err={err:.3e} "
              f"max_abs_grad={scale:.3e} ms={ms:.5f} call_ms={c_ms:.5f} plain_ms={plain_ms:.5f} "
              f"plain_call_ms={plain_c_ms:.5f} library_ms={library_ms:.5f} "
              f"library_call_ms={library_c_ms:.5f} bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} vs_library={ms / library_ms:.3f}")
        print(f"interaction_dot_backward B={b:<6} turns (kernel, library, library, kernel "
              f"after the first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
              f"library_ms={[round(t, 7) for t in lib_ms]} "
              f"kernel_below_library_in_every_turn={max(kernel_ms) < min(lib_ms)}")
        if b == TRAIN_ROWS:
            record = {"name": "interaction_dot_backward", "route": "cuda",
                      "source": "src/repro_torch/csrc/interaction_dot.cu",
                      "replaces": "src/repro/kernels/interaction_dot/kernel.py:43",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "call_ms": c_ms, "plain_call_ms": plain_c_ms,
                      "library_call_ms": library_c_ms, "shape": f"B={b} F={f} D={d}",
                      "share_of_bound": b_ms / ms, "vs_library": ms / library_ms,
                      "turns_kernel_ms": kernel_ms, "turns_library_ms": lib_ms}
        del x, dy, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return record


def phase_mempool_alloc(torch, dev):
    import numpy as np
    from repro_torch.core.mempool import ArenaPool
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.kernels.mempool_alloc.ops import alloc_offsets, plan_block
    from repro_torch.kernels.mempool_alloc.ref import alloc_offsets_ref

    layout = featureplan.compile(get_spec("dlrm")).feed_layout()
    feed_sizes = layout.sizes(TRAIN_ROWS)
    record = None
    for n in ALLOC_NS + (ALLOC_HBM_N,):
        sizes = (feed_sizes if n == len(feed_sizes)
                 else np.random.default_rng(n).integers(0, 1 << 16, n))
        host = torch.tensor(np.asarray(sizes), dtype=torch.int32)
        sizes_d = host.to(dev)
        offsets, head = alloc_offsets(sizes_d)
        want_offsets, want_head = alloc_offsets_ref(host)
        torch.cuda.synchronize()
        check(torch.equal(offsets.cpu(), want_offsets) and torch.equal(head.cpu(), want_head),
              f"mempool_alloc N={n} != plain version")
        del offsets, want_offsets
        aligned = (sizes_d + 127) // 128 * 128
        # each size read once, each offset and the head written once; an
        # align, an add and a compare per request
        b_ms, b_by = bound(8 * n + 4, 3 * n, INT32_OPS)
        if n == ALLOC_HBM_N:
            # each call reads sizes that the L2 no longer holds: the blocks
            # are rotated, at least 3 of them and HBM_ROTATION_BYTES in all;
            # the library reads the aligned sizes, rotated the same way
            k = max(3, math.ceil(HBM_ROTATION_BYTES / sizes_d.nbytes))
            blocks = [sizes_d] + [sizes_d.roll(4097 * r) for r in range(1, k)]
            lib_blocks = [aligned] + [aligned.roll(4097 * r) for r in range(1, k)]
            rotation, lib_rotation = itertools.cycle(blocks), itertools.cycle(lib_blocks)
            ms = device_ms(torch, lambda: alloc_offsets(next(rotation)))
            library_ms = device_ms(
                torch, lambda: torch.cumsum(next(lib_rotation), 0, dtype=torch.int32))
            share = b_ms / ms
            check(share <= 1.0, f"mempool_alloc N={n}: {share:.3f} of its bound, above "
                                "100 %: the timing or the count is wrong")
            print(f"mempool_alloc N={n} exact=True head={int(head[0])} ms={ms:.7f} "
                  f"bound_ms={b_ms:.7f} ({b_by}) share_of_bound={share:.3f} "
                  f"library_ms={library_ms:.7f} vs_library={ms / library_ms:.3f} (inputs "
                  f"rotated over {k} blocks, {k * sizes_d.nbytes / 1e6:.1f} MB, past the L2)")
            record.update({"share_of_bound": share, "hbm_ms": ms, "hbm_bound_ms": b_ms,
                           "hbm_library_ms": library_ms, "hbm_vs_library": ms / library_ms,
                           "share_of_bound_shape": (
                               f"N={n}, sizes rotated over {k} blocks "
                               f"({k * sizes_d.nbytes / 1e6:.1f} MB), past the L2")})
            del blocks, lib_blocks, rotation, lib_rotation
            continue

        def kernel():
            return alloc_offsets(sizes_d)

        def library():
            return torch.cumsum(aligned, 0, dtype=torch.int32)

        ms, c_ms = timings(torch, kernel)
        plain_ms, plain_c_ms = timings(torch, lambda: alloc_offsets_ref(sizes_d))
        library_ms, library_c_ms = timings(torch, library)
        print(f"mempool_alloc N={n:<7} exact=True head={int(head[0])} ms={ms:.7f} "
              f"call_ms={c_ms:.7f} plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.7f} library_call_ms={library_c_ms:.7f} "
              f"bound_ms={b_ms:.8f} ({b_by})")
        if n == 1_000_000:
            # a second turn in the same call: kernel, library, library, kernel
            turn = [device_ms(torch, fn) for fn in (kernel, library, library, kernel)]
            kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
            print(f"mempool_alloc N={n} turns (kernel, library, library, kernel after the "
                  f"first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
                  f"library_ms={[round(t, 7) for t in lib_ms]}")
            record.update({"turns_1e6_kernel_ms": kernel_ms, "turns_1e6_library_ms": lib_ms})
        if n == len(feed_sizes):
            record = {"name": "mempool_alloc", "route": "cuda",
                      "source": "src/repro_torch/csrc/mempool_alloc.cu",
                      "replaces": "src/repro/kernels/mempool_alloc/kernel.py:60",
                      "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library_ms, "call_ms": c_ms,
                      "plain_call_ms": plain_c_ms, "library_call_ms": library_c_ms,
                      "shape": f"N={n}: the dlrm feed layout's slots at {TRAIN_ROWS} rows"}
    torch.cuda.empty_cache()
    stream = torch.cuda.Stream(dev)
    record["plan_block_ms"] = host_ms(lambda: plan_block(feed_sizes, device=dev, stream=stream))
    pool = ArenaPool(layout.arena_bytes(TRAIN_ROWS))

    def host_block():
        pool.reset()
        pool.alloc_block(feed_sizes)

    record["host_alloc_block_ms"] = host_ms(host_block)
    print(f"mempool_alloc host entry N={len(feed_sizes)}: plan_block (H2D, kernel, D2H, event "
          f"wait) ms={record['plan_block_ms']:.5f}; host ArenaPool.alloc_block "
          f"ms={record['host_alloc_block_ms']:.5f}")
    return record


def calibrate_output_layer(torch, params, cfg, plan, feed, dev) -> None:
    """Random weights on the raw counts of the dlrm spec give logits of
    10-40, where an fp32 sigmoid is exactly 1 and a comparison of pCTRs
    tests nothing. Rescale the last top-MLP layer so the logits of one
    warm-up request have unit spread around the logit of its click rate."""
    from repro_torch.fe.datagen import gen_views
    from repro_torch.models import recsys as R

    batch = feed.apply(feed.select(plan.run(gen_views(BATCH, seed=99), device=dev)))
    logits = R.forward(params, cfg, batch)
    rate = min(max(float(batch["label"].mean()), 0.01), 0.5)
    scale = 1.0 / float(logits.std())
    last = len(cfg.top_mlp) - 1
    params[f"top_w{last}"] *= scale
    params[f"top_b{last}"] = ((params[f"top_b{last}"] - float(logits.mean())) * scale
                              + math.log(rate / (1.0 - rate)))


def phase_end_to_end(torch, dev):
    from repro_torch.configs.dlrm_mlperf import CONFIG
    from repro_torch.core.metakernel import ExecutionStats
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import recsys as R

    cfg = capped_config()
    full_gib = sum(CONFIG.vocab_sizes) * CONFIG.embed_dim * 4 / 2**30
    gib = cfg.padded_rows * cfg.embed_dim * 4 / 2**30
    print(f"reduced: vocabularies capped at {VOCAB_CAP:,} rows: {cfg.multi_table().total_rows:,} "
          f"rows ({cfg.padded_rows:,} padded) = {gib:.1f} GiB fp32 on the card; the full "
          f"Criteo-1TB table is {sum(CONFIG.vocab_sizes):,} rows = {full_gib:.1f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg, rows_hint=BATCH)
    calibrate_output_layer(torch, params, cfg, plan, feed, dev)
    torch.cuda.synchronize()
    print(f"setup: params {sum(v.numel() for v in params.values()):,} on {dev}, "
          f"dedup capacity {feed.dedup_capacity}, {time.perf_counter() - t0:.2f} s")

    serve_requests(plan, feed, params, cfg, [gen_views(BATCH, seed=98)], device=dev)  # warm-up
    requests = [gen_views(BATCH, seed=100 + i) for i in range(N_BATCHES)]
    stats = ExecutionStats()
    hash_ops.run_hash_layer.launches = 0
    interaction_ops.pairwise_dots.launches = 0
    scores, latency = serve_requests(plan, feed, params, cfg, requests, device=dev, stats=stats)
    launches = {"feature_hash": hash_ops.run_hash_layer.launches,
                "interaction_dot": interaction_ops.pairwise_dots.launches}

    check(launches["feature_hash"] == 2 * N_BATCHES, f"feature_hash launches {launches}")
    check(launches["interaction_dot"] == N_BATCHES, f"interaction_dot launches {launches}")
    check(stats.n_device_dispatches == N_BATCHES, f"FE dispatches {stats.n_device_dispatches}")
    for s in scores:
        check(tuple(s.shape) == (BATCH,) and s.dtype == torch.float32, "pCTR shape/dtype")
        check(bool(torch.isfinite(s).all()), "pCTR finite")
        check(bool(((s > 0) & (s < 1)).all()), "pCTR in (0, 1)")

    with mock.patch.object(hash_ops, "run_hash_layer",
                           lambda cols, program: hash_layer_ref(cols, program=program)), \
            mock.patch.object(interaction_ops, "pairwise_dots", dot_interaction_ref):
        (plain,), _ = serve_requests(plan, feed, params, cfg, requests[:1], device=dev)
    err = float((scores[0] - plain).abs().max())
    check(err <= 1e-5, f"first batch pCTR vs plain-version path: max abs err {err}")

    lat_ms = [t * 1e3 for t in latency]
    p50 = float(statistics.median(lat_ms))
    p99 = float(sorted(lat_ms)[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)])
    all_s = torch.cat(scores)
    print(f"end_to_end dlrm-mlperf batches={N_BATCHES} batch={BATCH} "
          f"latency_ms={[round(t, 3) for t in lat_ms]} p50_ms={p50:.3f} p99_ms={p99:.3f} "
          f"pctr_mean={float(all_s.mean()):.4f} pctr_min={float(all_s.min()):.3e} "
          f"pctr_max={float(all_s.max()):.4f} plain_path_max_abs_err={err:.3e} "
          f"launches={launches} fe_dispatches={stats.n_device_dispatches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    print(f"end_to_end breakdown per request: fe_host_ops_ms={stats.host_seconds * 1e3 / N_BATCHES:.3f} "
          f"fe_device_ops_issue_ms={stats.device_seconds * 1e3 / N_BATCHES:.3f} "
          f"feed_and_model_ms={sum(lat_ms) / N_BATCHES - (stats.host_seconds + stats.device_seconds) * 1e3 / N_BATCHES:.3f}")
    profile_device(torch, "request", 4, lambda: serve_requests(
        plan, feed, params, cfg, requests[:4], device=dev))
    return launches


def _union_ms(spans, lo: float, hi: float) -> float:
    """Milliseconds of [lo, hi] (profiler microseconds) covered by at least
    one of ``spans``: kernels of concurrent streams count once."""
    covered, end = 0.0, lo
    for start, stop in sorted(spans):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            covered += stop - start
            end = stop
    return covered / 1e3


def profile_device(torch, unit: str, n: int, run, mark: str = "") -> None:
    """torch.profiler over ``run()``, which does ``n`` units of work (requests
    or steps) and ends in a synchronize: the device's busy share (time with
    at least one kernel or copy running) and the kernels and host-side torch
    ops that take the time (the profiler's own overhead inflates the wall
    time). With ``mark``, the name of a ``record_function`` range opened at
    the start of each unit, the window runs from the second unit's start to
    the last one's (without set-up and the first unit), and the gaps
    between unit starts are printed. Returns the device's busy and wall ms
    per unit, or None when the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    n_run = n
    lo, hi, window = -math.inf, math.inf, "whole run"
    if mark:
        # the host-side ranges (the profiler mirrors each on the device's
        # timeline as a user annotation, which is not device work)
        starts = sorted(e.time_range.start for e in events if e.name == mark
                        and e.device_type == torch.autograd.DeviceType.CPU)
        check(len(starts) == n and n >= 3, f"profile: {len(starts)} {mark} ranges for {n} {unit}s")
        lo, hi, n = starts[1], starts[-1], n - 2
        wall_ms = (hi - lo) / 1e3 / n
        gaps = [round((b - a) / 1e3, 1) for a, b in zip(starts, starts[1:])]
        window = f"{unit}s 2-{n + 1} of {n_run}; ms between {unit} starts {gaps}"
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != mark and lo <= e.time_range.start < hi]
    if not device:
        print("profile: the profiler recorded no device events; device busy share not measured")
        return None
    kernels = collections.Counter()
    counts = collections.Counter()
    for e in device:
        kernels[e.name] += e.time_range.elapsed_us() / 1e3 / n
        counts[e.name] += 1
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy_ms = _union_ms(spans, max(lo, min(a for a, _ in spans)), hi) / n
    print(f"profile: {n} {unit}s ({window}) wall_ms_per_{unit}={wall_ms:.3f} "
          f"device_busy_ms_per_{unit}={busy_ms:.3f} device_idle_share={1 - busy_ms / wall_ms:.3f} "
          f"device_events_per_{unit}={len(device) / n:.1f}")
    for name, ms in kernels.most_common(10):
        print(f"profile device {ms:8.4f} ms/{unit} x{counts[name] // n:<3} {name[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:8]:
        print(f"profile host (whole run) {e.self_cpu_time_total / 1e3 / n_run:8.4f} ms/{unit} "
              f"x{e.count // n_run:<4} {e.key[:90]}")
    return busy_ms, wall_ms


def capped_config():
    from repro_torch.configs.dlrm_mlperf import CONFIG

    return dataclasses.replace(
        CONFIG, vocab_sizes=tuple(min(v, VOCAB_CAP) for v in CONFIG.vocab_sizes))


def phase_training(torch, dev):
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.core.metakernel import ExecutionStats
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg)                 # dedup capacity: rows x 26
    calibrate_output_layer(torch, params, cfg, plan, feed, dev)
    train_step, init = R.make_sparse_train_step(cfg, adamw(LR))
    opt = init(params)
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=TRAIN_ROWS, device=dev)
    step = feed.make_step(train_step, fence_cb=feeder.donation_fence)
    views = [gen_views(TRAIN_ROWS, seed=200 + i) for i in range(TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    print(f"training setup: {TRAIN_ROWS} rows/step, working set {TRAIN_ROWS * cfg.n_sparse:,} rows "
          f"x {cfg.embed_dim}, feed layout {plan.feed_layout().slot_names} = "
          f"{plan.feed_layout().arena_bytes(TRAIN_ROWS):,} arena bytes, "
          f"{time.perf_counter() - t0:.2f} s")

    # First batch: the FE output against the same plan with feature_hash
    # swapped for its plain version, the staged slots, then the kernel path
    # against the plain path (the interaction's forward and backward kernels
    # swapped for autograd of the plain forward) on the same inputs.
    env = plan.run(views[0], device=dev)
    with mock.patch.object(hash_ops, "run_hash_layer",
                           lambda cols, program: hash_layer_ref(cols, program=program)):
        env_plain = plan.run(views[0], device=dev)
    for k in plan.output_slots:
        check(torch.equal(env[k], env_plain[k]),
              f"{k} at {TRAIN_ROWS} rows: feature_hash kernel path != plain version")
    del env_plain
    staged = feeder.stage(env)
    for k in plan.output_slots:
        check(torch.equal(staged[k], env[k]), f"staged {k} != plan output")
    batch = feed.apply(feed.select(staged))
    plain_path = mock.patch.object(interaction_ops, "pairwise_dots", dot_interaction_ref)
    ws = R.sparse_grads(params, cfg, batch)
    with plain_path:
        ws_plain = R.sparse_grads(params, cfg, batch)
    n = int(ws.n_unique)
    check(torch.equal(ws.unique, ws_plain.unique), "working sets differ")
    loss, loss_plain = float(ws.loss), float(ws_plain.loss)
    check(math.isfinite(loss) and abs(loss - loss_plain) <= 1e-5 * abs(loss_plain),
          f"first-step loss {loss} vs plain path {loss_plain}")
    g, g_plain = ws.working_grad[:n], ws_plain.working_grad[:n]
    g_scale = float(g_plain.abs().max())
    g_err = float((g - g_plain).abs().max())
    g_nonzero = int((g.abs().amax(dim=1) > 0).sum())
    check(g_scale > 0 and g_err <= 1e-5 * g_scale,
          f"working-row gradients: max abs err {g_err} vs max {g_scale}")
    check(g_nonzero >= 0.99 * n, f"only {g_nonzero} of {n} working rows have a gradient")
    dense_rel = max(float((ws.dense_grads[k] - ws_plain.dense_grads[k]).abs().max())
                    / max(float(ws_plain.dense_grads[k].abs().max()), 1e-30)
                    for k in ws.dense_grads)
    del ws_plain

    ids = ws.unique[:n].to(torch.int64)
    dense_names = [k for k in params if k != "embed"]
    saved_rows = params["embed"][ids].clone()
    saved_accum = opt["embed_accum"][ids].clone()
    saved_dense = {k: params[k].clone() for k in dense_names}
    saved_moments = {m: {k: t.clone() for k, t in opt["dense"][m].items()} for m in ("m", "v")}
    saved_step = opt["dense"]["step"]
    with plain_path:
        params, opt, m_plain = train_step(params, opt, batch)
    rows_plain = params["embed"][ids].clone()
    params["embed"][ids] = saved_rows            # undo the plain step
    opt["embed_accum"][ids] = saved_accum
    for k in dense_names:
        params[k].copy_(saved_dense[k])
    for m in ("m", "v"):
        for k, t in saved_moments[m].items():
            opt["dense"][m][k].copy_(t)
    opt["dense"]["step"] = saved_step
    params, opt, m = step(params, opt, staged)  # the warm-up step, kernel path
    rows = params["embed"][ids]
    rows_err = float((rows - rows_plain).abs().max())
    rows_moved = float((rows - saved_rows).abs().max())
    check(rows_err <= 1e-6 and rows_moved > 0,
          f"updated working rows: kernel vs plain max abs err {rows_err}, moved {rows_moved}")
    check(abs(float(m["loss"]) - float(m_plain["loss"])) <= 1e-5 * abs(float(m_plain["loss"])),
          f"step loss {float(m['loss'])} vs plain path {float(m_plain['loss'])}")
    print(f"training first step: loss={loss:.6f} plain_loss={loss_plain:.6f} unique={n:,} "
          f"of {ws.n_ids:,} ids; working-row grad max_abs_err={g_err:.3e} max_abs={g_scale:.3e} "
          f"nonzero_rows={g_nonzero:,}/{n:,}; dense grads max rel err={dense_rel:.3e}; "
          f"updated rows max_abs_err={rows_err:.3e} (moved up to {rows_moved:.3e})")
    del ws, saved_rows, saved_accum, rows_plain

    _reset_launches()
    before = dataclasses.replace(feeder.stats)
    stats = ExecutionStats()
    losses, step_ms = [], []
    for views_i in views[1:1 + TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, feeder.stage(plan.run(views_i, device=dev, stats=stats)))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _read_launches()
    staged_batches = feeder.stats.batches - before.batches
    check(launches == {"feature_hash": 2 * TRAIN_STEPS, "interaction_dot": TRAIN_STEPS,
                       "interaction_dot_backward": TRAIN_STEPS, "mempool_alloc": staged_batches}
          and staged_batches == TRAIN_STEPS, f"training launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    per = 1e3 / TRAIN_STEPS
    fe_host = stats.host_seconds * per
    fe_dev = stats.device_seconds * per
    d2h = (feeder.stats.d2h_seconds - before.d2h_seconds) * per
    place = (feeder.stats.place_seconds - before.place_seconds) * per
    h2d = (feeder.stats.h2d_seconds - before.h2d_seconds) * per - d2h
    mean_ms = sum(step_ms) / TRAIN_STEPS
    print(f"training dlrm-mlperf steps={TRAIN_STEPS} rows={TRAIN_ROWS} losses={losses} "
          f"step_ms={[round(t, 3) for t in step_ms]} mean_ms={mean_ms:.3f} "
          f"median_ms={statistics.median(step_ms):.3f} launches={launches} "
          f"rows_per_s={TRAIN_ROWS * 1e3 / mean_ms:.0f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    print(f"training breakdown per step: fe_host_ops_ms={fe_host:.3f} "
          f"fe_device_ops_issue_ms={fe_dev:.3f} feed_d2h_roundtrip_ms={d2h:.3f} "
          f"feed_placement_ms={place:.3f} feed_h2d_issue_ms={h2d:.3f} "
          f"adapt_and_step_ms={mean_ms - fe_host - fe_dev - d2h - place - h2d:.3f}; "
          f"feeder {feeder.stats.summary()}; train feed {feed.stats.summary()}")

    def two_steps():
        nonlocal params, opt
        for views_i in views[1 + TRAIN_STEPS:]:
            params, opt, _ = step(params, opt, feeder.stage(plan.run(views_i, device=dev)))

    profile_device(torch, "step", 2, two_steps)
    return launches


def phase_embedding_bag(torch, dev):
    import numpy as np
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    # the full-width shape: a training batch's interest bag, its ids deduped
    # into a working set of U rows
    plan = featureplan.compile(get_spec("dlrm"))
    env = plan.run(gen_views(TRAIN_ROWS, seed=700), device=dev)
    unique, inverse = torch.unique(env["batch_seq_ids"], return_inverse=True)
    full = (inverse.to(torch.int32).contiguous(), env["batch_seq_mask"].contiguous(),
            unique.numel(), 128)
    del env
    gen = torch.Generator(device=dev).manual_seed(3)
    record, worst = None, 0.0
    for shape in BAG_SHAPES + (None,):
        if shape is None:
            ids, w, u, d = full
            b, l = ids.shape
        else:
            b, l, u, d = shape
            rng = np.random.default_rng(b * l + u)
            ids = torch.from_numpy(rng.integers(0, u, (b, l)).astype(np.int32)).to(dev)
            w = torch.from_numpy(((rng.random((b, l)) < 0.8) * rng.random((b, l)))
                                 .astype(np.float32)).to(dev)
        table = torch.randn((u, d), generator=gen, device=dev)
        got = bag_lookup(ids, w, table)
        want = embedding_bag_ref(ids, w, table)
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        check(err == 0 if l == 1 else err <= 1e-5 * scale,
              f"embedding_bag B={b} L={l} U={u} D={d}: max abs err {err} vs max {scale}")
        worst = max(worst, err)
        nnz = int((w != 0).sum())
        rows = int(torch.unique(ids[w != 0]).numel())   # distinct rows a live slot reads
        ms, c_ms = timings(torch, lambda: bag_lookup(ids, w, table))
        plain_ms, plain_c_ms = timings(torch, lambda: embedding_bag_ref(ids, w, table))
        ids64 = ids.to(torch.int64)
        library_ms, library_c_ms = timings(torch, lambda: torch.nn.functional.embedding_bag(
            ids64, table, mode="sum", per_sample_weights=w))
        # ids and weights read once, each distinct live row once, the output
        # written once; an FMA per live slot and column
        b_ms, b_by = bound(8 * b * l + 4 * d * rows + 4 * b * d, 2 * d * nnz, FP32_FLOPS)
        print(f"embedding_bag B={b:<5} L={l:<2} U={u:<6} D={d:<3} nnz={nnz:<7} rows={rows:<6} "
              f"max_abs_err={err:.3e} max_abs_out={scale:.3e} ms={ms:.5f} call_ms={c_ms:.5f} "
              f"plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.5f} library_call_ms={library_c_ms:.5f} "
              f"bound_ms={b_ms:.6f} ({b_by})")
        if shape is None:
            record = {"name": "embedding_bag", "route": "cuda",
                      "source": "src/repro_torch/csrc/embedding_bag.cu",
                      "replaces": "src/repro/kernels/embedding_bag/kernel.py:61",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "call_ms": c_ms, "plain_call_ms": plain_c_ms,
                      "library_call_ms": library_c_ms,
                      "shape": f"B={b} L={l} U={u} D={d} nnz={nnz} rows={rows}: a training batch's "
                               f"interest bag over its deduped working set"}
            # its path: one call of the entry point at the full-width shape
            bag_lookup.launches = 0
            bag_lookup(ids, w, table)
            launches = {"embedding_bag": bag_lookup.launches}
            check(launches["embedding_bag"] == 1, f"bag_lookup launches {launches}")
        del ids, w, table, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()

    # the share of the bound past the L2: a 512 MiB table, uniform ids, 80 %
    # of slots live at random weights, ids and weights rotated over 3 blocks
    b, l, u, d = BAG_HBM_SHAPE
    table = torch.randn((u, d), generator=gen, device=dev)
    rng = np.random.default_rng(b * l + u)
    blocks = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, u, (b, l)).astype(np.int32)).to(dev)
        w = torch.from_numpy(((rng.random((b, l)) < 0.8) * rng.random((b, l)))
                             .astype(np.float32)).to(dev)
        blocks.append((ids, w, ids.to(torch.int64)))
    ids, w, _ = blocks[0]
    got = bag_lookup(ids, w, table)
    want = embedding_bag_ref(ids, w, table)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 1e-5 * scale,
          f"embedding_bag B={b} L={l} U={u} D={d}: max abs err {err} vs max {scale}")
    del got, want
    record["max_abs_err"] = max(worst, err)
    rows = [int(torch.unique(i[x != 0]).numel()) for i, x, _ in blocks]
    nnz = [int((x != 0).sum()) for _, x, _ in blocks]
    # as above, averaged over the blocks the calls cycle through
    b_ms, b_by = bound(8 * b * l + 4 * d * statistics.mean(rows) + 4 * b * d,
                       2 * d * statistics.mean(nnz), FP32_FLOPS)
    rotation, lib_rotation = itertools.cycle(blocks), itertools.cycle(blocks)

    def kernel():
        ids, w, _ = next(rotation)
        return bag_lookup(ids, w, table)

    def library():
        _, w, ids64 = next(lib_rotation)
        return torch.nn.functional.embedding_bag(ids64, table, mode="sum", per_sample_weights=w)

    ms, library_ms = device_ms(torch, kernel), device_ms(torch, library)
    share = b_ms / ms
    check(share <= 1.0, f"embedding_bag B={b} U={u}: {share:.3f} of its bound, above 100 %: "
                        "the timing or the count is wrong")
    shape = (f"B={b} L={l} U={u} D={d}, uniform ids, 80 % live; ids and weights rotated "
             f"over {len(blocks)} blocks, rows={rows}: past the L2")
    print(f"embedding_bag {shape} max_abs_err={err:.3e} max_abs_out={scale:.3e} ms={ms:.7f} "
          f"bound_ms={b_ms:.7f} ({b_by}) share_of_bound={share:.3f} "
          f"library_ms={library_ms:.7f} vs_library={ms / library_ms:.3f}")
    record.update({"share_of_bound": share, "share_of_bound_shape": shape, "hbm_ms": ms,
                   "hbm_bound_ms": b_ms, "hbm_library_ms": library_ms,
                   "hbm_vs_library": ms / library_ms})
    del table, blocks, rotation, lib_rotation, ids, w
    torch.cuda.empty_cache()
    return record, launches


def _reset_launches():
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.mempool_alloc import ops as alloc_ops

    hash_ops.run_hash_layer.launches = 0
    interaction_ops.pairwise_dots.launches = 0
    interaction_ops.pairwise_dots_backward.launches = 0
    alloc_ops.alloc_offsets.launches = 0


def _read_launches():
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.mempool_alloc import ops as alloc_ops

    return {"feature_hash": hash_ops.run_hash_layer.launches,
            "interaction_dot": interaction_ops.pairwise_dots.launches,
            "interaction_dot_backward": interaction_ops.pairwise_dots_backward.launches,
            "mempool_alloc": alloc_ops.alloc_offsets.launches}


STEP_MARK = "chip_smoke.step"


def marked_steps(torch):
    """Patch ``make_sparse_train_step`` so that every step it builds opens a
    ``record_function`` range named :data:`STEP_MARK` (the profiler's
    steady-state window)."""
    from repro_torch.models import recsys as R

    real = R.make_sparse_train_step

    def make(cfg, opt):
        raw, init = real(cfg, opt)

        def step(*a):
            with torch.profiler.record_function(STEP_MARK):
                return raw(*a)
        return step, init

    return mock.patch.object(R, "make_sparse_train_step", make)


def phase_streaming(torch, dev):
    from repro_torch.configs import get_arch
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.core.metakernel import run_layers
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.shardfmt import ShardReader
    from repro_torch.io.stream import StreamingLoader
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    spec = get_arch("dlrm-mlperf")
    data_dir = tempfile.mkdtemp(prefix="fbshards_")
    ckpt_dir = tempfile.mkdtemp(prefix="fbckpt_")
    switch_interval = sys.getswitchinterval()
    try:
        t0 = time.perf_counter()
        write_log_shards(data_dir, n_shards=STREAM_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        shard_mib = sum(e.nbytes for e in ShardDataset(data_dir).shards) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
        opt = adamw(LR)
        params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        plan = featureplan.compile(get_spec("dlrm"))
        calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
        _, init = R.make_sparse_train_step(cfg, opt)
        state = {"params": params, "opt": init(params)}
        torch.cuda.synchronize()
        print(f"streaming setup: {STREAM_SHARDS} shards x {TRAIN_ROWS} rows ({shard_mib:.1f} MiB) "
              f"in {data_dir}, full-width params, {time.perf_counter() - t0:.2f} s")

        def args(steps, *extra):
            # --fault-tolerant: shards in plan order, so every run sees the
            # same batches
            return train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir,
                                     "--spec", "dlrm", "--device-feed", "arena",
                                     "--fault-tolerant", "--steps", str(steps),
                                     "--device", dev.type, *extra])

        # the slice-2 plain loop's loss on the loader's first shard with
        # these params (copy feed, one thread)
        first = ShardDataset(data_dir).epoch_order(0, shuffle=True, seed=0)[0]
        mf_plain = plan.model_feed(cfg, rows_hint=TRAIN_ROWS)
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=TRAIN_ROWS, device=dev)
        staged = feeder.stage(plan.run(ShardReader(first.path).read_all(plan.required_columns),
                                       device=dev))
        loss_plain = float(R.sparse_grads(state["params"], mf_plain.config,
                                          mf_plain.apply(mf_plain.select(staged))).loss)
        feeder.donation_fence()
        del staged, feeder
        _, warm = train.run_streaming(args(1), spec, cfg, state, opt)   # warm-up step
        check(abs(warm[0] - loss_plain) <= 1e-6 * abs(loss_plain),
              f"first streaming loss {warm[0]} vs the plain loop's {loss_plain}")

        def serial(steps=TRAIN_STEPS):
            """The runner's work in one thread, in series: the same loader
            (its reader threads, --fault-tolerant order), the arena
            binding's FE layers and feeder, the same sparse step. Timed like
            the runner's wall: from the first batch's read to the last
            step's sync."""
            nonlocal state
            a = args(steps)
            loader = StreamingLoader(ShardDataset(data_dir), workers=a.stream_workers,
                                     prefetch=a.stream_prefetch, epochs=1, shuffle=True,
                                     seed=0, columns=plan.required_columns, ordered=True)
            ab = plan.arena_binding(split_sparse_fields=True)
            mf = plan.model_feed(dataclasses.replace(cfg, dedup_capacity=0),
                                 split_sparse_fields=True, rows_hint=loader.rows_hint)
            feeder = ab.make_feeder(rows_hint=loader.rows_hint, device=dev)
            step = mf.make_step(R.make_sparse_train_step(mf.config, opt)[0],
                                fence_cb=feeder.donation_fence)
            _reset_launches()
            losses, batches = [], iter(loader)
            t0 = time.perf_counter()
            try:
                for raw in itertools.islice(batches, steps):
                    env = dict(raw)
                    run_layers(ab.layers, env, device=dev)
                    p, o, m = step(state["params"], state["opt"], feeder.stage(env))
                    state = {"params": p, "opt": o}
                    losses.append(float(m["loss"]))
                feeder.flush()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / steps
            finally:
                batches.close()
                loader.close()
            return ms, losses, _read_launches()

        def streaming():
            _reset_launches()        # the main path: counts from 0, read just after
            t0 = time.perf_counter()
            stats, losses = train.run_streaming(args(TRAIN_STEPS), spec, cfg, state, opt)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            return stats.wall_seconds * 1e3 / stats.batches, losses, _read_launches(), stats, call_ms

        # runs in turns; then the GIL probe: the same turns with the
        # interpreter's switch interval cut from 5 ms to 0.5 ms
        order = ("serial", "stream", "stream", "serial", "serial", "stream",
                 "stream@0.5ms", "serial@0.5ms", "serial@0.5ms", "stream@0.5ms")
        runs = []
        for kind in order:
            if kind.endswith("@0.5ms"):
                sys.setswitchinterval(5e-4)
            res = serial() if kind.startswith("serial") else streaming()
            runs.append((kind,) + res)
            check(len(res[1]) == TRAIN_STEPS and all(math.isfinite(x) for x in res[1]),
                  f"{kind} losses {res[1]}")
        sys.setswitchinterval(switch_interval)
        per_step = {"feature_hash": 2, "interaction_dot": 1, "interaction_dot_backward": 1,
                    "mempool_alloc": 1}
        for kind, ms, losses, launches, *rest in runs:
            check(launches == {k: n * TRAIN_STEPS for k, n in per_step.items()},
                  f"{kind} launches {launches}")
            line = (f"streaming run={kind} steps={TRAIN_STEPS} wall_ms_per_step={ms:.3f} "
                    f"losses={[round(x, 5) for x in losses]} launches={launches}")
            if rest:
                s, call_ms = rest
                f = s.feed
                line += (f" call_ms_per_step={call_ms:.3f} "
                         f"train_ms_per_step={s.train_seconds * 1e3 / s.batches:.3f} "
                         f"fe_seconds={s.fe_seconds:.4f} train_seconds={s.train_seconds:.4f} "
                         f"adapt_seconds={s.adapt_seconds:.4f} wall_seconds={s.wall_seconds:.4f} "
                         f"overlap_seconds={s.overlap_seconds:.4f} "
                         f"overlap_fraction={s.overlap_fraction:.4f} "
                         f"fe_host_ops_s={s.exec_stats.host_seconds:.4f} "
                         f"fe_device_issue_s={s.exec_stats.device_seconds:.4f} "
                         f"feed_copies_elided={f.copies_elided} feed_d2h_s={f.d2h_seconds:.4f} "
                         f"feed_place_s={f.place_seconds:.4f} feed_h2d_s={f.h2d_seconds:.4f} "
                         f"feed_stall_s={f.stall_seconds:.4f} fresh_arenas={f.fresh_arenas} "
                         f"ingest_consumer_stall_s={s.ingest.consumer_stall_seconds:.4f}")
            print(line)
        by_kind = collections.defaultdict(list)
        for kind, ms, *_ in runs:
            by_kind[kind].append(round(ms, 3))
        print(f"streaming vs serial loop, wall ms per step (same loader, feed and step; "
              f"order {', '.join(order)}): {dict(by_kind)} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
        launches = runs[1][3]
        # each loop over one epoch (10 steps) under the profiler; beside it
        # the idle share that its device time gives at the unprofiled wall
        with marked_steps(torch):
            profiled = {"serial": profile_device(torch, "step", STREAM_SHARDS,
                                                 lambda: serial(STREAM_SHARDS), mark=STEP_MARK),
                        "stream": profile_device(torch, "step", STREAM_SHARDS,
                                                 lambda: train.run_streaming(
                                                     args(STREAM_SHARDS), spec, cfg, state, opt),
                                                 mark=STEP_MARK)}
        for kind, res in profiled.items():
            if res is not None:
                wall = statistics.median(by_kind[kind])
                print(f"streaming idle share of {kind}: device busy {res[0]:.3f} ms/step "
                      f"(profiled) over its unprofiled median wall {wall:.3f} ms/step = "
                      f"{1 - res[0] / wall:.3f}")
        del state, params
        torch.cuda.empty_cache()

        # checkpoint round trip at the smoke config (a full-width save is 26 GiB)
        smoke = spec.smoke()
        small = {"params": R.init_params(smoke, torch.Generator(device=dev).manual_seed(1))}
        small["opt"] = R.make_sparse_train_step(smoke, opt)[1](small["params"])
        _, losses = train.run_streaming(
            args(4, "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2"),
            spec, smoke, small, opt)
        fresh = {"params": R.init_params(smoke, torch.Generator(device=dev).manual_seed(2))}
        fresh["opt"] = R.make_sparse_train_step(smoke, opt)[1](fresh["params"])
        step_no, fresh = CheckpointManager(ckpt_dir).restore_latest(fresh)
        same = all(torch.equal(fresh["params"][k], v) for k, v in small["params"].items())
        same = same and torch.equal(fresh["opt"]["embed_accum"], small["opt"]["embed_accum"])
        check(step_no == 3 and same and fresh["opt"]["dense"]["step"] == 4,
              f"checkpoint round trip: step {step_no}, equal {same}")
        print(f"checkpoint round trip (smoke config): saved steps 1 and 3, restored step "
              f"{step_no} equal to the trained state; losses={[round(x, 5) for x in losses]}")
    finally:
        sys.setswitchinterval(switch_interval)
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # fp32 matmuls stay in full fp32 (the default); the kernel-vs-plain
    # comparisons and the JAX parity tolerances assume it
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    result = build.build()
    build.library()
    print(f"build: {result.library.relative_to(ROOT)} in {result.seconds:.2f} s")
    for ln in result.ptxas_log.splitlines():
        if "Function properties" in ln or "spill" in ln or "registers" in ln:
            print(f"ptxas: {ln.strip()}")
    clean = "0 bytes spill stores, 0 bytes spill loads"
    for kernel, want in (("dot_interaction_kernel", clean), ("dot_interaction_bwd_kernel", clean),
                         ("hash_layer_kernel", "0 bytes stack frame, " + clean),
                         ("alloc_offsets_kernel", "0 bytes stack frame, " + clean)):
        spills = [ln for ln in build.ptxas_lines(result.ptxas_log, kernel) if "spill" in ln]
        check(bool(spills) and all(want in ln for ln in spills),
              f"{kernel} has a stack frame, spills or has no ptxas report: {spills}")

    records = {"feature_hash": phase_feature_hash(torch, dev),
               "interaction_dot": phase_interaction_dot(torch, dev),
               "interaction_dot_backward": phase_interaction_bwd(torch, dev),
               "mempool_alloc": phase_mempool_alloc(torch, dev)}
    records["embedding_bag"], bag_launches = phase_embedding_bag(torch, dev)
    by_path = {"serve": phase_end_to_end(torch, dev)}
    torch.cuda.empty_cache()                    # each full-width phase frees its table
    by_path["train"] = phase_training(torch, dev)
    torch.cuda.empty_cache()
    by_path["stream"] = phase_streaming(torch, dev)
    by_path["bag_lookup"] = bag_launches
    for name, rec in records.items():
        # the streaming path runs four of the kernels; embedding_bag's count
        # is its own entry point's; each record is timed at its path's shape
        main_path = "bag_lookup" if name == "embedding_bag" else "stream"
        rec["launches"] = by_path[main_path][name]
        rec["launches_by_path"] = {path: n[name] for path, n in by_path.items() if name in n}
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
