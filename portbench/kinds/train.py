"""The ``train`` kind: the program's sparse train step on pre-extracted
batches, driven by its own training loop.

Set-up makes the weights and the batches from the seed, builds ONE step
object with its optimizer state (``repro_torch.models.recsys.
make_sparse_train_step`` with ``repro_torch.train.optimizer.adamw``), and
drives it through ``repro_torch.train.loop.run_training`` over the mix's
``check_steps`` first batches (the reference follows these), then
``warmup_steps`` more. The window hands that same object and feed to
``run_training`` again until ``--seconds`` have passed: a step runs from
its batch's request to the loss read that ends it (the loop reads every
step's loss to the host, which synchronizes).

For the check, set-up keeps what the program's state says after the first
step (AdamW's first moments; the Adagrad accumulators of the first batch's
rows) and after ``check_steps`` steps (the dense params; the rows the steps
touched), in host memory. Once the window has closed and the program's
state is freed, the weights are made again from the seed and the reference
follows the same steps.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import devtrace, judge, program, reference, traffic, weights
from portbench.harness import (Feed, KindResult, Stopwatch, WindowClosed, free_device,
                               memory_peak, sync)

ENDLESS = 1 << 62


def _step(cell):
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    od, oe = cell.mix["optimizer"]["dense"], cell.mix["optimizer"]["embed"]
    opt = adamw(od["lr"], b1=od["b1"], b2=od["b2"], eps=od["eps"],
                weight_decay=od["weight_decay"], clip_norm=od["clip_norm"])
    return R.make_sparse_train_step(program.recsys_config(cell.config), opt,
                                    embed_lr=oe["lr"], embed_eps=oe["eps"])


def p95(values) -> float:
    """The 95th percentile, linear between the two nearest ranks."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run(cell, seed: int, seconds: float, trace: bool, device, on_window_closed) -> KindResult:
    from repro_torch.train.loop import LoopConfig, run_training

    cfg, mix, model = cell.config, cell.mix, cell.model
    opt = mix["optimizer"]
    sw = Stopwatch()
    params = weights.make(cfg, model, seed, device)
    sync(device)
    sw.mark("weights")
    batches = traffic.make_batches(cfg, mix, seed, device)
    sw.mark("batches")
    step, init = _step(cell)
    state = {"params": params, "opt": init(params)}
    del params
    losses = []

    def train_step(st, batch):
        p, o, m = step(st["params"], st["opt"], batch)
        state.update(params=p, opt=o)
        losses.append(m["loss"])
        return state, m

    feed = Feed(batches, device)

    def steps(n: int, source=feed) -> None:
        run_training(cfg=LoopConfig(n_steps=n), state=state, train_step=train_step,
                     batch_source=source)

    k = int(mix["check_steps"])
    offs = weights.offsets(cfg)
    with sw.exclude():
        ids = [traffic.global_ids(cfg, b["sparse"].to(device), offs) for b in batches[:k]]
        first_rows = torch.unique(ids[0])
        union = torch.unique(torch.cat([i.reshape(-1) for i in ids]))
        del ids
    steps(1)
    sw.mark("first step")
    with sw.exclude():
        adam_m = {n: v.detach().to("cpu", copy=True)
                  for n, v in state["opt"]["dense"]["m"].items()}
        accum1 = state["opt"]["embed_accum"][first_rows].cpu()
        rows1 = state["params"]["embed"][first_rows].cpu()
    steps(k - 1)
    with sw.exclude():
        dense_k = {n: v.detach().to("cpu", copy=True)
                   for n, v in state["params"].items() if n != "embed"}
        rows_k = state["params"]["embed"][union].cpu()
        prog_losses = [float(x) for x in losses[:k]]
    steps(int(mix["warmup_steps"]))
    sync(device)
    sw.mark("later steps")
    setup_end = time.perf_counter()

    times, first = [], len(losses)

    def window_source(i):
        now = time.perf_counter()
        times.append(now)
        if now - times[0] >= seconds:
            raise WindowClosed
        return feed(i)

    try:
        steps(ENDLESS, window_source)
    except WindowClosed:
        pass
    n = len(times) - 1
    if n == 0:
        raise RuntimeError(f"the window of {seconds} s ran no step")
    window_s = times[-1] - times[0]
    step_s = [b - a for a, b in zip(times, times[1:])]
    failed = int((~torch.isfinite(torch.stack(losses[first:first + n]))).sum())
    on_window_closed()

    summary = None
    if trace:
        units = int(mix["trace_units"])

        def traced_source(i):
            with torch.profiler.record_function(devtrace.MARK):
                return feed(i)

        def segment():
            steps(units + 2, traced_source)
            sync(device)

        summary = devtrace.capture(segment, units, device)
    peak = memory_peak(device)

    del state, step, init, losses
    free_device(device)
    p0 = weights.make(cfg, model, seed, device)
    rows0 = p0.pop("embed")[union]
    free_device(device)
    prog = reference.TrainReadings(
        losses=prog_losses,
        grad=reference.grad_from_state(
            adam_m, opt["dense"]["b1"], rows0[torch.searchsorted(union, first_rows)],
            rows1.to(device), accum1.to(device), opt["embed"]["lr"], opt["embed"]["eps"]),
        change={n: reference.norm(v.to(device) - p0[n]) for n, v in dense_k.items()})
    prog.change["embed"] = reference.norm(rows_k.to(device) - rows0)
    ref = reference.train(model, cfg, opt, p0, rows0, union, batches[:k], device)
    rows = int(mix["rows"])
    return KindResult(
        setup_end=setup_end, setup_parts=sw.parts, excluded_s=sw.excluded,
        end_to_end={"train_examples_per_s": n * rows / window_s,
                    "train_step_p95_ms": p95(step_s) * 1e3},
        attempted=n, failed=failed, memory_peak_bytes=peak,
        numbers=judge.train_numbers(prog, ref),
        window={"units": n, "seconds": window_s, "rows": rows}, trace=summary,
        detail=judge.train_detail(prog, ref))
