"""Arena/donation aliasing analysis (AL2xx): static interference checks.

Audits the block-planned staging arena (paper §V, Alg. 1) **without
staging anything**: given a :class:`~repro_torch.core.devicefeed.
FeedLayout` (or raw slot byte sizes and a placement), it proves the slot
intervals can never overlap, stay 128-byte aligned, fit int32 offsets, and
that every planner in the package — the host prefix sum
(:func:`repro_torch.core.mempool.plan_offsets` via ``FeedLayout.plan``),
the ``mempool_alloc`` CUDA kernel
(:func:`repro_torch.kernels.mempool_alloc.ops.plan_block`, on the card
unless the caller asks for the CPU, where it takes the plain version), and
the runtime :class:`~repro_torch.core.mempool.ArenaPool` — agrees with the
analyzer's own shadow plan. A disagreement is exactly the bug class of a
silent int32 divergence in ``plan_block``. The kernel oracle is part of the
audit: a kernel that fails to build or launch is an analyzer crash, never a
skipped oracle.

The donation-safety pass models claim lifetimes on the buffer ring: batch
``k`` occupies ring slot ``k % buffers`` from stage until its consumer
completes, and rewinding that slot for batch ``k + buffers`` awaits batch
``k``'s completion — for a donated batch, the ``seq``-th donation fence.
The pass proves the fence the feeder waits on can always have been
registered given the feed queue's capacity (otherwise the port's
:class:`~repro_torch.core.devicefeed.DeviceFeeder` finds every arena
unfenced and allocates a fresh one, ``FeedStats.fresh_arenas``, where the
JAX feeder stalls until its fence timeout).

Rules
-----
``AL201`` (error)   — two slot intervals overlap in the arena plan.
``AL202`` (error)   — a slot offset or the arena total violates the layout
    alignment (the typed views of the staged arena depend on it).
``AL203`` (error)   — sizes negative or the aligned total exceeds int32
    (the planners' offset dtype): silent wrap territory.
``AL204`` (error)   — planner disagreement: prefix-sum plan, kernel plan,
    ArenaPool block allocation, and the analyzer's shadow plan must place
    every slot identically.
``AL205`` (warning) — ring under-provisioned: fewer buffers than the
    pipeline's concurrent claim lifetimes (writer + feed queue +
    consumer), so staging serializes on the completion gate.
``AL206`` (error)   — donated-buffer reclaim can await a donation fence
    the consumer cannot yet have registered (every batch then stages into
    a freshly allocated arena).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.check.findings import Finding
from repro_torch.core.mempool import ALIGN, ArenaPool, align_up
from repro_torch.device import DeviceLike
from repro_torch.kernels.mempool_alloc.ops import plan_block

_I32_MAX = np.iinfo(np.int32).max


def _shadow_plan(sizes: Sequence[int], align: int) -> Tuple[List[int], int]:
    """The analyzer's own Alg. 1 oracle: exclusive prefix sum of aligned
    sizes, in plain Python ints (no dtype to overflow)."""
    offsets: List[int] = []
    off = 0
    for n in sizes:
        offsets.append(off)
        off += align_up(int(n), align)
    return offsets, off


# ------------------------------------------------------------ plan auditing
def check_plan(sizes: Sequence[int], offsets: Sequence[int], total: int,
               *, align: int = ALIGN, names: Optional[Sequence[str]] = None,
               location: str = "block-plan") -> List[Finding]:
    """Audit one concrete placement (slot sizes + offsets + arena total)."""
    findings: List[Finding] = []
    sizes = [int(n) for n in sizes]
    offsets = [int(o) for o in offsets]
    names = list(names) if names is not None else [
        f"slot{i}" for i in range(len(sizes))]
    if len(offsets) != len(sizes):
        return [Finding(
            rule="AL204", severity="error", location=location,
            message=(f"plan has {len(offsets)} offsets for "
                     f"{len(sizes)} slots"),
            hint="regenerate the plan from the layout's slot list")]

    for name, n in zip(names, sizes):
        if n < 0:
            findings.append(Finding(
                rule="AL203", severity="error", location=location,
                message=f"slot {name!r} has negative size {n}",
                hint="slot sizes are rows*width*itemsize; check the layout"))
    if any(n < 0 for n in sizes):
        return findings

    aligned_total = sum(align_up(n, align) for n in sizes)
    if aligned_total > _I32_MAX:
        findings.append(Finding(
            rule="AL203", severity="error", location=location,
            message=(f"aligned arena total {aligned_total} overflows int32 "
                     f"(planner offset dtype)"),
            hint="split the batch or widen the planner to int64"))

    # Alignment of every slot start and of the declared total.
    for name, off in zip(names, offsets):
        if off % align:
            findings.append(Finding(
                rule="AL202", severity="error", location=location,
                message=(f"slot {name!r} starts at offset {off}, not "
                         f"{align}-byte aligned"),
                hint="offsets must be multiples of the layout alignment"))
    if int(total) % align:
        findings.append(Finding(
            rule="AL202", severity="error", location=location,
            message=f"arena total {total} is not {align}-byte aligned",
            hint="round the arena capacity up to the alignment"))

    # Interval disjointness + containment, in offset order.
    order = sorted(range(len(sizes)), key=lambda i: offsets[i])
    for a, b in zip(order, order[1:]):
        end_a = offsets[a] + sizes[a]
        if end_a > offsets[b]:
            findings.append(Finding(
                rule="AL201", severity="error", location=location,
                message=(f"slots {names[a]!r} [{offsets[a]}, {end_a}) and "
                         f"{names[b]!r} [{offsets[b]}, "
                         f"{offsets[b] + sizes[b]}) overlap"),
                hint="a staged write to one slot corrupts the other; "
                     "re-plan with disjoint intervals"))
    if order:
        last = order[-1]
        if offsets[last] + sizes[last] > int(total):
            findings.append(Finding(
                rule="AL201", severity="error", location=location,
                message=(f"slot {names[last]!r} ends at "
                         f"{offsets[last] + sizes[last]}, past the arena "
                         f"total {total}"),
                hint="the last slot overruns the arena; grow the capacity"))
    return findings


def check_agreement(plans: Dict[str, Tuple[Sequence[int], int]],
                    *, location: str = "block-plan") -> List[Finding]:
    """AL204: every planner must produce the identical placement."""
    findings: List[Finding] = []
    items = sorted(plans.items())
    ref_name, (ref_offsets, ref_total) = items[0]
    ref_offsets = [int(o) for o in ref_offsets]
    for name, (offsets, total) in items[1:]:
        offsets = [int(o) for o in offsets]
        if offsets != ref_offsets or int(total) != int(ref_total):
            findings.append(Finding(
                rule="AL204", severity="error", location=location,
                message=(f"planner {name!r} places slots at {offsets} "
                         f"(total {total}), but {ref_name!r} places them at "
                         f"{ref_offsets} (total {ref_total})"),
                hint="planners diverged (the silent int32 bug class); fix "
                     "whichever disagrees with the aligned prefix sum"))
    return findings


def check_feed_layout(layout, rows: int, *, location: str = "feed-layout",
                      device: DeviceLike = None) -> List[Finding]:
    """Audit a FeedLayout's placement for ``rows``-row batches against
    every planner in the package (tri-oracle + the analyzer's shadow plan);
    the kernel planner runs on ``device`` (the card unless the caller asks
    for ``"cpu"``)."""
    sizes = layout.sizes(rows)
    names = list(layout.slot_names)
    align = layout.align
    shadow_offsets, shadow_end = _shadow_plan(sizes, align)
    shadow_total = align_up(shadow_end, align)

    findings = check_plan(sizes, shadow_offsets, shadow_total,
                          align=align, names=names, location=location)
    if any(f.rule == "AL203" for f in findings):
        # The real planners raise OverflowError here by design; the static
        # finding already reports the hazard.
        return findings

    plans: Dict[str, Tuple[Sequence[int], int]] = {
        "shadow": (shadow_offsets, shadow_total)}
    offsets, total = layout.plan(rows)
    plans["plan_offsets"] = (list(np.asarray(offsets)), int(total))
    k_offsets, k_total = plan_block(sizes, align=align, device=device)
    plans["mempool_kernel"] = (list(np.asarray(k_offsets)), int(k_total))
    pool = ArenaPool(shadow_total, align=align)
    allocs = pool.alloc_block(sizes)
    plans["arena_pool"] = ([a.offset for a in allocs], shadow_total)

    findings += check_agreement(plans, location=location)
    for name, (offs, total) in sorted(plans.items()):
        if name == "shadow":
            continue
        findings += check_plan(sizes, offs, total, align=align, names=names,
                               location=f"{location}/{name}")
    return findings


# ----------------------------------------------------- ring/donation safety
def check_ring(layout, rows: int, *, buffers: int,
               queue_capacity: Optional[int] = None, donate: bool = True,
               location: str = "feed-ring") -> List[Finding]:
    """Audit the buffer ring's claim-lifetime plan for a pipeline run.

    ``queue_capacity`` defaults to the :class:`~repro_torch.core.pipeline.
    PipelinedRunner` bound ``max(1, buffers - 2)``. The lifetime model:
    staging batch ``k`` rewinds ring slot ``k % buffers``, which requires
    batch ``k - buffers`` complete; the queue bound guarantees the
    consumer has dequeued at least ``k - queue_capacity - 1`` batches at
    that point.
    """
    findings: List[Finding] = []
    if queue_capacity is None:
        queue_capacity = max(1, buffers - 2)
    if buffers < 1:
        return [Finding(
            rule="AL205", severity="error", location=location,
            message=f"ring needs at least one buffer, got {buffers}",
            hint="DeviceFeeder(buffers=...) must be >= 1")]

    # AL205: steady state wants one buffer being written, queue_capacity
    # staged-but-unconsumed, and one held by the consumer.
    lifetimes = 1 + queue_capacity + 1
    if buffers < lifetimes:
        findings.append(Finding(
            rule="AL205", severity="warning", location=location,
            message=(f"{buffers} ring buffer(s) for {lifetimes} concurrent "
                     f"claim lifetimes (1 staging + {queue_capacity} queued "
                     f"+ 1 held by the consumer): every claim waits on the "
                     f"completion gate"),
            hint="size buffers >= queue_capacity + 2 to overlap staging"))

    # AL206: reclaiming slot (k % buffers) for batch k awaits the fence of
    # batch k - buffers; the consumer has provably dequeued (and fenced)
    # batches up to k - queue_capacity - 1 when the feeder stages batch k.
    if donate and buffers < queue_capacity + 1:
        findings.append(Finding(
            rule="AL206", severity="error", location=location,
            message=(f"donated-buffer reclaim of batch k awaits fence "
                     f"seq k-{buffers}, but with a {queue_capacity}-deep "
                     f"feed queue the consumer has only registered fences "
                     f"through k-{queue_capacity + 1}: every reclaim "
                     f"finds its arena unfenced and allocates a fresh one"),
            hint="size buffers >= queue_capacity + 1 (PipelinedRunner's "
                 "maxsize=max(1, buffers-2) satisfies this for buffers>=2)"))

    # The ring stages real bytes: its per-buffer plan inherits the block
    # plan's invariants for this row count.
    if rows >= 0:
        try:
            arena = layout.arena_bytes(rows)
        except OverflowError:
            arena = None
        if arena is not None and arena * buffers > _I32_MAX:
            findings.append(Finding(
                rule="AL203", severity="warning", location=location,
                message=(f"{buffers} x {arena}-byte arenas exceed int32 "
                         f"total host staging bytes"),
                hint="large but legal (buffers are independent allocations);"
                     " consider fewer buffers or smaller batches"))
    return findings
