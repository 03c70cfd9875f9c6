"""Static plan verifier (PV1xx): abstract flow over a compiled FeaturePlan.

Replays a plan's layer executables on environments of ``meta`` tensors
(shapes and dtypes, no storage) — each fused super-layer's ``fused_fn``
run on them, as the JAX package runs ``jax.eval_shape`` over its jit, the
``feature_hash`` kernel through its wrapper's meta branch, host-op outputs
synthesized from the spec's column table — so dtype/shape flow, placement
legality, the OutputLayout contract, projection completeness, and the
ModelFeed remap bounds are all proven **without executing a single batch**
(host ops run numpy and cannot be traced; their output shapes are fully
determined by the spec, which is what the synthesis rules encode).

The flow's dtypes are those of the JAX package's abstract flow, slot for
slot: a host slot keeps the dtype it is synthesized with, and a device op's
output takes the layout's (``tests/test_torch_check.py`` states the map,
the identity).

Rules
-----
``PV101`` (error) — OutputLayout contract violation: a ``feed_slots()``
    slot the plan never produces, a produced ``batch_*`` output the layout
    does not declare, or a shape/dtype mismatch between the abstract flow
    and the declared (width, dtype, rank).
``PV102`` (error) — placement-boundary illegality: a host-placed op inside
    a coalesced SuperLayer (host ops may only ride at the super-layer's
    first member layer; anywhere deeper, the fused device dispatch would
    have to stop mid-flight for a host barrier the executor never takes).
``PV103`` (error) — abstract flow failure: a device input slot no host op
    synthesis rule nor earlier executable produces, a slot produced twice,
    or a fused jit that fails shape tracing.
``PV104`` (error) — projection incompleteness: ``plan.required_columns``
    is missing a column the compiled spec reads; the loader's projection
    pushdown would hand the pipeline a batch with the column never decoded.
``PV105`` (error) — ModelFeed remap out of bounds: a model sparse field
    without a vocab-modulo entry, a nonpositive modulo, a modulo larger
    than the embedding table it indexes, or a field source outside the
    spec's field range — each means ids can index past the table.
``PV106`` (error) — feed contract mismatch: the train feed consumes a slot
    the staging layout does not provide.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.check.findings import Finding
from repro_torch.fe import compiler
from repro_torch.fe.schema import ColType
from repro_torch.fe.spec import Sequence as SeqTransform


def abstract(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (a numpy or torch dtype):
    the port's ``jax.ShapeDtypeStruct``."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, np.dtype(dtype).name)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ----------------------------------------------------- abstract environment
def _host_slot_rules(spec) -> Tuple[Dict[str, object], Dict[str, object],
                                    Dict[str, int]]:
    table = compiler._column_table(spec)
    seqs = {t.name: t for t in spec.transforms
            if isinstance(t, SeqTransform)}
    merge_widths = {f"{m.prefix}dense": len(m.columns) for m in spec.merges}
    return table, seqs, merge_widths


def _abstract_host_slot(slot: str, rows: int, spec, table, seqs,
                        merge_widths) -> Optional[torch.Tensor]:
    """Abstract value of one host-op-produced slot, from the spec alone.

    Encodes the compiler's host-op output contracts: ``to_device`` emits
    float32 for FLOAT columns and the label, int64 otherwise;
    ``extract_text`` emits int64 ids + float32 masks at the sequence's
    ``max_len``; ``merge_<view>`` emits a float32 [rows, n_columns] block.
    """
    if slot.endswith("_col"):
        base = slot[: -len("_col")]
        rc = table.get(base)
        if rc is None:
            return None
        if base == spec.label or rc.ctype == ColType.FLOAT:
            return abstract((rows,), np.float32)
        return abstract((rows,), np.int64)
    if slot.endswith("_ids") and slot[: -len("_ids")] in seqs:
        t = seqs[slot[: -len("_ids")]]
        return abstract((rows, t.max_len), np.int64)
    if slot.endswith("_mask") and slot[: -len("_mask")] in seqs:
        t = seqs[slot[: -len("_mask")]]
        return abstract((rows, t.max_len), np.float32)
    if slot in merge_widths:
        return abstract((rows, merge_widths[slot]), np.float32)
    return None


def abstract_flow(plan, rows: int = 8
                  ) -> Tuple[Dict[str, torch.Tensor], List[Finding]]:
    """Flow meta tensors through the plan's executables (PV103)."""
    spec = plan.spec
    table, seqs, merge_widths = _host_slot_rules(spec)
    env: Dict[str, torch.Tensor] = {}
    findings: List[Finding] = []
    for ex in plan.layers:
        where = f"plan {plan.name!r}/layer {ex.index}"
        for slot in ex.device_input_slots:
            if slot in env:
                continue
            sds = _abstract_host_slot(slot, rows, spec, table, seqs,
                                      merge_widths)
            if sds is None:
                findings.append(Finding(
                    rule="PV103", severity="error", location=where,
                    message=(f"device input slot {slot!r} has no producer: "
                             f"no earlier executable emits it and no host-op "
                             f"synthesis rule covers it"),
                    hint="host ops feeding the device must emit *_col, "
                         "<seq>_ids/_mask, or <merge>dense slots"))
                return env, findings
            env[slot] = sds
        if ex.fused_fn is None:
            continue
        try:
            out = ex.fused_fn({s: env[s] for s in ex.device_input_slots})
        except Exception as e:  # noqa: BLE001 - tracing failure IS the finding
            findings.append(Finding(
                rule="PV103", severity="error", location=where,
                message=(f"fused dispatch fails abstract tracing: "
                         f"{type(e).__name__}: {e}"),
                hint="the device ops' shape contract is inconsistent with "
                     "the host-op outputs"))
            return env, findings
        for name, sds in out.items():
            if name in env:
                findings.append(Finding(
                    rule="PV103", severity="error", location=where,
                    message=f"slot {name!r} is produced twice",
                    hint="each slot must have exactly one producer"))
            env[name] = sds
    return env, findings


# ------------------------------------------------------------------- checks
def check_placement(plan) -> List[Finding]:
    """PV102: host ops only at each executable's first member layer."""
    findings: List[Finding] = []
    depth_of = plan.schedule.depth_of
    for ex in plan.layers:
        if not ex.layer_indices or len(ex.layer_indices) == 1:
            continue
        barrier = ex.layer_indices[0]
        for placed in ex.host_ops:
            depth = depth_of.get(placed.op.name)
            if depth != barrier:
                findings.append(Finding(
                    rule="PV102", severity="error",
                    location=f"plan {plan.name!r}/layer {ex.index}",
                    message=(f"host op {placed.op.name!r} sits at schedule "
                             f"depth {depth} inside a super-layer coalesced "
                             f"over layers {ex.layer_indices} (host barrier "
                             f"at {barrier})"),
                    hint="coalescing must break before every host-op layer "
                         "(scheduler.coalesce_layers invariant)"))
    return findings


def check_output_layout(plan, env: Dict[str, torch.Tensor],
                        rows: int) -> List[Finding]:
    """PV101: the abstract flow must land exactly on OutputLayout."""
    findings: List[Finding] = []
    where = f"plan {plan.name!r}/output_layout"
    declared = {name: (width, dtype, rank1)
                for name, width, dtype, rank1 in plan.layout.feed_slots()}
    produced = {k: v for k, v in env.items() if k.startswith("batch_")}
    for name, (width, dtype, rank1) in declared.items():
        got = produced.get(name)
        if got is None:
            findings.append(Finding(
                rule="PV101", severity="error", location=where,
                message=f"layout declares slot {name!r}, which the plan "
                        f"never produces",
                hint="OutputLayout and the final_batch op diverged"))
            continue
        want_shape = (rows,) if rank1 else (rows, width)
        got_dtype = str(got.dtype).removeprefix("torch.")
        if tuple(got.shape) != want_shape or got_dtype != np.dtype(dtype).name:
            findings.append(Finding(
                rule="PV101", severity="error", location=where,
                message=(f"slot {name!r}: plan produces "
                         f"{tuple(got.shape)}/{got_dtype}, layout declares "
                         f"{want_shape}/{dtype}"),
                hint="the staging arena would be mis-sized for this slot"))
    for name in sorted(set(produced) - set(declared)):
        findings.append(Finding(
            rule="PV101", severity="error", location=where,
            message=f"plan produces {name!r}, which OutputLayout does not "
                    f"declare",
            hint="undeclared outputs are never staged; extend feed_slots()"))
    return findings


def check_projection(plan) -> List[Finding]:
    """PV104: plan.required_columns covers everything the spec reads."""
    findings: List[Finding] = []
    where = f"plan {plan.name!r}/required_columns"
    want = compiler.required_columns(plan.spec)
    have = {v: set(cols) for v, cols in plan.required_columns.items()}
    for view, cols in sorted(want.items()):
        missing = sorted(set(cols) - have.get(view, set()))
        for col in missing:
            findings.append(Finding(
                rule="PV104", severity="error", location=where,
                message=(f"view {view!r} column {col!r} is read by the "
                         f"compiled spec but absent from the projection"),
                hint="the loader would never decode it; recompute "
                     "required_columns from the spec"))
    return findings


def verify_plan(plan, *, rows: int = 8) -> List[Finding]:
    """Full static verification of one compiled FeaturePlan (PV101-104)."""
    findings = check_placement(plan)
    env, flow_findings = abstract_flow(plan, rows)
    findings += flow_findings
    if not flow_findings:  # layout contract needs a completed flow
        findings += check_output_layout(plan, env, rows)
    findings += check_projection(plan)
    return findings


def verify_model_feed(mf, feed_layout) -> List[Finding]:
    """PV105/PV106: remap bounds + staging/feed slot contract for one
    compiled :class:`~repro_torch.fe.modelfeed.ModelFeed` against the staging
    :class:`~repro_torch.core.devicefeed.FeedLayout` it will consume."""
    findings: List[Finding] = []
    cfg = mf.config
    where = f"model_feed {cfg.name!r}"
    tables = tuple(int(v) for v in cfg.vocab_sizes[:cfg.n_sparse])
    vocab = np.asarray(mf.vocab).ravel()
    sources = np.asarray(mf.field_sources).ravel()

    if cfg.n_sparse and mf.n_spec_fields <= 0:
        findings.append(Finding(
            rule="PV105", severity="error", location=where,
            message=(f"model wants {cfg.n_sparse} sparse fields but the "
                     f"spec emits none"),
            hint="pick a spec with a SparseOutput block for this arch"))
        return findings
    for j in range(cfg.n_sparse):
        if j >= len(vocab):
            findings.append(Finding(
                rule="PV105", severity="error", location=where,
                message=(f"model field {j} has no vocab-modulo entry "
                         f"(vector covers {len(vocab)} of {cfg.n_sparse} "
                         f"fields): raw hash ids up to the spec's "
                         f"field_size would index its embedding table"),
                hint="the modulo vector must cover every sparse field"))
            continue
        mod = int(vocab[j])
        if mod <= 0:
            findings.append(Finding(
                rule="PV105", severity="error", location=where,
                message=f"model field {j} has nonpositive modulo {mod}",
                hint="modulo entries come from cfg.vocab_sizes; must be >=1"))
        elif j < len(tables) and mod > tables[j]:
            findings.append(Finding(
                rule="PV105", severity="error", location=where,
                message=(f"model field {j}: modulo {mod} exceeds its "
                         f"embedding table size {tables[j]} — remapped ids "
                         f"in [{tables[j]}, {mod}) index out of bounds"),
                hint="modulo must be <= the table's vocab size"))
        if j < len(sources) and not (0 <= int(sources[j]) < mf.n_spec_fields):
            findings.append(Finding(
                rule="PV105", severity="error", location=where,
                message=(f"model field {j} sources spec field "
                         f"{int(sources[j])}, outside the spec's "
                         f"{mf.n_spec_fields} fields"),
                hint="field_sources indices must be < n_spec_fields"))
    if len(sources) < cfg.n_sparse:
        findings.append(Finding(
            rule="PV105", severity="error", location=where,
            message=(f"field_sources covers {len(sources)} of "
                     f"{cfg.n_sparse} model fields"),
            hint="every model field needs a spec field source"))

    available = set(feed_layout.slot_names)
    if "batch_sparse" in available:
        # The device feeder derives per-field columns from a packed block.
        available.update(compiler.field_slots(mf.n_spec_fields))
    for slot in mf.slots:
        if slot not in available:
            findings.append(Finding(
                rule="PV106", severity="error", location=where,
                message=(f"train feed consumes slot {slot!r}, which the "
                         f"staging layout does not provide "
                         f"(staged: {sorted(feed_layout.slot_names)})"),
                hint="feed_layout(split_sparse_fields=...) must match the "
                     "model feed's split setting"))
    return findings
