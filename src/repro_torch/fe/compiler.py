"""Lower a declarative :class:`~repro_torch.fe.spec.FeatureSpec` into an OpGraph.

The same staged graph as the JAX package's compiler, so schedules (layers,
placements, dispatch counts) are identical:

* ``clean_<view>``   — HOST, one per base/joined source (JSON extraction +
  null fill, both driven by the view schema);
* ``join_views``     — HOST, the chained dictionary-lookup left joins;
* ``extract_text``   — HOST, every :class:`Sequence` transform (tokenize +
  pad) in one operator;
* ``to_device``      — HOST, gathers exactly the numeric columns the device
  stage consumes (the H2D boundary);
* ``cross_features`` — DEVICE, every :class:`Cross` of the spec in ONE
  launch of the ``feature_hash`` kernel (the paper's hash/cross meta-kernel);
* ``dense_features`` — DEVICE, elementwise torch ops;
* ``merge_<view>``   — HOST, instance-key merges of materialized tables;
* ``sparse_ids``     — DEVICE, the per-field ``mix``/``mod`` hashes in one
  ``feature_hash`` launch, then the field offsets (field i occupies
  ``[i*field_size, (i+1)*field_size)``);
* ``final_batch``    — DEVICE, assembles ``batch_dense`` / ``batch_sparse``
  / ``batch_seq_ids`` / ``batch_seq_mask`` / ``batch_label``.

Integer columns arrive as int64; the device ops narrow them to their low 32
bits read as signed int32 (:func:`repro_torch.fe.ops.narrow_int32`), which
is what the JAX plan's jit does with x64 off. So the ``mod`` fields are a
signed int32 floor-mod of the narrowed id.

:class:`Custom` transforms are inserted verbatim; their placement follows
their declared device/cost through the scheduler's heuristic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.opgraph import Device, OpCost, Operator, OpGraph
from repro_torch.fe import ops as F
from repro_torch.fe.colstore import Columns
from repro_torch.fe.join import hash_join
from repro_torch.fe.schema import ColType
from repro_torch.fe.views import extract_json_fields, fill_nulls
from repro_torch.fe.spec import (
    DEFAULT_FIELD_SIZE,
    Bucketize,
    Cross,
    Custom,
    DenseOutput,
    FeatureSpec,
    Hash,
    LogNorm,
    Scale,
    Sequence,
    SequenceOutput,
    Source,
    SparseOutput,
)
from repro_torch.kernels.feature_hash import ops as hash_ops


@dataclasses.dataclass(frozen=True)
class OutputLayout:
    """Shape contract of a compiled spec's ``batch_*`` outputs."""

    n_sparse_fields: int
    n_dense_feats: int
    seq_len: int            # total width of the concatenated sequence block
    field_size: int

    @property
    def sparse_id_space(self) -> int:
        return self.n_sparse_fields * self.field_size

    def feed_slots(self) -> Tuple[Tuple[str, int, str, bool], ...]:
        """Static H2D staging contract: (slot, row width, dtype, rank1).

        The per-row element widths and dtypes of every ``batch_*`` output a
        spec with this layout emits — what the device-feed tier needs to
        size its staging buffers at compile time.
        """
        slots: List[Tuple[str, int, str, bool]] = [
            ("batch_label", 1, "float32", True)]
        if self.n_dense_feats:
            slots.append(("batch_dense", self.n_dense_feats, "float32", False))
        if self.n_sparse_fields:
            slots.append(("batch_sparse", self.n_sparse_fields, "int32", False))
        if self.seq_len:
            slots.append(("batch_seq_ids", self.seq_len, "int32", False))
            slots.append(("batch_seq_mask", self.seq_len, "float32", False))
        return tuple(slots)


def field_slot(i: int) -> str:
    """Staged slot name of sparse field ``i``'s per-field id vector (the
    ``split_sparse_fields`` feed form)."""
    return f"batch_field_{i:02d}"


def field_slots(n: int) -> Tuple[str, ...]:
    """All per-field staged slot names of an ``n``-field sparse block."""
    return tuple(field_slot(i) for i in range(n))


class SpecError(ValueError):
    """A FeatureSpec that cannot be lowered (bad reference, type mismatch)."""


@dataclasses.dataclass(frozen=True)
class _FinalAssembly:
    """Shape of the ``final_batch`` assembly, which the host output binding
    repeats."""

    has_dense: bool
    merge_slots: Tuple[str, ...]
    has_sparse: bool
    n_sparse_fields: int
    seq_names: Tuple[str, ...]
    label_slot: str


def _final_assembly(spec: FeatureSpec) -> _FinalAssembly:
    dense_out = _single(spec, DenseOutput)
    sparse_out = _single(spec, SparseOutput)
    seq_out = _single(spec, SequenceOutput)
    return _FinalAssembly(
        has_dense=bool(dense_out and dense_out.features),
        merge_slots=tuple(f"{m.prefix}dense" for m in spec.merges),
        has_sparse=bool(sparse_out and sparse_out.fields),
        n_sparse_fields=len(sparse_out.fields) if sparse_out else 0,
        seq_names=tuple(seq_out.sequences) if seq_out else (),
        label_slot=f"{spec.label}_col",
    )


def _host(val) -> np.ndarray:
    """A slot's values on the host: a CUDA tensor comes back with a
    synchronous copy on the current stream (the JAX binding's
    ``np.asarray`` of a device array)."""
    if isinstance(val, torch.Tensor):
        return val.cpu().numpy()
    return np.asarray(val)


class OutputBinding:
    """Host twin of the device ``final_batch`` op for the arena feed.

    Assembles a spec's ``batch_*`` outputs from the pre-final slots
    (``dense_feats`` / ``sparse_ids`` / ``<seq>_ids`` / merge slots /
    label) **directly into caller-provided arrays**: the typed views of
    the pinned host buffer a :class:`~repro_torch.core.devicefeed.
    DeviceFeeder` claims per batch (``claim_views``). No ``batch_*``
    tensors are built and no env->arena copy follows; values are bit for
    bit the device assembly's (pure copies and concatenations; int64
    sequence ids keep their low 32 bits, as ``narrow_int32`` does). Slots
    the FE device layer left on the card come back to the host here.

    Every source is checked against its destination view before anything
    is written, so a wrong-shaped slot raises
    :class:`~repro_torch.core.devicefeed.FeedError` and leaves the views
    untouched.

    Duck-typed contract consumed by ``DeviceFeeder``: :meth:`ready`,
    :meth:`rows_of`, :meth:`write`.
    """

    final_op = "final_batch"

    def __init__(self, assembly: _FinalAssembly,
                 *, split_sparse_fields: bool = False) -> None:
        self._asm = assembly
        self.split_sparse_fields = split_sparse_fields
        inputs: List[str] = []
        if assembly.has_dense:
            inputs.append("dense_feats")
        inputs.extend(assembly.merge_slots)
        if assembly.has_sparse:
            inputs.append("sparse_ids")
        for n in assembly.seq_names:
            inputs.extend([f"{n}_ids", f"{n}_mask"])
        inputs.append(assembly.label_slot)
        self.input_slots: Tuple[str, ...] = tuple(dict.fromkeys(inputs))
        self.rows_slot = assembly.label_slot

    def ready(self, env: Mapping[str, object]) -> bool:
        """True when ``env`` carries the pre-assembly slots this binding
        consumes (the FE ran the sans-final layer build)."""
        return all(s in env for s in self.input_slots)

    def rows_of(self, env: Mapping[str, object]) -> int:
        return int(env[self.rows_slot].shape[0])

    def write(self, env: Mapping[str, object],
              views: Mapping[str, np.ndarray]) -> None:
        """Assemble every ``batch_*`` output straight into ``views``."""
        asm = self._asm
        # (destination views, host parts concatenated along axis 1 into them)
        plan: List[Tuple[List[np.ndarray], List[np.ndarray], str]] = [
            ([views["batch_label"]], [_host(env[asm.label_slot])], "batch_label")]
        if asm.has_dense or asm.merge_slots:
            parts = [_host(env["dense_feats"])] if asm.has_dense else []
            parts += [_host(env[s]) for s in asm.merge_slots]
            plan.append(([views["batch_dense"]], parts, "batch_dense"))
        if asm.has_sparse:
            ids = _host(env["sparse_ids"])
            if self.split_sparse_fields:
                fields = [views[field_slot(i)] for i in range(asm.n_sparse_fields)]
                want = (fields[0].shape[0], asm.n_sparse_fields)
                if ids.shape != want:
                    raise _shape_error("sparse_ids", ids.shape, want)
                plan.append((fields, [ids], "sparse_ids"))
            else:
                plan.append(([views["batch_sparse"]], [ids], "batch_sparse"))
        if asm.seq_names:
            plan.append(([views["batch_seq_ids"]],
                         [_host(env[f"{n}_ids"]) for n in asm.seq_names], "batch_seq_ids"))
            plan.append(([views["batch_seq_mask"]],
                         [_host(env[f"{n}_mask"]) for n in asm.seq_names], "batch_seq_mask"))
        for outs, parts, slot in plan:
            if len(outs) == 1:
                _check_concat(outs[0], parts, slot)
        for outs, parts, slot in plan:
            if len(outs) > 1:       # per-field id vectors from packed ids
                for i, out in enumerate(outs):
                    np.copyto(out, parts[0][:, i], casting="same_kind")
            elif len(parts) == 1:
                np.copyto(outs[0], parts[0], casting="same_kind")
            else:
                np.concatenate(parts, axis=1, out=outs[0], casting="same_kind")


def _shape_error(slot: str, got, want) -> Exception:
    from repro_torch.core.devicefeed import FeedError
    return FeedError(f"slot {slot!r}: shape {tuple(got)} != layout {tuple(want)}")


def _check_concat(out: np.ndarray, parts: List[np.ndarray], slot: str) -> None:
    """Raise unless ``parts`` concatenate along axis 1 to exactly ``out``'s
    shape (``np.copyto`` would broadcast a wrong-rowed slot silently)."""
    if len(parts) == 1:
        if parts[0].shape != out.shape:
            raise _shape_error(slot, parts[0].shape, out.shape)
        return
    rows = out.shape[0]
    widths = 0
    for p in parts:
        if p.ndim != 2 or p.shape[0] != rows:
            raise _shape_error(slot, p.shape, (rows, "*"))
        widths += p.shape[1]
    if widths != out.shape[1]:
        raise _shape_error(slot, (rows, widths), out.shape)


def output_binding(spec: FeatureSpec, *,
                   split_sparse_fields: bool = False) -> OutputBinding:
    """Compile ``spec``'s output binding (see :class:`OutputBinding`)."""
    return OutputBinding(_final_assembly(spec),
                         split_sparse_fields=split_sparse_fields)


# ------------------------------------------------------------ name resolution
@dataclasses.dataclass(frozen=True)
class _ResolvedCol:
    view: str        # source view name
    column: str      # column name on that view
    ctype: ColType
    extracted: bool  # produced by a JsonExtract, not stored on disk


def _column_table(spec: FeatureSpec) -> Dict[str, _ResolvedCol]:
    """Map joined-table column names -> their origin (view, column, type)."""
    table: Dict[str, _ResolvedCol] = {}

    def register(source: Source, prefix: str) -> None:
        for col in source.schema.columns:
            table[f"{prefix}{col.name}"] = _ResolvedCol(
                source.view, col.name, col.ctype, extracted=False)
        for je in source.json:
            for fname, ctype in je.fields:
                table[f"{prefix}{fname}"] = _ResolvedCol(
                    source.view, fname, ctype, extracted=True)

    register(spec.source(spec.base), "")
    for join in spec.joins:
        register(spec.source(join.view), join.prefix)
    return table


def _resolve(spec: FeatureSpec, table: Dict[str, _ResolvedCol],
             name: str, *, context: str) -> _ResolvedCol:
    try:
        return table[name]
    except KeyError:
        raise SpecError(
            f"spec {spec.name!r}: {context} references unknown column "
            f"{name!r} (known: {sorted(table)})") from None


# ----------------------------------------------------------------- main entry
def lower(spec: FeatureSpec, *, field_size: int = DEFAULT_FIELD_SIZE) -> OpGraph:
    """Compile ``spec`` into an :class:`OpGraph` (see module docstring)."""
    table = _column_table(spec)
    g = OpGraph()

    joined_views = [spec.base] + [j.view for j in spec.joins]
    external = list(dict.fromkeys(joined_views + [m.view for m in spec.merges]))
    g.mark_external(*external)

    # ---------------------------------------------------------- clean (HOST)
    clean_slots: Dict[str, str] = {}
    for view in joined_views:
        source = spec.source(view)
        slot = f"{view}_clean"
        clean_slots[view] = slot
        g.add(Operator(f"clean_{view}", _make_clean_fn(source, slot),
                       (view,), (slot,), device=Device.HOST))

    # ----------------------------------------------------------- join (HOST)
    if spec.joins:
        join_inputs = tuple(clean_slots[v] for v in joined_views)
        g.add(Operator(
            "join_views",
            _make_join_fn(spec, [clean_slots[v] for v in joined_views]),
            join_inputs, ("joined",), device=Device.HOST,
            cost=OpCost(bytes_touched=spec.join_bytes_touched)))
        joined_slot = "joined"
    else:
        joined_slot = clean_slots[spec.base]

    # -------------------------------------------- transform groups, by kind
    sequences = [t for t in spec.transforms if isinstance(t, Sequence)]
    crosses = [t for t in spec.transforms if isinstance(t, Cross)]
    customs = [t for t in spec.transforms if isinstance(t, Custom)]
    by_name = {t.name: t for t in spec.transforms if not isinstance(t, Custom)}

    dense_out = _single(spec, DenseOutput)
    sparse_out = _single(spec, SparseOutput)
    seq_out = _single(spec, SequenceOutput)

    dense_feats: List = []
    if dense_out is not None:
        for ref in dense_out.features:
            t = by_name.get(ref)
            if t is not None and not isinstance(t, (Bucketize, LogNorm, Scale)):
                raise SpecError(
                    f"spec {spec.name!r}: dense feature {ref!r} is a "
                    f"{type(t).__name__}, not a dense transform")
            dense_feats.append(t if t is not None else ref)

    sparse_fields: List = []
    if sparse_out is not None:
        for ref in sparse_out.fields:
            t = by_name.get(ref)
            if t is not None and not isinstance(t, (Hash, Cross)):
                raise SpecError(
                    f"spec {spec.name!r}: sparse field {ref!r} is a "
                    f"{type(t).__name__}, not Hash/Cross")
            sparse_fields.append(t if t is not None else ref)

    # ----------------------------------- host string/sequence extraction
    seq_plans: List[Tuple[Sequence, ColType]] = []
    for t in sequences:
        rc = _resolve(spec, table, t.column, context=f"Sequence {t.name!r}")
        if rc.ctype not in (ColType.STRING, ColType.INT_LIST):
            raise SpecError(
                f"spec {spec.name!r}: Sequence {t.name!r} needs a STRING or "
                f"INT_LIST column, got {rc.ctype} ({t.column!r})")
        seq_plans.append((t, rc.ctype))
    if seq_plans:
        outs = tuple(s for t, _ in seq_plans
                     for s in (f"{t.name}_ids", f"{t.name}_mask"))
        g.add(Operator("extract_text",
                       _make_extract_text_fn(seq_plans, field_size, joined_slot),
                       (joined_slot,), outs, device=Device.HOST))

    # ------------------------------- numeric columns to device (H2D stage)
    device_cols: List[str] = []

    def device_col(name: str, context: str, allowed, kind_desc: str) -> None:
        rc = _resolve(spec, table, name, context=context)
        if rc.ctype not in allowed:
            raise SpecError(
                f"spec {spec.name!r}: {context} needs a {kind_desc} column, "
                f"got {rc.ctype} ({name!r})")
        device_cols.append(name)

    for t in crosses:
        for c in (t.a, t.b):
            device_col(c, f"Cross {t.name!r}", (ColType.INT,),
                       "categorical INT")
    for t in sparse_fields:
        if isinstance(t, Hash):
            device_col(t.column, f"Hash {t.name!r}", (ColType.INT,),
                       "categorical INT")
    for t in dense_feats:
        if isinstance(t, (Bucketize, LogNorm, Scale)):
            device_col(t.column, f"{type(t).__name__} {t.name!r}",
                       (ColType.INT, ColType.FLOAT), "numeric")
    device_cols = list(dict.fromkeys(device_cols))
    label_rc = _resolve(spec, table, spec.label, context="label")
    if label_rc.ctype not in (ColType.INT, ColType.FLOAT):
        raise SpecError(
            f"spec {spec.name!r}: label {spec.label!r} must be a numeric "
            f"column, got {label_rc.ctype}")
    merge_keys = list(dict.fromkeys(m.key for m in spec.merges))
    for key in merge_keys:
        _resolve(spec, table, key, context="merge key")

    col_slot = {name: f"{name}_col" for name in device_cols}
    label_slot = f"{spec.label}_col"
    key_slots = {key: f"{key}_col" for key in merge_keys}
    to_device_outs = (tuple(col_slot[c] for c in device_cols)
                      + tuple(s for s in (label_slot,) if s not in col_slot.values())
                      + tuple(s for k, s in key_slots.items()
                              if s != label_slot and s not in col_slot.values()))
    g.add(Operator(
        "to_device",
        _make_to_device_fn(spec, table, device_cols, col_slot,
                           label_slot, key_slots, joined_slot),
        (joined_slot,), to_device_outs, device=Device.HOST))

    # ----------------------------------------------- extract (DEVICE, torch)
    if crosses:
        g.add(Operator(
            "cross_features",
            _make_cross_fn(crosses, col_slot, field_size),
            tuple(dict.fromkeys(col_slot[c] for t in crosses
                                for c in (t.a, t.b))),
            tuple(t.name for t in crosses), device=Device.DEVICE))

    if dense_feats:
        ins: List[str] = []
        for t in dense_feats:
            ins.append(col_slot[t.column]
                       if isinstance(t, (Bucketize, LogNorm, Scale)) else t)
        g.add(Operator(
            "dense_features",
            _make_dense_fn(dense_feats, col_slot),
            tuple(dict.fromkeys(ins)), ("dense_feats",), device=Device.DEVICE))

    for t in customs:
        g.add(Operator(t.name, t.fn, t.inputs, t.outputs,
                       device=t.device, cost=t.cost))

    # ------------------------------------------------------ merge (HOST)
    merge_slots: List[str] = []
    for m in spec.merges:
        slot = f"{m.prefix}dense"
        merge_slots.append(slot)
        g.add(Operator(
            f"merge_{m.view}",
            _make_merge_fn(m, key_slots[m.key], slot),
            (m.view, key_slots[m.key]), (slot,), device=Device.HOST,
            cost=OpCost(bytes_touched=m.bytes_touched)))

    # ------------------------------------------------- sparse pack (DEVICE)
    if sparse_fields:
        ins = []
        for t in sparse_fields:
            ins.append(col_slot[t.column] if isinstance(t, Hash)
                       else (t.name if isinstance(t, Cross) else t))
        g.add(Operator(
            "sparse_ids",
            _make_sparse_pack_fn(sparse_fields, col_slot, field_size),
            tuple(dict.fromkeys(ins)), ("sparse_ids",), device=Device.DEVICE))

    # ------------------------------------------------- assemble (DEVICE)
    final_inputs: List[str] = []
    if dense_feats:
        final_inputs.append("dense_feats")
    final_inputs.extend(merge_slots)
    if sparse_fields:
        final_inputs.append("sparse_ids")
    seq_names = []
    if seq_out is not None:
        seq_by_name = {t.name: t for t in sequences}
        for ref in seq_out.sequences:
            if ref not in seq_by_name:
                raise SpecError(
                    f"spec {spec.name!r}: SequenceOutput references "
                    f"{ref!r}, which is not a Sequence transform")
            seq_names.append(ref)
            final_inputs.extend([f"{ref}_ids", f"{ref}_mask"])
    final_inputs.append(label_slot)

    final_outputs = ["batch_label"]
    if dense_feats or merge_slots:
        final_outputs.append("batch_dense")
    if sparse_fields:
        final_outputs.append("batch_sparse")
    if seq_names:
        final_outputs.extend(["batch_seq_ids", "batch_seq_mask"])

    g.add(Operator(
        "final_batch",
        _make_final_fn(bool(dense_feats), tuple(merge_slots),
                       bool(sparse_fields), tuple(seq_names), label_slot),
        tuple(dict.fromkeys(final_inputs)), tuple(final_outputs),
        device=Device.DEVICE))

    g.validate()
    return g


def output_layout(spec: FeatureSpec,
                  *, field_size: int = DEFAULT_FIELD_SIZE) -> OutputLayout:
    """Static ``batch_*`` shape contract of ``spec`` (no compilation)."""
    sparse_out = _single(spec, SparseOutput)
    dense_out = _single(spec, DenseOutput)
    seq_out = _single(spec, SequenceOutput)
    seq_len = 0
    if seq_out is not None:
        by_name = {t.name: t for t in spec.transforms if isinstance(t, Sequence)}
        seq_len = sum(by_name[r].max_len for r in seq_out.sequences
                      if r in by_name)
    return OutputLayout(
        n_sparse_fields=len(sparse_out.fields) if sparse_out else 0,
        n_dense_feats=((len(dense_out.features) if dense_out else 0)
                       + sum(len(m.columns) for m in spec.merges)),
        seq_len=seq_len,
        field_size=field_size,
    )


def required_columns(spec: FeatureSpec) -> Dict[str, Tuple[str, ...]]:
    """Per-view columns the compiled pipeline actually reads.

    This is the loader projection: feeding it to ``StreamingLoader`` (or a
    column store) means untouched columns are never decoded from disk.
    Specs containing :class:`Custom` transforms fall back to *all* columns
    of every source — the compiler cannot see inside user callables.
    """
    table = _column_table(spec)
    needed: Dict[str, set] = {}

    def need(view: str, column: str) -> None:
        needed.setdefault(view, set()).add(column)

    if any(isinstance(t, Custom) for t in spec.transforms):
        out: Dict[str, Tuple[str, ...]] = {}
        for s in spec.sources:
            cols = set(s.schema.column_names)
            for m in spec.merges:
                if m.view == s.view:
                    cols.update(m.columns + (m.key,))
            out[s.view] = tuple(sorted(cols))
        return out

    def need_ref(name: str, context: str) -> None:
        rc = _resolve(spec, table, name, context=context)
        if rc.extracted:
            source = spec.source(rc.view)
            for je in source.json:
                if any(f == rc.column for f, _ in je.fields):
                    need(rc.view, je.column)
        else:
            need(rc.view, rc.column)

    def need_view_col(view: str, column: str, context: str) -> None:
        """A column read directly from one view (join build side): an
        on-disk schema column, or the JSON source of an extracted field."""
        source = spec.source(view)
        if column in source.schema.column_names:
            need(view, column)
            return
        for je in source.json:
            if any(f == column for f, _ in je.fields):
                need(view, je.column)
                return
        raise SpecError(
            f"spec {spec.name!r}: {context} references {column!r}, which is "
            f"neither a column nor an extracted field of view {view!r}")

    for join in spec.joins:
        # probe side resolves in the joined namespace (may be extracted)
        need_ref(join.key, f"join on {join.view!r}")
        need_view_col(join.view, join.key, f"join on {join.view!r}")
    for m in spec.merges:
        need_ref(m.key, f"merge on {m.view!r}")
        # merge views are consumed raw (no clean stage), so the key and
        # payload must be on-disk schema columns
        schema_cols = spec.source(m.view).schema.column_names
        for c in (m.key,) + m.columns:
            if c not in schema_cols:
                raise SpecError(
                    f"spec {spec.name!r}: merge on {m.view!r} references "
                    f"{c!r}, which is not a column of that view")
            need(m.view, c)
    need_ref(spec.label, "label")
    for t in spec.transforms:
        ctx = f"transform {t.name!r}"
        if isinstance(t, Cross):
            need_ref(t.a, ctx)
            need_ref(t.b, ctx)
        elif isinstance(t, (Hash, Bucketize, LogNorm, Scale, Sequence)):
            need_ref(t.column, ctx)
    return {view: tuple(sorted(cols)) for view, cols in needed.items()}


# ----------------------------------------------------------- op constructors
# Each factory closes over resolved spec pieces only (no late binding).
def _single(spec: FeatureSpec, kind):
    found = [o for o in spec.outputs if isinstance(o, kind)]
    if len(found) > 1:
        raise SpecError(
            f"spec {spec.name!r}: at most one {kind.__name__} allowed")
    return found[0] if found else None


def _make_clean_fn(source: Source, out_slot: str):
    schema = source.schema
    json_extracts = source.json

    def clean(**kwargs) -> Dict[str, Columns]:
        cols = kwargs[source.view]
        extracted: Dict[str, ColType] = {}
        for je in json_extracts:
            cols = extract_json_fields(cols, je.column, dict(je.fields))
            extracted.update(dict(je.fields))
        return {out_slot: fill_nulls(cols, schema, extracted=extracted)}

    return clean


def _make_join_fn(spec: FeatureSpec, clean_order: List[str]):
    joins = spec.joins
    base_slot = clean_order[0]
    right_slots = clean_order[1:]

    def join_all(**kwargs) -> Dict[str, Columns]:
        t = kwargs[base_slot]
        for join, slot in zip(joins, right_slots):
            t = hash_join(t, kwargs[slot], key=join.key,
                          right_prefix=join.prefix)
        return {"joined": t}

    return join_all


def _make_extract_text_fn(seq_plans, field_size: int, joined_slot: str):
    def extract_text(**kwargs) -> Dict[str, object]:
        joined = kwargs[joined_slot]
        out: Dict[str, object] = {}
        for t, ctype in seq_plans:
            col = joined[t.column]
            if ctype is ColType.STRING:
                col = F.tokenize_hash(col, field_size=field_size,
                                      ngrams=t.ngrams)
            ids, mask = F.ragged_to_padded(col, max_len=t.max_len)
            out[f"{t.name}_ids"] = ids
            out[f"{t.name}_mask"] = mask
        return out

    return extract_text


def _make_to_device_fn(spec, table, device_cols, col_slot,
                       label_slot, key_slots, joined_slot: str):
    plans: List[Tuple[str, str, np.dtype]] = []
    for name in device_cols:
        rc = table[name]
        dtype = np.float32 if rc.ctype is ColType.FLOAT else np.int64
        plans.append((col_slot[name], name, dtype))
    # label is always emitted as float32 (training target)
    if label_slot not in {s for s, _, _ in plans}:
        plans.append((label_slot, spec.label, np.float32))
    else:
        plans = [(s, n, np.float32 if s == label_slot else d)
                 for s, n, d in plans]
    for key, slot in key_slots.items():
        if slot not in {s for s, _, _ in plans}:
            plans.append((slot, key, np.int64))

    def to_device(**kwargs) -> Dict[str, np.ndarray]:
        joined = kwargs[joined_slot]
        return {slot: np.asarray(joined[name], dtype)
                for slot, name, dtype in plans}

    return to_device


def _stack_int32(kwargs, slots) -> torch.Tensor:
    """Stack id slots into one int32[K, N] column block (one narrowing pass)."""
    return F.narrow_int32(torch.stack([kwargs[s] for s in slots], dim=0))


def _make_cross_fn(crosses, col_slot, field_size: int):
    in_slots = tuple(dict.fromkeys(col_slot[c] for t in crosses for c in (t.a, t.b)))
    col = {s: i for i, s in enumerate(in_slots)}
    program = hash_ops.validate_program(
        [("cross", col[col_slot[t.a]], col[col_slot[t.b]], field_size)
         for t in crosses], len(in_slots))
    names = [t.name for t in crosses]

    def cross_features(**kwargs):
        out = hash_ops.run_hash_layer(_stack_int32(kwargs, in_slots), program)
        return {name: out[i] for i, name in enumerate(names)}

    cross_features.hash_layer = (in_slots, program)
    return cross_features


def _make_dense_fn(dense_feats, col_slot):
    plans = []
    for t in dense_feats:
        if isinstance(t, LogNorm):
            plans.append(("log", col_slot[t.column], None))
        elif isinstance(t, Scale):
            # XLA folds x / denom into x * (1 / denom) with the reciprocal
            # rounded to float32; doing the same keeps Scale bit-exact.
            plans.append(("scale", col_slot[t.column],
                          float(np.float32(1.0) / np.float32(t.denom))))
        elif isinstance(t, Bucketize):
            plans.append(("bucket", col_slot[t.column], t.boundaries))
        else:  # precomputed [B] float slot (e.g. a Custom output)
            plans.append(("slot", t, None))

    def dense_features(**kwargs):
        feats = []
        for kind, src, param in plans:
            x = kwargs[src]
            if not x.is_floating_point():
                x = F.narrow_int32(x)
            if kind == "log":
                feats.append(F.log_norm(x))
            elif kind == "scale":
                feats.append(x.to(torch.float32) * param)
            elif kind == "bucket":
                feats.append(F.bucketize(x, param).to(torch.float32))
            else:
                feats.append(x.to(torch.float32))
        return {"dense_feats": torch.stack(feats, dim=1)}

    return dense_features


def _make_merge_fn(merge, key_slot: str, out_slot: str):
    def merge_fn(**kwargs) -> Dict[str, np.ndarray]:
        probe: Columns = {merge.key: np.asarray(kwargs[key_slot])}
        merged = hash_join(probe, kwargs[merge.view], key=merge.key,
                           right_prefix=merge.prefix)
        return {out_slot: np.stack(
            [merged[f"{merge.prefix}{c}"] for c in merge.columns],
            axis=1).astype(np.float32)}

    return merge_fn


def _make_sparse_pack_fn(sparse_fields, col_slot, field_size: int):
    hashed: List[Tuple[int, str, str]] = []   # (field, kernel op kind, slot)
    passthrough: List[Tuple[int, str]] = []   # (field, cross output slot)
    for i, t in enumerate(sparse_fields):
        if isinstance(t, Hash):
            hashed.append((i, "hash" if t.mix else "mod", col_slot[t.column]))
        elif isinstance(t, Cross):
            passthrough.append((i, t.name))
        else:  # precomputed [B] int field hash slot
            hashed.append((i, "mod", t))
    in_slots = tuple(dict.fromkeys(s for _, _, s in hashed))
    col = {s: k for k, s in enumerate(in_slots)}
    program = hash_ops.validate_program(
        [(kind, col[s], 0, field_size) for _, kind, s in hashed], len(in_slots))
    n_fields = len(sparse_fields)

    def sparse_ids(**kwargs):
        fields: List[torch.Tensor] = [None] * n_fields  # type: ignore[list-item]
        if program:
            out = hash_ops.run_hash_layer(_stack_int32(kwargs, in_slots), program)
            for k, (i, _, _) in enumerate(hashed):
                fields[i] = out[k]
        for i, slot in passthrough:
            fields[i] = F.narrow_int32(kwargs[slot])
        ids = torch.stack(fields, dim=1)
        # global sparse id space: field i occupies [i*fs, (i+1)*fs)
        offsets = torch.arange(n_fields, dtype=torch.int32, device=ids.device) * field_size
        return {"sparse_ids": ids + offsets}

    sparse_ids.hash_layer = (in_slots, program)
    return sparse_ids


def _make_final_fn(has_dense: bool, merge_slots: Tuple[str, ...],
                   has_sparse: bool, seq_names: Tuple[str, ...],
                   label_slot: str):
    def final_batch(**kwargs):
        out: Dict[str, object] = {"batch_label": kwargs[label_slot]}
        dense_parts = ([kwargs["dense_feats"]] if has_dense else [])
        dense_parts += [kwargs[s] for s in merge_slots]
        if dense_parts:
            out["batch_dense"] = torch.cat(dense_parts, dim=1)
        if has_sparse:
            out["batch_sparse"] = kwargs["sparse_ids"]
        if seq_names:
            out["batch_seq_ids"] = torch.cat(
                [F.narrow_int32(kwargs[f"{n}_ids"]) for n in seq_names], dim=1)
            out["batch_seq_mask"] = torch.cat(
                [kwargs[f"{n}_mask"] for n in seq_names], dim=1)
        return out

    return final_batch
