"""Declarative feature definitions (the FeatureBox front end).

The paper's premise is that practitioners retrain CTR models constantly to
test new engineered features, so defining a feature must be cheap. This
module is the declarative surface for that: users describe *what* to compute
— sources, joins, transforms, outputs — as plain data, and
:mod:`repro_torch.fe.compiler` lowers the description into the existing
:class:`~repro_torch.core.opgraph.OpGraph` with correct placements, cost hints,
and sparse-field offsets.

A :class:`FeatureSpec` is a pure value: hashable pieces, no callables except
the :class:`Custom` escape hatch. The bundled scenario presets live in
:mod:`repro_torch.fe.specs`.

Naming: transforms and outputs reference columns of the *joined* table by
name — base-view columns keep their names, joined columns carry the join's
prefix (``u_age_bucket``), JSON-extracted fields appear under their field
name. Transform results are referenced by the transform's ``name``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Tuple

from repro_torch.core.opgraph import Device, OpCost
from repro_torch.fe.schema import ColType, ViewSchema

# Default feature-space layout (mirrors the legacy hand-wired ads pipeline).
DEFAULT_FIELD_SIZE = 1 << 20


# ------------------------------------------------------------------- sources
@dataclasses.dataclass(frozen=True)
class JsonExtract:
    """Parse fields out of a JSON string column during the clean stage."""

    column: str                          # JSON source column on the view
    fields: Tuple[Tuple[str, ColType], ...]  # (field name, type) pairs

    def __post_init__(self) -> None:
        object.__setattr__(self, "fields", tuple(self.fields))


@dataclasses.dataclass(frozen=True)
class Source:
    """One raw view consumed by the pipeline.

    ``json`` lists semi-structured payloads to flatten while cleaning;
    extracted fields become ordinary columns of the view (null-filled with
    their type defaults, same as schema columns).
    """

    view: str
    schema: ViewSchema
    json: Tuple[JsonExtract, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "json", tuple(self.json))


@dataclasses.dataclass(frozen=True)
class Join:
    """Left-join a source view onto the base table (host dictionary lookup)."""

    view: str
    key: str                 # shared key column (user_id, ad_id, ...)
    prefix: str = ""         # prefix for the joined columns


@dataclasses.dataclass(frozen=True)
class Merge:
    """Merge a materialized feature table on the instance key (paper §III).

    The named float columns are appended to the dense output, after all
    :class:`DenseOutput` features, in merge declaration order.
    """

    view: str
    columns: Tuple[str, ...]
    key: str = "instance_id"
    prefix: str = "basic_"
    bytes_touched: int = 4 * 1024**3   # dictionary working set (placement hint)

    def __post_init__(self) -> None:
        object.__setattr__(self, "columns", tuple(self.columns))


# ---------------------------------------------------------------- transforms
@dataclasses.dataclass(frozen=True)
class Hash:
    """A categorical column as one sparse field: ``id % field_size``.

    ``mix=True`` additionally avalanche-mixes the id (fmix32) before the
    modulo — use it when raw ids are correlated with the field size.
    """

    name: str
    column: str
    mix: bool = False


@dataclasses.dataclass(frozen=True)
class Cross:
    """Feature combination: hash two categorical columns into one field."""

    name: str
    a: str
    b: str


@dataclasses.dataclass(frozen=True)
class Bucketize:
    """Discretize a float column into right-open buckets (dense feature)."""

    name: str
    column: str
    boundaries: Tuple[float, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "boundaries", tuple(self.boundaries))


@dataclasses.dataclass(frozen=True)
class LogNorm:
    """``log(1+x)`` transform for heavy-tailed counters (dense feature)."""

    name: str
    column: str


@dataclasses.dataclass(frozen=True)
class Scale:
    """``x / denom`` as float32 (dense feature, e.g. ``hour / 24``)."""

    name: str
    column: str
    denom: float


@dataclasses.dataclass(frozen=True)
class Sequence:
    """A padded id sequence + mask from a ragged or string column.

    * INT_LIST columns are padded/truncated to ``max_len``;
    * STRING columns are tokenized (whitespace + ``ngrams``-gram hashing)
      on the host first — the paper's "extract keywords" stand-in.
    """

    name: str
    column: str
    max_len: int
    ngrams: int = 2


@dataclasses.dataclass(frozen=True)
class Custom:
    """Escape hatch: a user operator inserted into the graph as-is.

    ``fn`` takes the declared input slots as keyword arguments and returns
    ``{output: array}``. Device ops take and return torch tensors; host ops may run
    arbitrary Python. ``cost`` feeds the scheduler's placement heuristic for
    ``Device.AUTO`` ops.
    """

    name: str
    fn: Callable[..., Mapping[str, Any]]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    device: Device = Device.AUTO
    cost: OpCost = dataclasses.field(default_factory=OpCost)

    def __post_init__(self) -> None:
        object.__setattr__(self, "inputs", tuple(self.inputs))
        object.__setattr__(self, "outputs", tuple(self.outputs))


DENSE_TRANSFORMS = (Bucketize, LogNorm, Scale)
SPARSE_TRANSFORMS = (Hash, Cross)
Transform = Any  # union of the dataclasses above (kept loose for Custom)


# ------------------------------------------------------------------- outputs
@dataclasses.dataclass(frozen=True)
class SparseOutput:
    """``batch_sparse`` [B, n_fields] int32: one global sparse id per field.

    ``fields`` reference :class:`Hash`/:class:`Cross` transforms (or a
    :class:`Custom` output slot holding per-field hashes); declaration order
    is field order, and field *i* occupies ``[i*field_size, (i+1)*field_size)``
    in the global id space.
    """

    fields: Tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "fields", tuple(self.fields))


@dataclasses.dataclass(frozen=True)
class DenseOutput:
    """``batch_dense`` [B, n] float32 in declaration order.

    Columns contributed by :class:`Merge` tables are appended after these
    features, in merge declaration order.
    """

    features: Tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "features", tuple(self.features))


@dataclasses.dataclass(frozen=True)
class SequenceOutput:
    """``batch_seq_ids``/``batch_seq_mask`` [B, sum(max_len)]: the named
    :class:`Sequence` transforms concatenated along the length axis."""

    sequences: Tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "sequences", tuple(self.sequences))


Output = Any  # union of the three output dataclasses


# ---------------------------------------------------------------------- spec
@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """A full feature-engineering scenario as data.

    ``base`` names the instance-grain view; every :class:`Join` left-joins
    another source onto it, every :class:`Merge` joins a materialized table
    on the instance key. ``label`` is a base-view column emitted as
    ``batch_label``.
    """

    name: str
    base: str
    sources: Tuple[Source, ...]
    outputs: Tuple[Output, ...]
    joins: Tuple[Join, ...] = ()
    merges: Tuple[Merge, ...] = ()
    transforms: Tuple[Transform, ...] = ()
    label: str = "label"
    join_bytes_touched: int = 8 * 1024**3

    def __post_init__(self) -> None:
        object.__setattr__(self, "sources", tuple(self.sources))
        object.__setattr__(self, "outputs", tuple(self.outputs))
        object.__setattr__(self, "joins", tuple(self.joins))
        object.__setattr__(self, "merges", tuple(self.merges))
        object.__setattr__(self, "transforms", tuple(self.transforms))
        views = [s.view for s in self.sources]
        if len(set(views)) != len(views):
            raise ValueError(f"spec {self.name!r}: duplicate source views")
        if self.base not in views:
            raise ValueError(
                f"spec {self.name!r}: base view {self.base!r} is not a source")
        known = set(views)
        for j in self.joins:
            if j.view not in known:
                raise ValueError(
                    f"spec {self.name!r}: join references unknown view {j.view!r}")
        for m in self.merges:
            if m.view not in known:
                raise ValueError(
                    f"spec {self.name!r}: merge references unknown view {m.view!r}")
        names = [t.name for t in self.transforms]
        if len(set(names)) != len(names):
            raise ValueError(f"spec {self.name!r}: duplicate transform names")

    def source(self, view: str) -> Source:
        for s in self.sources:
            if s.view == view:
                return s
        raise KeyError(f"spec {self.name!r} has no source {view!r}")

    def transform(self, name: str) -> Transform:
        for t in self.transforms:
            if t.name == name:
                return t
        raise KeyError(f"spec {self.name!r} has no transform {name!r}")
