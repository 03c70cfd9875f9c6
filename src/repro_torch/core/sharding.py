"""A stand-in for the parts of ``jax.sharding`` the dry run reads.

The JAX package declares how each array of a step is laid out over a mesh
of devices (``PartitionSpec``, ``Mesh``, ``NamedSharding``) and lets XLA's
SPMD partitioner split the step. Eager PyTorch has no partitioner; what the
port keeps is the declaration and its arithmetic: which mesh axes each
dimension is split over, and the shape of one device's shard. No process
group is started and no device is touched: a :class:`Mesh` is only an
ordered ``{axis: size}``, the same mapping the sparse train step's
``mesh=`` takes (:func:`repro_torch.models.recsys.make_sparse_train_step`).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]


def _norm(entry: Entry) -> Entry:
    """A 1-tuple of axes means the axis it wraps, as in JAX."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec splits its dimension over."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class PartitionSpec(tuple):
    """How each dimension of an array is split: one entry per leading
    dimension, ``None`` (not split), an axis name, or a tuple of axis names
    (split over their product, the first axis major). Dimensions past the
    last entry are not split. A 1-tuple of axes is stored as the axis it
    wraps, as JAX stores it, so ``P(("data",))`` equals ``P("data")``."""

    def __new__(cls, *entries: Entry) -> "PartitionSpec":
        return super().__new__(cls, tuple(_norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """An abstract device mesh: an ordered ``{axis: size}`` (no devices).

    ``shape`` is that mapping, ``axis_names`` its keys in order and
    ``size`` the product of the sizes (the device count)."""

    def __init__(self, shape: Mapping[str, int]) -> None:
        self._shape = {a: int(n) for a, n in shape.items()}

    @property
    def shape(self) -> dict:
        return dict(self._shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    @property
    def size(self) -> int:
        return math.prod(self._shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self._shape})"


class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec) -> None:
        if not isinstance(spec, PartitionSpec):
            raise TypeError(f"expected a PartitionSpec, got {type(spec).__name__}")
        seen = []
        for e in spec:
            for a in entry_axes(e):
                if a not in mesh.shape:
                    raise ValueError(f"axis {a!r} of {spec} is not in {mesh}")
                if a in seen:
                    raise ValueError(f"axis {a!r} used twice in {spec}")
                seen.append(a)
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's shard of an array of ``shape``: each dimension over
        the product of its entry's axis sizes. Raises ``ValueError`` where
        that product does not divide the dimension, and ``IndexError`` for
        a split entry past the array's last dimension (one that is ``None``
        is ignored), as JAX does."""
        shape = tuple(int(d) for d in shape)
        if any(e is not None for e in self.spec[len(shape):]):
            raise IndexError(f"{self.spec} splits a dimension past the end of shape {shape}")
        mesh = self.mesh.shape
        out = []
        for i, d in enumerate(shape):
            n = math.prod(mesh[a] for a in entry_axes(self.spec[i])) if i < len(self.spec) else 1
            if d % n:
                raise ValueError(f"dimension {i} of shape {shape} ({d}) is not divisible by "
                                 f"{n}, the size of {self.spec[i]!r} on {self.mesh}")
            out.append(d // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"
