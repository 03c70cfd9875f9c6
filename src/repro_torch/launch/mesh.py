"""Meshes on ``torch.distributed`` process groups, and the collectives of
the model-parallel forms.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one process per device: NCCL on the
card, gloo on the CPU. The JAX package builds its meshes over the devices
one controller sees; here every rank runs the same program (SPMD) and the
collectives run on the mesh's per-axis groups.

* :func:`make_train_mesh` (``('pod', 'data')``) carries the data-parallel
  streaming train loop; :func:`make_model_mesh` (``('data', 'model')`` or
  ``('pod', 'data', 'model')``) the model-parallel forms of MoE, PNA and
  the LM (``models/{moe,gnn,transformer}.py``' ``mesh=``).
* The collectives are what ``shard_map`` gives the JAX forms, as autograd
  functions over one mesh axis or a tuple of them (the tuple's ranks in
  JAX's row-major order): :func:`all_gather` (tiled; its backward the
  reduce-scatter), :func:`psum` (its backward passes the cotangent
  through, as JAX's transpose of a psum whose result is replicated does),
  :func:`pvary` (the identity; its backward the psum: where a replicated
  value enters per-rank work, the ranks' cotangents add up), and
  :func:`axis_index`; :func:`all_to_all` moves rows between the ranks
  of a group (the LM's token layout, where rows do not split evenly). On
  gloo the backward all-reduces and keeps the
  rank's slice (the same sums); every other backend (NCCL, the fake group
  below) runs ``reduce_scatter_tensor``, the card's form and XLA's kind.
* :func:`shard_params` cuts a global param tree to this rank's shard by a
  tree of :class:`repro_torch.core.sharding.PartitionSpec` (the models'
  ``param_specs``); :func:`unshard_params` gathers it back.

One process drives one device: NCCL refuses two ranks on one card, so the
one-card machine runs a mesh of 1x1 (an NCCL group of one), and the
per-rank bodies of a larger mesh in turn, with the collectives written as
concatenations and sums.

The 16x16-chip production mesh (:func:`make_production_mesh`) is the dry
run's (``launch/dryrun.py``): an abstract mesh of axis sizes
(:class:`repro_torch.core.sharding.Mesh`) with no ranks behind it, over
which the cells declare their shardings. :func:`fake_mesh` gives one
device's view of such a mesh: a ``DeviceMesh`` of its shape over torch's
fake process group (rank 0 of the mesh's size, in this process), whose
collectives return at once and leave their outputs as allocated, so the
rank's program runs alone (on ``meta`` for the dry run's per-device
figures, or on the card for its compute and memory). ``make_host_mesh``
has no caller in either package and is not ported.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.sharding import Mesh, entry_axes
from repro_torch.device import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 (512 chips, 2 pods), as an
    abstract mesh: ``("data", "model")`` or ``("pod", "data", "model")``."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def parse_mesh_spec(spec: str):
    """``"PODxDATA"`` (the driver's ``--mesh`` flag) -> ``(pods, data)``.

    ``pods`` is the number of pods (inter-pod links are where
    ``--compress`` pays), ``data`` the data-parallel devices per pod
    (the "pod_size" of the byte accounting)."""
    parts = spec.lower().replace("×", "x").split("x")
    try:
        pods, data = (int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"--mesh expects PODSxDATA (e.g. 2x4), got {spec!r}") from None
    if pods < 1 or data < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return pods, data


def init_ranks(rank: int, world_size: int, store_path: str, device: DeviceLike = None) -> None:
    """Join the default process group as ``rank`` of ``world_size``, through
    a ``FileStore`` at ``store_path`` (no network): NCCL on the card, where
    each rank drives ``cuda:<rank>`` and a failed group fails the run
    (nothing falls back to gloo), gloo on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)


def check_visible(pods: int, data: int, device: DeviceLike = None) -> torch.device:
    """The resolved device, after JAX's oversubscription error: on the card a
    ``pods x data`` mesh needs that many visible cards, one per rank."""
    dev = resolve_device(device)
    n = pods * data
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"mesh {pods}x{data} needs {n} devices but only "
            f"{torch.cuda.device_count()} are visible (torch.cuda.device_count())")
    return dev


def _device_mesh(dev: torch.device, shape: Tuple[int, ...], names: Tuple[str, ...], label: str):
    """A ``DeviceMesh`` of ``shape`` over the default group, which must
    have ``prod(shape)`` ranks; a mesh of one in a process with no group
    starts one of world size 1."""
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {label} needs {n} devices but only 1 are visible; "
                f"start {n} ranks (one process per device, a process group of "
                f"world size {n}), as the driver's --mesh does")
        init_ranks(0, 1, os.path.join(tempfile.mkdtemp(prefix="fbmesh_"), "store"), dev)
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {label} needs {n} devices but the process group has "
            f"{dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_train_mesh(pods: int = 1, data: int = 1, *, device: DeviceLike = None):
    """``('pod', 'data')`` mesh for the data-parallel streaming train loop,
    on the card unless ``device`` is the CPU.

    Over the ranks of the default process group, which must number
    ``pods * data``. A 1x1 mesh in a process with no group starts one of
    world size 1 (an NCCL group of one on the card), so the single-device
    form runs the same collectives in the caller's own process."""
    dev = check_visible(pods, data, device)
    return _device_mesh(dev, (pods, data), ("pod", "data"), f"{pods}x{data}")


def make_model_mesh(data: int = 1, model: int = 1, *, pods: int = 1, device: DeviceLike = None):
    """``('data', 'model')`` mesh (``('pod', 'data', 'model')`` with
    ``pods > 1``) for the model-parallel forms, on the card unless
    ``device`` is the CPU: NCCL on the card, gloo on the CPU, over the
    ranks of the default process group (``pods * data * model`` of them;
    a 1x1 mesh starts a group of one, as :func:`make_train_mesh`)."""
    dev = check_visible(pods, data * model, device)
    if pods > 1:
        return _device_mesh(dev, (pods, data, model), ("pod", "data", "model"),
                            f"{pods}x{data}x{model}")
    return _device_mesh(dev, (data, model), ("data", "model"), f"{data}x{model}")


@contextlib.contextmanager
def fake_mesh(shape: Mapping[str, int], device_type: str = "cpu") -> Iterator[Any]:
    """Rank 0's ``DeviceMesh`` of ``shape`` (``{axis: size}``, e.g.
    ``make_production_mesh().shape``) over a fake process group of the
    mesh's size, for the duration of the ``with`` block.

    torch's ``fake`` backend (``torch.testing._internal.distributed.fake_pg``)
    runs no communication: a collective returns at once with its output
    buffers as they were allocated (uninitialised on the card, so a run
    under it reads bytes and time, never values). No store file, no other
    process. ``device_type`` is the mesh's: ``"cpu"`` for a pass on meta
    tensors, ``"cuda"`` for rank 0's work on the card. Raises where this
    process already has a default group. The group is destroyed on exit,
    with the subgroups :func:`_group` made over it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process with no default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape.values()))
    world = dist.group.WORLD
    try:
        yield init_device_mesh(device_type, tuple(shape.values()),
                               mesh_dim_names=tuple(shape))
    finally:
        dist.destroy_process_group()
        for key in [k for k in _GROUPS if k[2] is world]:
            del _GROUPS[key]


class RankView:
    """One rank's place on a mesh with no process group behind it: what
    :func:`axis_index` and :func:`shard_params` read of a ``DeviceMesh``,
    for cutting a rank's shards and running the rank bodies of a larger
    mesh in turn on one device."""

    def __init__(self, shape: Mapping[str, int], coord: Sequence[int]) -> None:
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(int(n) for n in shape.values())
        self._coord = [int(i) for i in coord]

    def get_coordinate(self):
        return list(self._coord)


# ------------------------------------------------------------ mesh axes
def as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks over ``axes`` (a name or a tuple of names)."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(shape[a] for a in as_axes(axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index over ``axes``: row-major over the tuple, the first
    axis major, as ``jax.lax.axis_index`` of a tuple."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in as_axes(axes):
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
    return idx


_GROUPS: Dict[Tuple[Any, Tuple[str, ...], Any], Any] = {}


def _group(mesh, axes: Axes):
    """The process group of this rank's peers over ``axes``. One axis: the
    mesh's own group; a tuple (in the mesh's axis order, so the group's
    ranks, sorted, run in its row-major order): a group per coordinate of
    the other axes, made once by every rank in the same order."""
    axes = as_axes(axes)
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in the mesh's order {tuple(names)}")
    key = (mesh, axes, dist.group.WORLD)        # a new default group makes new groups
    if key not in _GROUPS:
        ranks = mesh.mesh.permute(*[d for d in range(len(names)) if d not in dims], *dims)
        ranks = ranks.reshape(-1, math.prod(mesh.shape[d] for d in dims))
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(sorted(row))
            if dist.get_rank() in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


# ------------------------------------------------------------ collectives
def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``g`` summed, this rank's slice along ``dim``: one
    ``reduce_scatter_tensor`` (the card's form; XLA's reduce-scatter)."""
    n = dist.get_world_size(group)
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n,) + gt.shape[1:], dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim)


def _sum_slice(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """:func:`_scatter_sum` as gloo runs it: an all-reduce of the whole,
    then the rank's slice (the same sums)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = g.contiguous().clone()
    dist.all_reduce(s, group=group)
    return s.narrow(dim, r * (s.shape[dim] // n), s.shape[dim] // n).contiguous()


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    if dist.get_backend(group) == "gloo":
        return _sum_slice(g, group, dim)
    return _scatter_sum(g, group, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    s = x.contiguous().clone()
    dist.all_reduce(s, group=group)
    return s


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``); the backward sums the
    ranks' cotangents and gives each its slice (reduce-scatter)."""
    return _AllGather.apply(x, _group(mesh, axes), dim % x.dim())


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes``; the result is the same on every rank, so the
    backward passes each rank's cotangent through unchanged."""
    return _Psum.apply(x, _group(mesh, axes))


def pvary(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` (the same on every rank of ``axes``) as the input of per-rank
    work: the identity, whose backward sums the ranks' cotangents."""
    return _Pvary.apply(x, _group(mesh, axes))


def _exchange(x: torch.Tensor, group, send: Sequence[int], recv: Sequence[int]) -> torch.Tensor:
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(recv), list(send), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _exchange(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.recv, ctx.send), None, None, None


def all_to_all(x: torch.Tensor, mesh, axes: Axes, send: Sequence[int],
               recv: Sequence[int]) -> torch.Tensor:
    """Rows of ``x`` exchanged over ``axes``: its first ``send[0]`` rows go
    to rank 0 of the group, the next ``send[1]`` to rank 1, and so on; the
    result is the ``recv[k]`` rows from each rank ``k``, in rank order. Every
    rank of the group calls it, a split of 0 where it has nothing for a
    rank (one ``all_to_all_single``, whose splits may differ by rank on
    gloo and NCCL alike). The backward is the reverse exchange."""
    if x.shape[0] != sum(send):
        raise ValueError(f"all_to_all: {x.shape[0]} rows for sends of {sum(send)}")
    return _AllToAll.apply(x, _group(mesh, axes), tuple(send), tuple(recv))


@torch.no_grad()
def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Elementwise max over ``axes`` (no gradient)."""
    s = x.detach().contiguous().clone()
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=_group(mesh, axes))
    return s


# --------------------------------------------------------- param shards
def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a ``PartitionSpec`` splits some dimension over."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``;
    ``ValueError`` where a dimension does not split over its ranks."""
    out = list(shape)
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            n = axis_size(mesh, axes)
            if out[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over "
                                 f"{axes} ({n} ranks)")
            out[dim] //= n
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy of its own)."""
    block = shard_shape(x.shape, spec, mesh)
    for dim, e in enumerate(spec):
        if entry_axes(e):
            x = x.narrow(dim, axis_index(mesh, entry_axes(e)) * block[dim], block[dim])
    return x.contiguous().clone()


@torch.no_grad()
def unshard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``."""
    for dim, e in enumerate(spec):
        if entry_axes(e):
            x = _gather(x, _group(mesh, entry_axes(e)), dim)
    return x


def _map_specs(fn, params: Mapping[str, Any], specs: Mapping[str, Any]):
    return {k: (_map_specs(fn, v, specs[k]) if isinstance(v, Mapping) else fn(v, specs[k]))
            for k, v in params.items()}


def shard_params(params: Mapping[str, Any], specs: Mapping[str, Any], mesh):
    """This rank's shard of a global param tree under a tree of
    ``PartitionSpec`` of the same structure (``param_specs``)."""
    return _map_specs(lambda v, s: shard_tensor(v, s, mesh), params, specs)


def unshard_params(params: Mapping[str, Any], specs: Mapping[str, Any], mesh):
    """The inverse of :func:`shard_params`: the global tree on every rank."""
    return _map_specs(lambda v, s: unshard_tensor(v, s, mesh), params, specs)
