"""Train meshes on ``torch.distributed`` process groups.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one process per device: NCCL on the
card, gloo on the CPU. The JAX package builds its meshes over the devices
one controller sees; here every rank runs the same program (SPMD) and the
collectives of the train step run on the mesh's per-axis groups.

The 16x16-chip production mesh (:func:`make_production_mesh`) is the dry
run's (``launch/dryrun.py``): an abstract mesh of axis sizes
(:class:`repro_torch.core.sharding.Mesh`) with no ranks behind it, over
which the cells declare their shardings; the model-parallel steps that
would run on it stay ROADMAP A item 6. ``make_host_mesh`` has no caller in
either package and is not ported.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.sharding import Mesh
from repro_torch.device import DeviceLike, resolve_device


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


def make_train_mesh(pods: int = 1, data: int = 1, *, device: DeviceLike = None):
    """``('pod', 'data')`` mesh for the data-parallel streaming train loop,
    on the card unless ``device`` is the CPU.

    Over the ranks of the default process group, which must number
    ``pods * data``. A 1x1 mesh in a process with no group starts one of
    world size 1 (an NCCL group of one on the card), so the single-device
    form runs the same collectives in the caller's own process."""
    dev = check_visible(pods, data, device)
    n = pods * data
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {pods}x{data} needs {n} devices but only 1 are visible; "
                f"start {n} ranks (one process per device, a process group of "
                f"world size {n}), as the driver's --mesh does")
        init_ranks(0, 1, os.path.join(tempfile.mkdtemp(prefix="fbmesh_"), "store"), dev)
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {pods}x{data} needs {n} devices but the process group has "
            f"{dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (pods, data), mesh_dim_names=("pod", "data"))
