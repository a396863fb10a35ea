"""The device mesh over ``torch.distributed``.

The JAX package maps one program over a ``jax.sharding.Mesh`` with
``shard_map`` (through this module's JAX counterpart).  The port runs the
same SPMD program the PyTorch way: one process per device (``torchrun``,
or ``run_world`` below), each holding its own local shard, with the
mesh's named axes given by a
``torch.distributed.device_mesh.DeviceMesh``.  There is no ``shard_map``:
a function that the reference maps over the mesh runs, on every rank, on
that rank's shard, and exchanges data through the process groups of the
mesh's axes (``axis_group``).

Meshes are duck-typed by two attributes, ``shape`` and
``mesh_dim_names``: a ``DeviceMesh`` (which needs a process group) or a
``MeshShape`` (which does not, for spec arithmetic and planning, as the
JAX package's ``AbstractMesh``).

Backends follow the device the caller names: NCCL for ``cuda`` (one
device per rank, the rank's ``LOCAL_RANK``), gloo for ``cpu``.  The
default is ``cuda``, which raises without a GPU as
``models.runtime.resolve_device`` does; no rank switches backend on its
own.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..models.runtime import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names, without devices or process groups."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}``, the JAX package's ``mesh.shape``."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def axis_size(mesh, name: str) -> int:
    """Size of a mesh axis (``compat.axis_size`` inside ``shard_map``)."""
    return mesh_shape(mesh)[name]


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along a mesh axis (``lax.axis_index``)."""
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str) -> dist.ProcessGroup:
    """The process group of this rank's line along a mesh axis: its ranks
    in the order of their coordinates on that axis."""
    return mesh.get_group(name)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (pod and data when multi-pod)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def init_world(device_type: str = "cuda", *, init_method: str = "env://",
               rank: int = -1, world_size: int = -1,
               timeout_s: float = 300.0) -> torch.device:
    """Join the process group (NCCL for ``cuda``, gloo for ``cpu``) and
    return this rank's device.  ``env://`` reads ``torchrun``'s
    variables; a spawn passes ``rank``, ``world_size`` and its own
    ``init_method``.  Raises for ``cuda`` without a GPU."""
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda":
        resolve_device("cuda")                 # raises without a GPU
        local = int(os.environ.get("LOCAL_RANK", max(rank, 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            BACKENDS[device_type], init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the whole world (joined first
    from ``torchrun``'s environment when no group exists)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        init_world(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _rank_main(rank: int, fn: Callable, world: int, device_type: str,
               init_method: str, timeout_s: float, args: tuple) -> None:
    init_world(device_type, init_method=init_method, rank=rank,
               world_size=world, timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, *args: Any, init_method: str,
              device_type: str = "cuda", timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    have joined one process group.  A rank's exception is raised here
    (``torch.multiprocessing.ProcessRaisedException``, after the other
    ranks are stopped); ranks still running after ``timeout_s`` are
    killed and ``TimeoutError`` is raised.  ``fn`` must be importable by
    name (a module-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, device_type, init_method, timeout_s,
                          args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_world: {world} ranks still running after "
                    f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
