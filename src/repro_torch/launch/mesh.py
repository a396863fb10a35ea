"""Mesh construction over ``torch.distributed``.

``make_production_mesh`` is a shape only (``compat.MeshShape``): the
assigned 16 x 16 mesh (2 x 16 x 16 multi-pod) of the JAX package needs
256 or 512 devices, so the port plans against it (``distributed.fault``,
``distributed.sharding``) and runs nothing on it.  ``make_host_mesh``
builds a ``DeviceMesh`` over the world that ``torchrun`` or a spawn
(``distributed.compat.run_world``) gives.
"""
from __future__ import annotations

import torch.distributed as dist

from ..distributed.compat import MeshShape, dp_axes, init_world, \
    make_mesh, mesh_shape

__all__ = ["dp_axes", "make_host_mesh", "make_mesh", "make_production_mesh",
           "mesh_axis_size"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The assigned production mesh: 16 x 16 per pod, 2 pods when
    ``multi_pod``."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A ``data`` x ``model`` mesh over the current world (joined from
    ``torchrun``'s environment when no group exists).  As in the JAX
    package, a request larger than the world becomes ``(world, 1)``; a
    mesh covers the whole world, so a smaller one raises."""
    if not dist.is_initialized():
        init_world(device_type)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh does not cover the "
                         f"world of {n} ranks")
    return make_mesh((data, model), ("data", "model"), device_type)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)
