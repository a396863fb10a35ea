"""Sharding helpers: logical axis specs -> mesh specs, and local shards.

Modules in ``repro_torch.models`` describe every parameter with a
*logical* spec, a tuple of logical axis names, via their ``spec_*``
functions (the JAX package's, leaf for leaf).  This module maps logical
names to mesh axes:

    "tp"     -> "model"            (tensor parallel)
    "dp"     -> ("pod","data")     (batch / data parallel)
    "ep"     -> "data"             (expert parallel, MoE a2a strategy)
    "sp"     -> "data"             (sequence parallel for long-context KV)
    None     -> replicated

A mesh spec (``Spec``) is the JAX package's ``PartitionSpec`` as a plain
tuple: per dimension a mesh-axis name, a tuple of names (that dimension
cut over several axes, the first the major one) or None.  ZeRO-1
optimizer-state sharding is derived per leaf: the first unsharded
dimension divisible by the data size is additionally sharded over
"data".

The port's layouts are explicit: each rank holds ``local_shard(x, spec,
mesh)`` of an array and ``gather_full`` undoes it (``shard_shape`` gives
the local shape from the mesh's sizes alone).  The specs are what the
layers run on: a model built with ``sharded=True`` holds each parameter
as its ``local_shard`` of ``tree_pspecs(param_specs())`` and computes
tensor-parallel over ``model`` (Megatron's column/row split, through the
differentiable collectives of ``distributed.collectives``), with the MoE
experts cut over ``data`` for ``ep_a2a``; the ZeRO-1 moments
(``zero_tree_pspecs``) are the sharded train step's
(``train.optimizer``).  ``constrain`` (the JAX package's
``with_sharding_constraint``, a hint to the SPMD partitioner) has no
eager counterpart and returns its input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .compat import axis_group, axis_index, axis_names, dp_axes, mesh_shape

SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

LOGICAL_TO_MESH = {
    "tp": "model",
    "ep": "data",
    "sp": "data",
    "dp_only": "data",
    None: None,
}

__all__ = ["LOGICAL_TO_MESH", "NamedSharding", "Spec", "batch_pspec",
           "constrain", "dp_axes", "gather_full", "local_shard",
           "logical_to_pspec", "shard_shape", "shard_slices", "spec_axes",
           "spec_leaves", "tree_pspecs", "tree_shardings", "zero_pspec",
           "zero_tree_pspecs"]


@dataclass(frozen=True)
class NamedSharding:
    """Where a leaf lives: a mesh and the spec of its dimensions."""
    mesh: Any
    spec: Spec


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(a, (str, type(None))) for a in x)


def _map_logical(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every logical tuple of a nested dict/list/tuple."""
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_logical(fn, v) for v in tree)
    return tree


def logical_to_pspec(logical: Sequence[Optional[str]], mesh) -> Spec:
    """Map a logical axis tuple to a mesh spec on ``mesh``."""
    names = axis_names(mesh)
    out = []
    for ax in logical:
        if ax == "dp":
            axes = dp_axes(mesh)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        elif ax in LOGICAL_TO_MESH:
            m = LOGICAL_TO_MESH[ax]
            out.append(m if m is None or m in names else None)
        else:
            raise ValueError(f"unknown logical axis {ax!r}")
    return tuple(out)


def tree_pspecs(logical_tree: Any, mesh) -> Any:
    """Map a tree of logical tuples to mesh specs."""
    return _map_logical(lambda l: logical_to_pspec(l, mesh), logical_tree)


def tree_shardings(logical_tree: Any, mesh) -> Any:
    """A tree of ``NamedSharding(mesh, spec)`` (``Checkpointer.restore``
    takes it)."""
    return _map_logical(
        lambda l: NamedSharding(mesh, logical_to_pspec(l, mesh)),
        logical_tree)


def _used_axes(spec: Spec) -> set:
    used = set()
    for s in spec:
        if isinstance(s, tuple):
            used.update(s)
        elif s is not None:
            used.add(s)
    return used


def zero_pspec(pspec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: additionally shard the first eligible dim over 'data'.

    A dim is eligible if it is unsharded in ``pspec`` and divisible by the
    data-axis size.  If none qualifies the spec is returned unchanged
    (moments stay TP-sharded only)."""
    sizes = mesh_shape(mesh)
    if "data" not in sizes:
        return pspec
    dsize = sizes["data"]
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    if "data" in _used_axes(pspec):
        return pspec
    for i, (dim, s) in enumerate(zip(shape, spec)):
        if s is None and dim % dsize == 0 and dim >= dsize:
            spec[i] = "data"
            return tuple(spec)
    return pspec


def zero_tree_pspecs(param_pspecs: Any, param_shapes: Any, mesh) -> Any:
    """``zero_pspec`` leaf by leaf over the port's trees (dicts and lists
    with spec tuples at the leaves); ``param_shapes`` holds tensors or
    shape tuples in the same structure."""
    def walk(spec, shp):
        if isinstance(spec, dict):
            return {k: walk(v, shp[k]) for k, v in spec.items()}
        if isinstance(spec, list):
            return [walk(v, s) for v, s in zip(spec, shp)]
        shape = tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)
        return zero_pspec(spec, shape, mesh)
    return walk(param_pspecs, param_shapes)


def batch_pspec(mesh, *trailing: SpecEntry) -> Spec:
    """Spec of a [B, ...] array: batch over all dp axes."""
    axes = dp_axes(mesh)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return (lead, *trailing)


def constrain(x, mesh, spec: Spec):
    """Identity: the JAX package's sharding hint has no eager counterpart
    (the port's layouts are explicit: ``local_shard``)."""
    return x


def _axes_of(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(shape: Sequence[int], spec: Spec, mesh) -> Tuple[slice, ...]:
    """This rank's slice of an array of ``shape`` laid out by ``spec``:
    a dimension cut over axes ``(a, b)`` takes chunk ``i_a * n_b + i_b``
    of ``n_a * n_b``, as in the JAX package's device order."""
    sizes = mesh_shape(mesh)
    out = []
    for d, dim in enumerate(shape):
        axes = _axes_of(spec[d]) if d < len(spec) else ()
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + axis_index(mesh, a)
        if dim % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({n})")
        chunk = dim // n
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def local_shard(x, spec: Spec, mesh):
    """This rank's shard of the full array ``x`` (a tensor or numpy
    array), contiguous."""
    part = x[shard_slices(x.shape, spec, mesh)]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    return part.contiguous()


def gather_full(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full array from every rank's ``local_shard`` (a collective on
    the groups of the spec's axes: all ranks call it)."""
    for d in range(len(spec)):
        for a in reversed(_axes_of(spec[d])):       # minor axis first
            group = axis_group(mesh, a)
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
    return x


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in dimension order."""
    return tuple(a for e in spec for a in _axes_of(e))


def spec_leaves(tree: Any, like: Any) -> list:
    """The specs of a spec tree (dicts and lists, spec tuples at the
    leaves) in the order ``tree.leaves(like)`` gives the leaves of a tree
    ``like`` of the same structure, matched by key (dict order may
    differ: the JAX package's trees come with sorted keys)."""
    if isinstance(like, dict):
        return [s for k, v in like.items() for s in spec_leaves(tree[k], v)]
    if isinstance(like, list):
        return [s for t, v in zip(tree, like) for s in spec_leaves(t, v)]
    return [tree]


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's ``local_shard`` of an array of ``shape``
    (needs the mesh's sizes only: a ``MeshShape`` will do)."""
    sizes = mesh_shape(mesh)
    out = []
    for d, dim in enumerate(shape):
        n = 1
        for a in (_axes_of(spec[d]) if d < len(spec) else ()):
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {spec[d]} ({n})")
        out.append(dim // n)
    return tuple(out)
