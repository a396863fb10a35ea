"""AdamW with gradient clipping and a warmup-cosine schedule.

The JAX package's optimizer (``init_opt_state`` / ``adamw_update``) over
the port's parameter trees.  Moments are f32, the update math is f32, and
parameters are cast back to their own dtype.  Unlike the reference's pure
update, ``adamw_update`` writes the new parameters and moments IN PLACE
(under ``torch.no_grad``), so a step at full width holds one copy of each.

ZeRO-1 (the reference's ``zero_tree_pspecs`` moments, which
``launch/specs.py`` gives its sharded step): over a mesh, with the
parameters held as this rank's shards of their specs, ``zero_layout``
adds ``data`` to the first dimension of each leaf that its spec leaves
whole and the data size divides (``distributed.sharding.zero_pspec`` of
the leaf's GLOBAL shape).  The moments are then this rank's slice of that
dimension; the gradient arrives as the same slice
(``train_loop.zero_reduce_grads``), each rank updates its slice of the
parameter, and the slices are all-gathered over ``data`` in rank order.
Leaves without such a dimension keep whole moments.  ``global_norm``
sums each leaf's local squares over the axes its gradient is cut over,
once per leaf, so a replicated leaf counts once.  Over one rank every
collective is the identity and the update is ``adamw_update``'s bit for
bit.

Weight decay: the reference decays a leaf when its ndim is at least 2 in
ITS layout, where a stacked layer carries a leading ``R`` axis; so every
leaf of a stacked layer is decayed (norm scales included) and a tail
layer's or ``final_norm``'s 1-d scales are not.  ``adamw_update`` takes
those ndims (``models.convert.jax_ndims``), so the port decays the same
leaves.

``schedule`` computes in f32 tensors in the reference's order of
operations (it equals the JAX value bit for bit on the CPU); the bias
corrections ``b ** step`` are f32 too, but XLA's ``pow`` and PyTorch's
can differ in the last bit at some steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..distributed.collectives import all_gather, group_sum
from ..distributed.compat import axis_group, axis_index, mesh_shape
from ..distributed.sharding import (Spec, shard_shape, spec_axes,
                                    spec_leaves, zero_pspec)
from ..tree import leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # scalar int32
    mu: Any                     # first moments (tree like params), f32
    nu: Any                     # second moments, f32


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac`` (f32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


class ZeroLeaf(NamedTuple):
    """One leaf's ZeRO-1 layout: its parameter's mesh spec, its moments'
    (``zero_pspec``), and the dimension that adds ``data`` (or None)."""
    spec: Spec
    zspec: Spec
    dim: Optional[int]


class ZeroLayout(NamedTuple):
    mesh: Any
    leaves: List[ZeroLeaf]           # in ``tree.leaves`` order


def _global_shape(local: Tuple[int, ...], spec: Spec, mesh
                  ) -> Tuple[int, ...]:
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(local):
        e = spec[d] if d < len(spec) else None
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= sizes[a]
        out.append(n)
    return tuple(out)


def zero_layout(local_shapes: Any, pspecs: Any, mesh) -> ZeroLayout:
    """The ZeRO-1 layout of a tree of local shards (tensors, or anything
    with ``.shape``) whose mesh specs are ``pspecs``."""
    out = []
    for t, spec in zip(leaves(local_shapes),
                       spec_leaves(pspecs, local_shapes)):
        shape = _global_shape(tuple(t.shape), spec, mesh)
        z = zero_pspec(spec, shape, mesh)
        dim = next((d for d, e in enumerate(z) if e == "data" and
                    (spec[d] if d < len(spec) else None) is None), None)
        out.append(ZeroLeaf(spec, z, dim))
    return ZeroLayout(mesh, out)


def moment_shapes(local_shapes: Any, layout: ZeroLayout) -> List[tuple]:
    """This rank's moment shape of every leaf, in leaf order."""
    return [shard_shape(_global_shape(tuple(t.shape), zl.spec, layout.mesh),
                        zl.zspec, layout.mesh)
            for t, zl in zip(leaves(local_shapes), layout.leaves)]


def init_opt_state(params: Any, layout: Optional[ZeroLayout] = None
                   ) -> OptState:
    """Step 0 and zero f32 moments on each parameter's device: whole, or
    this rank's ZeRO-1 slices under ``layout``."""
    if layout is None:
        shapes = iter([tuple(p.shape) for p in leaves(params)])
    else:
        shapes = iter(moment_shapes(params, layout))
    shapes = tree_map(lambda _: next(shapes), params)
    zeros = lambda p, s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                     device=p.device)
    dev = leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params, shapes),
                    tree_map(zeros, params, shapes))


def grad_axes(layout: ZeroLayout) -> List[Tuple[str, ...]]:
    """The mesh axes each leaf's reduced gradient is cut over."""
    return [spec_axes(zl.zspec if zl.dim is not None else zl.spec)
            for zl in layout.leaves]


def global_norm(tree: Any, layout: Optional[ZeroLayout] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  Under a ZeRO-1
    ``layout`` each leaf's local sum is first summed over the axes its
    gradient is cut over (one collective per set of axes)."""
    sq = [l.float().square().sum() for l in leaves(tree)]
    if layout is not None:
        by_axes = {}
        for i, axes in enumerate(grad_axes(layout)):
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            vec = torch.stack([sq[i] for i in idx])
            for a in axes:
                vec = group_sum(vec, axis_group(layout.mesh, a))
            for j, i in enumerate(idx):
                sq[i] = vec[j]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: OptState, ndims: Any,
                 layout: Optional[ZeroLayout] = None
                 ) -> Tuple[Any, OptState, dict]:
    """One AdamW step, in place: returns (params, state, metrics) with
    ``params`` and the moments the same tensors, updated.  ``ndims`` is
    the tree of each leaf's ndim in the reference layout (weight decay
    only where it is at least 2).  With a ZeRO-1 ``layout`` the gradients
    and moments are this rank's slices (module docstring)."""
    step = state.step + 1
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, mu, nu, nd):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        wd = cfg.weight_decay if nd >= 2 else 0.0
        p32 = p.float()
        p.copy_(p32 - lr * (delta + wd * p32))

    if layout is None:
        tree_map(upd, params, grads, state.mu, state.nu, ndims)
    else:
        mesh = layout.mesh
        for p, g, mu, nu, nd, zl in zip(
                leaves(params), leaves(grads), leaves(state.mu),
                leaves(state.nu), leaves(ndims), layout.leaves):
            if zl.dim is None:
                upd(p, g, mu, nu, nd)
                continue
            c = mu.shape[zl.dim]
            mine = p.narrow(zl.dim, axis_index(mesh, "data") * c, c)
            upd(mine, g, mu, nu, nd)
            if c != p.shape[zl.dim]:
                p.copy_(all_gather(mine, axis_group(mesh, "data"), zl.dim))
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
