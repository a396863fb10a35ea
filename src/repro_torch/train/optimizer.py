"""AdamW with gradient clipping and a warmup-cosine schedule.

The JAX package's optimizer (``init_opt_state`` / ``adamw_update``) over
the port's parameter trees, without its ZeRO-1 sharding of the moments
(the data-parallel step keeps them replicated).  Moments are f32, the update math is f32, and
parameters are cast back to their own dtype.  Unlike the reference's pure
update, ``adamw_update`` writes the new parameters and moments IN PLACE
(under ``torch.no_grad``), so a step at full width holds one copy of each.

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
from typing import Any, NamedTuple, Tuple

import torch

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


def init_opt_state(params: Any) -> OptState:
    """Step 0 and zero f32 moments on each parameter's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = sum(l.float().square().sum() for l in leaves(tree))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: OptState, ndims: Any
                 ) -> Tuple[Any, OptState, dict]:
    """One AdamW step, in place: returns (params, state, metrics) with
    ``params`` and the moments the same tensors, updated.  ``ndims`` is
    the tree of each leaf's ndim in the reference layout (weight decay
    only where it is at least 2)."""
    step = state.step + 1
    gnorm = global_norm(grads)
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

    tree_map(upd, params, grads, state.mu, state.nu, ndims)
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
