"""Convert the JAX package's parameter and state pytrees (as numpy) into
the port's per-layer layout.

The JAX ``LM`` stacks the ``R`` repetitions of its block pattern on a
leading axis (``params["stages"][p]`` leaves are ``[R, ...]``) and runs
the remaining ``tail`` layers unstacked; layer order is repetition-major:
``stages[0][0], stages[1][0], ..., stages[0][1], ..., tail[0], ...``.
The port keeps one dict per layer in that order, with every leaf of the
layer carried across (qwen3's ``q_norm``/``k_norm`` scales, MoE experts
``[E, ...]``, sLSTM's ``r [4, H, dh, dh]`` and the recurrent state leaves
included).
Arrays arrive as numpy (``jax.tree.map(np.asarray, tree)`` on the
caller's side), so this module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..config import ResolvedConfig
from .runtime import DeviceLike


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # owned copy


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _unstack(stages, tail, n_rep: int) -> List[Any]:
    """Repetition-major list of per-layer subtrees."""
    layers = []
    for r in range(n_rep):
        for stage in stages:
            layers.append(_map(stage, lambda a, r=r: np.asarray(a)[r]))
    layers.extend(tail)
    return layers


def _n_rep(rcfg: ResolvedConfig) -> int:
    return rcfg.base.num_layers // len(rcfg.base.block_pattern)


def from_jax_params(params_np: Dict[str, Any], rcfg: ResolvedConfig,
                    device: DeviceLike) -> Dict[str, Any]:
    """JAX ``LM.init`` pytree (numpy leaves) -> the port's parameters on
    ``device`` (required: the caller names where the weights live)."""
    layers = _unstack(params_np["stages"], params_np["tail"], _n_rep(rcfg))
    conv = lambda a: _tensor(a, device)              # noqa: E731
    return {
        "embed": _map(params_np["embed"], conv),
        "final_norm": _map(params_np["final_norm"], conv),
        "layers": [_map(layer, conv) for layer in layers],
    }


def states_from_jax(states_np: Dict[str, Any], rcfg: ResolvedConfig,
                    device: DeviceLike) -> List[Dict[str, Any]]:
    """JAX serve-state / arena pytree (numpy leaves) -> the port's
    per-layer KV caches, so arena contents compare like with like."""
    layers = _unstack(states_np["stages"], states_np["tail"], _n_rep(rcfg))
    return [_map(layer, lambda a: _tensor(a, device)) for layer in layers]
