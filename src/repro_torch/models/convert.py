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
Whisper's JAX tree keeps its layers unstacked (``enc``/``dec`` tuples),
so ``whisper_from_jax`` only turns the tuples into lists.
Arrays arrive as numpy (``jax.tree.map(np.asarray, tree)`` on the
caller's side), so this module imports nothing of JAX.

``shard_params`` cuts a full parameter tree into one rank's shards of
its model's ``param_specs`` over a mesh: what a model built with
``sharded=True`` holds.

``jax_ndims`` tells the optimizer how many dimensions each port leaf has
in the JAX layout: the reference's AdamW decays exactly the leaves with
``ndim >= 2`` there, which includes every norm scale of a stacked layer
(``[R, d]``) and no norm scale of a tail layer or of ``final_norm``
(``[d]``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..config import ResolvedConfig
from ..distributed.sharding import local_shard, spec_leaves, tree_pspecs
from ..tree import tree_map
from .runtime import DeviceLike


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # owned copy


def _unstack(stages, tail, n_rep: int) -> List[Any]:
    """Repetition-major list of per-layer subtrees."""
    layers = []
    for r in range(n_rep):
        for stage in stages:
            layers.append(tree_map(lambda a, r=r: np.asarray(a)[r], stage))
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
        "embed": tree_map(conv, params_np["embed"]),
        "final_norm": tree_map(conv, params_np["final_norm"]),
        "layers": [tree_map(conv, layer) for layer in layers],
    }


def jax_ndims(params: Dict[str, Any], rcfg: ResolvedConfig) -> Any:
    """The tree of ``params`` with each leaf replaced by the ndim of its
    counterpart in the JAX package's layout: a layer among the first
    ``R * len(block_pattern)`` (stacked there on a leading ``R`` axis)
    counts one more dimension than it has here.  Whisper stacks
    nothing."""
    out = tree_map(lambda t: t.dim(), params)
    if not rcfg.base.encoder_layers:
        stacked = _n_rep(rcfg) * len(rcfg.base.block_pattern)
        for i in range(stacked):
            out["layers"][i] = tree_map(lambda n: n + 1, out["layers"][i])
    return out


def whisper_from_jax(tree_np: Dict[str, Any], device: DeviceLike
                     ) -> Dict[str, Any]:
    """JAX ``WhisperModel`` params or serve states (numpy leaves) -> the
    port's: the same dicts with lists for the per-layer tuples."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _tensor(t, device)
    return conv(tree_np)


def states_from_jax(states_np: Dict[str, Any], rcfg: ResolvedConfig,
                    device: DeviceLike) -> List[Dict[str, Any]]:
    """JAX serve-state / arena pytree (numpy leaves) -> the port's
    per-layer KV caches, so arena contents compare like with like."""
    layers = _unstack(states_np["stages"], states_np["tail"], _n_rep(rcfg))
    return [tree_map(lambda a: _tensor(a, device), layer) for layer in layers]


def shard_params(params: Dict[str, Any], model, mesh) -> Dict[str, Any]:
    """This rank's ``local_shard`` of every leaf of ``params`` (full
    arrays, tensors or numpy) under ``tree_pspecs(model.param_specs(),
    mesh)``."""
    specs = iter(spec_leaves(tree_pspecs(model.param_specs(), mesh),
                             params))
    return tree_map(lambda t: local_shard(t, next(specs), mesh), params)
