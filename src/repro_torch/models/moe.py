"""Mixture-of-Experts FFN: top-k router with capacity-based dispatch.

The JAX package's ``tp_dense`` strategy, batched over rows: every batch row
routes its own tokens into its own ``[E, C, D]`` expert buffer (the JAX
package ``vmap``s ``_moe_tokens`` over rows), so a row's output does not
depend on the other rows of its launch.  Within a row, assignments take
buffer positions in token-major order (token ``t``'s ``k`` choices before
token ``t + 1``'s); an assignment whose position reaches the capacity is
DROPPED and contributes nothing.  The row capacity is
``int(S * top_k * capacity_factor * 1.6 / E)``, at least 1, rounded up to
a multiple of 128 once it reaches 128: a token kept in one pass can be
dropped in another whose chunk length differs (decode has capacity 1 and
drops nothing, since a token's ``top_k`` experts are distinct).

Only kept assignments are written into the buffer.  Their (expert,
position) pairs are unique within a row, so the write needs no atomic
accumulation: it equals the JAX package's scatter-add (which adds zeros
for the dropped ones) bit for bit and is deterministic on the card.
Dropped assignments are written into one spare position past the
capacity, which the expert products never read, so nothing syncs with the
host.  The expert products are plain batched matrix products, as they are
outside any Pallas kernel in the JAX package.

``moe_apply`` takes the reference's ``strategy`` names and its dispatch
rules.  Without a device mesh every strategy runs ``tp_dense``.  Over a
mesh (``distributed.compat``), each rank passes its local batch shard:

``ep_a2a``   experts sharded over ``data``, d_ff over ``model``: every
             rank routes its own tokens (capacity ``max(int(t * top_k *
             cf / E), 8)`` over its ``t`` tokens), fills the full ``[E, C,
             D]`` buffer, and two ``collectives.all_to_all`` on the data
             group carry expert slabs to their owners and back; the
             partial down-projection is summed over ``model``.
``tp_smap``  experts replicated, d_ff over ``model``: the per-row dispatch
             of ``tp_dense`` with capacity ``max(int(S * top_k * 1.6 * cf
             / E), 8)`` on the rank's d_ff slice, the combine BEFORE the
             ``model`` sum (it is linear, so it commutes with the
             reduction and moves the token batch instead of the buffer),
             and the aux loss averaged over ``model``.

Both carry gradients.  The exchanges are differentiable
(``distributed.collectives``): the all-to-all's backward sends each slab's
gradient back to the rank it came from, so a rank's expert gradient sums
every data rank's tokens; ``copy_to_model`` on the tokens that enter the
d_ff slice (and, in ``tp_smap``, on the combine weights, which multiply a
partial output) sums their gradients over ``model``, and
``reduce_from_model`` on the partial output passes its gradient through.
Each rank's aux loss is its own tokens' (the reference's ``out_specs=P()``
gives the mean of the shards' under ``jax.grad``).

The strategies take the full parameters and cut this rank's slices with
``distributed.sharding.local_shard`` under ``spec_moe(strategy)``, or,
with ``sharded=True``, take the slices themselves (a tensor-parallel
model holds only those).  A ``tp_dense`` layer whose d_ff is sharded over
``model`` (``ep_a2a`` weights on a mesh whose ``data`` axis is 1, as the
reference's dispatch gives) runs ``tp_dense``'s capacity on the slices
with the same ``model`` sum.

``DROP_LOG``: when set to a list, every MoE layer appends the keep mask
of its call (``[B, S, top_k]`` bool, on the device: nothing syncs), so a
caller can count the dropped assignments of a pass or compare two passes'
drop decisions; None (the default) records nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..distributed.collectives import all_to_all, copy_to_model, \
    mean_over, reduce_from_model
from ..distributed.compat import axis_names, axis_size, mesh_shape
from ..distributed.sharding import local_shard, logical_to_pspec
from .layers import ACTS, _dense_init

STRATEGIES = ("tp_dense", "tp_smap", "ep_a2a")
ROW_CAPACITY_SCALE = 1.6     # the reference's per-row capacity factor boost

DROP_LOG: Optional[List[torch.Tensor]] = None


def init_moe(gen: torch.Generator, d: int, f: int, num_experts: int,
             dtype) -> Dict[str, torch.Tensor]:
    return {
        "router": _dense_init(gen, (d, num_experts), d, torch.float32),
        "w1": _dense_init(gen, (num_experts, d, f), d, dtype),
        "w3": _dense_init(gen, (num_experts, d, f), d, dtype),
        "w2": _dense_init(gen, (num_experts, f, d), f, dtype),
    }


def spec_moe(strategy: str) -> Dict[str, tuple]:
    e = "ep" if strategy == "ep_a2a" else None
    return {
        "router": (None, None),
        "w1": (e, None, "tp"),
        "w3": (e, None, "tp"),
        "w2": (e, "tp", None),
    }


def _route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., T, D] -> (expert ids [..., T, K], combine weights [..., T, K],
    router logits [..., T, E] in f32)."""
    logits = x.float() @ router_w
    weights, ids = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return ids, weights, logits


def _dispatch_indices(ids: torch.Tensor, num_experts: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each (token, k) assignment in its expert's buffer.

    ids [..., T, K] -> (pos [..., T, K], keep [..., T, K]): positions count
    per row in token-major order; assignments at or past ``capacity`` are
    dropped."""
    lead, (T, K) = ids.shape[:-2], ids.shape[-2:]
    flat = ids.reshape(*lead, T * K)
    onehot = torch.nn.functional.one_hot(flat, num_experts)   # [..., TK, E]
    pos_in_expert = torch.cumsum(onehot, dim=-2) - 1
    pos = torch.gather(pos_in_expert, -1, flat[..., None])[..., 0]
    pos = pos.reshape(ids.shape)
    return pos, pos < capacity


def _expert_ffn(w1, w3, w2, buf: torch.Tensor, act: str) -> torch.Tensor:
    """buf [E, N, D] -> [E, N, D] through each expert's gated MLP."""
    a = ACTS[act]
    h = a(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def row_capacity(seq: int, top_k: int, capacity_factor: float,
                 num_experts: int) -> int:
    """Expert buffer positions of one row of ``seq`` tokens, in the JAX
    package's order of float operations."""
    row_cf = capacity_factor * ROW_CAPACITY_SCALE
    cap = max(int(seq * top_k * row_cf / num_experts), 1)
    return ((cap + 127) // 128) * 128 if cap >= 128 else cap


def _moe_tokens(params, x: torch.Tensor, *, top_k: int, capacity: int,
                act: str, tp_mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row MoE over x [B, S, D] -> (out [B, S, D], router logits
    [B, S, E], expert ids [B, S, K]).  With ``tp_mesh`` the expert weights
    are d_ff slices and ``out`` is this rank's partial sum."""
    B, S, D = x.shape
    E = params["w1"].shape[0]
    ids, weights, logits = _route(params["router"], x, top_k)
    pos, keep = _dispatch_indices(ids, E, capacity)
    if DROP_LOG is not None:
        DROP_LOG.append(keep)
    if tp_mesh is not None:
        x, weights = copy_to_model(x, tp_mesh), copy_to_model(weights,
                                                               tp_mesh)
    # kept assignments at unique (row, expert, position); dropped ones at
    # the spare position ``capacity``, never read
    slot = torch.where(keep, pos, capacity)
    b_idx = torch.arange(B, device=x.device)[:, None, None].expand_as(ids)
    src = x[:, :, None, :].expand(B, S, top_k, D)
    buf = x.new_zeros((B, E, capacity + 1, D))
    buf[b_idx, ids, slot] = src
    buf = buf[:, :, :capacity]
    # every expert over every row's buffer: [E, B * C, D]
    flat = buf.permute(1, 0, 2, 3).reshape(E, B * capacity, D)
    out_buf = _expert_ffn(params["w1"], params["w3"], params["w2"], flat, act)
    out_buf = out_buf.reshape(E, B, capacity, D).permute(1, 0, 2, 3)
    gathered = out_buf[b_idx, ids, torch.where(keep, pos, 0)]  # [B, S, K, D]
    gathered = torch.where(keep[..., None], gathered.float(), 0.0)
    out = (gathered * weights[..., None]).sum(-2).to(x.dtype)
    return out, logits, ids


def _aux_loss(router_logits: torch.Tensor, ids: torch.Tensor,
              num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss ``E * sum_e f_e * p_e`` over flat
    tokens: logits [T, E], ids [T, K]."""
    probs = torch.softmax(router_logits, dim=-1)
    frac = torch.nn.functional.one_hot(ids[:, 0], num_experts).float().mean(0)
    return num_experts * (frac * probs.mean(0)).sum()


def moe_apply_tp_dense(params, x: torch.Tensor, *, top_k: int,
                       capacity_factor: float, act: str = "silu"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux loss scalar), dispatch per row."""
    B, S, D = x.shape
    E = params["w1"].shape[0]
    cap = row_capacity(S, top_k, capacity_factor, E)
    out, logits, ids = _moe_tokens(params, x, top_k=top_k, capacity=cap,
                                   act=act)
    aux = _aux_loss(logits.reshape(B * S, E), ids.reshape(B * S, top_k), E)
    return out, aux


def _local_weights(params, strategy: str, mesh, sharded: bool
                   ) -> Dict[str, torch.Tensor]:
    """This rank's slices of the expert weights under ``spec_moe``
    (``params`` as they are when they hold the slices already)."""
    if sharded:
        return params
    spec = spec_moe(strategy)
    out = {"router": params["router"]}
    for k in ("w1", "w3", "w2"):
        out[k] = local_shard(params[k], logical_to_pspec(spec[k], mesh),
                             mesh)
    return out


def _model_parallel(mesh) -> bool:
    return "model" in axis_names(mesh) and axis_size(mesh, "model") > 1


def moe_apply_ep_a2a(params, x: torch.Tensor, *, top_k: int,
                     capacity_factor: float, act: str = "silu", mesh,
                     dp_spec=None, sharded: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over this rank's tokens x [B_loc, S, D] ->
    (out [B_loc, S, D], this rank's aux loss)."""
    b_loc, S, D = x.shape
    E = params["router"].shape[1]
    n_data = axis_size(mesh, "data")
    assert E % n_data == 0, (E, n_data)
    e_loc = E // n_data
    w = _local_weights(params, "ep_a2a", mesh, sharded)  # [E_loc, D, F_loc]
    tp = _model_parallel(mesh)
    t = b_loc * S
    x2d = x.reshape(t, D)
    capacity = max(int(t * top_k * capacity_factor / E), 8)
    ids, weights, logits = _route(w["router"], x2d, top_k)
    pos, keep = _dispatch_indices(ids, E, capacity)
    if DROP_LOG is not None:
        DROP_LOG.append(keep)
    xe = copy_to_model(x2d, mesh) if tp else x2d
    # kept assignments at unique (expert, position); dropped ones at the
    # spare position ``capacity``, cut off before the exchange
    buf = x.new_zeros((E, capacity + 1, D))
    buf[ids, torch.where(keep, pos, capacity)] = \
        xe[:, None, :].expand(t, top_k, D)
    send = buf[:, :capacity].reshape(n_data, e_loc, capacity, D)
    # dispatch: slab j of every rank goes to rank j, which then holds the
    # tokens of every rank for its own experts
    recv = all_to_all(send, mesh, "data")
    recv = recv.transpose(0, 1).reshape(e_loc, n_data * capacity, D)
    out_loc = _expert_ffn(w["w1"], w["w3"], w["w2"], recv, act)
    if tp:
        out_loc = reduce_from_model(out_loc, mesh)
    # return: the reverse exchange
    back = out_loc.reshape(e_loc, n_data, capacity, D).transpose(0, 1)
    ret = all_to_all(back, mesh, "data").reshape(E, capacity, D)
    gathered = ret[ids, torch.where(keep, pos, 0)]         # [t, K, D]
    gathered = torch.where(keep[..., None], gathered.float(), 0.0)
    out = (gathered * weights[..., None]).sum(-2).to(x.dtype)
    return out.reshape(b_loc, S, D), _aux_loss(logits, ids, E)


def _moe_model_sum(w, x: torch.Tensor, *, top_k: int, capacity: int,
                   act: str, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row MoE over d_ff slices, the partial outputs summed over
    ``model`` after the combine -> (out, this rank's aux loss)."""
    b_loc, S, _ = x.shape
    E = w["router"].shape[1]
    out, logits, ids = _moe_tokens(w, x, top_k=top_k, capacity=capacity,
                                   act=act, tp_mesh=mesh)
    out = reduce_from_model(out, mesh)            # combined, not buffer
    aux = _aux_loss(logits.reshape(b_loc * S, E),
                    ids.reshape(b_loc * S, top_k), E)
    return out, aux


def moe_apply_tp_smap(params, x: torch.Tensor, *, top_k: int,
                      capacity_factor: float, act: str = "silu", mesh,
                      dp_spec=None, sharded: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel MoE over this rank's rows x [B_loc, S, D], the
    ``model`` sum after the per-token combine."""
    S = x.shape[1]
    E = params["router"].shape[1]
    row_cf = capacity_factor * ROW_CAPACITY_SCALE
    capacity = max(int(S * top_k * row_cf / E), 8)
    w = _local_weights(params, "tp_smap", mesh, sharded)  # [E, D, F_loc]
    out, aux = _moe_model_sum(w, x, top_k=top_k, capacity=capacity,
                              act=act, mesh=mesh)
    return out, mean_over(aux, mesh, "model")


def moe_apply(params, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              strategy: str = "tp_dense", act: str = "silu", mesh=None,
              dp_spec=None, sharded: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN by strategy name, with the JAX package's dispatch: a
    mesh whose ``data`` axis is larger than 1 runs ``ep_a2a`` for it; a
    ``model`` axis larger than 1 with a batch spec runs ``tp_smap`` for
    ``tp_dense`` and ``tp_smap``; everything else runs ``tp_dense``
    (over d_ff slices summed over ``model`` when ``sharded`` weights are
    cut there)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown MoE strategy {strategy!r}")
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, act=act)
    if mesh is not None and "model" in axis_names(mesh):
        sizes = mesh_shape(mesh)
        if strategy == "ep_a2a" and sizes.get("data", 1) > 1:
            return moe_apply_ep_a2a(params, x, mesh=mesh, dp_spec=dp_spec,
                                    sharded=sharded, **kw)
        if strategy in ("tp_dense", "tp_smap") and sizes["model"] > 1 \
                and dp_spec is not None:
            return moe_apply_tp_smap(params, x, mesh=mesh, dp_spec=dp_spec,
                                     sharded=sharded, **kw)
        if sharded and sizes["model"] > 1:
            E = params["router"].shape[1]
            return _moe_model_sum(
                params, x, top_k=top_k, act=act, mesh=mesh,
                capacity=row_capacity(x.shape[1], top_k, capacity_factor, E))
    return moe_apply_tp_dense(params, x, **kw)
