"""Distributed collectives: SP-KV decode attention, ring collectives,
gradient compression.

Each function runs on every rank of the mesh on that rank's shard (the
JAX package calls its counterparts inside ``shard_map``) and exchanges
data through the process groups of the mesh's axes.

``sp_decode_attention``
    Long-context decode: the KV cache sequence dim is sharded over the
    ``data`` axis.  Each rank runs the decode kernel's log-sum-exp mode
    (``ops.decode_attention_lse``) over its slice and the partial
    softmaxes are combined with a MAX and a SUM all-reduce: the
    flash-decoding pattern across ranks.

``ring_all_gather`` / ``ring_reduce_scatter`` / ``matmul_ag_overlap``
    Chunked rings of ``batch_isend_irecv`` hops (the reference's
    ``lax.ppermute``), in the reference's order of hops, chunks and adds.

``int8_compress`` / ``int8_decompress`` + ``compressed_psum``
    Per-tensor int8 quantization with error feedback for the cross-pod
    gradient all-reduce.

``copy_to_model`` / ``reduce_from_model`` / ``gather_from_model`` /
``gather_to_model`` / ``mean_over`` / ``all_to_all`` (differentiable) and
``group_sum`` / ``reduce_scatter`` / ``all_gather`` (on gradients and
optimizer slices)
    What GSPMD inserts for the reference's tensor-parallel specs, made
    explicit (Megatron's pair): ``copy_to_model`` is the identity forward
    and sums the gradient over the axis, ``reduce_from_model`` sums
    forward and passes the gradient through, ``gather_from_model``
    concatenates the ranks' shards into a value every rank then uses
    alike (the gradient: this rank's slice), ``gather_to_model``
    concatenates them into a value each rank uses for its own part (the
    gradient: reduce-scattered, the adjoint of the gather),
    ``mean_over`` (the reference's ``pmean``) averages both ways, and
    ``all_to_all``'s backward is the exchange back.  Every sum is taken
    in rank order (an all-gather, then adds from rank 0 up), so every
    rank holds the same bits and two runs are bitwise equal; over a
    group of one rank each is the identity.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels import ops
from .compat import axis_group, axis_index, axis_names, axis_size


# ---------------------------------------------------------------------------
# Sequence-parallel (SP-KV) decode attention
# ---------------------------------------------------------------------------

def _lse_scaled(part: torch.Tensor, m_glob: torch.Tensor) -> torch.Tensor:
    """A rank's ``[..., Dh + 2]`` parts (acc, l, m) rescaled to the global
    max: ``[..., Dh + 1]`` (acc, l), zero where the rank saw no key."""
    m = part[..., -1]
    m_safe = torch.where(torch.isneginf(m_glob), 0.0, m_glob)
    scale = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    return part[..., :-1] * scale[..., None]


def _lse_finish(acc_l: torch.Tensor, dtype) -> torch.Tensor:
    return (acc_l[..., :-1]
            / torch.clamp(acc_l[..., -1], min=1e-30)[..., None]).to(dtype)


def merge_lse(parts: List[torch.Tensor], dtype) -> torch.Tensor:
    """The combine of ``sp_decode_attention`` over parts held in one
    process (shard order): global max, rescale, sum, divide."""
    m_glob = torch.stack([p[..., -1] for p in parts]).amax(0)
    total = _lse_scaled(parts[0], m_glob)
    for p in parts[1:]:
        total = total + _lse_scaled(p, m_glob)
    return _lse_finish(total, dtype)


def sp_decode_attention(q: torch.Tensor, k_local: torch.Tensor,
                        v_local: torch.Tensor, kv_len: torch.Tensor, mesh,
                        sm_scale: float, axis: str = "data",
                        heads_local: bool = False) -> torch.Tensor:
    """Flash-decoding across the mesh.

    q [B, Hq, Dh] is replicated over ``axis``; k_local/v_local [B,
    S_local, Hkv, Dh] are this rank's slice of the cache's sequence (rank
    i holds positions ``[i * S_local, (i + 1) * S_local)``); kv_len [B]
    is the global valid length.  When the KV heads divide over a
    ``model`` axis larger than 1 (the reference's rule), each rank also
    takes only its heads and the heads are gathered at the end.  With
    ``heads_local`` q and the cache hold this rank's heads already (a
    tensor-parallel attention layer): they are neither cut nor gathered.
    Returns [B, Hq, Dh] in q's dtype on every rank of ``axis``."""
    s_local = k_local.shape[1]
    idx = axis_index(mesh, axis)
    tp = axis_size(mesh, "model") if "model" in axis_names(mesh) else 1
    heads = not heads_local and tp > 1 and k_local.shape[2] % tp == 0
    if heads:
        j = axis_index(mesh, "model")
        hk, hq = k_local.shape[2] // tp, q.shape[1] // tp
        q = q[:, j * hq:(j + 1) * hq]
        k_local = k_local[:, :, j * hk:(j + 1) * hk]
        v_local = v_local[:, :, j * hk:(j + 1) * hk]
    local_len = torch.clamp(kv_len - idx * s_local, 0, s_local)
    part = ops.decode_attention_lse(q, k_local, v_local, local_len,
                                    sm_scale=sm_scale)
    group = axis_group(mesh, axis)
    m_glob = part[..., -1].clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    acc_l = _lse_scaled(part, m_glob)
    dist.all_reduce(acc_l, op=dist.ReduceOp.SUM, group=group)
    out = _lse_finish(acc_l, q.dtype)
    if heads:
        parts = [torch.empty_like(out) for _ in range(tp)]
        dist.all_gather(parts, out.contiguous(),
                        group=axis_group(mesh, "model"))
        out = torch.cat(parts, dim=1)
    return out


# ---------------------------------------------------------------------------
# Ring collectives (chunked, overlappable)
# ---------------------------------------------------------------------------

def _ring_shift(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """One ppermute hop ``i -> i + 1`` around the axis: send ``x`` to the
    next rank, return what the previous one sent."""
    group = axis_group(mesh, axis_name)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + 1) % n),
                   group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - 1) % n),
                   group)])
    for r in reqs:
        r.wait()
    return out


def _in_rank_order(chunks: List[torch.Tensor], idx: int, n: int
                   ) -> List[torch.Tensor]:
    """Chunk j of a ring came from rank (idx - j) mod n: rank order."""
    out = [None] * n
    for j, c in enumerate(chunks):
        out[(idx - j) % n] = c
    return out


def ring_all_gather(x: torch.Tensor, mesh, axis_name: str, *,
                    axis: int = 0) -> torch.Tensor:
    """All-gather via n-1 ring hops: the concatenation over the mesh axis
    along ``axis``, in rank order."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    chunks, cur = [x], x
    for _ in range(n - 1):
        cur = _ring_shift(cur, mesh, axis_name)
        chunks.append(cur)
    idx = axis_index(mesh, axis_name)
    return torch.cat(_in_rank_order(chunks, idx, n), dim=axis)


def ring_reduce_scatter(x: torch.Tensor, mesh, axis_name: str, *,
                        axis: int = 0) -> torch.Tensor:
    """Reduce-scatter via n-1 ring hops and adds, the reference's: rank i
    starts from chunk i + 1 of its input and, at hop s, adds chunk
    i + 1 + s of its own input to the partial received from rank i - 1.
    With n == 2 that is chunk i of the sum.  With n > 2 the partials mix
    chunks (rank i - 1 sent a sum over other chunk indices), so the
    result is not a reduce-scatter: a fault of the reference, kept for
    parity (ROADMAP Queue 3)."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    assert x.shape[axis] % n == 0
    chunk = x.shape[axis] // n
    idx = axis_index(mesh, axis_name)

    def get_chunk(j):
        return x.narrow(axis, j * chunk, chunk)

    acc = get_chunk((idx + 1) % n)
    for step in range(1, n):
        acc = _ring_shift(acc, mesh, axis_name)
        acc = acc + get_chunk((idx + 1 + step) % n)
    return acc


# ---------------------------------------------------------------------------
# Gradient compression (int8 + error feedback)
# ---------------------------------------------------------------------------

def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, mesh, axis_name: str,
                    error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed all-reduce with error feedback.

    Compensates ``x + error`` (the residual from the previous step),
    reduces the quantized tensor, and returns (mean-reduced value, new
    local error).  The reduction is an all-reduce of the dequantized
    value (as the reference's psum; the wire format models 1 byte an
    element)."""
    n = axis_size(mesh, axis_name)
    xc = x.float() + (error if error is not None else 0.0)
    q, scale = int8_compress(xc)
    deq = int8_decompress(q, scale)
    new_error = xc - deq
    dist.all_reduce(deq, op=dist.ReduceOp.SUM,
                    group=axis_group(mesh, axis_name))
    return (deq / n).to(x.dtype), new_error


# ---------------------------------------------------------------------------
# Overlapped TP matmul (all-gather x-shards while computing)
# ---------------------------------------------------------------------------

def matmul_ag_overlap(x: torch.Tensor, w: torch.Tensor, mesh,
                      axis_name: str) -> torch.Tensor:
    """Full-sequence ``x @ w`` from sequence-sharded x [B, S/n, D] and a
    weight shard [D, F_local]: at each of the n ring steps multiply the
    chunk in hand while the next one travels.  Returns [B, S, F_local]."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x @ w
    outs, cur = [], x
    for step in range(n):
        outs.append(cur @ w)
        if step < n - 1:
            cur = _ring_shift(cur, mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    return torch.cat(_in_rank_order(outs, idx, n), dim=1)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (differentiable; sums in rank order)
# ---------------------------------------------------------------------------

def _gather_parts(x: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, added in rank order
    (bitwise the same on every rank); ``x`` itself over one rank."""
    if dist.get_world_size(group) == 1:
        return x
    parts = _gather_parts(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk (by rank order along ``dim``) of ``group_sum(x)``,
    bitwise: each rank receives its chunk of every rank's ``x`` and adds
    them in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = recv[0]
    for r in recv[1:]:
        out = out + r
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(_gather_parts(x, group), dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group_sum(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group) / dist.get_world_size(ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)], None, None


class _GatherToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()          # the output must not inherit x's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def copy_to_model(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis``.  Put where a
    value held alike by every rank of the axis feeds a rank-local part
    (a column-parallel product, a head-local norm)."""
    return _CopyToModel.apply(x, axis_group(mesh, axis))


def reduce_from_model(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axis``; the gradient
    passes through (a row-parallel product's output)."""
    return _ReduceFromModel.apply(x, axis_group(mesh, axis))


def gather_from_model(x: torch.Tensor, mesh, dim: int,
                      axis: str = "model") -> torch.Tensor:
    """The ranks' shards of ``axis`` concatenated along ``dim`` in rank
    order, a value every rank then uses alike (a column-parallel output
    that joins the replicated residual stream); the gradient, whole on
    every rank, gives back this rank's slice."""
    return _GatherFromModel.apply(x, axis_group(mesh, axis), dim % x.dim())


def gather_to_model(x: torch.Tensor, mesh, dim: int,
                    axis: str = "model") -> torch.Tensor:
    """The ranks' shards of ``axis`` concatenated along ``dim`` in rank
    order, a value each rank uses for its own part (a recurrent mixer's
    whole heads, read by the rank's columns): the gradient, partial on
    each rank, is summed over ``axis`` and cut back to this rank's slice
    (``reduce_scatter``, in rank order)."""
    return _GatherToModel.apply(x, axis_group(mesh, axis), dim % x.dim())


def mean_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's ``pmean``: the mean over ``axis``, forward and
    backward."""
    return _MeanOver.apply(x, axis_group(mesh, axis))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``'s leading axis cut into one slab a rank of ``axis``: slab j
    goes to rank j, which receives the ranks' slabs in rank order (the
    reference's ``lax.all_to_all(split_axis=0, concat_axis=0)``).  The
    backward is the same exchange, which sends each slab's gradient
    back."""
    return _AllToAll.apply(x, axis_group(mesh, axis))
