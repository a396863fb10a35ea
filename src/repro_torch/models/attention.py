"""GQA self-attention block with KV caches (full attention).

Modes
-----
``full``     causal (or bidirectional) self-attention over the whole input;
             optionally emits a KV cache ("prefill").
``extend``   chunked prefill: queries are a suffix at ``q_offset``; cached
             KV for ``[0, q_offset)`` is reused (the cascade
             fraction-extension primitive).
``decode``   one new token per sequence against the cache.

Caches are dicts ``{"k": [B, S_alloc, KV, Dh], "v": ...}``; keys are stored
*post-RoPE* so cache entries are position-final.  Unlike the JAX package,
caches are updated IN PLACE (the returned cache is the same dict): the
chunk or token KV is written with ``index_put_`` into the preallocated
tensors, cast to the cache dtype on the write.

Paged serving: ``extend``/``decode`` also accept ``slots`` [B], in which
case ``cache`` is a persistent slot ARENA ``{"k": [N_rows, S_alloc, KV,
Dh], ...}`` shared by many documents — row ``slots[b]`` belongs to batch
row ``b`` (the last arena row is the serving scratch/padding sentinel).
Attention reads the arena through the paged kernels
(``ops.attention_paged`` / ``ops.arena_decode_attention``) — no [B, S]
gather copy.

``qk_norm`` (qwen3, gemma3) applies a per-head RMS norm to q and k after
the projections and before RoPE, in every mode.

Sliding-window layers (``window > 0``, gemma3's local layers) keep RING
caches of ``Wn = cache.shape[1]`` slots (``min(window, S_alloc)``):
absolute position ``p`` lives in slot ``p % Wn``, valid because softmax
attention is permutation-invariant over the key set once positions are
baked into the keys.  As in the JAX package:

- ``full`` with a cache builds a ring of ``window`` slots from the last
  ``min(S, window)`` keys;
- ``extend`` at ``q_offset == 0`` attends through ``ops.attention(...,
  window=)`` (the flash kernel on the card), then writes the chunk's last
  ``min(S, Wn)`` keys into the ring;
- ``extend`` at ``q_offset > 0`` attends over the ring plus the chunk on a
  masked plain path (f32 scores ``[B, Hq, S, Wn + S]``; the JAX package
  computes it outside any kernel too), each ring slot's position rebuilt
  from its index;
- ``decode`` writes at ``pos % Wn`` and reads ``min(cache_len + 1, Wn)``
  slots through ``ops.decode_attention``.

The ring holds whatever the chunk carried, bucket PAD included: a
document padded past the window keeps pad keys in its ring and the decode
reads every slot, as the JAX package does (the port keeps its semantics).
Paged serving (``slots``) takes full attention only.

M-RoPE (qwen2-vl): with ``mrope_sections`` the rotation reads
``positions3`` [B, S, 3] (t, h, w) instead of ``positions``; text-only
input takes t = h = w = position.  Keys go into the cache post-rotation,
so decode and extend need no M-RoPE knowledge beyond their own
positions.

Cross-attention (whisper's decoder): with ``kv_ctx=(k, v)`` the block
projects only the queries and attends, bidirectionally, over K/V that the
caller computed once from the encoder output; no cache is written and no
rotation applied.  ``use_rope=False`` skips the rotation of self-attention
too (whisper adds absolute sinusoids to its inputs instead).

Training runs ``full`` mode with ``want_cache=False``: ``ops.attention``
then records the gradient (``kernels.flash_attention.FlashAttentionFn``).

Sequence-parallel decode (``sp_mesh``, a device mesh): a full-attention
cache is cut along its sequence over the mesh's ``data`` axis, rank ``i``
holding positions ``[i * S_local, (i + 1) * S_local)`` in a cache of
``S_local`` slots.  A prefill (``extend`` at ``q_offset`` 0, or ``full``
with a cache) attends over the whole chunk on every rank and keeps the
rank's slice; a decode step writes the token's K/V only on the rank that
owns its position and attends through
``distributed.collectives.sp_decode_attention`` (the decode kernel's
log-sum-exp mode and two all-reduces).  Windowed layers keep their ring
path, as in the JAX package.  An extend at ``q_offset > 0`` and paged
serving take no sharded cache.

Tensor parallelism (``tp_mesh``, a mesh whose ``model`` axis is larger
than 1; the parameters this rank's shards of ``spec_attention``): ``wq``
and ``wo`` hold this rank's query heads, ``wk``/``wv`` its KV heads when
``kv_sharded`` (the KV heads divide over ``tp``), else all of them, of
which the rank reads the KV heads of its own query heads.  The input
enters through ``copy_to_model``, so do the replicated weights that act
on the rank's heads alone (``wk``/``wv`` when not sharded, the QK-norm
scales), and ``wo``'s partial output leaves through
``reduce_from_model``.  The local heads run the same kernels at local
head counts.  What each cache holds under it:

- a dense cache or ring of sharded KV heads holds the rank's KV heads;
- one of replicated KV heads (``spec_kv_cache(kv_sharded=False)``:
  recurrentgemma's single MQA head at any ``tp``) holds every KV head on
  every rank: a serving step projects them all and writes the same
  cache on every rank, and attends over the KV heads of the rank's query
  heads (in training only those are projected);
- a sequence-parallel cache holds the rank's KV heads of its ``data``
  slice: the decode kernel's log-sum-exp mode runs over the rank's heads
  and the combine runs over ``data`` (``sp_decode_attention(...,
  heads_local=True)``);
- cross-attention (``kv_ctx``) reads the rank's heads of the K/V the
  caller projected with the rank's ``wk``/``wv`` shards.

Paged caches (``slots``) take no model axis: they raise (ROADMAP Queue
1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed.collectives import copy_to_model, reduce_from_model, \
    sp_decode_attention
from ..distributed.compat import axis_index, axis_size
from ..kernels import ops
from ..kernels.ref import NEG_INF
from .layers import (apply_mrope, apply_rope, init_dense, init_rmsnorm,
                     rmsnorm_apply)


def init_attention(gen: torch.Generator, d: int, h: int, kv: int, dh: int,
                   dtype, qk_norm: bool = False) -> Dict[str, Any]:
    p = {
        "wq": init_dense(gen, (d, h * dh), dtype).reshape(d, h, dh),
        "wk": init_dense(gen, (d, kv * dh), dtype).reshape(d, kv, dh),
        "wv": init_dense(gen, (d, kv * dh), dtype).reshape(d, kv, dh),
        "wo": init_dense(gen, (h * dh, d), dtype).reshape(h, dh, d),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(dh, gen.device)
        p["k_norm"] = init_rmsnorm(dh, gen.device)
    return p


def spec_attention(kv_sharded: bool, qk_norm: bool) -> Dict[str, Any]:
    kv_spec = (None, "tp", None) if kv_sharded else (None, None, None)
    s = {
        "wq": (None, "tp", None),
        "wk": kv_spec,
        "wv": kv_spec,
        "wo": ("tp", None, None),
    }
    if qk_norm:
        s["q_norm"] = {"scale": (None,)}
        s["k_norm"] = {"scale": (None,)}
    return s


def spec_kv_cache(kv_sharded: bool, sp: bool) -> Dict[str, Any]:
    """Cache logical spec: batch over dp; optionally sequence over
    sp (data)."""
    seq = "sp" if sp else None
    kv = "tp" if kv_sharded else None
    return {"k": ("dp", seq, kv, None), "v": ("dp", seq, kv, None)}


def init_kv_cache(batch: int, s_alloc: int, kv: int, dh: int, dtype,
                  device) -> Dict[str, torch.Tensor]:
    shape = (batch, s_alloc, kv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    B, S, _ = x.shape
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(B, S, h, k)


def _ring_write(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, positions: torch.Tensor,
                modulus: int) -> Dict[str, torch.Tensor]:
    """Write the chunk's keys into the ring in place: position ``p`` to
    slot ``p % modulus``.  Only the last ``min(S, Wn)`` positions are
    written, so no two land in one slot; the JAX package scatters the
    whole chunk and keeps the last write of each slot, which is the same
    result (``index_put_`` on CUDA leaves duplicates unspecified)."""
    ck, cv = cache["k"], cache["v"]
    keep = min(k.shape[1], ck.shape[1])
    ring = positions[:, -keep:] % modulus                  # [B, keep]
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    ck[bidx, ring] = k[:, -keep:].to(ck.dtype)
    cv[bidx, ring] = v[:, -keep:].to(cv.dtype)
    return cache


def _ring_extend(q, k, v, ck, cv, positions, *, window: int, q_offset: int,
                 kv_len: Optional[torch.Tensor], sm_scale: float
                 ) -> torch.Tensor:
    """Sliding-window extend at ``q_offset > 0``: the chunk's queries over
    the ring (before this chunk's write) plus the chunk, with every key's
    absolute position (a ring slot's is the largest ``p < q_offset`` with
    ``p % Wn == slot``).  f32 scores ``[B, Hq, S, Wn + S]``, masked to
    ``-1e30`` and a full softmax, as the JAX package computes it (a row
    with no visible key averages every value there, too).  Returns f32."""
    B, S = q.shape[:2]
    Wn = ck.shape[1]
    slot = torch.arange(Wn, device=q.device)
    kpos = slot + torch.div(q_offset - 1 - slot, Wn,
                            rounding_mode="floor") * Wn
    kpos_all = torch.cat([kpos[None].expand(B, Wn),
                          positions.to(kpos.dtype)], dim=1)   # [B, Wn + S]
    qpos = positions[..., None]                               # [B, S, 1]
    kp = kpos_all[:, None, :]
    valid = (kp <= qpos) & (kp > qpos - window) & (kp >= 0)
    if kv_len is not None:
        valid &= kp < kv_len.to(kp.device)[:, None, None]
    g = q.shape[2] // ck.shape[2]
    kf = torch.cat([ck.float(), k.float()], 1).repeat_interleave(g, dim=2)
    vf = torch.cat([cv.float(), v.float()], 1).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, kf)
    s = torch.where(valid[:, None], s, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)


def _sp_rank(mesh) -> int:
    return axis_index(mesh, "data")


def _sp_slice(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a [B, S, ...] cache cut over ``data``."""
    n = axis_size(mesh, "data")
    if t.shape[1] % n:
        raise ValueError(f"a sequence-parallel cache of {t.shape[1]} "
                         f"positions does not divide over {n} ranks")
    s = t.shape[1] // n
    i = _sp_rank(mesh)
    return t[:, i * s:(i + 1) * s].contiguous()


def _kv_heads_of_rank(h_loc: int, kv: int, mesh) -> slice:
    """The KV heads that rank j's query heads ``[j * h_loc, (j + 1) *
    h_loc)`` read, out of ``kv`` replicated ones."""
    g = h_loc * axis_size(mesh, "model") // kv
    j = axis_index(mesh, "model")
    if h_loc % g == 0:
        return slice(j * h_loc // g, (j + 1) * h_loc // g)
    if g % h_loc == 0:
        return slice(j * h_loc // g, j * h_loc // g + 1)
    raise NotImplementedError(
        f"{h_loc} query heads a rank do not map onto whole groups of "
        f"{g} query heads a KV head")


def _tp_weights(p: Dict[str, Any], mesh, kv_sharded: bool, train: bool
                ) -> Tuple[Dict[str, Any], Optional[slice]]:
    """This rank's view of the attention weights under tensor
    parallelism, and the KV heads its query heads read out of a cache
    that keeps every KV head (None where the rank's K/V are its own
    heads); module docstring."""
    q, kv_sl = dict(p), None
    if not kv_sharded:
        sl = _kv_heads_of_rank(p["wq"].shape[1], p["wk"].shape[1], mesh)
        if train:
            q["wk"] = copy_to_model(p["wk"], mesh)[:, sl]
            q["wv"] = copy_to_model(p["wv"], mesh)[:, sl]
        else:
            kv_sl = sl
    for n in ("q_norm", "k_norm"):
        if n in p:
            q[n] = {"scale": copy_to_model(p[n]["scale"], mesh)}
    return q, kv_sl


def attention_apply(
    p: Dict[str, Any],
    x: torch.Tensor,                           # [B, S, D]
    *,
    mode: str = "full",                        # full | extend | decode
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,  # [B, S] absolute positions
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,  # [B] int32 valid entries
    q_offset: int = 0,                         # mode=extend
    kv_len: Optional[torch.Tensor] = None,     # [B] true length incl. the
                                               # chunk, mode=extend
    slots: Optional[torch.Tensor] = None,      # [B] arena rows (paged)
    block_tables: Optional[torch.Tensor] = None,  # [B, S_alloc // block]
                                               # rows per cache block;
                                               # reads only
    want_cache: bool = False,
    qk_norm: bool = False,
    theta: float = 10_000.0,
    norm_eps: float = 1e-6,
    mrope_sections=None,
    positions3: Optional[torch.Tensor] = None,  # [B, S, 3] for M-RoPE
    use_rope: bool = True,                     # whisper: absolute sinusoids
    kv_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross K, V
    sp_mesh=None,                              # sequence-parallel caches
    tp_mesh=None,                              # tensor-parallel heads
    kv_sharded: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    local = window is not None and window > 0
    sp = sp_mesh is not None and not local
    if sp and slots is not None:
        raise ValueError("paged serving takes no sequence-parallel cache")
    kv_sl = None
    if tp_mesh is not None:
        if slots is not None:
            raise NotImplementedError(
                "paged caches under tensor parallelism are not ported "
                "(ROADMAP.md, Queue 1)")
        p, kv_sl = _tp_weights(p, tp_mesh, kv_sharded,
                               train=(mode == "full" and not want_cache))
        x = copy_to_model(x, tp_mesh)

    def rd(t: torch.Tensor) -> torch.Tensor:
        """The KV heads this rank's query heads read."""
        return t if kv_sl is None else t[:, :, kv_sl]

    B, S, D = x.shape
    dh = p["wq"].shape[-1]
    sm_scale = 1.0 / math.sqrt(dh)
    h, dv, d = p["wo"].shape

    if kv_ctx is not None:
        # cross-attention: K/V precomputed from the encoder output
        k, v = kv_ctx
        out = ops.attention(_proj(x, p["wq"]), k, v, causal=False,
                            sm_scale=sm_scale)
        out = out.reshape(B, S, h * dv) @ p["wo"].reshape(h * dv, d)
        if tp_mesh is not None:
            out = reduce_from_model(out, tp_mesh)
        return out, None
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if mrope_sections is not None and positions3 is None:
        # text-only input on an M-RoPE model: t = h = w = position
        positions3 = positions[..., None].expand(B, S, 3)

    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, norm_eps)
    if use_rope and mrope_sections is not None:
        q = apply_mrope(q, positions3, theta, mrope_sections)
        k = apply_mrope(k, positions3, theta, mrope_sections)
    elif use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

    new_cache = None
    if mode == "full":
        out = ops.attention(q, rd(k), rd(v), causal=causal, window=window,
                            sm_scale=sm_scale)
        if want_cache:
            if sp:
                new_cache = {"k": _sp_slice(k, sp_mesh),
                             "v": _sp_slice(v, sp_mesh)}
            elif local:
                ck = k.new_zeros((B, window) + k.shape[2:])
                cv = torch.zeros_like(ck)
                new_cache = _ring_write({"k": ck, "v": cv}, k, v, positions,
                                        window)
            else:
                new_cache = {"k": k, "v": v}
    elif mode == "extend":
        assert cache is not None
        ck, cv = cache["k"], cache["v"]
        if slots is not None:
            # paged extend: write the chunk's KV into the addressed arena
            # rows, then attend in place through the paged kernel
            kv_valid = min(q_offset + S, ck.shape[1])
            ck[slots, q_offset:q_offset + S] = k.to(ck.dtype)
            cv[slots, q_offset:q_offset + S] = v.to(cv.dtype)
            out = ops.attention_paged(
                q, ck, cv, slots, kv_valid=kv_valid,
                block_tables=block_tables, causal=causal,
                q_offset=q_offset, kv_len=kv_len, sm_scale=sm_scale)
        elif sp:
            # prefill of a sequence-parallel cache: the whole chunk on
            # every rank, then the rank's slice of it
            if q_offset != 0:
                raise NotImplementedError(
                    "a sequence-parallel cache takes a prefill at q_offset 0 "
                    "and decode steps")
            kk, vv = k.to(ck.dtype), v.to(cv.dtype)
            out = ops.attention(q, rd(kk), rd(vv), causal=causal,
                                kv_len=kv_len, sm_scale=sm_scale)
            lo = _sp_rank(sp_mesh) * ck.shape[1]
            n = max(min(S - lo, ck.shape[1]), 0)
            ck[:, :n] = kk[:, lo:lo + n]
            cv[:, :n] = vv[:, lo:lo + n]
        elif local and q_offset == 0:
            # fresh prefill into a preallocated ring: the windowed kernel
            # over the chunk itself, then the ring write
            out = ops.attention(q, rd(k), rd(v), causal=causal,
                                window=window, kv_len=kv_len,
                                sm_scale=sm_scale)
            _ring_write(cache, k, v, positions, ck.shape[1])
        elif local:
            out = _ring_extend(q, rd(k), rd(v), rd(ck), rd(cv), positions,
                               window=window, q_offset=q_offset,
                               kv_len=kv_len, sm_scale=sm_scale).to(x.dtype)
            _ring_write(cache, k, v, positions, window)
        else:
            # dense extend: write new kv at [q_offset, q_offset + S)
            ck[:, q_offset:q_offset + S] = k.to(ck.dtype)
            cv[:, q_offset:q_offset + S] = v.to(cv.dtype)
            kv_valid = q_offset + S
            out = ops.attention(
                q, rd(ck[:, :kv_valid]), rd(cv[:, :kv_valid]),
                causal=causal, q_offset=q_offset, kv_len=kv_len,
                sm_scale=sm_scale)
        if want_cache:
            new_cache = cache
    elif mode == "decode":
        assert cache is not None and cache_len is not None and S == 1
        # decode masks by cache_len; a per-row kv_len is extend-only
        assert kv_len is None, "kv_len is mode='extend' only; decode " \
            "masks by cache_len"
        ck, cv = cache["k"], cache["v"]
        if slots is not None:
            # paged decode: write the token's KV at (slots[b], cache_len[b])
            # and read the arena in place
            ck[slots, cache_len] = k[:, 0].to(ck.dtype)
            cv[slots, cache_len] = v[:, 0].to(cv.dtype)
            out1 = ops.arena_decode_attention(
                q[:, 0], ck, cv, slots, cache_len + 1,
                block_tables=block_tables, sm_scale=sm_scale)
        elif sp:
            # the token's K/V land on the rank that owns position
            # cache_len[b] (the others rewrite a slot with itself)
            s_loc = ck.shape[1]
            at_g = cache_len.long() - _sp_rank(sp_mesh) * s_loc
            own = ((at_g >= 0) & (at_g < s_loc))[:, None, None]
            at = torch.clamp(at_g, 0, s_loc - 1)
            bidx = torch.arange(B, device=x.device)
            ck[bidx, at] = torch.where(own, k[:, 0].to(ck.dtype), ck[bidx, at])
            cv[bidx, at] = torch.where(own, v[:, 0].to(cv.dtype), cv[bidx, at])
            out1 = sp_decode_attention(q[:, 0], rd(ck), rd(cv),
                                       cache_len + 1, sp_mesh, sm_scale,
                                       heads_local=tp_mesh is not None)
        else:
            bidx = torch.arange(B, device=x.device)
            if local:
                # ring: the token lands in slot pos % Wn; every filled slot
                # is visible (the ring holds only the last Wn positions)
                Wn = ck.shape[1]
                at = positions[:, 0] % Wn
                kv_valid = torch.clamp(cache_len + 1, max=Wn)
            else:
                at, kv_valid = cache_len, cache_len + 1
            ck[bidx, at] = k[:, 0].to(ck.dtype)
            cv[bidx, at] = v[:, 0].to(cv.dtype)
            out1 = ops.decode_attention(q[:, 0], rd(ck), rd(cv), kv_valid,
                                        sm_scale=sm_scale)
        out = out1[:, None]
        new_cache = cache
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, h * dv) @ p["wo"].reshape(h * dv, d)
    if tp_mesh is not None:
        out = reduce_from_model(out, tp_mesh)
    return out, new_cache
