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

``qk_norm`` (qwen3) applies a per-head RMS norm to q and k after the
projections and before RoPE, in every mode.  Sliding-window ring caches,
cross-attention and M-RoPE are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops
from .layers import apply_rope, init_dense, init_rmsnorm, rmsnorm_apply


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
    kv_ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if window not in (None, 0) or kv_ctx is not None \
            or mrope_sections is not None:
        raise NotImplementedError(
            "sliding-window caches, cross-attention and M-RoPE are not "
            "ported yet")
    B, S, D = x.shape
    dh = p["wq"].shape[-1]
    sm_scale = 1.0 / math.sqrt(dh)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    new_cache = None
    if mode == "full":
        out = ops.attention(q, k, v, causal=causal, sm_scale=sm_scale)
        if want_cache:
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
        else:
            # dense extend: write new kv at [q_offset, q_offset + S)
            ck[:, q_offset:q_offset + S] = k.to(ck.dtype)
            cv[:, q_offset:q_offset + S] = v.to(cv.dtype)
            kv_valid = q_offset + S
            out = ops.attention(
                q, ck[:, :kv_valid], cv[:, :kv_valid], causal=causal,
                q_offset=q_offset, kv_len=kv_len, sm_scale=sm_scale)
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
        else:
            bidx = torch.arange(B, device=x.device)
            ck[bidx, cache_len] = k[:, 0].to(ck.dtype)
            cv[bidx, cache_len] = v[:, 0].to(cv.dtype)
            out1 = ops.decode_attention(q[:, 0], ck, cv, cache_len + 1,
                                        sm_scale=sm_scale)
        out = out1[:, None]
        new_cache = cache
    else:
        raise ValueError(mode)

    h, dv, d = p["wo"].shape
    out = out.reshape(B, S, h * dv) @ p["wo"].reshape(h * dv, d)
    return out, new_cache
