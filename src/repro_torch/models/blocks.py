"""Block layer: causal self-attention (full or sliding-window) + dense
SwiGLU FFN, pre-norms.

Two block kinds are ported: ``ATTN_FULL`` (llama, qwen3 with its per-head
q/k norm) and ``ATTN_LOCAL`` (gemma3's sliding-window layers, whose state
is a ring cache of ``min(sliding_window, s_alloc)`` slots).  Encoder,
recurrent and MoE blocks, M-RoPE and modality frontends raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import ATTN_FULL, ATTN_LOCAL, ResolvedConfig
from .attention import attention_apply, init_attention, init_kv_cache
from .layers import init_mlp, init_rmsnorm, mlp_apply, rmsnorm_apply

PORTED_KINDS = (ATTN_FULL, ATTN_LOCAL)


def check_supported(rcfg: ResolvedConfig) -> None:
    """Raise for configurations the port does not run yet."""
    b = rcfg.base
    if any(k not in PORTED_KINDS for k in b.layer_kinds()):
        raise NotImplementedError(
            f"{b.name}: only {PORTED_KINDS} blocks are ported")
    if b.moe is not None or b.d_ff <= 0:
        raise NotImplementedError(f"{b.name}: only dense FFNs are ported")
    if (b.mrope_sections is not None or b.frontend_stub is not None
            or b.encoder_layers):
        raise NotImplementedError(
            f"{b.name}: M-RoPE, modality frontends and encoders are not "
            "ported")


def init_block(gen: torch.Generator, rcfg: ResolvedConfig,
               dtype) -> Dict[str, Any]:
    d = rcfg.base.d_model
    return {
        "norm1": init_rmsnorm(d, gen.device),
        "attn": init_attention(gen, d, rcfg.padded_heads,
                               rcfg.padded_kv_heads, rcfg.head_dim, dtype,
                               qk_norm=rcfg.base.qk_norm),
        "norm2": init_rmsnorm(d, gen.device),
        "mlp": init_mlp(gen, d, rcfg.base.d_ff, dtype),
    }


def state_shape(rcfg: ResolvedConfig, kind: str, batch: int,
                s_alloc: int) -> Tuple[int, ...]:
    """Shape of a layer's K (and V) cache: a sliding-window layer's ring
    never needs more positions than its window."""
    if kind == ATTN_LOCAL:
        s_alloc = min(rcfg.base.sliding_window, s_alloc)
    return (batch, s_alloc, rcfg.padded_kv_heads, rcfg.head_dim)


def init_block_state(rcfg: ResolvedConfig, kind: str, batch: int,
                     s_alloc: int, dtype, device) -> Dict[str, torch.Tensor]:
    return init_kv_cache(*state_shape(rcfg, kind, batch, s_alloc), dtype,
                         device)


def block_apply(
    p: Dict[str, Any],
    x: torch.Tensor,                           # [B, S, D]
    *,
    kind: str,
    rcfg: ResolvedConfig,
    mode: str,                                 # prefill | extend | decode
    state: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,     # [B] true length, extend
    slots: Optional[torch.Tensor] = None,      # [B] arena rows (paged)
    block_tables: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (y, new_state)."""
    b = rcfg.base
    window = b.sliding_window if kind == ATTN_LOCAL else None
    assert slots is None or kind == ATTN_FULL, \
        "paged serving (slots) supports full-attention blocks only"
    h = rmsnorm_apply(p["norm1"], x, b.norm_eps)
    attn_mode = {"prefill": "full", "extend": "extend",
                 "decode": "decode"}[mode]
    mix, new_state = attention_apply(
        p["attn"], h, mode=attn_mode, causal=True, window=window,
        positions=positions, cache=state, cache_len=cache_len,
        q_offset=q_offset, kv_len=kv_len, slots=slots,
        block_tables=block_tables, want_cache=True, qk_norm=b.qk_norm,
        theta=b.rope_theta, norm_eps=b.norm_eps)
    x = x + mix
    h2 = rmsnorm_apply(p["norm2"], x, b.norm_eps)
    return x + mlp_apply(p["mlp"], h2, b.act), new_state
