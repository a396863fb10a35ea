"""Block layer: full causal self-attention + dense SwiGLU FFN, pre-norms.

The only block kind ported so far is ``ATTN_FULL`` with a dense FFN (the
llama family, and qwen3 with its per-head q/k norm).  Sliding-window,
encoder, recurrent and MoE blocks raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import ATTN_FULL, ResolvedConfig
from .attention import attention_apply, init_attention, init_kv_cache
from .layers import init_mlp, init_rmsnorm, mlp_apply, rmsnorm_apply


def check_supported(rcfg: ResolvedConfig) -> None:
    """Raise for configurations the port does not run yet."""
    b = rcfg.base
    if any(k != ATTN_FULL for k in b.layer_kinds()):
        raise NotImplementedError(
            f"{b.name}: only {ATTN_FULL!r} blocks are ported")
    if b.moe is not None or b.d_ff <= 0:
        raise NotImplementedError(f"{b.name}: only dense FFNs are ported")
    if (b.mrope_sections is not None or b.embed_scale
            or b.frontend_stub is not None or b.encoder_layers):
        raise NotImplementedError(
            f"{b.name}: M-RoPE, embed scaling, modality frontends and "
            "encoders are not ported")


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


def init_block_state(rcfg: ResolvedConfig, batch: int, s_alloc: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    return init_kv_cache(batch, s_alloc, rcfg.padded_kv_heads,
                         rcfg.head_dim, dtype, device)


def block_apply(
    p: Dict[str, Any],
    x: torch.Tensor,                           # [B, S, D]
    *,
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
    h = rmsnorm_apply(p["norm1"], x, b.norm_eps)
    attn_mode = {"prefill": "full", "extend": "extend",
                 "decode": "decode"}[mode]
    mix, new_state = attention_apply(
        p["attn"], h, mode=attn_mode, causal=True, positions=positions,
        cache=state, cache_len=cache_len, q_offset=q_offset, kv_len=kv_len,
        slots=slots, block_tables=block_tables, want_cache=True,
        qk_norm=b.qk_norm, theta=b.rope_theta, norm_eps=b.norm_eps)
    x = x + mix
    h2 = rmsnorm_apply(p["norm2"], x, b.norm_eps)
    return x + mlp_apply(p["mlp"], h2, b.act), new_state
