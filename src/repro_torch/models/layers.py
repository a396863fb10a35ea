"""Primitive layers: RMS norm, rotary embeddings, SwiGLU MLP, embedding and
the tied LM head.

Functional pairs ``init_*(gen, ...) -> params`` / ``*_apply(params, x)``
over plain dicts of tensors, with the JAX package's parameter layouts so
converted weights drop in unchanged.  Initializers draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _dense_init(gen: torch.Generator, shape, in_axis_size: int,
                dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(dtype)


def init_dense(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _dense_init(gen, shape, shape[0], dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE.  x: [B, S, H, Dh]; positions: [B, S] (int)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                # [dh/2]
    ang = positions[..., None].float() * inv             # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]                  # [B, S, 1, dh/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

ACTS = {"silu": F.silu, "gelu": F.gelu, "relu": F.relu}


def init_mlp(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {
        "w1": _dense_init(gen, (d, f), d, dtype),
        "w3": _dense_init(gen, (d, f), d, dtype),
        "w2": _dense_init(gen, (f, d), f, dtype),
    }


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = ACTS[act]
    h = a(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    t = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return {"table": t.to(dtype)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def lm_head_apply(params, x: torch.Tensor,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Tied head: logits = x @ table.T with f32 ACCUMULATION and f32 out.

    On the card a bf16 table stays in its storage dtype (cuBLAS bf16
    product with an f32 result) instead of materializing an f32 copy of
    the whole vocab table every step; on the CPU the product runs in f32.
    """
    table = params["table"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and table.dtype == torch.float32:
        logits = x2 @ table.t()
    elif x2.is_cuda:
        logits = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ table.float().t()
    logits = logits.reshape(*lead, table.shape[0])
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
