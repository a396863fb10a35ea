"""Plain PyTorch versions of the kernels.

Deliberately naive (materialize the full score matrix, f32 softmax): they
define correctness for small shapes, serve every CPU tensor that reaches
``ops``, and are what ``chip_smoke.py`` holds the CUDA kernels against.
Masked scores use the finite ``NEG_INF`` of the kernels, and rows with no
visible key produce zeros, not NaN.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,             # [B, Sq, Hq, Dh]
    k: torch.Tensor,             # [B, Skv, Hkv, Dh]
    v: torch.Tensor,             # [B, Skv, Hkv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,   # [B] valid kv length
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with prefix-extend semantics.

    Query position i (0-based within q) has absolute position q_offset + i.
    ``causal`` masks kv positions > absolute q position; ``window`` further
    restricts to kv positions > abs_q - window.
    """
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    assert Hq % Hkv == 0
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (Dh ** 0.5)

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)      # [B, Hq, Sq, Skv]

    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None and window > 0:
        mask &= kpos > qpos - window
    mask = mask[None, None].expand(B, 1, Sq, Skv)
    if kv_len is not None:
        mask = mask & (kpos < kv_len.to(q.device)[:, None, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    return out.to(q.dtype)


def gather_rows(
    arena: torch.Tensor,                         # [N, S, H, D]
    slots: torch.Tensor,                         # [B] arena row per sequence
    block_tables: Optional[torch.Tensor] = None,  # [B, S // block]
    block: Optional[int] = None,
) -> torch.Tensor:
    """Assemble per-sequence caches [B, S, H, D] from slot ids or from a
    block table (column ``j`` names the row holding positions
    ``[j * block, (j + 1) * block)``) — a pure bit move."""
    if block_tables is None:
        return arena.index_select(0, slots.long())
    N, S, H, D = arena.shape
    nb = S // block
    flat = arena.reshape(N * nb, block, H, D)
    idx = (block_tables.long() * nb
           + torch.arange(nb, device=arena.device)[None])
    return flat[idx].reshape(block_tables.shape[0], S, H, D)


def decode_reference(
    q: torch.Tensor,             # [B, Hq, Dh] single query token
    k: torch.Tensor,             # [B, Skv, Hkv, Dh]
    v: torch.Tensor,
    *,
    kv_len: Optional[torch.Tensor] = None,   # [B] valid cache entries
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    out = mha_reference(q[:, None], k, v, causal=False, window=None,
                        q_offset=0, kv_len=kv_len, sm_scale=sm_scale)
    return out[:, 0]


def relevance_reference(
    x: torch.Tensor,            # [C, T, D] chunk token embeddings
    lengths: torch.Tensor,      # [C] valid token count per chunk
    w: torch.Tensor,            # [D]
    b: torch.Tensor,            # [] or [1] bias
) -> torch.Tensor:
    """sigmoid(meanpool(x) @ w + b) per chunk -> [C] relevance scores.

    Rows ``t < lengths[c]`` are pooled and the sum is divided by the raw
    ``max(lengths[c], 1)``, so a chunk longer than T pools all T rows but
    divides by its length."""
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None]).float()
    summed = torch.einsum("ctd,ct->cd", x.float(), mask)
    denom = lengths.float().clamp_min(1.0)[:, None]
    pooled = summed / denom
    logit = pooled @ w.float() + b.float().reshape(())
    return torch.sigmoid(logit)
