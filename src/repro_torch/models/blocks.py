"""Block layer: a sequence mixer and an optional FFN, with pre-norms.

Kinds (``config`` constants): ``ATTN_FULL`` (llama, qwen3 with its
per-head q/k norm, qwen2-vl with M-RoPE, phi3.5-moe), ``ENC_ATTN``
(bidirectional self-attention, as the JAX package's block has it; no
shipped configuration stacks it), ``ATTN_LOCAL``
(gemma3's and recurrentgemma's sliding-window layers, whose state is a
ring cache of ``min(sliding_window, s_alloc)`` slots), ``MLSTM`` and
``SLSTM`` (xlstm) and ``RGLRU`` (recurrentgemma).  The FFN is a dense
gated MLP, a top-k MoE (``models.moe``), or absent when ``d_ff == 0``
(xlstm).  Every block has one surface:

    init_block / state_shape / init_block_state / block_apply

``state_shape`` gives every state leaf with its dtype: attention caches
``{"k", "v"}`` at the storage dtype (``kv_dtype``), recurrent states in
f32 whatever the model dtype, as in the JAX package.  ``block_apply``
also returns the MoE auxiliary loss (zero without MoE); its ``train``
mode carries no state.  The encoder-decoder (whisper-base, its encoder
and audio frontend stub) runs through ``models.whisper.WhisperModel``,
not through these blocks' ``LM``; ``check_supported`` says so.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import (ATTN_FULL, ATTN_LOCAL, AUDIO, ENC_ATTN, MLSTM, RGLRU,
                      SLSTM, ResolvedConfig)
from . import ssm
from .attention import attention_apply, init_attention, spec_attention
from .layers import init_mlp, init_rmsnorm, mlp_apply, rmsnorm_apply, \
    spec_mlp, spec_rmsnorm
from .moe import init_moe, moe_apply, spec_moe

PORTED_KINDS = (ATTN_FULL, ATTN_LOCAL, ENC_ATTN, MLSTM, SLSTM, RGLRU)
ATTN_KINDS = (ATTN_FULL, ATTN_LOCAL, ENC_ATTN)

LeafShapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def check_supported(rcfg: ResolvedConfig) -> None:
    """Raise for a configuration the decoder-only ``LM`` cannot run: a
    block kind the port lacks, or an encoder-decoder (audio) model, which
    ``models.whisper.WhisperModel`` runs."""
    b = rcfg.base
    if any(k not in PORTED_KINDS for k in b.layer_kinds()):
        raise NotImplementedError(
            f"{b.name}: only {PORTED_KINDS} blocks are ported")
    if b.family == AUDIO or b.encoder_layers \
            or b.frontend_stub == "audio_frames":
        raise ValueError(f"{b.name}: an encoder-decoder model; build "
                         "models.whisper.WhisperModel")


def _has_ffn(rcfg: ResolvedConfig) -> bool:
    return rcfg.base.moe is not None or rcfg.base.d_ff > 0


def _lru_width(rcfg: ResolvedConfig) -> int:
    return rcfg.base.d_model       # Griffin's lru_width == d_model at 2b


def init_block(gen: torch.Generator, rcfg: ResolvedConfig, kind: str,
               dtype) -> Dict[str, Any]:
    b = rcfg.base
    d = b.d_model
    p: Dict[str, Any] = {"norm1": init_rmsnorm(d, gen.device)}
    if kind in ATTN_KINDS:
        p["attn"] = init_attention(gen, d, rcfg.padded_heads,
                                   rcfg.padded_kv_heads, rcfg.head_dim,
                                   dtype, qk_norm=b.qk_norm)
    elif kind == MLSTM:
        p["mlstm"] = ssm.init_mlstm(gen, d, b.num_heads, dtype)
    elif kind == SLSTM:
        p["slstm"] = ssm.init_slstm(gen, d, b.num_heads, dtype)
    elif kind == RGLRU:
        p["rglru"] = ssm.init_rglru(gen, d, _lru_width(rcfg), dtype)
    else:
        raise ValueError(kind)
    if _has_ffn(rcfg):
        p["norm2"] = init_rmsnorm(d, gen.device)
        if b.moe is not None:
            p["moe"] = init_moe(gen, d, b.d_ff, b.moe.num_experts, dtype)
        else:
            p["mlp"] = init_mlp(gen, d, b.d_ff, dtype)
    return p


def spec_block(rcfg: ResolvedConfig, kind: str) -> Dict[str, Any]:
    """Logical specs of one layer's parameters (``init_block``'s tree)."""
    b = rcfg.base
    kv_sharded = rcfg.padded_kv_heads >= rcfg.tp
    s: Dict[str, Any] = {"norm1": spec_rmsnorm()}
    if kind in ATTN_KINDS:
        s["attn"] = spec_attention(kv_sharded, b.qk_norm)
    elif kind == MLSTM:
        s["mlstm"] = ssm.spec_mlstm()
    elif kind == SLSTM:
        s["slstm"] = ssm.spec_slstm()
    elif kind == RGLRU:
        s["rglru"] = ssm.spec_rglru()
    if _has_ffn(rcfg):
        s["norm2"] = spec_rmsnorm()
        if b.moe is not None:
            s["moe"] = spec_moe(b.moe.strategy)
        else:
            s["mlp"] = spec_mlp()
    return s


def spec_block_state(rcfg: ResolvedConfig, kind: str, *, batch_sharded: bool,
                     seq_sharded: bool) -> Dict[str, Any]:
    """Logical spec of a layer's state.  ``batch_sharded``: batch over dp;
    ``seq_sharded``: a full-attention cache's sequence over data
    (sequence-parallel decode; ring caches and recurrent states stay
    whole)."""
    kv_sharded = rcfg.padded_kv_heads >= rcfg.tp
    dp = "dp" if batch_sharded else None
    if kind in ATTN_KINDS:
        sp = "sp" if (seq_sharded and kind != ATTN_LOCAL) else None
        kv = "tp" if kv_sharded else None
        return {"k": (dp, sp, kv, None), "v": (dp, sp, kv, None)}
    if kind == MLSTM:
        s = ssm.spec_mlstm_state()
    elif kind == SLSTM:
        s = ssm.spec_slstm_state()
    elif kind == RGLRU:
        s = ssm.spec_rglru_state()
    else:
        raise ValueError(kind)
    if not batch_sharded:
        s = {n: tuple(None if a == "dp" else a for a in t)
             for n, t in s.items()}
    return s


def state_shape(rcfg: ResolvedConfig, kind: str, batch: int, s_alloc: int,
                kv_dtype: torch.dtype, seq_shards: int = 1,
                tp: int = 1) -> LeafShapes:
    """(shape, dtype) of every state leaf of one layer.  ``kv_dtype`` is
    the storage dtype of attention caches only; a sliding-window layer's
    ring never needs more positions than its window.  ``seq_shards``
    cuts a full-attention cache's ``s_alloc`` positions over that many
    ranks (sequence-parallel decode); ``tp`` > 1 gives a tensor-parallel
    rank's shards, cut as ``spec_block_state`` cuts them (an attention
    cache's KV heads where they divide over ``tp``, a recurrent state's
    columns)."""
    b = rcfg.base
    head_shards = tp if rcfg.padded_kv_heads >= tp else 1
    if kind in ATTN_KINDS:
        if kind == ATTN_LOCAL:
            s_alloc = min(b.sliding_window, s_alloc)
        elif s_alloc % seq_shards:
            raise ValueError(f"s_alloc {s_alloc} does not divide over "
                             f"{seq_shards} sequence shards")
        else:
            s_alloc //= seq_shards
        shape = (batch, s_alloc, rcfg.padded_kv_heads // head_shards,
                 rcfg.head_dim)
        return {"k": (shape, kv_dtype), "v": (shape, kv_dtype)}
    if kind == MLSTM:
        return ssm.mlstm_state_shape(batch, b.num_heads,
                                     b.d_model // b.num_heads, tp)
    if kind == SLSTM:
        return ssm.slstm_state_shape(batch, b.d_model // tp)
    if kind == RGLRU:
        return ssm.rglru_state_shape(batch, _lru_width(rcfg) // tp)
    raise ValueError(kind)


def init_block_state(rcfg: ResolvedConfig, kind: str, batch: int,
                     s_alloc: int, kv_dtype: torch.dtype, device,
                     seq_shards: int = 1, tp: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """A fresh state (``state_shape``'s leaves): zeroed caches; recurrent
    states at their initial values (mLSTM/sLSTM ``m`` at ``LOG_EPS``,
    sLSTM ``n`` at 1e-6)."""
    b = rcfg.base
    if kind == MLSTM:
        return ssm.init_mlstm_state(batch, b.num_heads,
                                    b.d_model // b.num_heads, device, tp)
    if kind == SLSTM:
        return ssm.init_slstm_state(batch, b.d_model // tp, device)
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in state_shape(rcfg, kind, batch, s_alloc,
                                              kv_dtype, seq_shards,
                                              tp).items()}


def block_apply(
    p: Dict[str, Any],
    x: torch.Tensor,                           # [B, S, D]
    *,
    kind: str,
    rcfg: ResolvedConfig,
    mode: str,                         # train | prefill | extend | decode
    state: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,     # [B] true length, extend
    slots: Optional[torch.Tensor] = None,      # [B] arena rows (paged)
    block_tables: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    positions3: Optional[torch.Tensor] = None,
    mesh=None,                                 # device mesh (MoE strategies)
    dp_spec=None,                              # batch spec over the mesh
    sp_mesh=None,                              # sequence-parallel caches
    tp_mesh=None,                              # tensor-parallel layers
    sharded: bool = False,                     # p holds this rank's shards
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Any]:
    """Returns (y, new_state, MoE aux loss or 0.0).  Attention caches are
    updated in place (the returned state is the same dict); recurrent
    states come back as new tensors; ``train`` returns no state.  A
    recurrent layer ignores ``kv_len``: it runs over the whole chunk,
    bucket PAD included, as the JAX package's does.  With ``tp_mesh``
    the attention heads, the MLP's d_ff and a recurrent mixer's columns
    are this rank's shards (``models.attention``, ``models.layers``,
    ``models.ssm``)."""
    b = rcfg.base
    aux = 0.0                  # a tensor only where a MoE FFN computes it
    h = rmsnorm_apply(p["norm1"], x, b.norm_eps)
    if kind in ATTN_KINDS:
        window = b.sliding_window if kind == ATTN_LOCAL else None
        assert slots is None or kind == ATTN_FULL, \
            "paged serving (slots) supports full-attention blocks only"
        attn_mode = {"train": "full", "prefill": "full", "extend": "extend",
                     "decode": "decode"}[mode]
        mix, new_state = attention_apply(
            p["attn"], h, mode=attn_mode, causal=(kind != ENC_ATTN),
            window=window, positions=positions, positions3=positions3,
            mrope_sections=b.mrope_sections, cache=state,
            cache_len=cache_len, q_offset=q_offset, kv_len=kv_len,
            slots=slots, block_tables=block_tables,
            want_cache=(mode != "train"),
            qk_norm=b.qk_norm, theta=b.rope_theta, norm_eps=b.norm_eps,
            sp_mesh=sp_mesh, tp_mesh=tp_mesh,
            kv_sharded=rcfg.padded_kv_heads >= rcfg.tp)
    else:
        assert slots is None, \
            "paged serving (slots) supports attention-state models only"
        tp = dict(mesh=tp_mesh)
        if kind == MLSTM:
            mix, new_state = ssm.mlstm_apply(
                p["mlstm"], h, state=state,
                mode="step" if mode == "decode" else "full",
                heads=b.num_heads, **tp)
        elif kind == SLSTM:
            mix, new_state = ssm.slstm_apply(p["slstm"], h, state=state,
                                             heads=b.num_heads, **tp)
        elif kind == RGLRU:
            mix, new_state = ssm.rglru_apply(p["rglru"], h, state=state,
                                             **tp)
        else:
            raise ValueError(kind)
    x = x + mix
    if mode == "train":
        new_state = None
    if _has_ffn(rcfg):
        h2 = rmsnorm_apply(p["norm2"], x, b.norm_eps)
        if b.moe is not None:
            y, aux = moe_apply(p["moe"], h2, top_k=b.moe.top_k,
                               capacity_factor=b.moe.capacity_factor,
                               strategy=b.moe.strategy, act=b.act,
                               mesh=mesh, dp_spec=dp_spec, sharded=sharded)
        else:
            y = mlp_apply(p["mlp"], h2, b.act, tp_mesh)
        x = x + y
    return x, new_state, aux
