"""Configuration system for the task-cascades framework.

Every assigned architecture is described by a :class:`ModelConfig`; every
input-shape cell by a :class:`ShapeConfig`.  ``resolve()`` applies the
TP-divisibility padding policy (DESIGN.md §5) and returns a frozen
:class:`ResolvedConfig` that the model zoo consumes.

Configs are plain dataclasses (no framework deps) so that importing this
module never touches jax device state.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------
ATTN_FULL = "attn_full"          # full causal self-attention
ATTN_LOCAL = "attn_local"        # sliding-window self-attention
MLSTM = "mlstm"                  # xLSTM matrix-memory block
SLSTM = "slstm"                  # xLSTM scalar-memory block
RGLRU = "rglru"                  # Griffin/RecurrentGemma RG-LRU block
ENC_ATTN = "enc_attn"            # bidirectional encoder self-attention

VALID_BLOCK_KINDS = {ATTN_FULL, ATTN_LOCAL, MLSTM, SLSTM, RGLRU, ENC_ATTN}

# Families
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"


def pad_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # "ep_a2a": experts sharded over the data axis via shard_map all-to-all;
    # "tp_dense": experts unsharded on the expert dim, d_ff sharded on model.
    strategy: str = "tp_dense"
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (pre-padding)."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    # Repeating block pattern; cycled to fill num_layers.  E.g. gemma3:
    # 5×local + 1×global.  Dense default: (ATTN_FULL,).
    block_pattern: Tuple[str, ...] = (ATTN_FULL,)
    sliding_window: int = 4096           # for ATTN_LOCAL blocks
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False                # qwen3-style per-head RMS on q/k
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                    # mlp activation (silu → SwiGLU)
    # encoder-decoder (whisper): number of encoder layers; decoder layers =
    # num_layers.  None for decoder-only archs.
    encoder_layers: Optional[int] = None
    encoder_seq_len: int = 0             # fixed encoder source length
    # modality frontend stub: if set, input_specs provide precomputed
    # embeddings of this dimension instead of token ids for the frontend part
    frontend_stub: Optional[str] = None  # None | "audio_frames" | "vision_patches"
    frontend_len: int = 0                # stub frontend sequence length
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"
    embed_scale: bool = False            # gemma-style sqrt(d) embed multiplier
    # Pad KV heads up to the TP width so decode KV caches shard cleanly over
    # the model axis (DESIGN.md §5).  MQA archs (kv=1) set False and keep a
    # replicated KV with sequence-sharded flash-decode for long contexts.
    pad_kv_to_tp: bool = True
    # Supported shape cells (by name); long_500k only for sub-quadratic archs
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern cyclically over num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four LM-family shape cells (assigned set).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_config(shape_name: str,
                 batch_override: Optional[int] = None) -> ShapeConfig:
    """The shape ``shape_name``, its global batch cut to
    ``batch_override`` when given (a cell run on fewer cards)."""
    sh = SHAPES[shape_name]
    if batch_override is None:
        return sh
    return dataclasses.replace(sh, global_batch=batch_override)


@dataclass(frozen=True)
class ResolvedConfig:
    """ModelConfig after padding policy; consumed by the model zoo."""

    base: ModelConfig
    head_dim: int
    padded_heads: int            # Q heads after padding to TP multiple
    padded_kv_heads: int         # KV heads (>= min(kv, tp) grouping unit)
    padded_vocab: int
    tp: int                      # model-axis size the padding was computed for

    @property
    def name(self) -> str:
        return self.base.name

    @property
    def d_model(self) -> int:
        return self.base.d_model

    @property
    def num_layers(self) -> int:
        return self.base.num_layers

    @property
    def d_ff(self) -> int:
        return self.base.d_ff

    def param_count(self) -> int:
        """Approximate parameter count (dense-equivalent, post-padding)."""
        b = self.base
        d, l = b.d_model, b.num_layers
        h = self.padded_heads * self.head_dim
        hkv = self.padded_kv_heads * self.head_dim
        attn = d * h + 2 * d * hkv + h * d
        if b.moe is not None:
            ff = 3 * d * b.d_ff * b.moe.num_experts + d * b.moe.num_experts
        elif b.d_ff > 0:
            ff = 3 * d * b.d_ff
        else:
            ff = 0
        # ssm blocks approximated as attention-sized
        emb = self.padded_vocab * d * (1 if b.tie_embeddings else 2)
        enc = 0
        if b.encoder_layers:
            enc = b.encoder_layers * (attn + ff)
        return l * (attn + ff) + emb + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        b = self.base
        if b.moe is None:
            return self.param_count()
        d, l = b.d_model, b.num_layers
        h = self.padded_heads * self.head_dim
        hkv = self.padded_kv_heads * self.head_dim
        attn = d * h + 2 * d * hkv + h * d
        ff_active = 3 * d * b.d_ff * b.moe.top_k
        emb = self.padded_vocab * d * (1 if b.tie_embeddings else 2)
        return l * (attn + ff_active) + emb


def resolve(cfg: ModelConfig, tp: int = 16) -> ResolvedConfig:
    """Apply the padding policy (DESIGN.md §5) for a given TP width."""
    head_dim = cfg.head_dim or (cfg.d_model // cfg.num_heads)
    padded_heads = pad_to_multiple(cfg.num_heads, tp)
    # KV heads: pad to the TP width when requested (cache shardability —
    # DESIGN.md §5); else keep logical count, replicated across TP sub-groups.
    if cfg.num_kv_heads >= tp:
        padded_kv = pad_to_multiple(cfg.num_kv_heads, tp)
    elif cfg.pad_kv_to_tp:
        padded_kv = tp
    else:
        # must divide padded_heads for GQA grouping
        padded_kv = cfg.num_kv_heads
        if padded_heads % padded_kv != 0:
            # bump kv up to the smallest divisor of padded_heads >= kv
            k = padded_kv
            while padded_heads % k != 0:
                k += 1
            padded_kv = k
    padded_vocab = pad_to_multiple(cfg.vocab_size, tp)
    return ResolvedConfig(
        base=cfg,
        head_dim=head_dim,
        padded_heads=padded_heads,
        padded_kv_heads=padded_kv,
        padded_vocab=padded_vocab,
        tp=tp,
    )


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, len(cfg.block_pattern) * 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab_size=512,
        head_dim=32,
        sliding_window=64,
        max_seq_len=4096,
        encoder_layers=2 if cfg.encoder_layers else None,
        encoder_seq_len=64 if cfg.encoder_layers else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=4, top_k=cfg.moe.top_k, strategy="tp_dense"
        )
    if cfg.mrope_sections is not None:
        # rescale M-RoPE sections to the reduced head_dim (keep t:h:w ratio)
        half = small["head_dim"] // 2
        t = half // 4
        hw = (half - t) // 2
        small["mrope_sections"] = (half - 2 * hw, hw, hw)
    if cfg.frontend_len:
        small["frontend_len"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
