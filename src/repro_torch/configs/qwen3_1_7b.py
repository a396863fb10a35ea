"""qwen3-1.7b: dense GQA with per-head q/k RMS norm — the default cascade
oracle. [hf:Qwen/Qwen3-8B; hf]"""
from ..config import ATTN_FULL, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family=DENSE,
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    block_pattern=(ATTN_FULL,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
