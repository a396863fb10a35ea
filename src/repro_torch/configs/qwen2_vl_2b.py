"""qwen2-vl-2b: VLM backbone with M-RoPE. [arXiv:2409.12191; hf]

The vision frontend is a STUB: callers pass precomputed patch embeddings
``patch_emb`` [B, S_img, d_model] (1024 at ``frontend_len``), prepended to
the text tokens; 3-channel (t, h, w) M-RoPE positions ride in
``positions3``.
"""
from ..config import ATTN_FULL, VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=VLM,
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    block_pattern=(ATTN_FULL,),
    mrope_sections=(16, 24, 24),     # frequency pairs per (t, h, w); sum=64
    rope_theta=1_000_000.0,
    frontend_stub="vision_patches",
    frontend_len=1024,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
