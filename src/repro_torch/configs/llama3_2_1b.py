"""llama3.2-1b: small llama3 dense LM — the default cascade proxy.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from ..config import ATTN_FULL, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family=DENSE,
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    block_pattern=(ATTN_FULL,),
    rope_theta=500_000.0,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
