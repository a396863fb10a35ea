"""gemma3-27b: 62L dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt scaled; unverified]  62 = 10 x (5 local + 1 global)
superblocks + 2 local tail.  head_dim=128 explicit (d_model/heads != 128),
qk-norm, sqrt(d) embed scaling, 1024-token sliding window on local layers.
Oracle-class model in the task-cascade pairing.
"""
from ..config import ATTN_FULL, ATTN_LOCAL, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family=DENSE,
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    block_pattern=(ATTN_LOCAL,) * 5 + (ATTN_FULL,),
    sliding_window=1024,
    qk_norm=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    # local layers bound KV; global layers run SP-KV sequence sharding,
    # so the 500k decode cell is supported (DESIGN.md long_500k notes).
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
