"""dbrx-132b: 16-expert top-4 fine-grained MoE. [hf:databricks/dbrx-base]

EP REQUIRED: dense expert replication would need ~16.5 GB/chip for FFN
weights alone; experts shard over the 16-way ``data`` axis via shard_map
all-to-all, expert d_ff additionally sharded over ``model``.
"""
from ..config import ATTN_FULL, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    block_pattern=(ATTN_FULL,),
    moe=MoEConfig(num_experts=16, top_k=4, strategy="ep_a2a"),
    rope_theta=500_000.0,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
