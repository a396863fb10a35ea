"""phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE. [hf:microsoft/Phi-3.5-MoE]

The strategy name is the JAX package's default, ``tp_dense``: on one card
(no mesh) it runs as named; over a mesh whose ``model`` axis is larger
than 1 it runs ``tp_smap`` (``models.moe``).
"""
from ..config import ATTN_FULL, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family=MOE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    block_pattern=(ATTN_FULL,),
    moe=MoEConfig(num_experts=16, top_k=2, strategy="tp_dense"),
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
