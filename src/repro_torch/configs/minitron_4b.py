"""minitron-4b: width/depth-pruned nemotron dense LM. [arXiv:2407.14679; hf]"""
from ..config import ATTN_FULL, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family=DENSE,
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    block_pattern=(ATTN_FULL,),
    # pure full attention: long_500k skipped (DESIGN.md)
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
