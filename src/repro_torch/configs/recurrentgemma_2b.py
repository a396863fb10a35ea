"""recurrentgemma-2b: Griffin hybrid — RG-LRU + local attention, 1:2.
[arXiv:2402.19427; hf]

26 = 8 x (rec, rec, local-attn) + 2 rec tail; RG-LRU via a log-depth
scan, 2048-token sliding window on attention layers (head_dim 256), MQA
(kv=1, pad_kv_to_tp=False).
"""
from ..config import ATTN_LOCAL, HYBRID, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family=HYBRID,
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    sliding_window=2048,
    embed_scale=True,
    pad_kv_to_tp=False,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
