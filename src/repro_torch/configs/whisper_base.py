"""whisper-base: encoder-decoder audio backbone. [arXiv:2212.04356]

Conv/mel frontend is a STUB (precomputed frame embeddings, 1500 frames);
6 bidirectional encoder layers + 6 decoder layers with cross-attention.
Decode shapes run the decoder only (encoder runs once at prefill).
"""
from ..config import ATTN_FULL, AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family=AUDIO,
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    block_pattern=(ATTN_FULL,),
    act="gelu",
    encoder_layers=6,
    encoder_seq_len=1536,         # 1500 mel frames, padded to lane multiple
    frontend_stub="audio_frames",
    frontend_len=1536,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
)
