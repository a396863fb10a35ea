"""xlstm-350m: alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own gating/projections, no separate MLP.
mLSTM runs chunkwise-parallel ([L, L] products within a chunk, a loop over
chunks); sLSTM is a true nonlinear recurrence and loops over time
(``models.ssm``).
"""
from ..config import MLSTM, SLSTM, SSM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family=SSM,
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=(MLSTM, SLSTM),
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
