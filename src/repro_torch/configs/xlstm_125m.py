"""xLSTM-125M: sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]
12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0 — xLSTM blocks carry their own
up-projections (mLSTM pf=2 pre-up, sLSTM post-up GeGLU FFN).
sLSTM at blocks {1, 3} following the paper's [7:1]-style placement.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_at=(1, 3), proj_factor=2.0, pos_embed="none",
    norm="layernorm", tie_embeddings=True,
)
