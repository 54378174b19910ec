"""Paper's 3.6B GPT (Section 4.1 TP sweep).  12Ld^2+Vd = 3.55B.
GPT-3-style: learned pos-emb epoch replaced by RoPE for TPU recipe; the paper's
parallelism results do not depend on the positional scheme.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-3.6b", family="dense",
    n_layers=30, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=12288, vocab_size=50304,
    gated_mlp=False, act="gelu", norm="layernorm", tie_embeddings=True,
)
