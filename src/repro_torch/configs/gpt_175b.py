"""Paper's 175B GPT (Sections 5-6: BO search + scaling).  GPT-3 shape."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-175b", family="dense",
    n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96,
    d_ff=49152, vocab_size=50304,
    gated_mlp=False, act="gelu", norm="layernorm", tie_embeddings=True,
)
