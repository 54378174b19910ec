"""Paper's 20B GPT (Section 4.2 PP sweeps).  GPT-NeoX-20B shape: 44L d=6144."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-20b", family="dense",
    n_layers=44, d_model=6144, n_heads=64, n_kv_heads=64,
    d_ff=24576, vocab_size=50304,
    gated_mlp=False, act="gelu", norm="layernorm", tie_embeddings=True,
)
