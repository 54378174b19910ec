"""H2O-Danube-3-4B: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.  SWA window 4096 (mistral-style) => sub-quadratic long-context.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    head_dim=120, swa_window=4096, rope_theta=10000.0,
    norm="rmsnorm", gated_mlp=True, tie_embeddings=False,
)
