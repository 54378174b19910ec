"""Hymba-1.5B: parallel attention + mamba(SSD) heads per layer; SWA except
3 global-attention layers {first, middle, last}. [arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16 vocab=32001.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    head_dim=64, ssm_state=16, ssm_heads=25, proj_factor=2.0,
    swa_window=1024, rope_theta=10000.0, norm="rmsnorm", gated_mlp=True,
    tie_embeddings=True,
)
