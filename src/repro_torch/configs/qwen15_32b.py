"""Qwen1.5-32B: dense with QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]
64L d_model=5120 40H (kv=40, full MHA) d_ff=27392 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, norm="rmsnorm", gated_mlp=True,
    tie_embeddings=False,
)
