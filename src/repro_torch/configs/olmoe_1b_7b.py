"""OLMoE-1B-7B: 64 experts top-8 MoE. [arXiv:2409.02060; hf]
16L d_model=2048 16H d_ff=1024(per expert) vocab=50304.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=50304,
    n_experts=64, top_k=8, moe_d_ff=1024,
    rope_theta=10000.0, norm="rmsnorm", gated_mlp=True,
    tie_embeddings=True,
)
