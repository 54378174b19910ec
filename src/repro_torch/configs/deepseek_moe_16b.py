"""DeepSeekMoE-16B: 2 shared + 64 routed experts top-6, fine-grained;
first layer dense. [arXiv:2401.06066; hf]
28L d_model=2048 16H moe_d_ff=1408 (per expert) vocab=102400; the dense
first layer's d_ff is 10944.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408, first_k_dense=1,
    rope_theta=10000.0, norm="rmsnorm", gated_mlp=True,
    tie_embeddings=False,
)
