"""InternVL2-1B: InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    head_dim=64, rope_theta=1e6, norm="rmsnorm", gated_mlp=True,
    tie_embeddings=True, n_vision_tokens=256,
)
