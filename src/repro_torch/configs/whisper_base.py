"""Whisper-base: encoder-decoder, conv frontend stubbed (precomputed frame
embeddings). [arXiv:2212.04356; unverified]
6L(enc)+6L(dec) d_model=512 8H d_ff=2048 vocab=51865, learned pos-embeds.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, enc_frames=1500,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    pos_embed="learned", norm="layernorm", gated_mlp=False, act="gelu",
    tie_embeddings=True,
    # whisper's real decoder context is 448; the 32k shapes of the dry-run
    # exercise the backbone structurally, so the learned table covers them
    max_position=32768,
)
