"""Architecture config: a JAX-free copy of ``repro.models.config``.

Same fields, ``hd``, ``n_params()`` and ``reduced()``; ``compute_dtype`` is a
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    swa_window: Optional[int] = None  # sliding-window attention width (None = full)
    rope_theta: float = 10000.0
    pos_embed: str = "rope"          # rope | learned | none
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    gated_mlp: bool = True           # SwiGLU vs plain GELU MLP
    act: str = "silu"
    tie_embeddings: bool = True
    max_position: int = 524288

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    slstm_at: Tuple[int, ...] = ()
    proj_factor: float = 2.0

    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500

    # --- vlm ---
    n_vision_tokens: int = 0

    # --- numerics ---
    dtype: str = "bfloat16"          # compute dtype

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def n_params(self) -> int:
        """Exact parameter count, as ``repro`` counts it."""
        d, hd = self.d_model, self.hd
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        att = d * (q + 2 * kv) + q * d
        if self.qkv_bias:
            att += q + 2 * kv
        if self.family == "moe":
            ff_moe = 3 * d * self.moe_d_ff
            dense_ff = 3 * d * self.d_ff if self.d_ff else 0
            router = d * self.n_experts
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            moe_layer = att + self.n_experts * ff_moe + router + shared + 2 * d
            dense_layer = att + dense_ff + 2 * d
            body = (self.n_layers - self.first_k_dense) * moe_layer + self.first_k_dense * dense_layer
        elif self.family in ("ssm", "hybrid"):
            # the reference counts these blocks in its model code
            raise NotImplementedError(
                f"n_params of family {self.family!r} comes with the port of "
                "that family's blocks (ROADMAP queue 1, item 8)")
        elif self.family == "encdec":
            ff = (3 if self.gated_mlp else 2) * d * self.d_ff
            enc_layer = att + ff + 2 * d
            dec_layer = att + att + ff + 3 * d
            body = self.enc_layers * enc_layer + self.n_layers * dec_layer
        else:  # dense / vlm backbone
            ff = (3 if self.gated_mlp else 2) * d * self.d_ff
            body = self.n_layers * (att + ff + 2 * d)
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        pos = 0
        if self.pos_embed == "learned":
            pos = min(self.max_position, 32768) * d
            if self.family == "encdec":
                pos += self.enc_frames * d
        return int(body + emb + head + pos + d)  # + final norm

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.slstm_at else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            head_dim=16,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) or 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            slstm_at=tuple(i for i in self.slstm_at if i < 4)[:2],
            enc_layers=min(self.enc_layers, 2),
            enc_frames=32 if self.family == "encdec" else self.enc_frames,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            swa_window=min(self.swa_window, 32) if self.swa_window else None,
            max_position=8192,
            dtype="float32",
        )
