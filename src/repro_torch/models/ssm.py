"""Selective state-space (Mamba2/SSD-style) heads and the Hymba hybrid
block, mirroring ``repro.models.ssm``.

The reference's SSD is plain ``jnp`` (no Pallas kernel): the chunked form,
intra-chunk quadratic products and an inter-chunk recurrence carried by
``lax.scan``.  Here the chunk loop is a Python loop over chunks of
``CHUNK`` positions (the sequence zero-padded up to a multiple of it, which
leaves the carried state unchanged: a padded position has dt = 0), each
chunk's products laid out per head, (B, H, L, L), for ``torch.matmul``.
Decode keeps an O(1) recurrent state per head, ``ssm_h`` (B, H, N, P) in
f32, and the last K - 1 = 3 inputs of the depthwise causal conv, ``conv``
(B, 3, inner) in the compute dtype; :func:`ssd_decode` and
:func:`hymba_block_decode` update both in place, as the attention updates
its ring.

A Hymba block runs attention (through ``kernels.ops``: K1 on full
sequences, K5 a decode step) and the SSM heads on the same normed input
and averages their RMS-normed outputs.  Its per-layer attention window is
the caller's (``transformer.layer_windows``).  Parameters keep the
reference's names and ``(d_in, d_out)`` orientation, so checkpoints cross
between the packages unchanged.

Under tensor parallelism the SSM heads split over tp, as the attention's
do: ``in_proj`` holds this rank's heads' columns of its x half and of its
z half (``core.sharding`` maps the two halves to and from the reference's
whole leaf), ``conv`` this rank's channels (channel c is head c // P's),
``out_proj`` its rows (row-parallel, left into the residual stream's
layout), and the norm over the inner width sums its statistic over tp.
``bc_proj``, ``A_log``, ``D`` and ``dt_bias`` stay whole, as the rules
place them: every rank computes B and C (shared by all heads) and takes its
heads' dt columns and vectors, so each rank's gradient of these leaves, and
of ``out_norm``'s scale, covers its own heads only and ``core.stepfn`` sums
them over tp.  The decode state holds this rank's heads and channels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.models import layers
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_init, cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

CHUNK = 256
CONV_K = 4

# the reference's ``_SSM_SCAN_HINTS`` (``transformer.HybridLM``'s placement
# rules, matched before ``core.sharding.PARAM_RULES``): the per-head
# decay/skip/dt vectors replicated, the B/C/dt projection's state dim
# whole, the depthwise conv's channels on tp
SHARDING_HINTS = (
    (r"\b(A_log|D|dt_bias)\b$", (None,)),
    (r"\bbc_proj\b$", ("embed", None)),
    (r"\bconv\b$", (None, "tp")),
)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(heads H, head channels P, state N)."""
    H = cfg.ssm_heads or cfg.n_heads
    inner = int(cfg.proj_factor * cfg.d_model)
    return H, inner // H, cfg.ssm_state


def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    H, P, N = ssm_dims(cfg)
    inner = H * P
    dev = gen.device
    return {
        "in_proj": layers.dense_init(gen, d, 2 * inner),       # x and gate z
        "bc_proj": layers.dense_init(gen, d, 2 * N + H),       # B, C, dt per head
        "conv": torch.randn((CONV_K, inner), generator=gen, dtype=torch.float32,
                            device=dev) * 0.1,                 # depthwise causal conv
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "out_proj": layers.dense_init(gen, inner, d,
                                      scale=1.0 / (inner ** 0.5 * (2 * cfg.n_layers) ** 0.5)),
        "out_norm": layers.norm_init("rmsnorm", inner, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i].to(x.dtype)
    return out


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without ``F.softplus``'s linear
    branch past 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


SUM_BLOCK = 16


def _prefix_sums_(x: torch.Tensor) -> torch.Tensor:
    """In place along the last dim: x_t ← ((x_0 + x_1) + ...) + x_t."""
    for k in range(1, x.shape[-1]):
        x[..., k] += x[..., k - 1]
    return x


def _suffix_sums(x: torch.Tensor) -> torch.Tensor:
    """Along the last dim: out_t = ((x_t + x_{t+1}) + ...) + x_{n-1}."""
    n = x.shape[-1]
    out = x.clone()
    for k in range(1, n):
        out[..., :n - k] += x[..., k:]
    return out


def _blocked_cumsum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The cumulative (or, ``reverse``, suffix) sum along the last dim, a
    multiple of ``SUM_BLOCK``, in XLA's order of additions (its rewrite of
    a cumulative reduce-window): each window's elements summed in index
    order within blocks of ``SUM_BLOCK``, the same over the blocks' totals,
    then each block's offset added."""
    n = x.shape[-1]
    inner = x.reshape(*x.shape[:-1], n // SUM_BLOCK, SUM_BLOCK)
    if reverse:
        inner = _suffix_sums(inner)
        outer = _suffix_sums(inner[..., 0])
        off = torch.cat([outer[..., 1:], torch.zeros_like(outer[..., :1])], -1)
    else:
        inner = _prefix_sums_(inner.clone())
        outer = _prefix_sums_(inner[..., -1].clone())
        off = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], -1)
    return (inner + off[..., None]).reshape(x.shape)


class _ChunkCumsum(torch.autograd.Function):
    """Cumulative sum over dim 2 in the reference's order of additions.
    The intra-chunk decay L_t - L_s subtracts two such sums, which reach
    thousands within a chunk: their f32 rounding is the decay's error, so
    the port rounds as the reference does.  The backward is the suffix sum
    (the reference's transpose rule), in the reference's order too."""

    @staticmethod
    def forward(ctx, x):
        return _blocked_cumsum(x.movedim(2, -1)).movedim(-1, 2)

    @staticmethod
    def backward(ctx, g):
        return _blocked_cumsum(g.movedim(2, -1), reverse=True).movedim(-1, 2)


def _ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    A: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, f32.  xh: (Bt, S, H, P), dt: (Bt, S, H), B, C: (Bt, S,
    N), A: (H,), h0: (Bt, H, N, P); S a multiple of ``CHUNK`` → (y (Bt, S,
    H, P), the state after S)."""
    Bt, S, H, P = xh.shape
    nc = S // CHUNK
    loga = -A * dt                                               # (Bt, S, H) ≤ 0
    cum = _ChunkCumsum.apply(loga.reshape(Bt, nc, CHUNK, H))    # L_t within a chunk
    mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=xh.device))
    h = h0
    ys = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        xck = xh[:, sl].transpose(1, 2)                          # (Bt, H, L, P)
        dck = dt[:, sl].transpose(1, 2)                          # (Bt, H, L)
        bck, cck = B[:, sl], C[:, sl]                            # (Bt, L, N)
        cumk = cum[:, c].transpose(1, 2)                         # (Bt, H, L)
        # intra-chunk quadratic form, (t, s) = (query, key) per head
        decay = cumk[..., :, None] - cumk[..., None, :]          # L_t - L_s
        scores = (cck @ bck.transpose(1, 2))[:, None] \
            * torch.exp(torch.where(mask, decay, float("-inf"))) \
            * dck[..., None, :]                                  # (Bt, H, L, L)
        y_intra = scores @ xck
        # inter-chunk: the carried state's contribution
        y_inter = (cck[:, None] @ h) * torch.exp(cumk)[..., None]
        # the state after this chunk
        tail = torch.exp(cumk[..., -1:] - cumk)                  # (Bt, H, L)
        dB = bck[:, None] * (dck * tail)[..., None]              # (Bt, H, L, N)
        h = h * torch.exp(cumk[..., -1])[..., None, None] + dB.transpose(2, 3) @ xck
        ys.append((y_intra + y_inter).transpose(1, 2))
    return torch.cat(ys, dim=1), h


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The norm over the whole inner width, the gate, and the row-parallel
    ``out_proj`` left into the residual stream's layout."""
    y = layers.rmsnorm_heads(p["out_norm"], y) * F.silu(z)
    return tp.leave(y @ p["out_proj"].to(y.dtype))


def _bc_dt(p: Params, x: torch.Tensor, N: int):
    """B, C (shared by every head) and this rank's heads' dt from the whole
    ``bc_proj``, f32."""
    bcd = x @ p["bc_proj"].to(x.dtype)
    dt = _softplus(tp.mine(bcd[..., 2 * N:], -1).float() + tp.mine(p["dt_bias"], 0))
    return bcd[..., :N].float(), bcd[..., N:2 * N].float(), dt


def ssd_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSM.  x: (B, S, d) → (out (B, S, d), final state
    (B, H, N, P) f32)."""
    x = tp.enter(x)
    Bt, S, _ = x.shape
    _, P, N = ssm_dims(cfg)
    dt_ = x.dtype
    xh, z = torch.chunk(x @ p["in_proj"].to(dt_), 2, dim=-1)
    xh = F.silu(_causal_conv(xh, p["conv"]))
    B, C, dt = _bc_dt(p, x, N)                                  # dt (Bt, S, H)
    A = torch.exp(tp.mine(p["A_log"], 0))
    H = A.shape[0]
    xhh = xh.reshape(Bt, S, H, P).float()
    if h0 is None:
        h0 = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    pad = (-S) % CHUNK
    xs, dts, Bs, Cs = xhh, dt, B, C
    if pad:
        xs = F.pad(xhh, (0, 0, 0, 0, 0, pad))
        dts, Bs, Cs = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    y, h_last = _ssd_chunk_scan(xs, dts, Bs, Cs, A, h0)
    y = y[:, :S] + xhh * tp.mine(p["D"], 0)[None, None, :, None]
    y = y.reshape(Bt, S, H * P).to(dt_)
    return _gate_out(p, y, z), h_last


def ssd_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, h: torch.Tensor,
               conv_buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B, 1, d); h: (B, H, N, P);
    conv_buf: (B, K - 1, inner) → (out, new h, new conv_buf)."""
    x = tp.enter(x)
    Bt = x.shape[0]
    _, P, N = ssm_dims(cfg)
    dt_ = x.dtype
    xh, z = torch.chunk(x @ p["in_proj"].to(dt_), 2, dim=-1)    # (B, 1, inner)
    window = torch.cat([conv_buf.to(dt_), xh], dim=1)           # (B, K, inner)
    conv_out = torch.einsum("bki,ki->bi", window, p["conv"].to(dt_))[:, None, :]
    xh = F.silu(conv_out)
    B, C, dt = (t[:, 0] for t in _bc_dt(p, x, N))               # (B, N), (B, H)
    A = torch.exp(tp.mine(p["A_log"], 0))
    H = A.shape[0]
    a = torch.exp(-A[None, :] * dt)
    xp = xh.reshape(Bt, H, P).float()
    h_new = h * a[..., None, None] + torch.einsum("bn,bh,bhp->bhnp", B, dt, xp)
    y = torch.einsum("bn,bhnp->bhp", C, h_new) + xp * tp.mine(p["D"], 0)[None, :, None]
    y = y.reshape(Bt, 1, H * P).to(dt_)
    return _gate_out(p, y, z), h_new, window[:, 1:]


# ---------------------------------------------------------------------------
# Hymba hybrid block: parallel attention + SSM heads on the same input
# ---------------------------------------------------------------------------

def hymba_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {
        "norm1": layers.norm_init(cfg.norm, cfg.d_model, dev),
        "attn": attention_init(gen, cfg),
        "ssm": ssd_init(gen, cfg),
        "attn_out_norm": layers.norm_init("rmsnorm", cfg.d_model, dev),
        "ssm_out_norm": layers.norm_init("rmsnorm", cfg.d_model, dev),
        "norm2": layers.norm_init(cfg.norm, cfg.d_model, dev),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp),
    }


def _mix(cfg: ModelConfig, p: Params, x: torch.Tensor, a: torch.Tensor,
         s: torch.Tensor) -> torch.Tensor:
    mixed = 0.5 * (layers.rmsnorm(p["attn_out_norm"], a) + layers.rmsnorm(p["ssm_out_norm"], s))
    x = x + mixed
    return x + layers.mlp_apply(p["mlp"], layers.norm_apply(cfg.norm, p["norm2"], x),
                                gated=cfg.gated_mlp, act=cfg.act, d_ff=cfg.d_ff)


def hymba_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, window: Optional[int]) -> torch.Tensor:
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    a = attention_apply(cfg, p["attn"], h, positions, causal=True, window=window)
    s, _ = ssd_apply(cfg, p["ssm"], h)
    return _mix(cfg, p, x, a, s)


def hymba_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                     window: Optional[int], device, ways: int = 1) -> Params:
    """``{"kv": the ring (``window`` wide, or ``max_len`` for a global
    layer), "ssm_h": (B, H, N, P) f32, "conv": (B, K - 1, inner)}``, at the
    heads and channels of one of ``ways`` tp ranks."""
    H, P, N = ssm_dims(cfg)
    H //= ways
    return {
        "kv": cache_init(cfg, batch, max_len, window=window, device=device,
                         n_kv_heads=cfg.n_kv_heads // ways),
        "ssm_h": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, H * P), dtype=cfg.compute_dtype,
                            device=device),
    }


def hymba_block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, t, cache, *,
                       window: Optional[int]):
    """One token through the block; the ring, ``ssm_h`` and ``conv`` of
    ``cache`` are updated in place → (x, cache)."""
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    a, _ = attention_decode(cfg, p["attn"], h, t, cache["kv"], window=window)
    s, hs, cb = ssd_decode(cfg, p["ssm"], h, cache["ssm_h"], cache["conv"])
    cache["ssm_h"].copy_(hs)
    cache["conv"].copy_(cb)
    return _mix(cfg, p, x, a, s), cache


def hymba_param_count(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    H, P, N = ssm_dims(cfg)
    inner = H * P
    att = d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) + cfg.n_heads * hd * d
    ssm = d * 2 * inner + d * (2 * N + H) + 4 * inner + 3 * H + inner + inner * d
    ff = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    per_layer = att + ssm + ff + 4 * d
    return cfg.n_layers * per_layer
