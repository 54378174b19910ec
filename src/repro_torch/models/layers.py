"""Primitive layers, mirroring ``repro.models.layers``.

Plain functions over parameter dicts of tensors.  Initializers return fp32;
the forward pass casts to the compute dtype.  Weights keep the reference's
``(d_in, d_out)`` orientation and are applied as ``x @ W`` (the transpose of
``nn.Linear``), so checkpoints cross between the packages unchanged.

Under tensor parallelism (rules installed by ``core.sharding.axis_rules``)
a leaf holds this rank's slice (``core.sharding.shard_params``): the MLP is
column-parallel in and row-parallel out, inside ``core.tp``'s regions (or
whole, where tp does not divide its width), and
a vocabulary table shorter than the config's vocabulary is looked up and
unembedded vocab-parallel.  Without rules the regions are the identity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import tp

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, ``(d_in, d_out)`` fp32 on the
    generator's device."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -3.0 * std, 3.0 * std,
                                       generator=gen)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                       device=gen.device) * 0.02


# ---------------------------------------------------------------------------
# norms (computed in fp32 whatever the storage dtype of x and the scale)
# ---------------------------------------------------------------------------

def norm_init(kind: str, d: int, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def rmsnorm_heads(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` over a width whose channels the tp ranks split by
    heads: ``x`` holds this rank's channels, the mean square is taken over
    the whole width (its sum all-reduced over tp) and this rank's channels
    of the whole ``scale`` apply (their gradient a partial sum over tp)."""
    if tp.size() == 1:
        return rmsnorm(p, x, eps=eps)
    xf = x.float()
    var = tp.sum_sq(xf) / (xf.shape[-1] * tp.size())
    out = xf * torch.rsqrt(var + eps) * tp.mine(p["scale"], 0).float()
    return out.to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def norm_apply(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates the
    split halves ``[x1, x2]`` (not interleaved pairs), angles in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]                  # (..., S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True) -> Params:
    p: Params = {"w_out": dense_init(gen, d_ff, d_model)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff)
        p["w_up"] = dense_init(gen, d_model, d_ff)
    else:
        p["w_in"] = dense_init(gen, d_model, d_ff)
    return p


def mlp_apply(p: Params, x: torch.Tensor, *, d_ff: int, gated: bool = True,
              act: str = "silu") -> torch.Tensor:
    """Column-parallel ``w_gate``/``w_up``/``w_in`` (their d_ff columns
    sharded), row-parallel ``w_out``: the regions enter from the residual
    stream's layout and leave back into it.  Where tp does not divide the
    hidden width ``d_ff`` the rules leave the MLP whole (``sanitize``), and
    every rank computes it whole on its own rows of the residual stream,
    outside the regions: without sequence parallel every rank computes the
    same MLP on the same input, so its weights' gradients are whole there
    and are not summed over tp; under sequence parallel each rank's are a
    partial sum over its S/tp rows (``core.stepfn`` all-reduces them)."""
    dt = x.dtype
    regions = tp.divides(d_ff)
    if regions:
        x = tp.enter(x)
    if gated:
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    else:
        h = x @ p["w_in"].to(dt)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    h = h @ p["w_out"].to(dt)
    return tp.leave(h) if regions else h


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """``table[ids]`` in ``dtype``; a table of fewer rows than ``vocab_size``
    is this rank's slice of the vocabulary, looked up vocab-parallel."""
    if vocab_size is not None and table.shape[0] != vocab_size:
        return tp.vocab_embed(table, ids, dtype)
    return table.to(dtype)[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32 from the upcast table (this rank's
    slice of the vocabulary when the table is sharded)."""
    return x.float() @ table.float().T


def gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: the reference takes a mask-sum (so a vocab-sharded
    axis partitions cleanly); on one device a gather gives the same value."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: Optional[int] = None) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]``; logits narrower than
    ``vocab_size`` are this rank's slice of the vocabulary
    (``core.tp.vocab_cross_entropy``)."""
    if vocab_size is not None and logits.shape[-1] != vocab_size:
        return tp.vocab_cross_entropy(logits, labels)
    return torch.logsumexp(logits, dim=-1) - gold_logit(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy. logits fp32 (..., V); labels int (...,)."""
    nll = token_nll(logits, labels, vocab_size)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
