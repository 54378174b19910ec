"""Mixture-of-Experts FFN, mirroring ``repro.models.moe``: top-k routing
under a per-group capacity, fine-grained routed experts and optional shared
experts, and the Switch load-balance loss.

The reference has two dispatches of one semantics: the GShard one-hot
einsums and an argsort gather/scatter.  The port has one, the second: the
flat ``(token, slot)`` ids (token-major, slot-minor) are stably sorted by
(group, expert), a slot's place in its expert's queue is its rank in that
bucket, and a slot at a place ≥ C is dropped (combine weight 0).  The kept
slots' tokens are gathered into an ``(E, G·C, d)`` buffer, the experts run
as three ``torch.bmm``, and every ``(token, slot)`` gathers its expert's row
back, weighted, into a ``(T, k, d)`` tensor summed over k.  No ``(T, E, C)``
one-hot is built, and every sum over a token's slots runs in slot order:
the combine, and the dispatch's backward (:class:`_Dispatch`), where the
gather's own backward would add a token's k rows by atomics in an order
that changes from run to run.  So a step repeats bit for bit.  Empty
buffer rows hold token 0: no slot reads their output, so they add nothing
to the output, and their gradient is exactly 0.

Routing groups (:func:`moe_groups`): the tokens are routed in G groups of
T/G consecutive tokens (rows), each with its own capacity; G falls back to
1 where it does not divide T.  Over the mesh's ``(pod, data)`` plane
(:func:`routing_plane`) a rank routes its own rows as one group of the
reference's G = dp·pods, and the load-balance statistics ``me`` and ``ce``
are averaged over the plane (one all-reduce of 2·E floats a layer, whose
backward sums the cotangents) before their product.  The settings are
process-wide, as ``core.sharding``'s rules: a CUDA backward recomputes a
remat block on autograd's device thread.

Expert parallelism (the family's rules put the expert axis on tp): every
rank routes all of its group's tokens identically from the replicated
router, runs only its ``E/tp`` local experts, and its combine is a partial
sum that one all-reduce over tp finishes (a reduce-scatter to the sequence
slices under sequence parallel, the tokens gathered before the routing).
The router's gradient comes whole on every rank: the combine weights enter
the region through ``copy_to_tp``, whose backward sums the ranks' parts.
The shared experts' ``w_gate``/``w_up`` are cut over ``d`` by the rules and
``w_out`` over its rows: the first two are gathered in the block and their
columns of this rank's rows of ``w_out`` taken, a column- then row-parallel
MLP whose partial sum joins the routed one before the all-reduce.  Where tp
does not divide E the experts stay whole (``sanitize``) and every rank
computes the routed part whole.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

_state = SimpleNamespace(groups=1, plane=None, plane_size=1)

# the reference's ``MoELM.param_sharding_hints``, matched before the generic
# rules: the expert stacks carry an explicit "expert" axis (on tp) and the
# router stays replicated, so every rank routes identically.  ``w_gate`` and
# ``w_up`` also match the shared experts' (d, ff) leaves, whose rules then
# cut d ("expert") and ff ("embed")
SHARDING_HINTS = (
    (r"moe.*\brouter\b$", ("embed", None)),
    (r"moe.*\b(w_gate|w_up)\b$", ("expert", "embed", "tp")),
    (r"moe.*\bw_out\b$", ("expert", "tp", "embed")),
)


@contextmanager
def moe_groups(n: int):
    """Route the tokens of a call in ``n`` groups (the reference's
    ``moe_groups``)."""
    old = _state.groups
    _state.groups = max(1, int(n))
    try:
        yield
    finally:
        _state.groups = old


@contextmanager
def routing_plane(group, size: int):
    """Average the load-balance statistics over ``group`` (``size`` ranks,
    each one routing group of the reference's); nothing when ``size`` is 1."""
    old = (_state.plane, _state.plane_size)
    _state.plane, _state.plane_size = (group, size) if size > 1 else (None, 1)
    try:
        yield
    finally:
        _state.plane, _state.plane_size = old


def _trunc_normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -3.0 * std, 3.0 * std, generator=gen)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The router (d, E), the experts ``w_gate``/``w_up`` (E, d, ff) and
    ``w_out`` (E, ff, d), and the shared experts as one gated MLP of width
    ``n_shared_experts·moe_d_ff``; fp32."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p: Params = {
        "router": layers.dense_init(gen, d, E, scale=0.02),
        "w_gate": _trunc_normal(gen, (E, d, ff), 1.0 / math.sqrt(d)),
        "w_up": _trunc_normal(gen, (E, d, ff), 1.0 / math.sqrt(d)),
        "w_out": _trunc_normal(gen, (E, ff, d), 1.0 / math.sqrt(ff)),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, cfg.n_shared_experts * ff, gated=True)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """The reference's per-group expert capacity: ``min(max(k, round(Tg·k/E
    ·capacity_factor)), Tg)`` (Python's round: half to even)."""
    k, E = cfg.top_k, cfg.n_experts
    c = int(max(k, round(tokens_per_group * k / E * cfg.capacity_factor)))
    return min(c, tokens_per_group)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """Tokens (T, d) → (probs (T, E) f32, expert ids (T, k), normalized gate
    weights (T, k) f32).  The router runs in f32; ties between experts go to
    the lower index, as ``lax.top_k`` gives them."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    gate_w = torch.gather(probs, 1, idx)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, idx, gate_w


def load_balance(cfg: ModelConfig, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch's ``E·Σ_e me_e·ce_e``: ``me`` the mean router probability and
    ``ce`` the share of slots of each expert, over every group (over the
    routing plane too)."""
    E, k = cfg.n_experts, cfg.top_k
    T = probs.shape[0]
    me = probs.mean(0)
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32, device=probs.device))
    ce = counts / T / k
    if _state.plane is not None:
        both = tp.sum_over(torch.cat([me, ce]), _state.plane) / _state.plane_size
        me, ce = both[:E], both[E:]
    return E * torch.sum(me * ce)


def _slots(cfg: ModelConfig, idx: torch.Tensor, G: int, C: int, e0: int, n_local: int):
    """Per flat (token, slot) of the T·k: its row in this rank's
    (n_local, G·C) expert buffer (0 where it does not land there) and
    whether it lands (kept under the capacity, on a local expert)."""
    E, k = cfg.n_experts, cfg.top_k
    T = idx.shape[0]
    N = T * k
    dev = idx.device
    group = (torch.arange(T, device=dev) // (T // G)).repeat_interleave(k)
    key = idx.reshape(-1).long() + E * group                   # (group, expert)
    order = torch.sort(key, stable=True).indices                # token-major in a bucket
    counts = torch.zeros(G * E, dtype=torch.long, device=dev).index_add_(
        0, key, torch.ones(N, dtype=torch.long, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty(N, dtype=torch.long, device=dev).scatter_(
        0, order, torch.arange(N, device=dev) - starts[key[order]])
    el = key % E - e0
    lands = (pos < C) & (el >= 0) & (el < n_local)
    row = torch.where(lands, el * (G * C) + group * C + pos, 0)
    return row, lands


class _Dispatch(torch.autograd.Function):
    """``x[src]``: each buffer row one token.  The backward gathers each
    (token, slot)'s row and sums a token's k of them in slot order."""

    @staticmethod
    def forward(ctx, x, src, row, lands, k: int):
        ctx.save_for_backward(row, lands)
        ctx.k = k
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, dxe):
        row, lands = ctx.saved_tensors
        g = torch.where(lands[:, None], dxe.index_select(0, row), 0.0)
        return g.view(-1, ctx.k, dxe.shape[-1]).sum(1), None, None, None, None


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The routed experts on their buffers (n, rows, d) → (n, rows, d)."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dt))) * torch.bmm(xe, p["w_up"].to(dt))
    return torch.bmm(h, p["w_out"].to(dt))


def routed(cfg: ModelConfig, p: Params, xf: torch.Tensor, idx: torch.Tensor,
           gate_w: torch.Tensor, G: int, C: int, e0: int = 0) -> torch.Tensor:
    """The routed experts' combine (T, d) over the experts ``p`` holds
    (``e0`` the first's id), in ``xf``'s dtype."""
    T, d = xf.shape
    k = cfg.top_k
    n_local = p["w_gate"].shape[0]
    row, lands = _slots(cfg, idx, G, C, e0, n_local)
    src = torch.zeros(n_local * G * C + 1, dtype=torch.long, device=xf.device)
    src.scatter_(0, torch.where(lands, row, n_local * G * C),
                 torch.arange(T * k, device=xf.device) // k)
    xe = _Dispatch.apply(xf, src[:-1], row, lands, k).view(n_local, G * C, d)
    ye = _experts(p, xe).view(n_local * G * C, d)
    w = torch.where(lands, gate_w.reshape(-1), 0.0).to(xf.dtype)
    return (ye.index_select(0, row) * w[:, None]).view(T, k, d).sum(1)


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' gated MLP on ``x`` (T, d): whole, or under tp
    this rank's part (the rows of ``w_out`` it holds) of a sum over ranks."""
    dt = x.dtype
    wg, wu, wo = p["w_gate"], p["w_up"], p["w_out"]
    if wg.shape[0] != x.shape[-1]:          # d cut over tp by the family's rules
        wg, wu = tp.gather_dim(wg, 0, tp.group()), tp.gather_dim(wu, 0, tp.group())
    if wg.shape[1] != wo.shape[0]:          # this rank's columns: its rows of w_out
        start = tp.rank() * wo.shape[0]
        wg, wu = wg.narrow(1, start, wo.shape[0]), wu.narrow(1, start, wo.shape[0])
    h = F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))
    return h @ wo.to(dt)


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) in the residual stream's layout → (out, like x; aux, the
    load-balance loss, an f32 scalar)."""
    sp = tp.sequence_parallel()
    xw = tp.gather_seq(x, reduce_grad=False) if sp else x
    B, S, d = xw.shape
    T = B * S
    G = _state.groups if T % _state.groups == 0 else 1
    C = capacity(cfg, T // G)
    xf = xw.reshape(T, d)
    probs, idx, gate_w = route(cfg, p["router"], xf)
    aux = load_balance(cfg, probs, idx)

    n_local = p["w_gate"].shape[0]
    ep = n_local != cfg.n_experts           # the experts cut over tp
    xin = tp.copy_to_tp(xf)                 # the tp region's input
    partial = None
    if ep:
        partial = routed(cfg, p, xin, idx, tp.copy_to_tp(gate_w), G, C, tp.rank() * n_local)
        whole = None
    else:
        whole = routed(cfg, p, xf, idx, gate_w, G, C)
    if "shared" in p:
        s = _shared(p["shared"], xin)
        if whole is not None and tp.size() == 1:
            whole = whole + s
        else:
            partial = s if partial is None else partial + s
    out = None
    if whole is not None:
        out = whole.view(B, S, d)
        if sp:
            out = tp.split(out, 1)
    if partial is not None:
        part = partial.view(B, S, d)
        part = tp.reduce_scatter_to_seq(part) if sp else tp.reduce_from_tp(part)
        out = part if out is None else out + part
    return out, aux
