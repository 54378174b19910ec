"""xLSTM blocks, mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, recurrent), mirroring ``repro.models.xlstm``.  [arXiv:2405.04517]

The reference's recurrences are plain ``jnp`` (no Pallas kernel), so they
are plain PyTorch here, as the hybrid's SSD is.  The mLSTM runs its
chunkwise-parallel form: within a chunk of ``MCHUNK`` positions a
quadratic (B, L, L, H) product, across chunks the carried (C, n, m) state
in a Python loop where the reference scans it.  The exponential gates keep
the reference's m-state max trick, and its ``stop_gradient`` on the
stabilizers is ``detach`` here.  The sequence is padded to a multiple of
``MCHUNK`` with a log input gate of -1e30 (nothing enters the state) and a
log forget gate of 0 (nothing leaves it).  The sLSTM is a loop over time
where the reference has ``lax.scan``: its four recurrent products are one
batched product a step, and in training the whole loop is one autograd
node (``_SLSTMScan``) whose backward is written out, so that a step
records no graph over 1024 positions (a recorded loop is host-bound at ~3x
the launches).

Both recurrences run in f32.  The reference multiplies f32 activations by
compute-dtype weights in a few places (``h0 @ W`` and the recurrent
``einsum`` of the sLSTM, the gate biases of the mLSTM) and JAX promotes the
weight to f32 there; PyTorch raises on a mixed matmul, so the port upcasts
the weight in exactly those places and rounds nothing the reference does
not round.

Decode keeps the reference's O(1) states: the mLSTM's ``{"C", "n", "m",
"conv"}`` (C (B, H, D, D), n (B, H, D), m (B, H) in f32, the last three
conv inputs in the compute dtype) and the sLSTM's ``{"c", "n", "m", "h"}``
(B, d) in f32, ``m`` starting at -1e30.  The decode steps return new
states, which the caller copies into its caches.  Parameters keep the
reference's names and ``(d_in, d_out)`` orientation.

Under tensor parallelism the heads split over tp.  The mLSTM's ``in_proj``
holds this rank's heads' columns of its x half and of its z half (as the
SSD's, ``core.sharding`` maps the halves), ``conv`` its channels; its
``wq``/``wk``/``wv`` columns are its heads, but their rows read every
channel, so the conv output and the input branch are all-gathered over tp
before them (a gather of two activations of inner/tp channels; computing
the x half whole instead would hold ``in_proj``'s x columns and ``conv``
whole on every rank, against the rules' placement).  The sLSTM's
``wz``/``wi``/``wf`` columns are its heads (``wo``, ruled by rows, is
gathered), the block-diagonal ``rz``..``ro`` are sliced to them, so the
scan needs no collective, and its output is normed over d (the statistic
summed over tp) and placed back into the residual stream by a row-parallel
exit (``core.tp.leave_cols``).  The gate weights and biases
(``w_igate``/``w_fgate``, ``b_*``), the recurrent weights and the
``out_norm`` scales stay whole, as the rules place them, and each rank uses
its heads' part: their gradients are partial sums that ``core.stepfn``
sums over tp.  The decode states hold this rank's heads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _causal_conv

Params = Dict[str, Any]

MCHUNK = 128
M_INIT = -1e30          # the decode states' stabilizer before any input


def _inner(cfg: ModelConfig) -> int:
    return int(cfg.proj_factor * cfg.d_model)


def slstm_ff(cfg: ModelConfig) -> int:
    return int(math.ceil(8 * cfg.d_model / 3 / 64) * 64)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, inner, H = cfg.d_model, _inner(cfg), cfg.n_heads
    dev = gen.device
    return {
        "norm": layers.norm_init(cfg.norm, d, dev),
        "in_proj": layers.dense_init(gen, d, 2 * inner),
        "conv": torch.randn((4, inner), generator=gen, dtype=torch.float32, device=dev) * 0.1,
        "wq": layers.dense_init(gen, inner, inner),
        "wk": layers.dense_init(gen, inner, inner),
        "wv": layers.dense_init(gen, inner, inner),
        "w_igate": layers.dense_init(gen, inner, H, scale=0.02),
        "b_igate": torch.full((H,), -10.0, dtype=torch.float32, device=dev),
        "w_fgate": layers.dense_init(gen, inner, H, scale=0.02),
        "b_fgate": torch.linspace(3.0, 6.0, H, dtype=torch.float32, device=dev),
        "out_norm": layers.norm_init("rmsnorm", inner, dev),
        "out_proj": layers.dense_init(gen, inner, d,
                                      scale=1.0 / (inner ** 0.5 * (2 * cfg.n_layers) ** 0.5)),
    }


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk.  q/k/v: (B, L, H, D); li/lf: (B, L, H); state (C, n, m)
    stabilized → (h (B, L, H, D), the state after the chunk)."""
    C0, n0, m0 = state                                   # (B,H,D,D) (B,H,D) (B,H)
    L, D = q.shape[1], q.shape[3]
    scale = D ** -0.5
    Fc = torch.cumsum(lf, dim=1)                         # (B, L, H)
    # log-decay D_ts = F_t - F_s + li_s for s <= t
    dlog = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    dlog = torch.where(mask[None, :, :, None], dlog, float("-inf"))
    G = Fc + m0[:, None, :]                              # the carried state's log-scale
    m_t = torch.maximum(torch.amax(dlog, dim=2), G).detach()
    a = torch.exp(dlog - m_t[:, :, None, :])             # (B, L, L, H)
    qk = torch.einsum("blhd,bshd->blsh", q, k) * scale
    w = a * qk
    num = torch.einsum("blsh,bshd->blhd", w, v)
    den = torch.sum(w, dim=2)                            # (B, L, H)
    inter = torch.exp(G - m_t)
    num = num + inter[..., None] * torch.einsum("blhd,bhde->blhe", q * scale, C0)
    den = den + inter * torch.einsum("blhd,bhd->blh", q * scale, n0)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # the state after the chunk
    li_end = Fc[:, -1:, :] - Fc + li                     # decay from s to the end
    m_out = torch.maximum(Fc[:, -1] + m0, torch.amax(li_end, dim=1)).detach()
    carry = torch.exp(Fc[:, -1] + m0 - m_out)
    b = torch.exp(li_end - m_out[:, None, :])            # (B, L, H)
    C_new = carry[:, :, None, None] * C0 + torch.einsum("blh,blhd,blhe->bhde", b, k, v)
    n_new = carry[:, :, None] * n0 + torch.einsum("blh,blhd->bhd", b, k)
    return h, (C_new, n_new, m_out)


def mlstm_seq(cfg: ModelConfig, q, k, v, li, lf, state=None):
    """The chunk scan over the whole sequence.  q/k/v: (B, S, H, D) f32;
    li/lf: (B, S, H) → (h (B, S, H, D), the final (C, n, m)).  Without a
    ``state`` it starts from zeros and m = -inf, as the reference's."""
    B, S, H, D = q.shape
    if state is None:
        state = (q.new_zeros((B, H, D, D)), q.new_zeros((B, H, D)),
                 q.new_full((B, H), float("-inf")))
    pad = (-S) % MCHUNK
    if pad:
        def z(x, fill=0.0):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=fill)
        q, k, v, lf = z(q), z(k), z(v), z(lf)
        li = z(li, M_INIT)
    hs = []
    for c in range(q.shape[1] // MCHUNK):
        sl = slice(c * MCHUNK, (c + 1) * MCHUNK)
        h, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl], state)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S], state


def _whole_channels(x: torch.Tensor) -> torch.Tensor:
    """This rank's channels of a branch → all of them: ``wq``/``wk``/``wv``
    are dense (inner, inner) maps, each head's columns reading every channel
    (the backward reduce-scatters: each rank's products give a partial sum
    of the gradient)."""
    return x if tp.size() == 1 else tp.gather_dim(x, x.dim() - 1, tp.group())


def _mlstm_gates(cfg: ModelConfig, p: Params, xc: torch.Tensor, xin: torch.Tensor):
    """q, k, v (..., H, D) and the log gates li, lf (..., H), f32, from the
    conv branch ``xc`` and the input branch ``xin`` (all channels): this
    rank's heads under tp (the columns of ``wq``/``wk``/``wv`` it holds, its
    heads' columns of the whole gate weights and biases)."""
    dt = xc.dtype
    D = _inner(cfg) // cfg.n_heads
    shape = xc.shape[:-1] + (-1, D)
    q = (xc @ p["wq"].to(dt)).reshape(shape).float()
    k = (xc @ p["wk"].to(dt)).reshape(shape).float()
    v = (xin @ p["wv"].to(dt)).reshape(shape).float()
    li = (xc @ tp.mine(p["w_igate"], 1).to(dt)).float() + tp.mine(p["b_igate"], 0).float()
    lf = F.logsigmoid((xc @ tp.mine(p["w_fgate"], 1).to(dt)).float()
                      + tp.mine(p["b_fgate"], 0).float())
    return q, k, v, li, lf


def _mlstm_out(p: Params, x: torch.Tensor, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    h = layers.rmsnorm_heads(p["out_norm"], h.to(x.dtype)) * F.silu(z)
    return x + tp.leave(h @ p["out_proj"].to(x.dtype))


def _mlstm_branches(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The normed x into the tp region → (the input branch, the gate z),
    this rank's channels of each."""
    h = tp.enter(layers.norm_apply(cfg.norm, p["norm"], x))
    return torch.chunk(h @ p["in_proj"].to(x.dtype), 2, dim=-1)


def mlstm_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xin, z = _mlstm_branches(cfg, p, x)
    B, S, _ = xin.shape
    xc = F.silu(_causal_conv(xin, p["conv"]))
    q, k, v, li, lf = _mlstm_gates(cfg, p, _whole_channels(xc), _whole_channels(xin))
    hseq, _ = mlstm_seq(cfg, q, k, v, li, lf)
    return _mlstm_out(p, x, hseq.reshape(B, S, -1), z)


def mlstm_state_init(cfg: ModelConfig, batch: int, device, ways: int = 1) -> Params:
    """The decode state at the heads and channels of one of ``ways`` tp
    ranks."""
    H = cfg.n_heads // ways
    D = _inner(cfg) // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, D, D), **f32),
            "n": torch.zeros((batch, H, D), **f32),
            "m": torch.full((batch, H), M_INIT, **f32),
            "conv": torch.zeros((batch, 3, H * D), dtype=cfg.compute_dtype, device=device)}


def mlstm_block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, state
                       ) -> Tuple[torch.Tensor, Params]:
    """The O(1) recurrent step.  x: (B, 1, d) → (x, the new state)."""
    B = x.shape[0]
    dt = x.dtype
    D = _inner(cfg) // cfg.n_heads
    xin, z = _mlstm_branches(cfg, p, x)
    window = torch.cat([state["conv"].to(dt), xin], dim=1)          # (B, 4, inner)
    xc = F.silu(torch.einsum("bki,ki->bi", window, p["conv"].to(dt))[:, None])
    q, k, v, li, lf = _mlstm_gates(cfg, p, _whole_channels(xc[:, 0]),
                                   _whole_channels(xin[:, 0]))     # (B, H, D), (B, H)
    q = q * D ** -0.5
    C0, n0, m0 = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m0, li)
    fg = torch.exp(lf + m0 - m_new)
    ig = torch.exp(li - m_new)
    C = fg[..., None, None] * C0 + ig[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fg[..., None] * n0 + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    hh = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    out = _mlstm_out(p, x, hh.reshape(B, 1, -1), z)
    return out, {"C": C, "n": n, "m": m_new, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    dev = gen.device

    def rec():  # block-diagonal recurrent weights, one (dh, dh) a head
        return torch.randn((H, dh, dh), generator=gen, dtype=torch.float32,
                           device=dev) / dh ** 0.5

    p = {"norm": layers.norm_init(cfg.norm, d, dev)}
    for g in "zifo":
        p[f"w{g}"] = layers.dense_init(gen, d, d)
        p[f"r{g}"] = rec()
    p.update({
        "bz": torch.zeros((d,), dtype=torch.float32, device=dev),
        "bi": torch.full((d,), -10.0, dtype=torch.float32, device=dev),
        "bf": torch.linspace(3.0, 6.0, d, dtype=torch.float32, device=dev),
        "bo": torch.zeros((d,), dtype=torch.float32, device=dev),
        "out_norm": layers.norm_init("rmsnorm", d, dev),
        "norm2": layers.norm_init(cfg.norm, d, dev),
        "mlp": layers.mlp_init(gen, d, slstm_ff(cfg), gated=True),
    })
    return p


def slstm_state_init(cfg: ModelConfig, batch: int, device, ways: int = 1) -> Params:
    """The decode state at the heads' channels of one of ``ways`` tp ranks."""
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model // ways
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_INIT, **f32), "h": torch.zeros((batch, d), **f32)}


def _slstm_w(p: Params, g: str) -> torch.Tensor:
    """Gate ``g``'s input weight, this rank's heads' columns under tp: the
    rules cut ``wz``/``wi``/``wf`` by columns, but ``wo`` (the attention's
    rule, first match) by rows, so it is gathered whole and its columns
    taken (the gather's backward reduce-scatters its gradient to the
    rows)."""
    w = p[f"w{g}"]
    if g == "o" and tp.size() > 1:
        w = tp.mine(tp.gather_dim(w, 0, tp.group()), 1)
    return w


def _slstm_pre(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The gates' input parts (B, S, 4, d) in the order z, i, f, o, f32: the
    normed x (upcast, as the reference casts it) times each f32-promoted
    weight, plus its bias (this rank's heads' channels under tp)."""
    h0 = tp.enter(layers.norm_apply(cfg.norm, p["norm"], x)).float()
    return torch.stack([h0 @ _slstm_w(p, g).float() + tp.mine(p[f"b{g}"], 0).float()
                        for g in "zifo"], 2)


def _slstm_r(p: Params) -> torch.Tensor:
    """The four block-diagonal recurrent weights side by side, (H, dh,
    4·dh) f32: one batched product a step where the reference has four
    (this rank's heads under tp: the recurrence needs no collective)."""
    return torch.cat([tp.mine(p[f"r{g}"], 0).float() for g in "zifo"], dim=-1)


def _to_scan(pre: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, 4, d) → (S, H, B, 4, dh), the scan's layout: a head's rows at
    one position are one matrix of the recurrent product."""
    B, S, _, d = pre.shape
    return pre.view(B, S, 4, H, d // H).permute(1, 3, 0, 2, 4).contiguous()


def _state_in(x: torch.Tensor, H: int) -> torch.Tensor:
    """A decode state (B, d) → (H, B, dh)."""
    return x.view(x.shape[0], H, -1).transpose(0, 1).contiguous()


def _slstm_scan(X, R, c, n, m, h, saved=None):
    """The sLSTM recurrence over time, without autograd.  X: (S, H, B, 4, dh)
    the gates' input parts (overwritten with the whole pre-activations, the
    recurrent part added); R: (H, dh, 4·dh); c, n, m, h: (H, B, dh) the
    state before the first position.  ``saved`` (C, N, M, Hs), each (S, H,
    B, dh), receive every position's state; → the last (c, n, m, h)."""
    S, H, B, _, dh = X.shape
    for t in range(S):
        x = X[t]
        x.add_(torch.bmm(h, R).view(H, B, 4, dh))
        z, li = torch.tanh(x[:, :, 0]), x[:, :, 1]
        o = torch.sigmoid(x[:, :, 3])
        a = F.logsigmoid(x[:, :, 2]).add_(m)                  # lf + m
        m = torch.maximum(a, li, out=None if saved is None else saved[2][t])
        fg = torch.exp(a.sub_(m))
        ig = torch.exp(li - m)
        c = torch.addcmul(fg * c, ig, z, out=None if saved is None else saved[0][t])
        n = torch.addcmul(ig, fg, n, out=None if saved is None else saved[1][t])
        den = torch.maximum(n, torch.exp(-m))
        h = torch.div(o * c, den, out=None if saved is None else saved[3][t])
    return c, n, m, h


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over a sequence from the fresh state, as one
    autograd node: the forward steps without recording a graph and keeps
    every position's pre-activations and state; the backward recomputes the
    gates from them, vectorized over the sequence, and runs the reverse
    recurrence of the gradients (c, n, m and h carried) with the
    derivatives JAX takes of the reference's cell (a tie of a maximum
    splits the gradient in halves, as ``jnp.maximum``'s does).  The
    recurrent weights' gradient is one product over all positions.
    P: (S, H, B, 4, dh) the gates' input parts; R: (H, dh, 4·dh) →
    Hs (S, H, B, dh)."""

    @staticmethod
    def forward(ctx, P, R):
        S, H, B, _, dh = P.shape
        X = P.clone()
        C, N, M, Hs = (P.new_empty((S, H, B, dh)) for _ in range(4))
        zero = P.new_zeros((H, B, dh))
        _slstm_scan(X, R, zero, zero, P.new_full((H, B, dh), M_INIT), zero,
                    saved=(C, N, M, Hs))
        ctx.save_for_backward(X, R, C, N, M, Hs)
        return Hs

    @staticmethod
    def backward(ctx, gH):
        X, R, C, N, M, Hs = ctx.saved_tensors
        S, H, B, _, dh = X.shape

        def prev(T, init):
            return torch.cat([torch.full_like(T[:1], init), T[:-1]])

        Cp, Np, Mp, Hp = prev(C, 0.0), prev(N, 0.0), prev(M, M_INIT), prev(Hs, 0.0)
        xz, xi, xf, xo = X.unbind(3)
        z, o = torch.tanh(xz), torch.sigmoid(xo)
        a = F.logsigmoid(xf) + Mp
        fg, ig = torch.exp(a - M), torch.exp(xi - M)
        e = torch.exp(-M)
        den = torch.maximum(N, e)

        def share(u, v):                    # d max(u, v) / du, ties halved
            return (u > v).float() + 0.5 * (u == v).float()

        K = Hs / den
        A1, A2, A3 = o / den, -K * share(N, e), K * share(e, N) * e   # dc, dn, dm from h
        Q = C / den * o * (1 - o)                              # dXo from h
        Ma, Ml = share(a, xi), share(xi, a)
        dz_dx, df_dx = 1 - z * z, torch.sigmoid(-xf)
        dX = torch.empty_like(X)
        Rt = R.transpose(1, 2)
        gc, gn, gm, gh = (X.new_zeros((H, B, dh)) for _ in range(4))
        for t in range(S - 1, -1, -1):
            g = gH[t] + gh
            dc = torch.addcmul(gc, g, A1[t])
            dn = torch.addcmul(gn, g, A2[t])
            gmt = torch.addcmul(gm, g, A3[t])
            dfg = torch.addcmul(dc * Cp[t], dn, Np[t]).mul_(fg[t])   # d(a - m)
            dig = torch.addcmul(dn, dc, z[t]).mul_(ig[t])             # d(li - m)
            dm = gmt - dfg - dig
            torch.mul(g, Q[t], out=dX[t, :, :, 3])
            torch.mul(dc * ig[t], dz_dx[t], out=dX[t, :, :, 0])
            torch.addcmul(dig, dm, Ml[t], out=dX[t, :, :, 1])
            gm = torch.addcmul(dfg, dm, Ma[t])                        # d a = d m_prev
            torch.mul(gm, df_dx[t], out=dX[t, :, :, 2])
            gc, gn = dc * fg[t], dn * fg[t]
            gh = torch.bmm(dX[t].view(H, B, 4 * dh), Rt)
        dR = torch.bmm(Hp.transpose(0, 1).reshape(H, S * B, dh).transpose(1, 2),
                       dX.transpose(0, 1).reshape(H, S * B, 4 * dh))
        return dX, dR


def _slstm_out(cfg: ModelConfig, p: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The cell output ``h`` (this rank's heads' channels under tp) normed
    over d and added to the residual stream, then the FFN."""
    x = x + tp.leave_cols(layers.rmsnorm_heads(p["out_norm"], h.to(x.dtype)))
    return x + layers.mlp_apply(p["mlp"], layers.norm_apply(cfg.norm, p["norm2"], x),
                                gated=True, d_ff=slstm_ff(cfg))


def _local_heads(cfg: ModelConfig, pre: torch.Tensor) -> int:
    return pre.shape[-1] // (cfg.d_model // cfg.n_heads)


def slstm_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    pre = _slstm_pre(cfg, p, x)
    B, S = pre.shape[:2]
    hs = _SLSTMScan.apply(_to_scan(pre, _local_heads(cfg, pre)), _slstm_r(p))
    return _slstm_out(cfg, p, x, hs.permute(2, 0, 1, 3).reshape(B, S, -1))


def slstm_block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, state
                       ) -> Tuple[torch.Tensor, Params]:
    B = x.shape[0]
    pre = _slstm_pre(cfg, p, x)
    H = _local_heads(cfg, pre)
    st = _slstm_scan(_to_scan(pre, H), _slstm_r(p),
                     *(_state_in(state[k], H) for k in "cnmh"))
    st = {k: v.transpose(0, 1).reshape(B, -1) for k, v in zip("cnmh", st)}
    return _slstm_out(cfg, p, x, st["h"][:, None]), st


def xlstm_param_count(cfg: ModelConfig) -> int:
    d, H = cfg.d_model, cfg.n_heads
    inner = _inner(cfg)
    n_s = len(cfg.slstm_at)
    n_m = cfg.n_layers - n_s
    m_block = d + d * 2 * inner + 4 * inner + 3 * inner * inner + 2 * inner * H + 2 * H \
        + inner + inner * d
    dh = d // H
    s_block = d + 4 * (d * d + H * dh * dh) + 4 * d + d + d + 3 * d * slstm_ff(cfg)
    return n_m * m_block + n_s * s_block
