"""The flash-attention kernels: K1 (forward, ``csrc/flash_fwd.cu``) and
K2-K4 (backward, ``csrc/flash_bwd.cu``), their wrappers, their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Replace the Pallas kernels of ``repro/kernels/flash_attention.py``:
``_fwd_kernel`` (K1, launched by ``_forward``) and ``_delta_kernel`` (K2),
``_dq_kernel`` (K3) and ``_dkv_kernel`` (K4), launched by ``_backward``.
K1 is online-softmax attention with the causal, sliding-window and
segment-id masks and GQA through ``h // g``; it emits ``O`` and
``lse = m + log(max(l, 1e-30))`` (B, Hq, Sq) f32.  The backward recomputes
``P = exp(s - lse)`` under the same masks from the residuals
``(q, k, v, segment_ids, O, lse)``: K2 ``delta = rowsum(dO * O)``, K3 dQ,
K4 dK and dV with the GQA group summed inside the kernel.

Bound on the H100: K1, K3 and K4 by tensor-core operations (``4``, ``6``
and ``8·B·Hq·Sq·Sk·D``, about halved when causal), K2 by bytes.  The
kernels bound their tile loops the way ``_block_relevant`` does and run
their products on the tensor cores in bf16 (FMA in f32); see the sources
for the design.  Unlike the reference's ``flash_supported``, any sequence
length launches them: they mask the ragged tails themselves.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    ("flash_fwd", "repro_flash_fwd"): [_P] * 6 + [_I] * 7 + [_LL] * 9 + [_I, _I, _F, _P],
    ("flash_bwd", "repro_flash_delta"): [_P] * 3 + [_I] * 5 + [_LL] * 6 + [_P],
    ("flash_bwd", "repro_flash_dq"): [_P] * 8 + [_I] * 7 + [_PLL, _I, _I, _F, _P],
    ("flash_bwd", "repro_flash_dkv"): [_P] * 9 + [_I] * 7 + [_PLL, _I, _I, _F, _P],
}


def _entry(lib: str = "flash_fwd", name: str = "repro_flash_fwd"):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[(lib, name)]
        fn.restype = _I
    return fn


def _check_inputs(q, k, v, segment_ids, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or Sq == 0 or Sk == 0:
        raise ValueError(f"flash_fwd: incompatible shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if segment_ids is not None and (tuple(segment_ids.shape) != (B, Sq) or Sq != Sk):
        raise ValueError(f"flash_fwd: segment_ids must be (B, S) with Sq == Sk; "
                         f"got {tuple(segment_ids.shape)} for Sq={Sq}, Sk={Sk}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_fwd: window must be positive, got {window}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              segment_ids: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1.  q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D), bf16 or f32 on one
    CUDA device, last dim contiguous → (O like q, lse (B, Hq, Sq) f32)."""
    _check_inputs(q, k, v, segment_ids, window)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    ts = (q, k, v) if segment_ids is None else (q, k, v, segment_ids)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_fwd: every input must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd: bf16 or f32 q/k/v of one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd: the head dim of q/k/v must be contiguous")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"flash_fwd: grid too large (Hq={Hq}, B={B})")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if seg is None else seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Sk, Hq, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), window or 0, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_fwd")
    build.launch_counts["flash_fwd"] += 1
    return o, lse


def _mask_plain(B: int, Sq: int, Sk: int, device, segment_ids, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """The kernels' mask over aligned positions, (B|1, 1, 1, Sq, Sk) bool."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ok = ok[None]
    if segment_ids is not None:
        ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return ok[:, None, None]


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    segment_ids: Optional[torch.Tensor] = None, causal: bool = True,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version: the same (O, lse), with the kernel's masking
    semantics (a fully masked row gives O = 0), in fp32 einsums."""
    _check_inputs(q, k, v, segment_ids, window)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    ok = _mask_plain(B, Sq, Sk, q.device, segment_ids, causal, window)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * ok
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, Sq)
    return o.reshape(B, Sq, Hq, D).to(q.dtype), lse


# ---------------------------------------------------------------------------
# backward: K2 (delta), K3 (dQ), K4 (dK, dV)
# ---------------------------------------------------------------------------

def _check_grad_inputs(q, k, v, do, lse, delta, segment_ids, window):
    _check_inputs(q, k, v, segment_ids, window)
    B, Sq, Hq, _ = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash backward: dO {tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"flash backward: {name} must be (B, Hq, Sq) = {(B, Hq, Sq)} "
                             f"f32; got {tuple(t.shape)} {t.dtype}")


def _check_card(name: str, ts) -> None:
    """What every backward wrapper refuses: tensors off the card or on two
    devices, dtypes other than one of bf16/f32, a strided head dim."""
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{name}: every input must be on the same CUDA device")
    if ts[0].dtype not in _DTYPE_CODE or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{name}: bf16 or f32 inputs of one dtype; got "
                         f"{[str(t.dtype) for t in ts]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name}: the head dim of every input must be contiguous")


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch K2.  O, dO: (B, Sq, Hq, D), bf16 or f32 on one CUDA device, last
    dim contiguous → delta = rowsum(dO * O), (B, Hq, Sq) f32."""
    if o.dim() != 4 or tuple(o.shape) != tuple(do.shape) or o.shape[1] == 0:
        raise ValueError(f"flash_delta: O and dO (B, Sq, Hq, D) of one shape expected; "
                         f"got {tuple(o.shape)}, {tuple(do.shape)}")
    _check_card("flash_delta", (o, do))
    B, Sq, Hq, D = o.shape
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=o.device)
    rc = _entry("flash_bwd", "repro_flash_delta")(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), _DTYPE_CODE[o.dtype], B, Sq, Hq, D,
        *o.stride()[:3], *do.stride()[:3], torch.cuda.current_stream(o.device).cuda_stream)
    build.check(rc, "flash_delta")
    build.launch_counts["flash_delta"] += 1
    return delta


def _launch_grad(name: str, q, k, v, do, lse, delta, segment_ids, causal, window, outs):
    _check_grad_inputs(q, k, v, do, lse, delta, segment_ids, window)
    _check_card(name, (q, k, v, do))
    if not (lse.device == delta.device == q.device and lse.is_contiguous()
            and delta.is_contiguous()):
        raise ValueError(f"{name}: lse and delta must be contiguous on q's device")
    if segment_ids is not None and segment_ids.device != q.device:
        raise ValueError(f"{name}: segment_ids must be on q's device")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"{name}: grid too large (Hq={Hq}, B={B})")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3])
    rc = _entry("flash_bwd", f"repro_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if seg is None else seg.data_ptr(),
        *(t.data_ptr() for t in outs), _DTYPE_CODE[q.dtype], B, Sq, Sk, Hq, Hkv, D,
        strides, int(causal), window or 0, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, name)
    build.launch_counts[name] += 1


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
             lse: torch.Tensor, delta: torch.Tensor, *,
             segment_ids: Optional[torch.Tensor] = None, causal: bool = True,
             window: Optional[int] = None) -> torch.Tensor:
    """Launch K3.  q, dO: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); lse, delta:
    (B, Hq, Sq) f32 contiguous → dQ like q."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_grad("flash_dq", q, k, v, do, lse, delta, segment_ids, causal, window, (dq,))
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, *,
              segment_ids: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4.  Shapes as :func:`flash_dq` → (dK, dV) like k and v, the
    GQA group of each KV head summed inside the kernel."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_grad("flash_dkv", q, k, v, do, lse, delta, segment_ids, causal, window, (dk, dv))
    return dk, dv


def flash_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K2's plain version: rowsum(dO * O) in f32, (B, Hq, Sq)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _grad_probs_plain(q, k, v, do, lse, delta, segment_ids, causal, window):
    """(P, dS), each (B, Hkv, g, Sq, Sk) f32, recomputed as the kernels do:
    masked entries are exactly 0, whatever lse is."""
    _check_grad_inputs(q, k, v, do, lse, delta, segment_ids, window)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, Sq, Hkv, g, D),
                     k.float()) * (D ** -0.5)
    ok = _mask_plain(B, Sq, Sk, q.device, segment_ids, causal, window)
    p = torch.where(ok, torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float().reshape(B, Sq, Hkv, g, D), v.float())
    return p, p * (dp - delta.reshape(B, Hkv, g, Sq, 1))


def flash_dq_plain(q, k, v, do, lse, delta, *, segment_ids=None, causal=True,
                   window=None) -> torch.Tensor:
    """K3's plain version, in f32 einsums → dQ like q."""
    _, ds = _grad_probs_plain(q, k, v, do, lse, delta, segment_ids, causal, window)
    B, Sq, Hq, D = q.shape
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * (D ** -0.5)
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, segment_ids=None, causal=True,
                    window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version, in f32 einsums → (dK, dV) like k and v, the GQA
    group summed."""
    p, ds = _grad_probs_plain(q, k, v, do, lse, delta, segment_ids, causal, window)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    dof = do.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * (D ** -0.5)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the reference's ``_flash`` custom VJP.

    It saves the residuals of ``_flash_fwd``: (q, k, v, segment_ids, O,
    lse), never the (S, S) scores.  On CUDA tensors the forward launches K1
    and the backward K2, K3 and K4; on CPU tensors the same residuals go
    through the plain versions.  The kernels are looked up by name at each
    call."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window):
        fwd = flash_fwd if q.is_cuda else flash_fwd_plain
        o, lse = fwd(q, k, v, segment_ids=segment_ids, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        kw = dict(segment_ids=segment_ids, causal=ctx.causal, window=ctx.window)
        if q.is_cuda:
            delta = flash_delta(o, do)
            dq = flash_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
        else:
            delta = flash_delta_plain(o, do)
            dq = flash_dq_plain(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None
