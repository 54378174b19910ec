"""K1: the flash-attention forward, ``csrc/flash_fwd.cu``, with its wrapper
and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:_fwd_kernel``
(launched by ``_forward``).  Online-softmax attention with the causal,
sliding-window and segment-id masks and GQA through ``h // g``; it emits
``O`` and ``lse = m + log(max(l, 1e-30))`` (B, Hq, Sq) f32, which the
training backward will need.

Bound on the H100: tensor-core operations, ``4·B·Hq·Sq·Sk·D`` (about halved
when causal).  The kernel bounds its tile loop the way ``_block_relevant``
does and runs both products on the tensor cores in bf16 (FMA in f32); see
the source for the design.  Unlike the reference's ``flash_supported``, any
sequence length launches the kernel: it masks the ragged tails itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = build.load("flash_fwd").repro_flash_fwd
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 7 + [LL] * 9
                       + [I, I, ctypes.c_float, P])
        fn.restype = I
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
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ok = ok[None]
    if segment_ids is not None:
        ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])
    ok = ok[:, None, None]                                  # (B|1, 1, 1, Sq, Sk)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * ok
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, Sq)
    return o.reshape(B, Sq, Hq, D).to(q.dtype), lse
