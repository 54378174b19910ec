"""K5: single-token decode attention, ``csrc/decode_attention.cu``, with its
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:_decode_kernel``
(launched by ``decode_attention``): one query token against a ring-buffer
cache, keys valid where ``kpos >= 0 & kpos <= t`` (& inside the window).

Bound on the H100: the bytes of K and V read, ``2·B·S·Hkv·D·bytes``.  One
block per (KV head, batch row) loads each K/V row once for all ``g`` query
heads of its group; see the source for the design.  Any cache length
launches the kernel (the reference fell back to its oracle unless S divided
128).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 96, 128)
MAX_GROUP = 8                      # query heads per KV head the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = build.load("decode_attention").repro_decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 8 + [ctypes.c_float, P]
        fn.restype = I
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, *, t: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Launch K5.  q: (B, 1, Hq, D); k/v: (B, S, Hkv, D), bf16 or f32,
    contiguous, on one CUDA device; kpos: (B, S) int32 (-1 = empty slot);
    t: the query's absolute position → (B, 1, Hq, D)."""
    B, one, Hq, D = q.shape
    if one != 1 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or tuple(kpos.shape) != (B, k.shape[1]):
        raise ValueError(f"decode_attention: q (B,1,Hq,D), k/v (B,S,Hkv,D), kpos (B,S) "
                         f"expected; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(kpos.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: Hq={Hq} must be a multiple of Hkv={Hkv}, "
                         f"at most {MAX_GROUP} times it")
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, kpos)):
        raise ValueError("decode_attention: every input must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: bf16 or f32 q/k/v of one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kpos.dtype != torch.int32:
        raise ValueError(f"decode_attention: kpos must be int32, got {kpos.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (q, k, v, kpos)):
        raise ValueError("decode_attention: q, k, v and kpos must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k/v must be 16-byte aligned (vector loads)")
    if B > 65535 or S == 0:
        raise ValueError(f"decode_attention: unsupported B={B}, S={S}")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    o = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, Hq, Hkv, D, int(t), window or 0, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention")
    build.launch_counts["decode_attention"] += 1
    return o


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kpos: torch.Tensor, *, t: int,
                           window: Optional[int] = None) -> torch.Tensor:
    """K5's plain version, with the kernel's semantics (O = 0 when no key is
    valid), in fp32 einsums."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D) * (D ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid &= kpos > t - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p / l, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)
