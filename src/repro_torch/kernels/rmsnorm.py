"""K7: fused RMSNorm (``csrc/rmsnorm.cu``), its wrapper and its plain
PyTorch version.

K7 replaces the Pallas kernel ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``
(launched by ``rmsnorm``): ``x · rsqrt(mean(x²) + eps) · scale`` over the
last axis, in f32 inside, the output in x's dtype; a 1-D x is one row.  It
is reached, as in the reference, only through ``kernels.ops.rmsnorm`` with
the ``fused_rmsnorm`` flag on: the models' own norms (``models.layers``)
compute inline.

Bound on the H100: the bytes, x read and y written once, against 3.35
TB/s.  Each row of x is read once: a warp holds a row of up to 4 KB in
registers (16-byte vectors, where ``d`` and the alignment allow), a block
stages a longer or unaligned row in shared memory; the scale is staged once
per persistent block; any row count, any ``d``.  See the source for the
design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _entry():
    f = build.load("rmsnorm").repro_rmsnorm
    if f.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P, P, P, I, I, ctypes.c_longlong, I, ctypes.c_float, I, P]
        f.restype = I
    return f


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Launch K7.  x: (..., d), f32, bf16 or f16, contiguous, on a CUDA
    device; scale: (d,) of one of those dtypes, contiguous, on the same
    device → y of x's shape and dtype."""
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: x (..., d) and scale (d,) expected; got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm: x and scale must be on the same CUDA device")
    if x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm: x and scale must be f32, bf16 or f16; got "
                         f"{x.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d >= 2 ** 31:
        raise ValueError(f"rmsnorm: unsupported shape {tuple(x.shape)}")
    y = torch.empty_like(x)
    vec = d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0
    rc = _entry()(x.data_ptr(), scale.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
                  _DTYPE_CODE[scale.dtype], rows, d, float(eps), int(vec),
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "rmsnorm")
    build.launch_counts["rmsnorm"] += 1
    return y


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """K7's plain version: the oracle's arithmetic (f32 inside, x's dtype
    out)."""
    return ref.rmsnorm_reference(x, scale, eps=eps)
