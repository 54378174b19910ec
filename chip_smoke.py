#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one Hopper card (sm_90):

1. prints the environment: torch and CUDA versions, the card's name and
   power limit as ``nvidia-smi`` reports them;
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
   prints the build's seconds and ptxas's register/spill report;
3. holds K1 (flash forward) against its plain version on the card, O and lse,
   over head groupings, head dims, ragged lengths, masks and dtypes;
   then K2, K3 and K4 (flash backward: delta, dQ, dK and dV) the same way,
   and the autograd ``FlashAttention`` against autograd through K1's plain
   version;
4. holds K5 (decode attention) against its plain version the same way;
   then K6 (paged decode attention) against its plain version over page
   sizes 16/64/128, head groupings, head dims, windows and dtypes (pages
   shuffled, a hole in one table, a position per row; and at B = 8, page
   16, with 1024-token histories), and against K5 on the same K/V laid out
   contiguously; shows that NaN in pages K6 must not read (the trash page,
   unmapped pages, pages before the window) changes nothing; and holds
   K5's per-row form (a (B,) tensor of positions) against its plain version;
5. serves granite-3-2b at its published width and depth (random bf16
   weights from seed 0) through ``InferenceSession.generate``: 4 prompts of
   500 tokens, 32 new tokens each.  Launch counts are zeroed just before and
   read just after: K1 must have launched once per layer (40) and K5 once per
   layer per decode step (40 x 31).  The prefill's last-position logits are
   compared, twice, with the same session on the plain versions on the card;
6. checks that, in f32 at full width (2 layers), the kernel path's greedy
   tokens equal the plain path's;
7. serves a chat stream with the same model through
   ``InferenceSession.serve``, on contiguous slots and on the paged pool:
   16 requests share a 256-token system prompt, suffixes of 16-112 tokens,
   replies cycling through 128/16/16/32 tokens, 8 slots, pages of 16.
   Launches are counted per arm: K5 once per layer per decode step (and K1
   per admission prefill) on slots, K6 once per layer per decode step on
   the pool.  It prints the serving statistics, peak memory, a profiled
   decode step of each arm and the share of requests whose tokens agree
   between the arms (bf16 near-ties may flip; reported, not required);
8. checks that, in f32 at full width (2 layers), a smaller stream gives the
   same tokens on the paged arm, on the contiguous arm and through uniform
   ``generate``, with the kernels and with their plain versions;
9. trains granite-3-2b at its published width and depth through
   ``TrainSession.step`` (bf16 compute, fp32 masters, AdamW; seed 0): batch
   8 of 1024 tokens in 2 micro-batches, remat "full", 4 steps.  Every step's
   launches are counted: K1 twice per layer per micro-batch (forward and
   remat), K2, K3 and K4 once.  Losses must be finite and no step skipped;
   the last step is profiled; one batch is evaluated, and its per-token
   losses with the kernels and with the plain versions are held to 2x
   bf16's own error, as the logits are in 5;
10. checks that, in f32 at full width (2 layers), 3 training steps with the
   kernels and with the plain versions give the same losses (1e-5 relative)
   and params (1e-4);
11. holds each kernel against its plain version at its slice's shapes (K1's
   O and lse, K2-K4 at the training attention, K5's O, K6 at the stream's
   decode; f32 and bf16), then times it there beside its plain version, one
   PyTorch library call (``scaled_dot_product_attention``, its backward for
   K3 and K4; none for K2 and K6; timed only here) and its bound;
12. prints a ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  It also exits non-zero
when CUDA is not available, or when it does not stand in a checkout of the
repository.  Tolerances: 2e-2 in bf16, 1e-4 in f32 (absolute plus relative,
as ``numpy.testing.assert_allclose``), TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# bf16 logits of the 40-layer prefill, kernels vs plain versions: both round
# every layer's activations to bf16 (8 bits) and the kernel also rounds P
# before P V, so through 40 random layers they drift apart by about as much
# as bf16 drifts from f32.  The limit: max|kernel - plain| at most this many
# times max|plain - plain on an f32 copy of the same weights|.
LOGIT_FLOOR_FACTOR = 2.0
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16, H100 SXM data sheet

SLICE = dict(arch="granite_3_2b", batch=4, prompt_len=500, new_tokens=32)
# the chat stream served through both arms of the scheduler: 16 requests
# share a 256-token system prompt, suffixes of 16-112 tokens, replies
# cycling through STREAM_GENS, 8 slots, KV pages of 16 tokens
STREAM = dict(arch="granite_3_2b", requests=16, system=256, suffix=(16, 112), slots=8,
              page_size=16)
STREAM_GENS = (128, 16, 16, 32)
TRAIN = dict(arch="granite_3_2b", seq_len=1024, global_batch=8, gas=2, steps=4)


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def close(got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol·|want| everywhere)."""
    d = (got.detach().float() - want.detach().float()).abs()
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return float(d.max()), ok


KERNEL_NAMES = (("flash_fwd", "fa"), ("flash_delta", "fa"), ("flash_dq", "fa"),
                ("flash_dkv", "fa"), ("decode_attention", "da"),
                ("paged_decode_attention", "da"))


@contextlib.contextmanager
def plain_versions(fa, da):
    """Inside this block the dispatch (``kernels.ops`` and ``FlashAttention``)
    sends CUDA tensors to the kernels' plain versions too: the comparison path
    on the card."""
    mods = {"fa": fa, "da": da}
    saved = [(mods[m], n, getattr(mods[m], n)) for n, m in KERNEL_NAMES]
    for mod, name, _ in saved:
        setattr(mod, name, getattr(mod, f"{name}_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; inputs stay in the 50 MB L2 at these shapes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ms(x) -> str:
    return "none" if x is None else f"{x:.4f} ms"


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_window(torch, fn, top: int = 8):
    """Run ``fn`` under ``torch.profiler``: host wall time (inflated by the
    profiler), summed device time of the kernels, and the kernels that take
    most of it as (ms, launches, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(((dev_ms(e), e.count, e.key[:90]) for e in kern), reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": sum(r[0] for r in rows), "top": rows[:top]}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernels in {secs:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name, p in paths.items():
        log_path = Path(f"{p}.log")
        if not log_path.exists():
            continue
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _segments(torch, B, S):
    """Two documents, then a -1 pad tail (batched admission)."""
    seg = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
    seg[:, : 2 * S // 5] = 0
    seg[:, 2 * S // 5: 4 * S // 5] = 1
    return seg


def phase_flash_sweep(torch, fa):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {dt: [0.0, 0.0] for dt in TOL}
    failures, n = [], 0
    for Hq, Hkv in ((4, 4), (8, 2), (32, 8)):
        for D in (16, 64, 96, 128):
            for S in (128, 200):
                for mask in ("causal", "window64", "none", "segments"):
                    for dtype in (torch.bfloat16, torch.float32):
                        B = 2
                        shp_q, shp_kv = (B, S, Hq, D), (B, S, Hkv, D)
                        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                                   for s in (shp_q, shp_kv, shp_kv))
                        kw = dict(causal=mask != "none",
                                  window=64 if mask == "window64" else None)
                        if mask == "segments":
                            kw["segment_ids"] = _segments(torch, B, S)
                        o, lse = fa.flash_fwd(q, k, v, **kw)
                        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
                        torch.cuda.synchronize()
                        name = str(dtype).split(".")[-1]
                        tol = TOL[name]
                        eo, ok_o = close(o, o_ref, tol)
                        el, ok_l = close(lse, lse_ref, tol)
                        worst[name][0] = max(worst[name][0], eo)
                        worst[name][1] = max(worst[name][1], el)
                        n += 1
                        if not (ok_o and ok_l):
                            failures.append(f"Hq={Hq} Hkv={Hkv} D={D} S={S} {mask} {name}: "
                                            f"O err {eo:.3g}, lse err {el:.3g}")
    for name, (eo, el) in worst.items():
        log(f"[K1 sweep] {name}: max |O - plain| {eo:.3g}, max |lse - plain| {el:.3g} "
            f"(tol {TOL[name]})")
    require(not failures, f"K1 disagrees with its plain version in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K1 sweep] {n} cases agree")


def phase_flash_bwd_sweep(torch, fa):
    """K2, K3 and K4 against their plain versions on the same residuals
    (O and lse from K1's plain version, so both sides see equal inputs), then
    the whole ``FlashAttention`` against autograd through ``flash_fwd_plain``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {dt: [0.0] * 4 for dt in TOL}
    failures, n = [], 0
    for Hq, Hkv in ((4, 4), (8, 2)):                 # g = 1 and 4
        for D in (16, 64, 96, 128):
            for S in (200, 1024):                    # 200 is ragged to every tile
                for mask in ("causal", "window", "none", "segments"):
                    for dtype in (torch.bfloat16, torch.float32):
                        B = 2
                        q, do = (torch.randn((B, S, Hq, D), generator=gen,
                                             device="cuda").to(dtype) for _ in range(2))
                        k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                                            device="cuda").to(dtype) for _ in range(2))
                        kw = dict(causal=mask != "none",
                                  window=64 if mask == "window" else None,
                                  segment_ids=_segments(torch, B, S) if mask == "segments"
                                  else None)
                        o, lse = fa.flash_fwd_plain(q, k, v, **kw)
                        delta = fa.flash_delta(o, do)
                        delta_ref = fa.flash_delta_plain(o, do)
                        got = (delta, fa.flash_dq(q, k, v, do, lse, delta_ref, **kw),
                               *fa.flash_dkv(q, k, v, do, lse, delta_ref, **kw))
                        want = (delta_ref, fa.flash_dq_plain(q, k, v, do, lse, delta_ref, **kw),
                                *fa.flash_dkv_plain(q, k, v, do, lse, delta_ref, **kw))
                        torch.cuda.synchronize()
                        name = str(dtype).split(".")[-1]
                        errs = []
                        for i, (a, b) in enumerate(zip(got, want)):
                            err, ok = close(a, b, TOL[name])
                            worst[name][i] = max(worst[name][i], err)
                            errs.append((err, ok))
                        n += 1
                        if not all(ok for _, ok in errs):
                            failures.append(
                                f"Hq={Hq} Hkv={Hkv} D={D} S={S} {mask} {name}: errors "
                                f"delta/dQ/dK/dV " + " ".join(f"{e:.3g}" for e, _ in errs))
    for name, w in worst.items():
        log(f"[K2-K4 sweep] {name}: max |kernel - plain| delta {w[0]:.3g}, dQ {w[1]:.3g}, "
            f"dK {w[2]:.3g}, dV {w[3]:.3g} (tol {TOL[name]})")
    require(not failures, f"K2-K4 disagree with their plain versions in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K2-K4 sweep] {n} cases agree")

    # the autograd Function (K1 forward, K2 -> K3 -> K4 backward) against
    # autograd through K1's plain version, f32, at the training slice's shape
    B, S, Hq, Hkv, D = 2, 1024, 32, 8, 64
    for mask in ("causal", "segments"):
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").requires_grad_()
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda").requires_grad_()
                for _ in range(2))
        cot = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
        seg = _segments(torch, B, S) if mask == "segments" else None
        out = fa.FlashAttention.apply(q, k, v, seg, True, None)
        got = torch.autograd.grad(out, (q, k, v), cot)
        out_ref, _ = fa.flash_fwd_plain(q, k, v, segment_ids=seg, causal=True)
        want = torch.autograd.grad(out_ref, (q, k, v), cot)
        for name, a, b in zip(("dQ", "dK", "dV"), got, want):
            err, ok = close(a, b, TOL["float32"])
            log(f"[Function] {mask}, f32, (B, S, Hq, Hkv, D) = {(B, S, Hq, Hkv, D)}: "
                f"{name} max |Function - autograd of plain| {err:.3g} (tol {TOL['float32']})")
            require(ok, f"FlashAttention's {name} disagrees with autograd ({mask})")


def _ring(torch, B, S, fill=None, t_wrap=None):
    """kpos (B, S) and t: slots 0..fill hold positions 0..fill (rest empty),
    or a ring wrapped past ``t_wrap`` holding its last S positions."""
    slots = torch.arange(S, device="cuda", dtype=torch.int32)
    if t_wrap is None:
        kpos = torch.where(slots <= fill, slots, torch.full_like(slots, -1))
        t = fill
    else:
        base = (t_wrap // S) * S
        kpos = base + slots
        kpos = torch.where(kpos > t_wrap, kpos - S, kpos)
        t = t_wrap
    return kpos[None].expand(B, S).contiguous(), t


def phase_decode_sweep(torch, da):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = {dt: 0.0 for dt in TOL}
    failures, n = [], 0
    B, Hkv = 2, 2
    # 544 is ragged to 128 only; 532 (the slice's cache) also ends in a
    # partial 32-key chunk, the kernel's masked tail
    for S in (532, 544):
        cases = [dict(fill=f) for f in (0, 300, S - 1)] + [dict(t_wrap=2000)]
        for g in (1, 4):
            for D in (16, 64, 96, 128):
                for case in cases:
                    for window in (None, 128):
                        for dtype in (torch.bfloat16, torch.float32):
                            q = torch.randn((B, 1, g * Hkv, D), generator=gen,
                                            device="cuda").to(dtype)
                            k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                                                device="cuda").to(dtype) for _ in range(2))
                            kpos, t = _ring(torch, B, S, **case)
                            o = da.decode_attention(q, k, v, kpos, t=t, window=window)
                            o_ref = da.decode_attention_plain(q, k, v, kpos, t=t, window=window)
                            torch.cuda.synchronize()
                            name = str(dtype).split(".")[-1]
                            err, ok = close(o, o_ref, TOL[name])
                            worst[name] = max(worst[name], err)
                            n += 1
                            if not ok:
                                failures.append(f"S={S} g={g} D={D} {case} window={window} "
                                                f"{name}: err {err:.3g}")
    for name, err in worst.items():
        log(f"[K5 sweep] {name}: max |O - plain| {err:.3g} (tol {TOL[name]})")
    require(not failures, f"K5 disagrees with its plain version in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K5 sweep] {n} cases agree")


def _paged_case(torch, gen, *, B, ps, n_max, Hkv, g, D, dtype, ts, holes=()):
    """A pool of shuffled physical pages on the card: row b maps the pages
    its position ts[b] needs (``holes``: (row, logical page) left unmapped),
    the rest of its table is -1.  Also the same K/V laid out contiguously
    for K5: (k, v, kpos) with kpos the logical position, -1 where unmapped."""
    n_pages = 1 + B * n_max
    q = torch.randn((B, 1, Hkv * g, D), generator=gen, device="cuda").to(dtype)
    kp, vp = (torch.randn((n_pages, ps, Hkv, D), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    phys = 1 + torch.randperm(n_pages - 1, generator=gen, device="cuda")
    pt = torch.full((B, n_max), -1, dtype=torch.int32, device="cuda")
    for b, t in enumerate(ts):
        n = t // ps + 1
        pt[b, :n] = phys[b * n_max:b * n_max + n].to(torch.int32)
    for b, i in holes:
        pt[b, i] = -1
    tst = torch.tensor(ts, dtype=torch.int32, device="cuda")
    pages = pt.clamp_min(0).long()
    kc = kp[pages].reshape(B, n_max * ps, Hkv, D).contiguous()
    vc = vp[pages].reshape(B, n_max * ps, Hkv, D).contiguous()
    logical = torch.arange(n_max * ps, dtype=torch.int32, device="cuda")[None]
    kpos = torch.where((pt >= 0).repeat_interleave(ps, dim=1), logical,
                       torch.full_like(logical, -1)).contiguous()
    return q, kp, vp, pt, tst, kc, vc, kpos


def phase_paged_sweep(torch, da):
    """K6 against its plain version over page sizes, head groupings, head
    dims, windows and dtypes (rows mid-page, on a page boundary, at the
    table's end, one with an unmapped hole; physical pages shuffled), and at
    B = 8, page 16, with 1024-token histories.  Then: K6 never reads the
    trash page (NaN there changes nothing); K6 against K5 on the same K/V
    laid out contiguously; K5's per-row form against its plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    worst = {dt: 0.0 for dt in TOL}
    failures, n = [], 0

    def check(label, got, want, dtype):
        nonlocal n
        name = str(dtype).split(".")[-1]
        err, ok = close(got, want, TOL[name])
        worst[name] = max(worst[name], err)
        n += 1
        if not ok:
            failures.append(f"{label} {name}: err {err:.3g}")

    cases = []
    for ps, n_max in ((16, 6), (64, 3), (128, 3)):
        for g in (1, 4):
            for D in (16, 64, 96, 128):
                for window in (None, 8):
                    cases.append(dict(B=4, ps=ps, n_max=n_max, Hkv=2, g=g, D=D, window=window,
                                      ts=[5, 2 * ps, n_max * ps - 1, n_max * ps - 1],
                                      holes=[(3, 1)]))
    # the stream's decode shape with 1024-token histories (one row shorter)
    for window in (None, 256):
        cases.append(dict(B=8, ps=16, n_max=64, Hkv=8, g=4, D=64, window=window,
                          ts=[1023] * 7 + [700], holes=[]))
    same_as_k5, k5_f32 = True, 0.0
    for c in cases:
        window = c.pop("window")
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, pt, ts, kc, vc, kpos = _paged_case(torch, gen, dtype=dtype, **c)
            o = da.paged_decode_attention(q, kp, vp, pt, ts=ts, window=window)
            o_ref = da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts, window=window)
            label = (f"K6 B={c['B']} ps={c['ps']} n_max={c['n_max']} g={c['g']} D={c['D']} "
                     f"window={window}")
            check(label, o, o_ref, dtype)
            # K5 over the same K/V laid out contiguously, positions per row
            o5 = da.decode_attention(q, kc, vc, kpos, t=ts, window=window)
            check(label + " vs K5", o, o5, dtype)
            same_as_k5 &= bool(torch.equal(o, o5))
            if dtype == torch.float32:
                k5_f32 = max(k5_f32, float((o - o5).abs().max()))
            # never read: the trash page, pages no table maps (the holes'),
            # and pages wholly before a row's window
            unread = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
            ptc = pt.cpu()
            for b in range(c["B"]):
                t = int(c["ts"][b])
                for i in range(c["n_max"]):
                    page = int(ptc[b, i])
                    if page >= 0 and not (window and (i + 1) * c["ps"] - 1 <= t - window):
                        unread[page] = False
            kp[unread], vp[unread] = float("nan"), float("nan")
            o_nan = da.paged_decode_attention(q, kp, vp, pt, ts=ts, window=window)
            torch.cuda.synchronize()
            if not torch.equal(o_nan, o):
                failures.append(f"{label}: NaN in pages it must not read changed the output")
        c["window"] = window
    for name, err in worst.items():
        log(f"[K6 sweep] {name}: max |O - plain| and |K6 - K5| {err:.3g} (tol {TOL[name]})")
    log(f"[K6 sweep] K6 equals K5 on the same K/V laid out contiguously bit for bit in "
        f"every case: {same_as_k5} (f32 max |K6 - K5| {k5_f32:.3g}, tol 1e-5); NaN in the "
        f"trash page, the unmapped pages and the pages before the window changed no output")
    require(k5_f32 <= 1e-5, f"K6 differs from K5 by {k5_f32:.3g} in f32")
    require(not failures, f"K6 disagrees in {len(failures)} of {n} comparisons:\n  "
            + "\n  ".join(failures[:20]))
    log(f"[K6 sweep] {n} comparisons agree")

    # K5's per-row form: ring caches holding each row's own history
    worst5, n5, fail5 = {dt: 0.0 for dt in TOL}, 0, []
    B, S, Hkv = 8, 532, 8
    for g in (1, 4):
        for D in (16, 64, 96, 128):
            for window in (None, 128):
                for dtype in (torch.bfloat16, torch.float32):
                    ts = torch.tensor([0, 7, 100, 531, 532, 900, 2000, 311], dtype=torch.int32,
                                      device="cuda")
                    slots = torch.arange(S, dtype=torch.int32, device="cuda")[None]
                    base = (ts[:, None] // S) * S
                    kpos = base + slots
                    kpos = torch.where(kpos > ts[:, None], kpos - S, kpos)
                    kpos = torch.where(kpos >= 0, kpos, torch.full_like(kpos, -1)).contiguous()
                    q = torch.randn((B, 1, Hkv * g, D), generator=gen, device="cuda").to(dtype)
                    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    o = da.decode_attention(q, k, v, kpos, t=ts, window=window)
                    o_ref = da.decode_attention_plain(q, k, v, kpos, t=ts, window=window)
                    torch.cuda.synchronize()
                    name = str(dtype).split(".")[-1]
                    err, ok = close(o, o_ref, TOL[name])
                    worst5[name] = max(worst5[name], err)
                    n5 += 1
                    if not ok:
                        fail5.append(f"g={g} D={D} window={window} {name}: err {err:.3g}")
    for name, err in worst5.items():
        log(f"[K5 per-row] {name}: max |O - plain| {err:.3g} (tol {TOL[name]})")
    require(not fail5, f"K5's per-row form disagrees with its plain version in {len(fail5)} "
            f"of {n5} cases:\n  " + "\n  ".join(fail5))
    log(f"[K5 per-row] {n5} cases agree")


def phase_slice(torch, np, build, fa, da, InferenceSession, tree_map):
    B, P, N = SLICE["batch"], SLICE["prompt_len"], SLICE["new_tokens"]
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(SLICE["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    log(f"[slice] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_params() / 1e9:.3f} B params, {cfg.dtype}; "
        f"init {time.perf_counter() - t0:.1f} s")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(B, P)).astype(np.int32)

    # the main path, counted
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    toks = sess.generate(prompts, N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] generate: {tuple(toks.shape)} tokens in {gen_s:.2f} s (first call); "
        f"launches {counts}; peak memory {peak / 2**30:.2f} GiB")
    L = cfg.n_layers
    require(counts.get("flash_fwd", 0) == L,
            f"K1 launched {counts.get('flash_fwd', 0)} times, expected {L}")
    require(counts.get("decode_attention", 0) == L * (N - 1),
            f"K5 launched {counts.get('decode_attention', 0)} times, expected {L * (N - 1)}")
    require(tuple(toks.shape) == (B, P + N) and toks.dtype == torch.int32,
            f"generate returned {tuple(toks.shape)} {toks.dtype}")
    out = toks.cpu().numpy()
    require(bool((out[:, :P] == prompts).all()), "generate altered the prompts")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")

    # prefill logits: kernels vs plain versions, on the card; the plain path
    # on an f32 copy of the same weights gives bf16's own error at this depth.
    # Each path runs twice, to show whether a reading repeats within a call.
    pt = torch.from_numpy(prompts).cuda()

    def prefill_logits(s):
        return s.prefill_cache_step(s.params, {"tokens": pt}, s.init_cache(B, P + N))[0]

    with torch.inference_mode():
        logits_k = [prefill_logits(sess) for _ in range(2)]
        with plain_versions(fa, da):
            logits_p = [prefill_logits(sess) for _ in range(2)]
            sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                      tree_map(lambda x: x.float(), sess.params),
                                      device=sess.device)
            logits_f = prefill_logits(sess32)
            del sess32
    log(f"[slice] prefill logits repeat bitwise within this call: kernel path "
        f"{torch.equal(logits_k[0], logits_k[1])}, plain path "
        f"{torch.equal(logits_p[0], logits_p[1])}")
    floor = float((logits_p[0] - logits_f).abs().max())
    for i, (lk, lp) in enumerate(zip(logits_k, logits_p)):
        require(bool(torch.isfinite(lk).all()), "non-finite prefill logits")
        diff = float((lk - lp).abs().max())
        diff_f = float((lk - logits_f).abs().max())
        rel = diff / float(lp.abs().max())
        top1 = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        log(f"[slice] prefill logits (B, V) = {tuple(lk.shape)}, reading {i + 1}: max "
            f"|kernel - plain| {diff:.4g} ({rel:.4g} of max |logit|), top-1 agreement "
            f"{top1:.2f}; bf16 noise floor max |plain - plain f32| {floor:.4g}; max "
            f"|kernel - plain f32| {diff_f:.4g} (tol: kernel - plain <= "
            f"{LOGIT_FLOOR_FACTOR} x floor)")
        require(diff <= LOGIT_FLOOR_FACTOR * floor,
                f"prefill logits differ from the plain path by {diff:.4g}, more than "
                f"{LOGIT_FLOOR_FACTOR} x bf16's own error {floor:.4g}")
    require(bool((toks[:, P] == logits_k[0].argmax(-1).to(torch.int32)).all()),
            "generate's first token is not the argmax of the kernel path's prefill")

    # steady-state throughput: prefill, then N-1 decode steps, host clock
    with torch.inference_mode():
        caches = sess.init_cache(B, P + N)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = sess.prefill_cache_step(sess.params, {"tokens": pt}, caches)
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in range(P, P + N - 1):
            tok, caches = sess.serve_step(sess.params, tok, t, caches)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        # where the device time goes: one profiled prefill and N-1 decode steps
        prof_pre = profile_window(torch, lambda: sess.prefill_cache_step(
            sess.params, {"tokens": pt}, sess.init_cache(B, P + N)))
        tok0 = logits.argmax(-1).to(torch.int32)

        def decode():
            tok = tok0
            for t in range(P, P + N - 1):
                tok, _ = sess.serve_step(sess.params, tok, t, caches)

        prof_dec = profile_window(torch, decode)
    log(f"[slice] prefill {B * P / pre_s:.1f} tok/s ({pre_s * 1e3:.1f} ms for "
        f"{B}x{P}); decode {B * (N - 1) / dec_s:.1f} tok/s "
        f"({dec_s / (N - 1) * 1e3:.2f} ms/step at batch {B}); "
        f"max_memory_allocated {peak} B")
    for name, prof, wall in (("prefill", prof_pre, pre_s), ("decode", prof_dec, dec_s)):
        if prof["device_ms"] == 0:
            log(f"[profile] {name}: device time not measured (no device events)")
            continue
        log(f"[profile] {name}: device busy {prof['device_ms']:.2f} ms of {wall * 1e3:.2f} ms "
            f"unprofiled wall ({prof['device_ms'] / (wall * 1e3):.1%}); profiled wall "
            f"{prof['wall_ms']:.2f} ms")
        for ms, count, key in prof["top"]:
            log(f"[profile] {name}:   {ms:8.3f} ms  {count:5d}x  {key}")
    del sess, caches, logits, logits_k, logits_p, logits_f
    torch.cuda.empty_cache()
    return counts


def phase_f32_identity(torch, np, fa, da, get_config, InferenceSession):
    cfg = dataclasses.replace(get_config(SLICE["arch"]), n_layers=2, dtype="float32")
    sess = InferenceSession.from_recipe(cfg, seed=1)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 200)).astype(np.int32)
    toks_k = sess.generate(prompts, 16)
    with plain_versions(fa, da):
        toks_p = sess.generate(prompts, 16)
    same = bool(torch.equal(toks_k, toks_p))
    log(f"[f32] {cfg.name} at full width, 2 layers, f32: greedy tokens kernel == plain: "
        f"{same}")
    require(same, f"f32 greedy tokens differ:\n{toks_k[:, 200:]}\n{toks_p[:, 200:]}")
    del sess
    torch.cuda.empty_cache()


def chat_stream(np, vocab, *, requests, system, suffix, seed=0, gens=STREAM_GENS):
    """Prompts sharing one system prompt, with suffixes spread evenly over
    ``suffix`` (inclusive), and replies cycling through ``gens``."""
    rs = np.random.RandomState(seed)
    sysp = rs.randint(1, vocab, size=system).astype(np.int32)
    lo, hi = suffix
    lens = [lo + (hi - lo) * i // max(requests - 1, 1) for i in range(requests)]
    lens = [lens[(7 * i) % requests] for i in range(requests)]      # mixed order
    prompts = [np.concatenate([sysp, rs.randint(1, vocab, size=n).astype(np.int32)])
               for n in lens]
    return prompts, [gens[i % len(gens)] for i in range(requests)]


def _agreement(np, prompts, outs_a, outs_b):
    """(requests whose tokens agree, requests whose first generated token
    agrees, generated tokens that agree before the first difference, per
    request) between two runs of one stream."""
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(outs_a, outs_b))
    first = sum(int(a[len(p)]) == int(b[len(p)]) for p, a, b in zip(prompts, outs_a, outs_b))
    run = [int(np.argmax(np.append(a[len(p):] != b[len(p):], True)))
           for p, a, b in zip(prompts, outs_a, outs_b)]
    return same, first, run


def phase_stream(torch, np, build, InferenceSession, tree_map, smi):
    """granite-3-2b at its published width and depth (random bf16 weights
    from seed 0) serves the chat stream through ``InferenceSession.serve``,
    on contiguous slots and on the paged pool.  Launches are zeroed before
    and read after each arm: contiguous K1 once per layer per admission
    prefill group and K5 once per layer per decode step; paged K6 once per
    layer per decode step and no K1 or K5 (the paged suffix prefill is the
    masked einsum).  The arms' tokens are compared, in bf16 and on an f32
    copy of the model (reported, not required: near-ties may flip).  Then
    one decode step of each arm is profiled."""
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(STREAM["arch"], seed=0)
    torch.cuda.synchronize()
    cfg, L = sess.cfg, sess.cfg.n_layers
    prompts, gens = chat_stream(np, cfg.vocab_size, requests=STREAM["requests"],
                                system=STREAM["system"], suffix=STREAM["suffix"])
    n_slots, ps = STREAM["slots"], STREAM["page_size"]
    log(f"[stream] {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.dtype}; {len(prompts)} requests, system "
        f"prompt {STREAM['system']}, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, replies {sorted(set(gens))}, {sum(gens)} tokens, "
        f"{n_slots} slots, page {ps}; init {time.perf_counter() - t0:.1f} s")
    arms, launches = {}, {}
    for arm in ("contiguous", "paged"):
        kw = dict(paged=True, page_size=ps) if arm == "paged" else {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        t0 = time.perf_counter()
        outs, st = sess.serve(prompts, gens, n_slots=n_slots, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        arms[arm], launches[arm] = (outs, st, wall, peak), counts
        log(f"[stream] {arm}: {st.requests} requests, {st.generated_tokens} tokens, "
            f"{st.decode_steps} decode steps in {wall:.2f} s ({st.generated_tokens / wall:.1f} "
            f"tok/s, host clock, admission prefills included); occupancy {st.occupancy:.4f}, "
            f"stranded_fraction {st.stranded_fraction:.4f}, prompt tokens {st.prompt_tokens}, "
            f"prefilled {st.prefill_tokens}" + (
                f", prefix_hits {st.prefix_hits}, prefix_hit_rate {st.prefix_hit_rate:.4f}, "
                f"pool_occupancy {st.pool_occupancy:.4f} of {st.pool_pages} pages"
                if arm == "paged" else "")
            + f"; launches {counts}; max_memory_allocated {peak} B; {smi}")
        require(st.requests == len(prompts) and st.generated_tokens == sum(gens),
                f"{arm}: served {st.requests} requests, {st.generated_tokens} tokens")
        for p, m, o in zip(prompts, gens, outs):
            require(len(o) == len(p) + m and bool((o[:len(p)] == p).all()),
                    f"{arm}: a request came back with {len(o)} tokens or altered")
            require(bool(((o >= 0) & (o < cfg.vocab_size)).all()), f"{arm}: ids out of range")
        steps = st.decode_steps
        if arm == "contiguous":
            require(counts.get("decode_attention", 0) == L * steps,
                    f"K5 launched {counts.get('decode_attention', 0)} times, expected "
                    f"{L} x {steps}")
            require(counts.get("flash_fwd", 0) > 0 and counts["flash_fwd"] % L == 0,
                    f"K1 launched {counts.get('flash_fwd', 0)} times, not a positive "
                    f"multiple of {L}")
            require(counts.get("paged_decode_attention", 0) == 0, "K6 ran on slots")
        else:
            require(counts.get("paged_decode_attention", 0) == L * steps,
                    f"K6 launched {counts.get('paged_decode_attention', 0)} times, expected "
                    f"{L} x {steps}")
            require(counts.get("decode_attention", 0) == 0 and counts.get("flash_fwd", 0) == 0,
                    f"the paged arm launched K1 or K5: {counts}")
            require(st.prefix_hits > 0 and st.stranded_fraction < arms["contiguous"][1]
                    .stranded_fraction, "the paged arm shared no prefix or stranded more")
    same, first, run = _agreement(np, prompts, arms["contiguous"][0], arms["paged"][0])
    log(f"[stream] requests whose tokens agree between the arms: {same} of {len(prompts)} "
        f"({same / len(prompts):.4f}); whose first token (the admission prefill's argmax) "
        f"agrees: {first} of {len(prompts)}; tokens agreeing before the first difference, "
        f"per request (of {gens}): {run}; bf16 near-ties may flip: the arms prefill through "
        f"different attention code (K1; the masked einsum) in different batches, so their "
        f"bf16 caches differ by rounding")
    # the same stream on an f32 copy of the model: rounding 2^16 times finer
    sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                              tree_map(lambda x: x.float(), sess.params), device=sess.device)
    outs32 = {arm: sess32.serve(prompts, gens, n_slots=n_slots,
                                **(dict(paged=True, page_size=ps) if arm == "paged" else {}))[0]
              for arm in ("contiguous", "paged")}
    del sess32
    torch.cuda.empty_cache()
    same, first, run = _agreement(np, prompts, outs32["contiguous"], outs32["paged"])
    log(f"[stream] f32 copy, full depth: requests whose tokens agree between the arms: "
        f"{same} of {len(prompts)}; first token {first} of {len(prompts)}; tokens agreeing "
        f"before the first difference: {run}")

    # one decode step of each arm, profiled, at the stream's mid-depth: every
    # slot holds a request 320 + 16 b tokens deep
    with torch.inference_mode():
        B = n_slots
        ts = torch.tensor([320 + 16 * b for b in range(B)], dtype=torch.int32, device="cuda")
        toks = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
        max_len = max(len(p) + m for p, m in zip(prompts, gens))
        caches = sess.init_cache(B, max_len)
        for c in caches["blocks"]:
            c["pos"].copy_(torch.where(torch.arange(max_len, device="cuda")[None] < ts[:, None],
                                       torch.arange(max_len, device="cuda")[None], -1))
        n_max = -(-max_len // ps)
        pool = sess.init_paged_pool(1 + B * n_max, ps)
        tables = (1 + torch.arange(B * n_max, dtype=torch.int32, device="cuda")).reshape(B, n_max)
        tables = torch.where(torch.arange(n_max, device="cuda")[None] <= (ts[:, None] // ps),
                             tables, -1).to(torch.int32).contiguous()
        step = {"contiguous": lambda: sess.slot_step(sess.params, toks, ts, caches),
                "paged": lambda: sess.paged_slot_step(sess.params, toks, ts, pool, tables)}
        profiles = {}
        for arm, fn in step.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()[0].cpu()                 # the scheduler reads each step's tokens
            wall_ms = (time.perf_counter() - t0) / 5 * 1e3
            prof = profile_window(torch, lambda: fn()[0].cpu(), top=6)
            profiles[arm] = (wall_ms, prof)
            if prof["device_ms"] == 0:
                log(f"[profile] {arm} decode step: {wall_ms:.2f} ms host clock; device time "
                    "not measured (no device events)")
                continue
            log(f"[profile] {arm} decode step (B = {B}, ts 320-{320 + 16 * (B - 1)}): device "
                f"busy {prof['device_ms']:.3f} ms of {wall_ms:.3f} ms unprofiled wall "
                f"({prof['device_ms'] / wall_ms:.1%}); profiled wall {prof['wall_ms']:.2f} ms")
            for ms, count, key in prof["top"]:
                log(f"[profile] {arm} decode step:   {ms:8.3f} ms  {count:5d}x  {key}")
    del sess, caches, pool
    torch.cuda.empty_cache()
    return launches


def phase_stream_f32_identity(torch, np, fa, da, get_config, InferenceSession):
    """granite-3-2b at full width, 2 layers, f32: a smaller chat stream on
    the paged arm, on the contiguous arm and each request through uniform
    ``generate`` alone give identical tokens, with the kernels and with
    their plain versions."""
    cfg = dataclasses.replace(get_config(STREAM["arch"]), n_layers=2, dtype="float32")
    sess = InferenceSession.from_recipe(cfg, seed=1)
    prompts, gens = chat_stream(np, cfg.vocab_size, requests=6, system=64, suffix=(5, 40),
                                seed=1, gens=(24, 8, 12))
    runs = {}
    for plain in (False, True):
        ctx = plain_versions(fa, da) if plain else contextlib.nullcontext()
        with ctx:
            tag = "plain" if plain else "kernel"
            runs[f"paged {tag}"], _ = sess.serve(prompts, gens, n_slots=4, paged=True)
            runs[f"contiguous {tag}"], _ = sess.serve(prompts, gens, n_slots=4)
            runs[f"generate {tag}"] = [sess.generate(p[None], m)[0].cpu().numpy()
                                       for p, m in zip(prompts, gens)]
    want = runs["generate kernel"]
    agree = {k: all(np.array_equal(a, b) for a, b in zip(v, want)) for k, v in runs.items()}
    log(f"[f32 stream] {cfg.name} at full width, 2 layers, f32, {len(prompts)} requests: tokens "
        f"equal uniform generate with the kernels: {agree}")
    require(all(agree.values()), f"f32 stream tokens differ: {agree}")
    del sess
    torch.cuda.empty_cache()


def phase_train(torch, build, fa, da, TrainSession, stepfn, ParallelismConfig, DataConfig,
                smi):
    """Full-width, full-depth granite-3-2b trains for TRAIN["steps"] steps:
    bf16 compute, fp32 masters and AdamW, random weights from seed 0.  Every
    step's launches are counted; the last step is profiled; then one batch
    is evaluated (``evaluate()``), and its per-token losses are taken with
    the kernels, with their plain versions, and with the plain versions on
    an f32 copy of the model (bf16's own error)."""
    t0 = time.perf_counter()
    sess = TrainSession.from_recipe(
        TRAIN["arch"], seed=0,
        plan=ParallelismConfig(gas=TRAIN["gas"], remat_policy="full"),
        train_cfg=stepfn.TrainConfig(total_steps=TRAIN["steps"], warmup=2),
        data_cfg=DataConfig(seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"]))
    torch.cuda.synchronize()
    cfg, L, G = sess.cfg, sess.cfg.n_layers, TRAIN["gas"]
    log(f"[train] {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{sess.n_params / 1e9:.3f} B params ({cfg.dtype} compute, f32 masters); gas {G}, "
        f"remat full, batch {TRAIN['global_batch']} x {TRAIN['seq_len']}; init "
        f"{time.perf_counter() - t0:.1f} s")
    want = {"flash_fwd": 2 * L * G, "flash_delta": L * G, "flash_dq": L * G,
            "flash_dkv": L * G}
    torch.cuda.reset_peak_memory_stats()
    losses, walls, launches, metrics = [], [], None, {}
    for i in range(TRAIN["steps"]):
        last = i == TRAIN["steps"] - 1
        sess.batches(i)                        # host data, outside the timed window
        torch.cuda.synchronize()
        build.launch_counts.clear()
        t0 = time.perf_counter()
        if last:
            prof = profile_window(torch, lambda: metrics.update(sess.step()), top=12)
        else:
            metrics.update(sess.step())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = dict(build.launch_counts)
        launches = counts if launches is None else launches
        loss, skipped = float(metrics["loss"]), float(metrics["skipped"])
        losses.append(loss)
        log(f"[train] step {i}: loss {loss:.6f}, grad_norm {float(metrics['grad_norm']):.4f}, "
            f"lr {float(metrics['lr']):.3g}, skipped {skipped:.0f}, {walls[-1] * 1e3:.1f} ms"
            f"{' (profiled)' if last else ''}; launches {counts}")
        require(all(counts.get(k, 0) == n for k, n in want.items()),
                f"step {i}: launches {counts}, expected {want} per step")
        require(math.isfinite(loss) and skipped == 0.0, f"step {i}: loss {loss}, skipped {skipped}")
    peak = torch.cuda.max_memory_allocated()
    timed = walls[1:-1] or walls[:1]           # the first step also warms up
    step_s = sum(timed) / len(timed)
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    log(f"[train] losses {losses}; {step_s * 1e3:.1f} ms per step (mean of steps "
        f"1-{len(walls) - 2}, host clock), {tokens / step_s:.1f} tokens/s; first step "
        f"{walls[0] * 1e3:.1f} ms; max_memory_allocated {peak} B ({peak / 1e9:.2f} GB); {smi}")
    require(peak < 80e9, f"peak memory {peak} B does not fit the card's 80 GB")
    if prof["device_ms"] == 0:
        log("[profile] train step: device time not measured (no device events)")
    else:
        log(f"[profile] train step: device busy {prof['device_ms']:.2f} ms of "
            f"{step_s * 1e3:.2f} ms unprofiled wall ({prof['device_ms'] / (step_s * 1e3):.1%}); "
            f"profiled wall {prof['wall_ms']:.2f} ms")
        for ms, count, key in prof["top"]:
            log(f"[profile] train step:   {ms:8.3f} ms  {count:5d}x  {key}")

    # one batch, three ways: kernels, plain versions, plain versions on f32.
    # Held per token, as phase 5 holds logits: the mean over 8192 tokens of
    # either difference is a draw of the same small size, so a scalar floor
    # can be near 0 by chance.
    from repro_torch.models import layers, transformer
    host_batch = sess.batches(TRAIN["steps"])
    batch = sess._to_device(host_batch)
    mask = batch["loss_mask"].float()

    def token_nll(c, plain):
        ctx = plain_versions(fa, da) if plain else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            logits = transformer.lm_forward(c, sess.state["params"], batch, remat_policy="none")
            return torch.logsumexp(logits, -1) - layers.gold_logit(logits, batch["labels"])

    xent_eval = float(sess.evaluate(host_batch)["xent"])
    nll_k, nll_p = token_nll(cfg, False), token_nll(cfg, True)
    nll_f = token_nll(dataclasses.replace(cfg, dtype="float32"), True)
    xent = {n: float((x * mask).sum() / mask.sum())
            for n, x in (("kernel", nll_k), ("plain", nll_p), ("plain f32", nll_f))}
    diff = float((nll_k - nll_p).abs().max())
    floor = float((nll_p - nll_f).abs().max())
    log(f"[train] evaluate() xent {xent_eval:.6f}; masked mean of per-token losses: "
        + ", ".join(f"{n} {x:.6f}" for n, x in xent.items()))
    log(f"[train] per-token loss, (B, S) = {tuple(nll_k.shape)}: max |kernel - plain| "
        f"{diff:.4g}, bf16 noise floor max |plain - plain f32| {floor:.4g} (tol: kernel - "
        f"plain <= {LOGIT_FLOOR_FACTOR} x floor); std of the differences "
        f"{float((nll_k - nll_p).std()):.3g} and {float((nll_p - nll_f).std()):.3g}")
    require(math.isfinite(xent_eval) and abs(xent_eval - xent["kernel"]) <= 1e-5 * xent_eval,
            f"evaluate() gave {xent_eval}, its per-token losses {xent['kernel']}")
    require(diff <= LOGIT_FLOOR_FACTOR * floor,
            f"per-token losses differ from the plain path by {diff:.4g}, more than "
            f"{LOGIT_FLOOR_FACTOR} x bf16's own error {floor:.4g}")
    del sess, metrics, batch, nll_k, nll_p, nll_f
    torch.cuda.empty_cache()
    return launches


def phase_train_f32_identity(torch, fa, da, get_config, TrainSession, stepfn,
                             ParallelismConfig, DataConfig):
    """granite-3-2b at full width, 2 layers, f32: the kernels and the plain
    versions each take 3 steps from the same state (the same seed)."""
    from repro_torch.core.tree import tree_leaves
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=2, dtype="float32")

    def run(plain):
        sess = TrainSession.from_recipe(
            cfg, seed=1, plan=ParallelismConfig(gas=2, remat_policy="full"),
            train_cfg=stepfn.TrainConfig(total_steps=3, warmup=1),
            data_cfg=DataConfig(seq_len=256, global_batch=4))
        ctx = plain_versions(fa, da) if plain else contextlib.nullcontext()
        with ctx:
            losses = [float(sess.step()["loss"]) for _ in range(3)]
        return losses, sess.state["params"]

    losses_k, params_k = run(False)
    losses_p, params_p = run(True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    errs = [close(a, b, 1e-4) for (_, a), (_, b) in zip(tree_leaves(params_k),
                                                       tree_leaves(params_p))]
    worst = max(e for e, _ in errs)
    log(f"[f32 train] {cfg.name} at full width, 2 layers, f32, 3 steps: losses kernel "
        f"{losses_k}, plain {losses_p} (max rel diff {rel:.3g}, tol 1e-5); params max "
        f"|kernel - plain| {worst:.3g} (tol 1e-4)")
    require(rel <= 1e-5, f"f32 losses differ by {rel:.3g} relative")
    require(all(ok for _, ok in errs), f"f32 params differ by up to {worst:.3g}")
    del params_k, params_p
    torch.cuda.empty_cache()


def phase_timing(torch, fa, da, smi):
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16
    rows = {}

    def check(name, got, want, tol):
        err, ok = close(got, want, tol)
        log(f"[check] {name}: max |kernel - plain| {err:.3g} (tol {tol})")
        require(ok, f"{name}: kernel disagrees with its plain version at the slice's shape")
        return err

    # K1 at the slice's prefill: (B, S, Hq, Hkv, D) = (4, 500, 32, 8, 64), causal;
    # held against the plain version in both dtypes, timed in bf16
    B, S, Hq, Hkv, D = 4, 500, 32, 8, 64
    q32 = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
    k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
    o, lse = fa.flash_fwd(q32, k32, v32, causal=True)
    o_ref, lse_ref = fa.flash_fwd_plain(q32, k32, v32, causal=True)
    check("K1 O, slice shape, float32", o, o_ref, TOL["float32"])
    check("K1 lse, slice shape, float32", lse, lse_ref, TOL["float32"])
    q, k, v = (x.to(bf) for x in (q32, k32, v32))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal=True)
    err_o = check("K1 O, slice shape, bfloat16", o, o_ref, TOL["bfloat16"])
    check("K1 lse, slice shape, bfloat16", lse, lse_ref, TOL["bfloat16"])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)           # causal pairs only
    b_ms, b_by = bound(nbytes, flops)
    rows["flash_fwd"] = dict(
        max_abs_err=err_o,
        ms=time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, causal=True), iters=10),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, shape="q (4,500,32,64), k/v (4,500,8,64) bf16, causal")

    # K5 at the slice's decode: B=4, S=532 (full ring; its last 32-key chunk
    # holds 20 keys), Hq=32, Hkv=8, D=64; held in both dtypes, timed in bf16
    S = 532
    q32 = torch.randn((B, 1, Hq, D), generator=gen, device="cuda")
    k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
    kpos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S).contiguous()
    t = S - 1
    check("K5 O, slice shape, float32", da.decode_attention(q32, k32, v32, kpos, t=t),
          da.decode_attention_plain(q32, k32, v32, kpos, t=t), TOL["float32"])
    q, k, v = (x.to(bf) for x in (q32, k32, v32))
    err_o = check("K5 O, slice shape, bfloat16", da.decode_attention(q, k, v, kpos, t=t),
                  da.decode_attention_plain(q, k, v, kpos, t=t), TOL["bfloat16"])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = ((kpos >= 0) & (kpos <= t))[:, None, None, :]
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * kpos.numel()
    flops = 4 * B * Hq * D * S                             # every slot is valid here
    b_ms, b_by = bound(nbytes, flops)
    rows["decode_attention"] = dict(
        max_abs_err=err_o,
        ms=time_ms(torch, lambda: da.decode_attention(q, k, v, kpos, t=t), iters=200),
        plain_ms=time_ms(torch, lambda: da.decode_attention_plain(q, k, v, kpos, t=t)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=200),
        bound_ms=b_ms, bound_by=b_by,
        shape="q (4,1,32,64), k/v (4,532,8,64) bf16, t=531, full ring")
    rows.update(_time_paged(torch, da, gen, check))
    rows.update(_time_backward(torch, fa, gen, check))
    for name, r in rows.items():
        log(f"[time] {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {_ms(r['library_ms'])}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), max |kernel - plain| "
            f"{r['max_abs_err']:.3g}; {smi}")
    return rows


def _time_paged(torch, da, gen, check):
    """K6 at the stream's decode: 8 rows at positions 320-432 (page 16,
    31-page tables, pages shuffled), Hq 32, Hkv 8, D 64; held against its
    plain version in both dtypes, timed in bf16.  No single PyTorch call
    gathers through a page table, so there is no library time; SDPA over
    the same K/V laid out contiguously is printed for scale.  Then K5's
    per-row form at the contiguous arm's decode (the same rows in 496-slot
    ring caches)."""
    F = torch.nn.functional
    B, ps, n_max, Hkv, g, D = 8, 16, 31, 8, 4, 64
    ts_list = [320 + 16 * b for b in range(B)]
    rows, errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        gen.manual_seed(7)
        q, kp, vp, pt, ts, kc, vc, kpos = _paged_case(torch, gen, B=B, ps=ps, n_max=n_max,
                                                      Hkv=Hkv, g=g, D=D, dtype=dtype,
                                                      ts=ts_list)
        errs[name] = check(f"K6 O, stream shape, {name}",
                           da.paged_decode_attention(q, kp, vp, pt, ts=ts),
                           da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts), TOL[name])
        check(f"K5 per-row O, stream shape, {name}", da.decode_attention(q, kc, vc, kpos, t=ts),
              da.decode_attention_plain(q, kc, vc, kpos, t=ts), TOL[name])
    keys = sum(t + 1 for t in ts_list)                  # the keys the queries can see
    nbytes = 2 * (2 * q.numel()) + 2 * keys * Hkv * D * 2 + 4 * (pt.numel() + B)
    flops = 4 * Hkv * g * D * keys
    b_ms, b_by = bound(nbytes, flops)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    mask = ((kpos >= 0) & (kpos <= ts[:, None]))[:, None, None, :]
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=200)
    rows["paged_decode_attention"] = dict(
        max_abs_err=errs["bfloat16"],
        ms=time_ms(torch, lambda: da.paged_decode_attention(q, kp, vp, pt, ts=ts), iters=200),
        plain_ms=time_ms(torch, lambda: da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"q (8,1,32,64), pool ({kp.shape[0]},16,8,64) bf16, tables (8,31), ts 320-432")
    k5_ms = time_ms(torch, lambda: da.decode_attention(q, kc, vc, kpos, t=ts), iters=200)
    k5_plain = time_ms(torch, lambda: da.decode_attention_plain(q, kc, vc, kpos, t=ts))
    # K5 reads every slot's position (no page table), and the K/V rows of
    # the valid ones
    k5_bound, _ = bound(nbytes - 4 * pt.numel() + 4 * kpos.numel(), flops)
    log(f"[time] for scale only: SDPA over the same K/V laid out contiguously (B, S) = "
        f"({B}, {n_max * ps}), masked: {sdpa_ms:.4f} ms; K5's per-row form on that layout: "
        f"{k5_ms:.4f} ms, its plain version {k5_plain:.4f} ms, its bound "
        f"{k5_bound * 1e3:.2f} us")
    return rows


def _time_backward(torch, fa, gen, check):
    """K2, K3 and K4 at the training slice's attention: q (4,1024,32,64),
    k/v (4,1024,8,64), causal; held against their plain versions in f32 and
    bf16, timed in bf16.  The library yardstick is the backward of
    ``scaled_dot_product_attention`` as a whole (forward + backward minus
    forward), which computes dQ, dK and dV together."""
    F = torch.nn.functional
    B, S, Hq, Hkv, D = 4, 1024, 32, 8, 64
    q32, do32 = (torch.randn((B, S, Hq, D), generator=gen, device="cuda") for _ in range(2))
    k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, do, k, v = (x.to(dtype) for x in (q32, do32, k32, v32))
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = fa.flash_delta_plain(o, do)
        errs["flash_delta"] = check(f"K2 delta, slice shape, {name}", fa.flash_delta(o, do),
                                    delta, TOL[name])
        errs["flash_dq"] = check(f"K3 dQ, slice shape, {name}",
                                 fa.flash_dq(q, k, v, do, lse, delta, causal=True),
                                 fa.flash_dq_plain(q, k, v, do, lse, delta, causal=True),
                                 TOL[name])
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=True)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=True)
        errs["flash_dkv"] = max(check(f"K4 dK, slice shape, {name}", dk, dk_ref, TOL[name]),
                                check(f"K4 dV, slice shape, {name}", dv, dv_ref, TOL[name]))
    # bf16 now: q, do, k, v, o, lse, delta of the last pass
    pairs = S * (S + 1) // 2                          # causal (q, k) pairs
    prod = 2 * B * Hq * D * pairs                     # one (q, k, d) product
    qb, kb = 2 * q.numel(), 2 * k.numel()             # bytes of a q-shaped / k-shaped bf16 tensor
    stats = 2 * 4 * lse.numel()                       # lse and delta, f32
    bounds = {
        "flash_delta": bound(2 * qb + stats / 2, 0),
        "flash_dq": bound(3 * qb + 2 * kb + stats, 3 * prod),
        "flash_dkv": bound(2 * qb + 4 * kb + stats, 4 * prod),
    }
    calls = {
        "flash_delta": (lambda: fa.flash_delta(o, do), lambda: fa.flash_delta_plain(o, do)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal=True),
                     lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, causal=True)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal=True),
                      lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=True)),
    }
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    sdpa_fwd = time_ms(torch, lambda: sdpa().detach())
    sdpa_both = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    sdpa_bwd = sdpa_both - sdpa_fwd
    shape = "q (4,1024,32,64), k/v (4,1024,8,64) bf16, causal"
    rows = {}
    for name, (kern, plain) in calls.items():
        b_ms, b_by = bounds[name]
        rows[name] = dict(max_abs_err=errs[name], ms=time_ms(torch, kern),
                          plain_ms=time_ms(torch, plain, iters=10),
                          library_ms=None if name == "flash_delta" else sdpa_bwd,
                          bound_ms=b_ms, bound_by=b_by, shape=shape)
    whole = sum(rows[n]["ms"] for n in calls)
    log(f"[time] flash backward as a whole (K2 + K3 + K4) at {shape}: {whole:.4f} ms; SDPA "
        f"backward {sdpa_bwd:.4f} ms (forward + backward {sdpa_both:.4f} ms, forward "
        f"{sdpa_fwd:.4f} ms)")
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.core import stepfn
    from repro_torch.core.recipe import ParallelismConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataConfig
    from repro_torch.session import InferenceSession, TrainSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {kind} (sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
        f"{torch.cuda.device_count()} device(s)")
    log(f"[env] nvidia-smi: {smi}")
    require(torch.cuda.get_device_capability(0) == (9, 0),
            "the kernels are built for sm_90a (Hopper)")

    phase_build(build)
    phase_flash_sweep(torch, fa)
    phase_flash_bwd_sweep(torch, fa)
    phase_decode_sweep(torch, da)
    phase_paged_sweep(torch, da)
    serve_launches = phase_slice(torch, np, build, fa, da, InferenceSession, tree_map)
    phase_f32_identity(torch, np, fa, da, get_config, InferenceSession)
    stream_launches = phase_stream(torch, np, build, InferenceSession, tree_map, smi)
    phase_stream_f32_identity(torch, np, fa, da, get_config, InferenceSession)
    train_launches = phase_train(torch, build, fa, da, TrainSession, stepfn,
                                 ParallelismConfig, DataConfig, smi)
    phase_train_f32_identity(torch, fa, da, get_config, TrainSession, stepfn,
                             ParallelismConfig, DataConfig)
    timing = phase_timing(torch, fa, da, smi)

    fa_src, bwd_src = "src/repro_torch/csrc/flash_fwd.cu", "src/repro_torch/csrc/flash_bwd.cu"
    ref_fa = "src/repro/kernels/flash_attention.py"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=fa_src, replaces=f"{ref_fa}:88"),
        dict(name="flash_delta", route="cuda", source=bwd_src, replaces=f"{ref_fa}:205"),
        dict(name="flash_dq", route="cuda", source=bwd_src, replaces=f"{ref_fa}:213"),
        dict(name="flash_dkv", route="cuda", source=bwd_src, replaces=f"{ref_fa}:252"),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:26"),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:61"),
    ]
    # launches: the counted main-path runs: the served generate, one train
    # step, and the stream on each arm
    runs = [serve_launches, train_launches, *stream_launches.values()]
    log(f"[launches] generate {serve_launches}; train step {train_launches}; stream "
        f"{stream_launches}")
    for kr in kernels:
        r = timing[kr["name"]]
        n = sum(c.get(kr["name"], 0) for c in runs)
        kr.update(launches=n, max_abs_err=r["max_abs_err"],
                  ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r["library_ms"])
    log(f"[env] card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - reported, and the run fails
        traceback.print_exc()
        code = 1
    sys.exit(code)
