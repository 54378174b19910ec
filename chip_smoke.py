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
4. holds K5 (decode attention) against its plain version the same way;
5. serves granite-3-2b at its published width and depth (random bf16
   weights from seed 0) through ``InferenceSession.generate``: 4 prompts of
   500 tokens, 32 new tokens each.  Launch counts are zeroed just before and
   read just after: K1 must have launched once per layer (40) and K5 once per
   layer per decode step (40 x 31).  The prefill's last-position logits are
   compared, twice, with the same session on the plain versions on the card;
6. checks that, in f32 at full width (2 layers), the kernel path's greedy
   tokens equal the plain path's;
7. holds each kernel against its plain version at the slice's shapes (K1's
   O and lse, K5's O; f32 and bf16), then times it there beside its plain
   version, one PyTorch library call (``scaled_dot_product_attention``,
   timed only here) and its bound;
8. prints a ``{"kernels": [...]}`` line and, last,
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


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def close(got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol·|want| everywhere)."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return float(d.max()), ok


@contextlib.contextmanager
def plain_versions(fa, da):
    """Inside this block the dispatch (``kernels.ops``) sends CUDA tensors to
    the kernels' plain versions too: the comparison path on the card."""
    saved = fa.flash_fwd, da.decode_attention
    fa.flash_fwd, da.decode_attention = fa.flash_fwd_plain, da.decode_attention_plain
    try:
        yield
    finally:
        fa.flash_fwd, da.decode_attention = saved


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
                        if mask == "segments":  # two documents, then a -1 pad tail
                            seg = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
                            seg[:, : 2 * S // 5] = 0
                            seg[:, 2 * S // 5: 4 * S // 5] = 1
                            kw["segment_ids"] = seg
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
    for name, r in rows.items():
        log(f"[time] {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), max |kernel - plain| "
            f"{r['max_abs_err']:.3g}; {smi}")
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
    from repro_torch.session import InferenceSession
    from repro_torch.session.infer import tree_map

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
    phase_decode_sweep(torch, da)
    launches = phase_slice(torch, np, build, fa, da, InferenceSession, tree_map)
    phase_f32_identity(torch, np, fa, da, get_config, InferenceSession)
    timing = phase_timing(torch, fa, da, smi)

    kernels = [
        dict(name="flash_fwd", route="cuda", source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:88"),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:26"),
    ]
    for kr in kernels:
        r = timing[kr["name"]]
        kr.update(launches=launches.get(kr["name"], 0), max_abs_err=r["max_abs_err"],
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
