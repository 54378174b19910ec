#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one Hopper card (sm_90):

1. prints the environment: torch and CUDA versions, the card's name and
   power limit as ``nvidia-smi`` reports them;
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
   prints the build's seconds and ptxas's registers and spills per entry
   function (K1, K3 and K4's bf16 wgmma instantiations named by padded head
   dim, the others by their template arguments); a spill in the decode
   kernels (K5, K6) or in K7 fails the run;
3. holds K1 (flash forward) against its plain version on the card, O and lse,
   over head groupings (h2o-danube's 32/8 among them), head dims 16, 64, 96,
   120 and 128, lengths 128/200/500 (ragged to its 128-row tiles), masks and
   dtypes;
   then K2, K3 and K4 (flash backward: delta, dQ, dK and dV) the same way,
   over the edges of their tiles (lengths 200/500/1024, windows of 64 and
   16, MHA and GQA 4/1, 8/2, 32/8), and two launches of K2, of K3 and of K4
   on equal inputs must give equal bits; K2 alone over a ragged length (1000)
   at head dims 64, 96, 120 and 128, one position, 40 heads, h2o's training
   shape, a long prompt and strided inputs, each launched twice for equal
   bits; and the autograd ``FlashAttention`` against autograd through K1's
   plain version;
4. holds K5 (decode attention) against its plain version the same way, and
   over long caches that span many of its splits (4096 and 4100 slots at
   B 1 and 4; full, wrapped, and not full so that whole splits are empty;
   a window that excludes whole splits; g 1 at D 128);
   then K6 (paged decode attention) against its plain version over page
   sizes 16/64/128, head groupings, head dims, windows and dtypes (pages
   shuffled, a hole in one table, a position per row; at B = 8, page
   16, with 1024-token histories; and at B = 1 with a 4096-token history
   through pages of 16, 64 and 128), and against K5 on the same K/V laid out
   contiguously; shows that NaN in pages K6 must not read (the trash page,
   unmapped pages, pages before the window) changes nothing; and holds
   K5's per-row form (a (B,) tensor of positions) against its plain version;
   then K7 (fused RMSNorm) against its plain version over the reference
   test's shapes, one row, a prime row count, d 2047/2048/8192, granite's
   training activations (8192 x 2048) and a 1-D x, eps 1e-6 and 1e-5, bf16
   and f32 (2e-2 and 1e-5), and ``ops.rmsnorm``'s dispatch: one counted
   launch with the ``fused_rmsnorm`` flag on, none with it off;
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
   bf16's own error, as the logits are in 5; then ``EvalSession``
   ``from_train_session`` (the weights shared, not copied) sweeps
   ``perplexity`` over 2 batches, one with its ``loss_mask``, with the
   kernels and with the plain versions, held to that rule (K1 once per
   layer per batch, no K2-K4);
10. checks that, in f32 at full width (2 layers), 3 training steps with the
   kernels and with the plain versions give the same losses (1e-5 relative)
   and params (1e-4);
11. runs the training CLI (``repro_torch.launch.train.main``, in this
   process) at full width, 2 layers (a run may write at most 45 GiB to
   the card's host disk, and a full-depth checkpoint is 30.4 GB; see
   ``CLI``), the batch and plan of 9, 8 steps, a checkpoint every 4: with
   ``--fail-at 6`` it must end in the injected crash; the same command
   without it must resume from step 4, with the losses of steps 4 and 5
   equal to the crashed run's bit for bit, and K1 4 x layers and K2-K4 2 x
   layers launches a step.  It prints the checkpoint's bytes, the
   snapshot, background write and restore times, ms per step inside
   ``run()`` against bare ``step()`` on the same config, a step while the
   background write runs, and peak memory;
12. runs the six drills of ``benchmarks/run.py:resilience_bench`` (skip,
   rollback, crash_restart, ckpt_retry, consensus_skip,
   replica_loss_replan) through ``TrainSession.run`` at full width, 1
   layer (the disk cap), bf16, with its fault plans, cadences, step counts
   and data (the fleet's wall-time straggler arm off, so that the injected
   loss alone re-plans): every figure must equal ``BENCH_resilience.json``'s;
   then times the in-step detection on vs off;
13. checks that, in f32 at granite's attention and MLP widths (1 layer, a
   4096-token vocabulary: the disk cap), the rollback and consensus drills
   give the same events, losses (1e-5 relative) and params (1e-4) with the
   kernels and with their plain versions;
14. holds each kernel against its plain version at its slice's shapes (K1's
   O and lse at the prefill and at the training attention, K2-K4 at the
   training attention, K5's O, K6 at the stream's decode, K5 and K6 at a
   4096-token cache, K7 at the training activations; f32 and bf16), then
   times it there beside its plain version and one PyTorch library call
   (``scaled_dot_product_attention``: its forward for K1, its backward
   alone for K3 and K4, masked for K5; ``rms_norm`` for K7;
   ``linalg.vecdot`` for K2; none for K6, for which SDPA on the K/V laid
   out contiguously is timed for scale; timed only here) in turns: kernel,
   library, library, kernel, in device time with the calls queued behind a
   spinning kernel, which the rows keep, and in CUDA events as the host
   issues the calls, printed beside (K2-K4 also at head dims 128 and 120,
   K2 with the share of its bound); and its bound;
15. (run before 14) the rest of the dense arm at published width, bf16
   (``DENSE``): phi3-mini-3.8b (32 layers, D 96, MHA), h2o-danube-3-4b (24
   layers, D 120, GQA 32/8, prompts of 4,200 past its 4096-token window)
   and qwen1.5-32b (cut to 8 of 64 layers, D 128, 40 MHA heads, QKV bias),
   each through ``InferenceSession.prefill`` (every position's logits, held
   to phase 5's rule; the last position alone, (B, 1, V)) and greedy
   ``generate``, launches exact (K1 once per layer per prefill, K5 once
   per layer per decode step);
16. (run before 14) h2o-danube-3-4b at full depth serves 4 requests of
   4,100-4,300 tokens on both scheduler arms (K5 / K6 launches exact, the
   arms' tokens compared as in 7);
17. (run before 14) trains h2o-danube-3-4b at full width, 4 of 24 layers,
   batch 2 x 4608 in 2 micro-batches (the window binds in K1-K4 at D 120),
   as 9 trains granite (launches exact, per-token losses held to 2x bf16's
   own error);
18. (run before 14) the f32 identities of 6 and 10 for phi3 and h2o at 2
   layers and qwen1.5 at 1 layer, full width;
19. (run after 17) the planning models beside the card: a GEMM sweep,
   bf16 ``torch.matmul`` of (M x 2048) by (2048 x 8192) for M from 16 to
   16384, in device time, gives the fraction of the bf16 peak that big
   GEMMs reach and the M at which it halves (``System.gemm_eff`` and
   ``eff_knee_m``), printed beside ``H100_SXM``'s constants; then
   ``estimate_step`` and ``per_device_bytes`` on ``H100_SXM`` for the
   training cells of 9 and 17, beside their step's measured device time
   and peak memory, with the ratios (no fit, no band: finite, positive,
   feasible);
20. prints each phase's seconds, a ``{"planning": {...}}`` line, a
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  It also exits non-zero
when CUDA is not available, or when it does not stand in a checkout of the
repository.  Tolerances: 2e-2 in bf16, 1e-4 in f32 (absolute plus relative,
as ``numpy.testing.assert_allclose``), TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# the head dims the attention sweeps take: the reduced configs' 16 and the
# published configs' 64, 96, 120 (h2o-danube-3-4b) and 128
HEAD_DIMS = (16, 64, 96, 120, 128)
# bf16 logits of the 40-layer prefill, kernels vs plain versions: both round
# every layer's activations to bf16 (8 bits) and the kernel also rounds P
# before P V, so through 40 random layers they drift apart by about as much
# as bf16 drifts from f32.  The limit: max|kernel - plain| at most this many
# times max|plain - plain on an f32 copy of the same weights|.
LOGIT_FLOOR_FACTOR = 2.0
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores, H100 SXM data sheet

SLICE = dict(arch="granite_3_2b", batch=4, prompt_len=500, new_tokens=32)
# the chat stream served through both arms of the scheduler: 16 requests
# share a 256-token system prompt, suffixes of 16-112 tokens, replies
# cycling through STREAM_GENS, 8 slots, KV pages of 16 tokens
STREAM = dict(arch="granite_3_2b", requests=16, system=256, suffix=(16, 112), slots=8,
              page_size=16)
STREAM_GENS = (128, 16, 16, 32)
TRAIN = dict(arch="granite_3_2b", seq_len=1024, global_batch=8, gas=2, steps=4)
# the rest of the dense arm, bf16, at published width, random weights:
# prefill logits at every position (kernels vs plain versions), then greedy
# generate.  phi3 and h2o at full depth; qwen1.5 cut to 8 of its 64 layers
# (~5.8 B parameters: init_params builds f32 before the cast, and all 64
# would take ~140 GB).  h2o's prompts pass its 4096-token window, so the
# window binds in K1 and K5's ring wraps
DENSE = (dict(arch="phi3_mini_38b", batch=2, prompt_len=512, new_tokens=16),
         dict(arch="h2o_danube_3_4b", batch=2, prompt_len=4200, new_tokens=16),
         dict(arch="qwen15_32b", n_layers=8, batch=2, prompt_len=512, new_tokens=16))
# h2o's long-prompt stream on both scheduler arms: 4 requests of 4,100-4,300
# tokens (K6 with the window binding), 4 slots, pages of 16
H2O_STREAM = dict(arch="h2o_danube_3_4b", prompt_lens=(4100, 4300, 4166, 4233),
                  gens=(16, 8, 12, 8), slots=4, page_size=16)
# h2o trained at full width, 4 of its 24 layers (~0.87 B parameters), 2 x
# 4608 tokens in 2 micro-batches: the window binds in K1-K4 at D 120
TRAIN_H2O = dict(arch="h2o_danube_3_4b", n_layers=4, seq_len=4608, global_batch=2, gas=2,
                 steps=3)
# the GEMM sweep of the planning phase: bf16 (M x K) @ (K x N), granite's
# MLP up-projection, M from 16 to 16384 in powers of two
GEMM = dict(k=2048, n=8192, ms=tuple(2**i for i in range(4, 15)))
# the f32 identities of phases 6 and 10 for the later dense configs at full
# width: (arch, layers)
F32_DENSE = (("phi3_mini_38b", 2), ("h2o_danube_3_4b", 2), ("qwen15_32b", 1))
# K7: tolerances (the reference's kernel test's) and the sweep's shapes
RMS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
RMS_SHAPES = ((8, 128), (3, 7, 256), (64, 512), (1, 2048), (131, 2048), (131, 2047),
              (7, 8192), (2048,), (8192, 2048))
# The card's host lets one run of this script write at most 45 GiB to its
# disk, deleted files included.  A checkpoint takes 12 B a parameter (f32
# params, m and v): 30.4 GB at full depth, 1.94 GB for one layer at full width (1.21 GB of it
# the 49155 x 2048 embedding).  So the phases that checkpoint run at full
# width with fewer layers: the CLI's crash -> resume at 2 (2 checkpoints,
# 5.3 GB), the six drills at 1 (15 checkpoints, 29.1 GB) and the f32 drills
# at 1 with a 4096-token vocabulary (8 checkpoints, 6.6 GB).
CLI = dict(arch="granite_3_2b", n_layers=2, seq=1024, batch=8, gas=2, steps=8, ckpt_every=4,
           fail_at=6)
# the resilience drills: resilience_bench's scenarios, data and LR
DRILL = dict(arch="granite_3_2b", n_layers=1, seq=128, batch=8, lr=1e-3)
F32_DRILL = dict(n_layers=1, vocab_size=4096, dtype="float32")
DRILLS = ("skip", "rollback", "crash_restart", "ckpt_retry", "consensus_skip",
          "replica_loss_replan")


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


def rule(tol) -> str:
    """The rule ``close`` applies, as the logs state it."""
    return f"tol {tol:g} abs + {tol:g} rel"


KERNEL_NAMES = (("flash_fwd", "fa"), ("flash_delta", "fa"), ("flash_dq", "fa"),
                ("flash_dkv", "fa"), ("decode_attention", "da"),
                ("paged_decode_attention", "da"), ("rmsnorm", "rn"))


@contextlib.contextmanager
def plain_versions():
    """Inside this block the dispatch (``kernels.ops`` and ``FlashAttention``)
    sends CUDA tensors to the kernels' plain versions too: the comparison path
    on the card."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    mods = {"fa": fa, "da": da, "rn": rn}
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


def device_ms(torch, fn, n: int = 20) -> float:
    """Device time of one call of ``fn``, not paced by the host: the ``n``
    calls are queued behind a kernel that spins on the card until the host
    has enqueued them all, so the events around them time the calls back to
    back on the device (``time_ms`` times them as the host issues them,
    which at ~25 us a kernel measures the host's ~40-50 us dispatch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(6):
        spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin[0].record()
        torch.cuda._sleep(cycles)
        spin[1].record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if enqueue_ms < 0.5 * spin[0].elapsed_time(spin[1]):
            return start.elapsed_time(end) / n
        cycles *= 4                  # the host was slower than the spin: spin longer
    raise SmokeFailure(f"device_ms: the host took {enqueue_ms:.1f} ms to enqueue {n} calls, "
                       "longer than the card's spin")


def in_turns(torch, kern, lib, n: int = 50):
    """``kern`` and ``lib`` in turns (kernel, library, library, kernel), in
    device time (``device_ms``, ``n`` calls a reading), then each in CUDA
    events over 200 calls as the host issues them.  Returns (the kernel's
    mean device time, the library's, the four device readings, the two
    event times)."""
    dev = [device_ms(torch, f, n=n) for f in (kern, lib, lib, kern)]
    ev = [time_ms(torch, f, iters=200) for f in (kern, lib)]
    return (dev[0] + dev[3]) / 2, (dev[1] + dev[2]) / 2, dev, ev


def turns_text(what, lib_name, dev, ev) -> str:
    return (f"device time {dev[0]:.4f} / {dev[3]:.4f} ms, {lib_name} {dev[1]:.4f} / "
            f"{dev[2]:.4f} ms ({(dev[0] + dev[3]) / (dev[1] + dev[2]):.2f}x {lib_name}); "
            f"CUDA events {what} {ev[0]:.4f} ms, {lib_name} {ev[1]:.4f} ms")


def _ms(x) -> str:
    return "none" if x is None else f"{x:.4f} ms"


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_window(torch, fn, top: int = 8):
    """Run ``fn`` under ``torch.profiler``: host wall time (inflated by the
    profiler), summed device time of the kernels, the kernels that take
    most of it as (ms, launches, name), and every kernel as ``all``."""
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
    return {"wall_ms": wall * 1e3, "device_ms": sum(r[0] for r in rows), "top": rows[:top],
            "all": rows}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _demangle(names):
    """C++ names of ptxas's mangled entry functions (``c++filt``, where the
    machine has it), without the anonymous namespace and parameter lists."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return dict(zip(names, names))
    short = [o.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
             for o in out]
    return dict(zip(names, short)) if len(short) == len(names) else dict(zip(names, names))


def phase_build(build):
    """Build every kernel; print ptxas's registers and spills per entry
    function (the bf16 wgmma instantiations of K1, K3 and K4 by their padded
    head dim, the others by their template arguments) and its notes that it
    serialized or fenced wgmma; fail on a spill in the decode kernels (K5,
    K6) or in K7."""
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernels in {secs:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    spilled = []
    for name, p in paths.items():
        log_path = Path(f"{p}.log")
        if not log_path.exists():
            continue
        entries, fn = {}, "?"
        for line in log_path.read_text().splitlines():
            if "Performance Loss" in line or "warpgroup.wait is injected" in line:
                # ptxas serialized (or fenced) wgmma: the kernel runs ~2x slower
                log(f"[build] {name}: ptxas note: {line.strip()[:240]}")
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
                entries[fn] = {}
            elif "spill stores" in line and fn in entries:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                entries[fn].update(stack=nums[0], stores=nums[1], loads=nums[2])
            elif "Used" in line and "registers" in line and fn in entries:
                entries[fn]["regs"] = int(line.split("Used")[1].split()[0])
        names = _demangle(list(entries))
        for fn, e in entries.items():
            label = names[fn]
            for pat, k in (("flash_fwd_wgmma", "K1"), ("flash_dq_wgmma", "K3"),
                           ("flash_dkv_wgmma", "K4")):
                if pat in fn:
                    label = (f"{k} bf16 wgmma, D padded to "
                             f"{'64' if 'ILi64E' in fn else '128'}, "
                             f"{'segment ids' if 'Lb1E' in fn else 'no segment ids'}")
            log(f"[build] {name}: {label}: {e.get('regs', '?')} registers, "
                f"{e.get('stack', '?')} bytes stack, {e.get('stores', '?')} / "
                f"{e.get('loads', '?')} bytes spill stores / loads")
            if name in ("decode_attention", "paged_decode_attention", "rmsnorm") and (
                    e.get("stores") or e.get("loads")):
                spilled.append(f"{name}: {label}")
        log(f"[build] {name}: {len(entries)} entry functions, at most "
            f"{max((e.get('regs', 0) for e in entries.values()), default=0)} registers, "
            f"{sum(1 for e in entries.values() if e.get('stores') or e.get('loads'))} "
            f"with a spill")
    require(not spilled, "ptxas spilled in the decode or RMSNorm kernels:\n  "
            + "\n  ".join(spilled))


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
    for Hq, Hkv in ((4, 4), (8, 2), (32, 8)):       # (32, 8): granite's and h2o's
        for D in HEAD_DIMS:
            for S in (128, 200, 500):                # 200, 500: ragged to 64 and 128 rows
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
            f"({rule(TOL[name])})")
    require(not failures, f"K1 disagrees with its plain version in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K1 sweep] {n} cases agree")


def phase_flash_bwd_sweep(torch, fa):
    """K2, K3 and K4 against their plain versions on the same residuals
    (O and lse from K1's plain version, so both sides see equal inputs), over
    the edges of the kernels' tiles: lengths 200 and 500 (ragged to K3's
    128-row q tiles and 64/128-key tiles, K4's 128-key items and 64-row q
    tiles) and 1024, every head dim of ``HEAD_DIMS``, MHA and GQA 4/1, 8/2
    and 32/8, causal, a window of 64 and one of 16 (smaller than any tile),
    none, segment ids, and queries and keys of two lengths (200 and 500);
    in every case two launches of K3 and of K4 on the same inputs
    must give equal bits (no atomics: the bitwise crash -> resume relies on
    it); then the whole ``FlashAttention`` against autograd through
    ``flash_fwd_plain``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {dt: [0.0] * 4 for dt in TOL}
    failures, unequal, n = [], [], 0
    cases = [(Hq, Hkv, D, S, S, mask)
             for Hq, Hkv in ((4, 4), (4, 1), (8, 2), (32, 8))   # (32, 8): granite's, h2o's
             for D in HEAD_DIMS if Hq != 32 or D in (64, 120)
             for S in (200, 500, 1024)
             for mask in ("causal", "window", "window16", "none", "segments")]
    # queries and keys of two lengths (no segment ids then)
    cases += [(8, 2, D, Sq, Sk, mask) for D in (64, 120) for Sq, Sk in ((200, 500), (500, 200))
              for mask in ("causal", "window16", "none")]
    for Hq, Hkv, D, S, Sk, mask in cases:
        for dtype in (torch.bfloat16, torch.float32):
            B = 2
            q, do = (torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            kw = dict(causal=mask != "none", window={"window": 64, "window16": 16}.get(mask),
                      segment_ids=_segments(torch, B, S) if mask == "segments" else None)
            o, lse = fa.flash_fwd_plain(q, k, v, **kw)
            delta = fa.flash_delta(o, do)
            delta_ref = fa.flash_delta_plain(o, do)
            got = (delta, fa.flash_dq(q, k, v, do, lse, delta_ref, **kw),
                   *fa.flash_dkv(q, k, v, do, lse, delta_ref, **kw))
            again = (fa.flash_delta(o, do), fa.flash_dq(q, k, v, do, lse, delta_ref, **kw),
                     *fa.flash_dkv(q, k, v, do, lse, delta_ref, **kw))
            want = (delta_ref, fa.flash_dq_plain(q, k, v, do, lse, delta_ref, **kw),
                    *fa.flash_dkv_plain(q, k, v, do, lse, delta_ref, **kw))
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            case = f"Hq={Hq} Hkv={Hkv} D={D} Sq={S} Sk={Sk} {mask} {name}"
            errs = []
            for i, (a, b) in enumerate(zip(got, want)):
                err, ok = close(a, b, TOL[name])
                worst[name][i] = max(worst[name][i], err)
                errs.append((err, ok))
            n += 1
            if not all(ok for _, ok in errs):
                failures.append(f"{case}: errors delta/dQ/dK/dV "
                                + " ".join(f"{e:.3g}" for e, _ in errs))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                unequal.append(case)
    for name, w in worst.items():
        log(f"[K2-K4 sweep] {name}: max |kernel - plain| delta {w[0]:.3g}, dQ {w[1]:.3g}, "
            f"dK {w[2]:.3g}, dV {w[3]:.3g} ({rule(TOL[name])})")
    require(not failures, f"K2-K4 disagree with their plain versions in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K2-K4 sweep] {n} cases agree")
    require(not unequal, f"two launches of K2/K3/K4 on equal inputs gave different bits in "
            f"{len(unequal)} of {n} cases:\n  " + "\n  ".join(unequal[:20]))
    log(f"[K2-K4 sweep] K2, K3 and K4 launched twice on equal inputs: equal bits in all {n} "
        f"cases")
    phase_delta_sweep(torch, fa, gen)

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
                f"{name} max |Function - autograd of plain| {err:.3g} ({rule(TOL['float32'])})")
            require(ok, f"FlashAttention's {name} disagrees with autograd ({mask})")


def phase_delta_sweep(torch, fa, gen):
    """K2 alone over what its runs (``fa.delta_split``: equal runs of
    positions across all heads, crossing batch rows, taken in chunks of 32)
    and its 16-byte vectors meet: a length of 1000 (ragged to every run and
    chunk) at head dims 64, 96, 120 and 128, one position at qwen's 40
    heads, h2o's training attention (2, 4608, 32, 120: runs of 18), a long
    prompt (1, 4200, 40, 128) and O and dO strided (heads and positions
    padded), in both dtypes; each case launched twice, which must give equal
    bits."""
    cases = [(4, 1000, 32, D) for D in (64, 96, 120, 128)]
    cases += [(1, 1, 40, 128), (3, 77, 5, 16), (2, 4608, 32, 120), (1, 4200, 40, 128)]
    worst, failures, n = {dt: 0.0 for dt in TOL}, [], 0
    for i, (B, Sq, Hq, D) in enumerate(cases + [(2, 300, 8, 64), (2, 1000, 32, 120)]):
        for dtype in (torch.bfloat16, torch.float32):
            if i < len(cases):
                o, do = (torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dtype)
                         for _ in range(2))
                how = "contiguous"
            else:                              # heads and positions padded, offsets aligned
                big = torch.randn((2, B, Sq + 8, Hq + 2, D), generator=gen,
                                  device="cuda").to(dtype)
                o, do = big[0, :, 8:, 1:Hq + 1], big[1, :, :Sq, 2:]
                how = "strided"
            got, again = fa.flash_delta(o, do), fa.flash_delta(o, do)
            want = fa.flash_delta_plain(o, do)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            err, ok = close(got, want, TOL[name])
            worst[name] = max(worst[name], err)
            n += 1
            if not ok or not torch.equal(got, again):
                failures.append(f"(B, Sq, Hq, D) = {(B, Sq, Hq, D)} {how} {name}, runs of "
                                f"{fa.delta_split(B, Sq, Hq)}: err {err:.3g}, equal bits on two "
                                f"launches {torch.equal(got, again)}")
    log("[K2 sweep] ragged and long lengths, 40 heads, strided O and dO: max |delta - plain| "
        + ", ".join(f"{k} {v:.3g} ({rule(TOL[k])})" for k, v in worst.items()))
    require(not failures, f"K2 disagrees or repeats unequally in {len(failures)} of {n} "
            f"cases:\n  " + "\n  ".join(failures))
    log(f"[K2 sweep] {n} cases agree, each with equal bits on two launches")


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
    """K5 against its plain version: B 2, Hkv 2 rings of 532 and 544 slots
    (ragged to 128; 532 also ends in a partial 32-key chunk) over fills,
    a wrapped ring, windows, head groupings, head dims and dtypes; then long
    caches that span many splits (``da.split_plan``): S 4096 and 4100 at B 1
    and 4, Hkv 8, g 4 at D 64 and g 1 at D 128 (the GPT configs' MHA), full,
    wrapped and not full (300 of S slots: whole splits empty), without a
    window and with one of 1000 (which excludes whole splits)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = {dt: 0.0 for dt in TOL}
    failures, n = [], 0
    cases = []
    for S in (532, 544):
        for g in (1, 4):
            for D in HEAD_DIMS:
                for ring in [dict(fill=f) for f in (0, 300, S - 1)] + [dict(t_wrap=2000)]:
                    for window in (None, 128):
                        cases.append((2, S, 2, g, D, ring, window))
    for B in (1, 4):
        for S in (4096, 4100):
            for g, D in ((4, 64), (1, 128)):
                for ring in (dict(fill=S - 1), dict(fill=300), dict(t_wrap=10000)):
                    for window in (None, 1000):
                        cases.append((B, S, 8, g, D, ring, window))
    for B, S, Hkv, g, D, ring, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, 1, g * Hkv, D), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            kpos, t = _ring(torch, B, S, **ring)
            o = da.decode_attention(q, k, v, kpos, t=t, window=window)
            o_ref = da.decode_attention_plain(q, k, v, kpos, t=t, window=window)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            err, ok = close(o, o_ref, TOL[name])
            worst[name] = max(worst[name], err)
            n += 1
            if not ok:
                failures.append(f"B={B} S={S} Hkv={Hkv} g={g} D={D} {ring} window={window} "
                                f"{name} (splits {da.split_plan(B, Hkv, S)}): err {err:.3g}")
    for name, err in worst.items():
        log(f"[K5 sweep] {name}: max |O - plain| {err:.3g} ({rule(TOL[name])})")
    require(not failures, f"K5 disagrees with its plain version in {len(failures)} of "
            f"{n} cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K5 sweep] {n} cases agree, long caches of 4096 and 4100 slots among them")


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
    table's end, one with an unmapped hole; physical pages shuffled), at
    B = 8, page 16, with 1024-token histories, and at B = 1 with a
    4096-token history through pages of 16, 64 and 128.  Then: K6 never reads the
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
            for D in HEAD_DIMS:
                for window in (None, 8):
                    cases.append(dict(B=4, ps=ps, n_max=n_max, Hkv=2, g=g, D=D, window=window,
                                      ts=[5, 2 * ps, n_max * ps - 1, n_max * ps - 1],
                                      holes=[(3, 1)]))
    # the stream's decode shape with 1024-token histories (one row shorter)
    for window in (None, 256):
        cases.append(dict(B=8, ps=16, n_max=64, Hkv=8, g=4, D=64, window=window,
                          ts=[1023] * 7 + [700], holes=[]))
    # a 4096-token history at B = 1 over many splits, through several page
    # sizes: the table full (one hole) or mapped to position 2500 only
    for ps in (16, 64, 128):
        for ts, holes in (([4095], [(0, 3)]), ([2500], [])):
            for window in (None, 1000):
                cases.append(dict(B=1, ps=ps, n_max=4096 // ps, Hkv=8, g=4, D=64,
                                  window=window, ts=ts, holes=holes))
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
        log(f"[K6 sweep] {name}: max |O - plain| and |K6 - K5| {err:.3g} ({rule(TOL[name])})")
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
        for D in HEAD_DIMS:
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
        log(f"[K5 per-row] {name}: max |O - plain| {err:.3g} ({rule(TOL[name])})")
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
        with plain_versions():
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


def phase_f32_identity(torch, np, fa, da, get_config, InferenceSession, arch=SLICE["arch"],
                       n_layers=2):
    """``arch`` at full width, ``n_layers`` layers, f32: greedy tokens with
    the kernels and with their plain versions must be equal."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    sess = InferenceSession.from_recipe(cfg, seed=1)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 200)).astype(np.int32)
    toks_k = sess.generate(prompts, 16)
    with plain_versions():
        toks_p = sess.generate(prompts, 16)
    same = bool(torch.equal(toks_k, toks_p))
    log(f"[f32] {cfg.name} at full width, {n_layers} layer(s), f32: greedy tokens kernel == "
        f"plain: {same}")
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
        ctx = plain_versions() if plain else contextlib.nullcontext()
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


def phase_dense(torch, np, build, get_config, InferenceSession, tree_map, smi):
    """The rest of the dense arm at published width, bf16, random weights
    from seed 0 (``DENSE``): for each model ``InferenceSession.prefill``
    (every position's logits) with the kernels, with their plain versions
    and with the plain versions on an f32 copy, held to phase 5's rule; the
    last position alone (``last_only``, (B, 1, V)); then a greedy
    ``generate``.  Launches are counted per run: the prefill K1 once per
    layer and nothing else; ``generate`` K1 once per layer and K5 once per
    layer per decode step.  Returns {name: (prefill's, generate's)}."""
    runs = {}
    for spec in DENSE:
        cfg, full = _dense_cfg(get_config, spec)
        t0 = time.perf_counter()
        sess = InferenceSession.from_recipe(cfg, seed=0)
        torch.cuda.synchronize()
        L, B, P, N = cfg.n_layers, spec["batch"], spec["prompt_len"], spec["new_tokens"]
        V = cfg.vocab_size
        log(f"[dense] {_describe(cfg, full)}, {cfg.dtype}; init {time.perf_counter() - t0:.1f} "
            f"s; batch {B} x {P}, {N} new tokens")
        prompts = np.random.RandomState(0).randint(0, V, size=(B, P)).astype(np.int32)
        batch = {"tokens": prompts}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        t0 = time.perf_counter()
        lk = sess.prefill(batch, last_only=False)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        pre = dict(build.launch_counts)
        require(pre == {"flash_fwd": L}, f"{cfg.name} prefill launched {pre}, expected K1 {L}")
        require(tuple(lk.shape) == (B, P, V) and lk.dtype == torch.float32,
                f"{cfg.name} prefill gave {tuple(lk.shape)} {lk.dtype}")
        last = sess.prefill(batch)
        require(tuple(last.shape) == (B, 1, V) and last.dtype == torch.float32,
                f"{cfg.name} prefill(last_only=True) gave {tuple(last.shape)} {last.dtype}")
        with plain_versions():
            lp = sess.prefill(batch, last_only=False)
            sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                      tree_map(lambda x: x.float(), sess.params),
                                      device=sess.device)
            lf = sess32.prefill(batch, last_only=False)
            del sess32
        floor = hold_to_floor("dense", f"{cfg.name} prefill logits (B, S, V) = "
                              f"{tuple(lk.shape)}", lk, lp, lf)
        # the same hidden states; the f32 unembed of one row against S rows
        # differs only in cuBLAS's summation order
        d_last, ok = close(last, lk[:, -1:], TOL["float32"])
        log(f"[dense] {cfg.name} prefill(last_only=True) (B, 1, V) = {tuple(last.shape)}: max "
            f"|last_only - the full prefill's last position| {d_last:.4g} "
            f"({rule(TOL['float32'])}); bf16 noise floor of the prefill {floor:.4g}")
        require(ok, f"{cfg.name}: last_only differs from the full prefill by {d_last:.4g}")
        first = lk[:, -1].argmax(-1).to(torch.int32)
        del lp, lf, last
        torch.cuda.empty_cache()
        build.launch_counts.clear()
        t0 = time.perf_counter()
        toks = sess.generate(prompts, N)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_fwd": L, "decode_attention": L * (N - 1)}
        log(f"[dense] {cfg.name}: prefill {pre_s * 1e3:.1f} ms (first call, host clock), "
            f"launches {pre}; generate {tuple(toks.shape)} in {gen_s:.2f} s (first call), "
            f"launches {counts}, expected {want}; first generated token = the prefill's "
            f"argmax in {float((toks[:, P] == first).float().mean()):.2f} of rows (bf16: the "
            f"cache-filling prefill may round otherwise; reported); peak memory {peak} B "
            f"({peak / 1e9:.2f} GB); {smi}")
        require(counts == want, f"{cfg.name} generate launched {counts}, expected {want}")
        out = toks.cpu().numpy()
        require(out.shape == (B, P + N) and bool((out[:, :P] == prompts).all())
                and bool(((out >= 0) & (out < V)).all()),
                f"{cfg.name} generate returned {out.shape} tokens, altered or out of range")
        runs[cfg.name] = (pre, counts)
        del sess, lk, toks
        torch.cuda.empty_cache()
    return runs


def phase_dense_stream(torch, np, build, InferenceSession, smi):
    """h2o-danube-3-4b at published width and depth, bf16, serves
    ``H2O_STREAM`` (prompts past its 4096-token window) through both
    scheduler arms; launches per arm as phase 7 holds them (contiguous: K5
    once per layer per decode step, K1 in whole layers, no K6; paged: K6
    once per layer per decode step, no K1 or K5).  The arms' tokens are
    compared as phase 7 compares them (reported): besides bf16's near-ties,
    the contiguous arm keeps a ring of 4096 slots that a bucketed admission
    prefill fills with pad positions over valid keys, as the reference's
    contiguous arm does (``tests/test_torch_paged.py``)."""
    spec = H2O_STREAM
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg, L = sess.cfg, sess.cfg.n_layers
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in spec["prompt_lens"]]
    gens = list(spec["gens"])
    log(f"[h2o stream] {cfg.name}: {L} layers, window {cfg.swa_window}, prompts "
        f"{list(spec['prompt_lens'])}, replies {gens}, {spec['slots']} slots, page "
        f"{spec['page_size']}; init {time.perf_counter() - t0:.1f} s")
    outs, launches = {}, {}
    for arm in ("contiguous", "paged"):
        kw = dict(paged=True, page_size=spec["page_size"]) if arm == "paged" else {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        t0 = time.perf_counter()
        outs[arm], st = sess.serve(prompts, gens, n_slots=spec["slots"], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launches[arm] = dict(build.launch_counts)
        log(f"[h2o stream] {arm}: {st.requests} requests, {st.generated_tokens} tokens, "
            f"{st.decode_steps} decode steps in {wall:.2f} s (host clock); prefilled "
            f"{st.prefill_tokens} of {st.prompt_tokens} prompt tokens; launches {c}; peak "
            f"memory {torch.cuda.max_memory_allocated()} B; {smi}")
        require(st.requests == len(prompts) and st.generated_tokens == sum(gens),
                f"h2o {arm}: served {st.requests} requests, {st.generated_tokens} tokens")
        for pr, m, o in zip(prompts, gens, outs[arm]):
            require(len(o) == len(pr) + m and bool((o[:len(pr)] == pr).all())
                    and bool(((o >= 0) & (o < cfg.vocab_size)).all()),
                    f"h2o {arm}: a request came back with {len(o)} tokens, altered or out of "
                    f"range")
        steps = st.decode_steps
        if arm == "contiguous":
            require(c.get("decode_attention", 0) == L * steps and c.get("flash_fwd", 0) > 0
                    and c["flash_fwd"] % L == 0 and not c.get("paged_decode_attention"),
                    f"h2o contiguous launches {c}, expected K5 {L} x {steps}, K1 in layers")
        else:
            require(c == {"paged_decode_attention": L * steps},
                    f"h2o paged launches {c}, expected K6 {L} x {steps} only")
    same, first, run = _agreement(np, prompts, outs["contiguous"], outs["paged"])
    log(f"[h2o stream] requests whose tokens agree between the arms: {same} of {len(prompts)}; "
        f"first token {first} of {len(prompts)}; tokens agreeing before the first difference "
        f"{run} (of {gens}; reported, not required: bf16 near-ties, and the contiguous arm's "
        f"4096-slot ring under a padded admission prefill, as in the reference)")
    del sess
    torch.cuda.empty_cache()
    return launches


def hold_to_floor(tag: str, what: str, kern, plain, plain_f32) -> float:
    """Phase 5's rule for bf16 outputs of a deep random model: max |kernel -
    plain| at most ``LOGIT_FLOOR_FACTOR`` times bf16's own error, max |plain
    - plain on an f32 copy of the same weights|.  Returns that floor."""
    require(bool(kern.isfinite().all()), f"{what}: non-finite values")
    diff = float((kern - plain).abs().max())
    floor = float((plain - plain_f32).abs().max())
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"[{tag}] {what}: max |kernel - plain| {diff:.4g} ({diff / float(plain.abs().max()):.4g} "
        f"of max |plain|), top-1 agreement {top1:.4f}; bf16 noise floor max |plain - plain "
        f"f32| {floor:.4g} (tol: kernel - plain <= {LOGIT_FLOOR_FACTOR} x floor)")
    require(diff <= LOGIT_FLOOR_FACTOR * floor,
            f"{what}: kernel and plain differ by {diff:.4g}, more than {LOGIT_FLOOR_FACTOR} x "
            f"bf16's own error {floor:.4g}")
    return floor


def _dense_cfg(get_config, spec):
    """(the spec's config, cut in depth where the spec says so; the
    published depth)."""
    cfg = get_config(spec["arch"])
    full = cfg.n_layers
    if "n_layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    return cfg, full


def _describe(cfg, full) -> str:
    cut = (f"CUT to {cfg.n_layers} of its {full} layers" if cfg.n_layers < full
           else f"{cfg.n_layers} layers (full depth)")
    return (f"{cfg.name}: {cut}, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
            f"of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.swa_window}, "
            f"QKV bias {cfg.qkv_bias}, tied head {cfg.tie_embeddings}, "
            f"{cfg.n_params() / 1e9:.3f} B params")


def phase_train(torch, build, get_config, TrainSession, stepfn, ParallelismConfig, DataConfig,
                smi, spec=TRAIN, tag="train", after=None):
    """``spec``'s model at full width (and full depth unless ``spec`` cuts
    it) trains for ``spec["steps"]`` steps: bf16 compute, fp32 masters and
    AdamW, random weights from seed 0.  Every step's launches are counted
    (K1 twice per layer per micro-batch, forward and remat; K2, K3 and K4
    once); the last step is profiled; then one batch is evaluated
    (``evaluate()``), and its per-token losses are taken with the kernels,
    with their plain versions, and with the plain versions on an f32 copy
    of the model (bf16's own error).  ``after(sess, floor)`` runs on the
    session before it is dropped.  Returns a step's launches and the
    profiled step's device time and the steps' peak memory."""
    t0 = time.perf_counter()
    cfg, full = _dense_cfg(get_config, spec)
    sess = TrainSession.from_recipe(
        cfg, seed=0,
        plan=ParallelismConfig(gas=spec["gas"], remat_policy="full"),
        train_cfg=stepfn.TrainConfig(total_steps=spec["steps"], warmup=2),
        data_cfg=DataConfig(seq_len=spec["seq_len"], global_batch=spec["global_batch"]))
    torch.cuda.synchronize()
    L, G = cfg.n_layers, spec["gas"]
    log(f"[{tag}] {_describe(cfg, full)} ({cfg.dtype} compute, f32 masters); gas {G}, "
        f"remat full, batch {spec['global_batch']} x {spec['seq_len']}; init "
        f"{time.perf_counter() - t0:.1f} s")
    want = {"flash_fwd": 2 * L * G, "flash_delta": L * G, "flash_dq": L * G,
            "flash_dkv": L * G}
    torch.cuda.reset_peak_memory_stats()
    losses, walls, launches, metrics = [], [], None, {}
    for i in range(spec["steps"]):
        last = i == spec["steps"] - 1
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
        log(f"[{tag}] step {i}: loss {loss:.6f}, grad_norm {float(metrics['grad_norm']):.4f}, "
            f"lr {float(metrics['lr']):.3g}, skipped {skipped:.0f}, {walls[-1] * 1e3:.1f} ms"
            f"{' (profiled)' if last else ''}; launches {counts}")
        require(all(counts.get(k, 0) == n for k, n in want.items()),
                f"step {i}: launches {counts}, expected {want} per step")
        require(math.isfinite(loss) and skipped == 0.0, f"step {i}: loss {loss}, skipped {skipped}")
    peak = torch.cuda.max_memory_allocated()
    timed = walls[1:-1] or walls[:1]           # the first step also warms up
    step_s = sum(timed) / len(timed)
    tokens = spec["global_batch"] * spec["seq_len"]
    log(f"[{tag}] losses {losses}; {step_s * 1e3:.1f} ms per step (mean of steps "
        f"1-{max(len(walls) - 2, 1)}, host clock), {tokens / step_s:.1f} tokens/s; first step "
        f"{walls[0] * 1e3:.1f} ms; max_memory_allocated {peak} B ({peak / 1e9:.2f} GB); {smi}")
    require(peak < 80e9, f"peak memory {peak} B does not fit the card's 80 GB")
    if prof["device_ms"] == 0:
        log(f"[profile] {tag} step: device time not measured (no device events)")
    else:
        log(f"[profile] {tag} step: device busy {prof['device_ms']:.2f} ms of "
            f"{step_s * 1e3:.2f} ms unprofiled wall ({prof['device_ms'] / (step_s * 1e3):.1%}); "
            f"profiled wall {prof['wall_ms']:.2f} ms")
        for ms, count, key in prof["top"]:
            log(f"[profile] {tag} step:   {ms:8.3f} ms  {count:5d}x  {key}")
        for label, pat in (("K1", "flash_fwd"), ("K2", "flash_delta"), ("K3", "flash_dq"),
                           ("K4", "flash_dkv")):
            rs = [(ms, count) for ms, count, key in prof["all"] if pat in key]
            k_ms, k_n = sum(r[0] for r in rs), sum(r[1] for r in rs)
            log(f"[profile] {tag} step: {label} ({pat}) {k_ms:.3f} ms of device time over "
                f"{k_n} launches ({k_ms / max(k_n, 1):.4f} ms a launch), "
                f"{k_ms / prof['device_ms']:.1%} of the step's device time; {smi}")

    # one batch, three ways: kernels, plain versions, plain versions on f32.
    # Held per token, as phase 5 holds logits: the mean over 8192 tokens of
    # either difference is a draw of the same small size, so a scalar floor
    # can be near 0 by chance.
    from repro_torch.models import layers, transformer
    host_batch = sess.batches(spec["steps"])
    batch = sess._to_device(host_batch)
    mask = batch["loss_mask"].float()

    def token_nll(c, plain):
        ctx = plain_versions() if plain else contextlib.nullcontext()
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
    log(f"[{tag}] evaluate() xent {xent_eval:.6f}; masked mean of per-token losses: "
        + ", ".join(f"{n} {x:.6f}" for n, x in xent.items()))
    log(f"[{tag}] per-token loss, (B, S) = {tuple(nll_k.shape)}: max |kernel - plain| "
        f"{diff:.4g}, bf16 noise floor max |plain - plain f32| {floor:.4g} (tol: kernel - "
        f"plain <= {LOGIT_FLOOR_FACTOR} x floor); std of the differences "
        f"{float((nll_k - nll_p).std()):.3g} and {float((nll_p - nll_f).std()):.3g}")
    require(math.isfinite(xent_eval) and abs(xent_eval - xent["kernel"]) <= 1e-5 * xent_eval,
            f"evaluate() gave {xent_eval}, its per-token losses {xent['kernel']}")
    require(diff <= LOGIT_FLOOR_FACTOR * floor,
            f"per-token losses differ from the plain path by {diff:.4g}, more than "
            f"{LOGIT_FLOOR_FACTOR} x bf16's own error {floor:.4g}")
    del metrics, batch, nll_k, nll_p, nll_f
    torch.cuda.empty_cache()
    if after is not None:
        after(sess, floor)
    del sess
    torch.cuda.empty_cache()
    return launches, dict(device_ms=prof["device_ms"], peak_bytes=peak)


def phase_eval(torch, build, EvalSession, sess, floor):
    """On phase 9's session: ``EvalSession.from_train_session`` (the
    training weights in place, no copy), ``perplexity`` over 2 batches (the
    first with the pipeline's ``loss_mask``, the second without it: every
    token bears loss) with the kernels and with their plain versions.  Each
    side's xent is a mean of per-token losses that phase 9 holds to
    ``LOGIT_FLOOR_FACTOR`` x its floor, so the two may differ by at most
    that.  Launches: K1 once per layer per batch, no K2-K4."""
    from repro_torch.core.tree import tree_leaves
    ev = EvalSession.from_train_session(sess)
    shared = all(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in
                 zip(tree_leaves(ev.params), tree_leaves(sess.state["params"])))
    require(shared, "EvalSession.from_train_session copied the training weights")
    masked = dict(sess.batches(TRAIN["steps"] + 1))
    whole = {k: v for k, v in sess.batches(TRAIN["steps"] + 2).items() if k != "loss_mask"}
    require("loss_mask" in masked, "the pipeline's batch has no loss_mask")
    L = sess.cfg.n_layers
    build.launch_counts.clear()
    rep_k = ev.perplexity([masked, whole])
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    with plain_versions():
        rep_p = ev.perplexity([masked, whole])
    diff = abs(rep_k["xent"] - rep_p["xent"])
    n_want = float(masked["loss_mask"].sum()) + float(whole["tokens"].size)
    log(f"[eval] EvalSession.from_train_session on {sess.cfg.name} (weights shared: {shared}): "
        f"perplexity over 2 batches of {TRAIN['global_batch']} x {TRAIN['seq_len']} (one with "
        f"its loss_mask; {rep_k['n_tokens']:.0f} tokens): kernels xent {rep_k['xent']:.6f} "
        f"(perplexity {rep_k['perplexity']:.2f}), plain {rep_p['xent']:.6f} (perplexity "
        f"{rep_p['perplexity']:.2f}); |diff| {diff:.3g} (tol {LOGIT_FLOOR_FACTOR} x phase 9's "
        f"per-token floor {floor:.4g}); launches {counts}")
    require(rep_k["n_batches"] == rep_p["n_batches"] == 2
            and rep_k["n_tokens"] == rep_p["n_tokens"] == n_want
            and math.isfinite(rep_k["perplexity"]), f"perplexity sweeps gave {rep_k}, {rep_p}")
    require(diff <= LOGIT_FLOOR_FACTOR * floor, f"eval xent differs by {diff:.3g}")
    require(counts == {"flash_fwd": 2 * L}, f"eval launched {counts}, expected K1 {2 * L}")
    del ev
    return counts


def phase_train_f32_identity(torch, fa, da, get_config, TrainSession, stepfn,
                             ParallelismConfig, DataConfig, arch=TRAIN["arch"], n_layers=2):
    """``arch`` at full width, ``n_layers`` layers, f32: the kernels and the
    plain versions each take 3 steps from the same state (the same seed)."""
    from repro_torch.core.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")

    def run(plain):
        sess = TrainSession.from_recipe(
            cfg, seed=1, plan=ParallelismConfig(gas=2, remat_policy="full"),
            train_cfg=stepfn.TrainConfig(total_steps=3, warmup=1),
            data_cfg=DataConfig(seq_len=256, global_batch=4))
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            losses = [float(sess.step()["loss"]) for _ in range(3)]
        return losses, sess.state["params"]

    losses_k, params_k = run(False)
    losses_p, params_p = run(True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    errs = [close(a, b, 1e-4) for (_, a), (_, b) in zip(tree_leaves(params_k),
                                                       tree_leaves(params_p))]
    worst = max(e for e, _ in errs)
    log(f"[f32 train] {cfg.name} at full width, {n_layers} layer(s), f32, 3 steps: losses kernel "
        f"{losses_k}, plain {losses_p} (max rel diff {rel:.3g}, tol 1e-5); params max "
        f"|kernel - plain| {worst:.3g} ({rule(1e-4)})")
    require(rel <= 1e-5, f"f32 losses differ by {rel:.3g} relative")
    require(all(ok for _, ok in errs), f"f32 params differ by up to {worst:.3g}")
    del params_k, params_p
    torch.cuda.empty_cache()


def gemm_profile(ms_by_m):
    """(efficiency by M, gemm_eff, eff_knee_m) from the sweep's device times:
    efficiency is 2·M·K·N over the time at the bf16 peak; ``gemm_eff`` is the
    mean efficiency at the two largest M, and ``eff_knee_m`` the M at which
    the efficiency first crosses ``gemm_eff / 2``, interpolated in log M
    (``repro_torch.core.systems.System``'s two fields)."""
    k, n = GEMM["k"], GEMM["n"]
    effs = {m: 2.0 * m * k * n / (t * 1e-3 * H100_BF16_FLOP_PER_S)
            for m, t in sorted(ms_by_m.items())}
    ms = sorted(effs)
    gemm_eff = (effs[ms[-1]] + effs[ms[-2]]) / 2
    half = gemm_eff / 2
    for m0, m1 in zip(ms, ms[1:]):
        e0, e1 = effs[m0], effs[m1]
        if e0 < half <= e1:
            frac = (half - e0) / (e1 - e0)
            knee = math.exp(math.log(m0) + frac * (math.log(m1) - math.log(m0)))
            return effs, gemm_eff, knee
    raise SmokeFailure(f"the GEMM efficiency never crosses gemm_eff / 2 = {half:.4f}: {effs}")


def phase_planning(torch, get_config, ParallelismConfig, smi, measured):
    """The planning models beside the card.  First the GEMM sweep that
    ``System.gemm_eff`` and ``eff_knee_m`` stand for: ``torch.matmul`` of
    bf16 (M x 2048) by (2048 x 8192) in device time (``device_ms``), the
    pair derived from it and ``H100_SXM``'s constants.  Then, for the two
    training cells of phases 9 and 17 (``measured``: their step's device
    time and peak memory), ``estimate_step``'s ``t_compute`` and ``t_step``
    and ``per_device_bytes``'s total beside the measurement, with their
    ratios.  No fit and no band: every figure must be finite and positive,
    each efficiency at most 1.05 (above the peak is impossible), and both
    cells feasible.  Returns the ``planning`` JSON object."""
    from repro_torch.core.cost_model import estimate_step
    from repro_torch.core.memory import per_device_bytes
    from repro_torch.core.systems import H100_SXM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = torch.randn(GEMM["k"], GEMM["n"], device="cuda", dtype=torch.bfloat16, generator=gen)
    ms_by_m = {}
    for m in GEMM["ms"]:
        a = torch.randn(m, GEMM["k"], device="cuda", dtype=torch.bfloat16, generator=gen)
        ms_by_m[m] = device_ms(torch, lambda: torch.matmul(a, b))
    del a, b
    effs, gemm_eff, knee = gemm_profile(ms_by_m)
    log(f"[planning] GEMM sweep, bf16 (M x {GEMM['k']}) @ ({GEMM['k']} x {GEMM['n']}), device "
        "time, efficiency against 989 TFLOP/s: " + "; ".join(
            f"M {m}: {ms_by_m[m]:.4f} ms, {effs[m]:.4f}" for m in GEMM["ms"]) + f"; {smi}")
    log(f"[planning] derived from the sweep: gemm_eff {gemm_eff:.4f}, eff_knee_m {knee:.1f}")
    log(f"[planning] H100_SXM's constants: gemm_eff {H100_SXM.gemm_eff}, eff_knee_m "
        f"{H100_SXM.eff_knee_m}")
    require(all(math.isfinite(e) and 0.0 < e <= 1.05 for e in effs.values()),
            f"GEMM efficiencies out of (0, 1.05]: {effs}")
    cells = {}
    for spec, tag in ((TRAIN, "train"), (TRAIN_H2O, "h2o train")):
        cfg, _ = _dense_cfg(get_config, spec)
        mbs = spec["global_batch"] // spec["gas"]
        plan = ParallelismConfig(mbs=mbs, gas=spec["gas"], remat_policy="full")
        cost = estimate_step(cfg, plan, system=H100_SXM, seq=spec["seq_len"],
                             flash_backward=True)
        mem = per_device_bytes(cfg, dp=1, tp=1, pp=1, mbs=mbs, gas=spec["gas"],
                               seq=spec["seq_len"], remat="full")["total"]
        got = measured[tag]
        cell = dict(arch=cfg.name, n_layers=cfg.n_layers, mbs=mbs, gas=spec["gas"],
                    seq=spec["seq_len"], est_t_compute_ms=cost.t_compute * 1e3,
                    est_t_step_ms=cost.t_step * 1e3, measured_device_ms=got["device_ms"],
                    time_ratio=got["device_ms"] / (cost.t_step * 1e3), est_mem_bytes=mem,
                    measured_peak_bytes=got["peak_bytes"], mem_ratio=got["peak_bytes"] / mem,
                    feasible=cost.feasible)
        cells[tag] = cell
        log(f"[planning] {tag}: {cfg.name} at {cfg.n_layers} layers, mbs {mbs} x gas "
            f"{spec['gas']} x seq {spec['seq_len']}, remat full, flash backward: estimate "
            f"t_compute {cell['est_t_compute_ms']:.2f} ms, t_step {cell['est_t_step_ms']:.2f} ms "
            f"vs measured step device time {got['device_ms']:.2f} ms (x{cell['time_ratio']:.3f}); "
            f"estimate memory {mem / 1e9:.3f} GB vs measured peak {got['peak_bytes'] / 1e9:.3f} GB "
            f"(x{cell['mem_ratio']:.3f}); feasible {cost.feasible}; {smi}")
        figures = [cell[k] for k in ("est_t_compute_ms", "est_t_step_ms", "measured_device_ms",
                                     "time_ratio", "est_mem_bytes", "measured_peak_bytes",
                                     "mem_ratio")]
        require(all(math.isfinite(v) and v > 0 for v in figures), f"{tag}: figures {cell}")
        require(cost.feasible, f"{tag}: estimate_step calls the cell the card ran infeasible")
    return dict(card=smi, gemm=dict(k=GEMM["k"], n=GEMM["n"],
                                    sweep=[dict(m=m, ms=ms_by_m[m], eff=effs[m])
                                           for m in GEMM["ms"]]),
                derived=dict(gemm_eff=gemm_eff, eff_knee_m=knee),
                h100_sxm=dict(gemm_eff=H100_SXM.gemm_eff, eff_knee_m=H100_SXM.eff_knee_m),
                cells=cells)


def phase_timing(torch, fa, da, rn, smi):
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16
    rows = {}

    def check(name, got, want, tol):
        err, ok = close(got, want, tol)
        log(f"[check] {name}: max |kernel - plain| {err:.3g} ({rule(tol)})")
        require(ok, f"{name}: kernel disagrees with its plain version at the slice's shape")
        return err

    # K1 at the slice's prefill: (B, S, Hq, Hkv, D) = (4, 500, 32, 8, 64), causal;
    # held against the plain version in both dtypes, timed in bf16; then at
    # the training step's attention, (4, 1024, 32, 8, 64).  At each shape
    # SDPA's forward is timed in the same call, in turns (kernel, SDPA, SDPA,
    # kernel)
    Hq, Hkv, D = 32, 8, 64
    k1 = {}
    for B, S in ((4, 500), (4, 1024)):
        q32 = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
        k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
        o, lse = fa.flash_fwd(q32, k32, v32, causal=True)
        o_ref, lse_ref = fa.flash_fwd_plain(q32, k32, v32, causal=True)
        check(f"K1 O, S={S}, float32", o, o_ref, TOL["float32"])
        check(f"K1 lse, S={S}, float32", lse, lse_ref, TOL["float32"])
        q, k, v = (x.to(bf) for x in (q32, k32, v32))
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal=True)
        err_o = check(f"K1 O, S={S}, bfloat16", o, o_ref, TOL["bfloat16"])
        check(f"K1 lse, S={S}, bfloat16", lse, lse_ref, TOL["bfloat16"])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        flops = 4 * B * Hq * D * (S * (S + 1) // 2)       # causal pairs only
        b_ms, b_by = bound(nbytes, flops)
        kern = lambda: fa.flash_fwd(q, k, v, causal=True)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
        # turns in CUDA events as the host issues the calls (a longer warm-up:
        # the card's clocks ramp after the idle before it) and in device time
        # (``device_ms``), which the row keeps: at these sizes a call's host
        # dispatch (~40-50 us of Python and ctypes) paces the first
        turns = [time_ms(torch, f, warmup=30) for f in (kern, lib, lib, kern)]
        dev = [device_ms(torch, f) for f in (kern, lib, lib, kern)]
        k1[S] = dict(
            max_abs_err=err_o, ms=(dev[0] + dev[3]) / 2,
            plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, causal=True), iters=10),
            library_ms=(dev[1] + dev[2]) / 2, bound_ms=b_ms, bound_by=b_by,
            shape=f"q ({B},{S},32,64), k/v ({B},{S},8,64) bf16, causal")
        log(f"[time] K1 at {k1[S]['shape']}, turns kernel, SDPA, SDPA, kernel: device time "
            f"{dev[0]:.4f} / {dev[3]:.4f} ms, SDPA forward {dev[1]:.4f} / "
            f"{dev[2]:.4f} ms ({k1[S]['ms'] / k1[S]['library_ms']:.2f}x SDPA); CUDA events "
            f"{turns[0]:.4f} / {turns[3]:.4f} ms, SDPA {turns[1]:.4f} / {turns[2]:.4f} ms "
            f"({(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x); bound "
            f"{b_ms * 1e3:.2f} us ({b_by}), {k1[S]['ms'] / b_ms:.1f}x it; {smi}")
    rows["flash_fwd"] = k1[500]
    rows["flash_fwd (training shape)"] = k1[1024]
    _k1_shapes(torch, fa, gen, smi)

    rows["decode_attention"] = _time_decode(torch, da, gen, check, smi)
    _time_long_cache(torch, da, gen, check, smi)
    rows.update(_time_paged(torch, da, gen, check, smi))
    rows.update(_time_backward(torch, fa, gen, check))
    rows.update(_time_rmsnorm(torch, rn, gen, check, smi))
    for name, r in rows.items():
        log(f"[time] {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {_ms(r['library_ms'])}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), max |kernel - plain| "
            f"{r['max_abs_err']:.3g}; {smi}")
    return rows


def _k1_shapes(torch, fa, gen, smi):
    """K1 beside SDPA's forward, device time (``device_ms``), at shapes past the
    slice's: a long sequence with and without the causal mask, head dims 120
    (h2o-danube) and 128 (gpt-175b, qwen) at the training shape; and one
    call's host dispatch at the prefill shape."""
    F = torch.nn.functional
    for B, S, D, causal in ((1, 4096, 64, False), (1, 4096, 64, True), (4, 1024, 120, True),
                            (4, 1024, 128, True)):
        q = torch.randn((B, S, 32, D), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((B, S, 8, D), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = device_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=causal))
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        flops = 4 * B * 32 * D * (S * (S + 1) // 2 if causal else S * S)
        log(f"[time] K1 at q ({B},{S},32,{D}), k/v ({B},{S},8,{D}) bf16, "
            f"{'causal' if causal else 'no mask'}: device time {ms:.4f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s), SDPA forward {lib:.4f} ms "
            f"({flops / lib / 1e9:.0f} TFLOP/s), {ms / lib:.2f}x; {smi}")
    q = torch.randn((4, 500, 32, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((4, 500, 8, 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    host = {}
    for name, fn in (("K1", lambda: fa.flash_fwd(q, k, v, causal=True)),
                     ("SDPA", lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True, enable_gqa=True))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    log(f"[time] host dispatch of one call at q (4,500,32,64) (host clock, no sync): K1's "
        f"wrapper {host['K1']:.1f} us, SDPA {host['SDPA']:.1f} us")


def _time_decode(torch, da, gen, check, smi):
    """K5 at the slice's decode: B=4, S=532 (a full ring; its last 32-key
    chunk holds 20 keys), Hq=32, Hkv=8, D=64; held against its plain version
    in both dtypes, timed in bf16 beside SDPA with the same mask, in turns in
    device time (which the row keeps), the CUDA-event times beside."""
    F = torch.nn.functional
    B, S, Hq, Hkv, D = 4, 532, 32, 8, 64
    q32 = torch.randn((B, 1, Hq, D), generator=gen, device="cuda")
    k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
    kpos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S).contiguous()
    t = S - 1
    check("K5 O, slice shape, float32", da.decode_attention(q32, k32, v32, kpos, t=t),
          da.decode_attention_plain(q32, k32, v32, kpos, t=t), TOL["float32"])
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    err_o = check("K5 O, slice shape, bfloat16", da.decode_attention(q, k, v, kpos, t=t),
                  da.decode_attention_plain(q, k, v, kpos, t=t), TOL["bfloat16"])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = ((kpos >= 0) & (kpos <= t))[:, None, None, :]
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * kpos.numel()
    flops = 4 * B * Hq * D * S                             # every slot is valid here
    b_ms, b_by = bound(nbytes, flops)
    ms, lib_ms, dev, ev = in_turns(
        torch, lambda: da.decode_attention(q, k, v, kpos, t=t),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    row = dict(max_abs_err=err_o, ms=ms,
               plain_ms=time_ms(torch, lambda: da.decode_attention_plain(q, k, v, kpos, t=t)),
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               shape="q (4,1,32,64), k/v (4,532,8,64) bf16, t=531, full ring")
    log(f"[time] K5 at {row['shape']}: {turns_text('K5', 'SDPA', dev, ev)}; bound "
        f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms / ms:.1%} of it; {smi}")
    return row


def _time_long_cache(torch, da, gen, check, smi):
    """K5 and K6 at a long cache, granite's 4096-token context at B = 1
    (Hq 32, Hkv 8, D 64, bf16; K6 through pages of 16, shuffled): held
    against their plain versions, timed in device time beside SDPA over the
    same K/V laid out contiguously, with the share of the bound reached
    (printed only)."""
    F = torch.nn.functional
    B, S, Hkv, g, D, ps = 1, 4096, 8, 4, 64, 16
    q, kp, vp, pt, ts, kc, vc, kpos = _paged_case(
        torch, gen, B=B, ps=ps, n_max=S // ps, Hkv=Hkv, g=g, D=D, dtype=torch.bfloat16,
        ts=[S - 1])
    check("K5 O, long cache, bfloat16", da.decode_attention(q, kc, vc, kpos, t=S - 1),
          da.decode_attention_plain(q, kc, vc, kpos, t=S - 1), TOL["bfloat16"])
    check("K6 O, long cache, bfloat16", da.paged_decode_attention(q, kp, vp, pt, ts=ts),
          da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts), TOL["bfloat16"])
    kv_bytes = 2 * S * Hkv * D * 2
    flops = 4 * Hkv * g * D * S
    k5_bound, by = bound(2 * 2 * q.numel() + kv_bytes + 4 * S, flops)
    k6_bound, _ = bound(2 * 2 * q.numel() + kv_bytes + 4 * (pt.numel() + B), flops)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)  # noqa: E731
    for name, kern, b_ms in (
            ("K5", lambda: da.decode_attention(q, kc, vc, kpos, t=S - 1), k5_bound),
            ("K6", lambda: da.paged_decode_attention(q, kp, vp, pt, ts=ts), k6_bound)):
        ms, _, dev, ev = in_turns(torch, kern, sdpa)
        log(f"[time] {name} at a long cache, q (1,1,32,64), {S} keys of (8,64) bf16"
            f"{', pages of 16' if name == 'K6' else ''}: {turns_text(name, 'SDPA', dev, ev)}; "
            f"bound {b_ms * 1e3:.2f} us ({by}), {b_ms / ms:.1%} of it; {smi}")


def _time_paged(torch, da, gen, check, smi):
    """K6 at the stream's decode: 8 rows at positions 320-432 (page 16,
    31-page tables, pages shuffled), Hq 32, Hkv 8, D 64; held against its
    plain version in both dtypes, timed in bf16 in device time.  No single
    PyTorch call gathers through a page table, so there is no library time;
    SDPA over the same K/V laid out contiguously, masked, is timed beside it
    for scale.  Then K5's per-row form at the contiguous arm's decode (the
    same rows in 496-slot ring caches), the same way."""
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
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    ms, sdpa_ms, dev, ev = in_turns(
        torch, lambda: da.paged_decode_attention(q, kp, vp, pt, ts=ts), sdpa)
    rows["paged_decode_attention"] = dict(
        max_abs_err=errs["bfloat16"], ms=ms,
        plain_ms=time_ms(torch, lambda: da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"q (8,1,32,64), pool ({kp.shape[0]},16,8,64) bf16, tables (8,31), ts 320-432")
    log(f"[time] K6 at {rows['paged_decode_attention']['shape']}: "
        f"{turns_text('K6', 'SDPA on the K/V laid out contiguously', dev, ev)}; bound "
        f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms / ms:.1%} of it; {smi}")
    k5_ms, _, dev5, ev5 = in_turns(torch, lambda: da.decode_attention(q, kc, vc, kpos, t=ts),
                                   sdpa)
    k5_plain = time_ms(torch, lambda: da.decode_attention_plain(q, kc, vc, kpos, t=ts))
    # K5 reads every slot's position (no page table), and the K/V rows of
    # the valid ones
    k5_bound, _ = bound(nbytes - 4 * pt.numel() + 4 * kpos.numel(), flops)
    log(f"[time] K5's per-row form on that layout, (B, S) = ({B}, {n_max * ps}): "
        f"{turns_text('K5', 'SDPA', dev5, ev5)}; its plain version {k5_plain:.4f} ms; bound "
        f"{k5_bound * 1e3:.2f} us, {k5_bound / k5_ms:.1%} of it; {smi}")
    return rows


def _time_backward(torch, fa, gen, check):
    """K2, K3 and K4 at the training slice's attention: q (4,1024,32,64),
    k/v (4,1024,8,64), causal; held against their plain versions in f32 and
    bf16, timed in bf16 in device time (``device_ms``), their CUDA-event
    times printed beside.  The library yardstick of K3 and K4 is the
    backward of ``scaled_dot_product_attention`` alone, which computes dQ,
    dK and dV together: one forward, then ``autograd.grad`` with
    ``retain_graph`` per call, in device time.  K2's is
    ``torch.linalg.vecdot(o, do, dim=-1)``, one pass over the same bytes
    (its output is bf16 and (B, Sq, Hq): a yardstick of time only), in
    turns with K2, with the share of K2's bound reached.  The same at head
    dims 128 and 120 (printed only)."""
    F = torch.nn.functional
    B, S, Hq, Hkv = 4, 1024, 32, 8
    rows = {}
    for D in (64, 128, 120):
        q32, do32 = (torch.randn((B, S, Hq, D), generator=gen, device="cuda") for _ in range(2))
        k32, v32 = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda") for _ in range(2))
        errs = {}
        for dtype in ((torch.float32, torch.bfloat16) if D == 64 else (torch.bfloat16,)):
            name = str(dtype).split(".")[-1]
            q, do, k, v = (x.to(dtype) for x in (q32, do32, k32, v32))
            o, lse = fa.flash_fwd(q, k, v, causal=True)
            delta = fa.flash_delta_plain(o, do)
            errs["flash_delta"] = check(f"K2 delta, D={D}, {name}", fa.flash_delta(o, do),
                                        delta, TOL[name])
            errs["flash_dq"] = check(f"K3 dQ, D={D}, {name}",
                                     fa.flash_dq(q, k, v, do, lse, delta, causal=True),
                                     fa.flash_dq_plain(q, k, v, do, lse, delta, causal=True),
                                     TOL[name])
            dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=True)
            dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=True)
            errs["flash_dkv"] = max(check(f"K4 dK, D={D}, {name}", dk, dk_ref, TOL[name]),
                                    check(f"K4 dV, D={D}, {name}", dv, dv_ref, TOL[name]))
        # bf16 now: q, do, k, v, o, lse, delta of the last pass
        pairs = S * (S + 1) // 2                          # causal (q, k) pairs
        prod = 2 * B * Hq * D * pairs                     # one (q, k, d) product
        qb, kb = 2 * q.numel(), 2 * k.numel()             # bytes of a q-/k-shaped bf16 tensor
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
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                               retain_graph=True)
        # in turns: the kernels, SDPA's backward, SDPA's backward, the kernels
        dev = {n: [device_ms(torch, kern)] for n, (kern, _) in calls.items()}
        lib = [device_ms(torch, sdpa_bwd), device_ms(torch, sdpa_bwd)]
        for n, (kern, _) in calls.items():
            dev[n].append(device_ms(torch, kern))
        ev = {n: time_ms(torch, kern) for n, (kern, _) in calls.items()}
        ev_lib = time_ms(torch, sdpa_bwd)
        k2_ms, vecdot_ms, dev2, ev2 = in_turns(torch, calls["flash_delta"][0],
                                               lambda: torch.linalg.vecdot(o, do, dim=-1))
        b2_ms = bounds["flash_delta"][0]
        log(f"[time] K2 at O/dO (4,1024,32,{D}) bf16, runs of {fa.delta_split(4, 1024, 32)}: "
            f"{turns_text('K2', 'vecdot', dev2, ev2)}; bound {b2_ms * 1e3:.2f} us (bytes), "
            f"{b2_ms / k2_ms:.1%} of it")
        dev["flash_delta"] = [dev2[0], dev2[3]]
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True).detach()
        ev_old = (time_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            (qt, kt, vt), dot)) - time_ms(torch, sdpa_fwd))
        lib_ms = sum(lib) / 2
        ms = {n: sum(t) / 2 for n, t in dev.items()}
        whole = sum(ms.values())
        here = f"q (4,1024,32,{D}), k/v (4,1024,8,{D}) bf16, causal"
        for n, (kern, plain) in calls.items():
            b_ms, b_by = bounds[n]
            log(f"[time] {n} at {here}: device time {dev[n][0]:.4f} / {dev[n][1]:.4f} ms "
                f"(turns), CUDA events {ev[n]:.4f} ms; bound {b_ms * 1e3:.2f} us ({b_by}), "
                f"{ms[n] / b_ms:.1f}x it")
            if D == 64:
                rows[n] = dict(max_abs_err=errs[n], ms=ms[n],
                               plain_ms=time_ms(torch, plain, iters=10),
                               library_ms=vecdot_ms if n == "flash_delta" else lib_ms,
                               bound_ms=b_ms, bound_by=b_by, shape=here)
        log(f"[time] flash backward as a whole (K2 + K3 + K4) at {here}: device time "
            f"{whole:.4f} ms; SDPA's backward alone {lib[0]:.4f} / {lib[1]:.4f} ms "
            f"({whole / lib_ms:.2f}x SDPA); CUDA events: K2 + K3 + K4 "
            f"{sum(ev.values()):.4f} ms, SDPA's backward alone {ev_lib:.4f} ms, and as "
            f"forward + backward minus forward {ev_old:.4f} ms")
    return rows


def phase_rmsnorm_sweep(torch, build, rn, ops, flags):
    """K7 against its plain version over the reference test's shapes, one
    row, a prime row count, d 2047/2048/8192, granite's training activations
    (8192 x 2048) and a 1-D x; eps 1e-6 and 1e-5; bf16 and f32.  Then
    ``ops.rmsnorm``'s dispatch: one counted launch with the flag on, none
    with it off."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    worst = {dt: 0.0 for dt in RMS_TOL}
    failures, n = [], 0
    for shape in RMS_SHAPES:
        for eps in (1e-6, 1e-5):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                scale = 1 + 0.5 * torch.randn(shape[-1], generator=gen, device="cuda")
                y = rn.rmsnorm(x, scale, eps=eps)
                y_ref = rn.rmsnorm_plain(x, scale, eps=eps)
                torch.cuda.synchronize()
                name = str(dtype).split(".")[-1]
                err, ok = close(y, y_ref, RMS_TOL[name])
                worst[name] = max(worst[name], err)
                n += 1
                if not ok or y.dtype != dtype or y.shape != x.shape:
                    failures.append(f"{shape} eps={eps} {name}: err {err:.3g}, {y.dtype} "
                                    f"{tuple(y.shape)}")
    for name, err in worst.items():
        log(f"[K7 sweep] {name}: max |y - plain| {err:.3g} ({rule(RMS_TOL[name])})")
    require(not failures, f"K7 disagrees with its plain version in {len(failures)} of {n} "
            f"cases:\n  " + "\n  ".join(failures[:20]))
    log(f"[K7 sweep] {n} cases agree (shapes {list(RMS_SHAPES)})")
    x = torch.randn((64, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.ones(2048, device="cuda")
    counts = {}
    for on in (False, True):
        with flags.flag_ctx(fused_rmsnorm=on):
            build.launch_counts.clear()
            y = ops.rmsnorm(x, scale)
            torch.cuda.synchronize()
            counts[on] = build.launch_counts.get("rmsnorm", 0)
            require(bool(torch.isfinite(y).all()), "ops.rmsnorm gave non-finite values")
    log(f"[K7 dispatch] ops.rmsnorm on a CUDA tensor launches K7 {counts[True]} time(s) with "
        f"fused_rmsnorm on, {counts[False]} with it off")
    require(counts == {False: 0, True: 1}, f"ops.rmsnorm dispatch counted {counts}")


def _time_rmsnorm(torch, rn, gen, check, smi):
    """K7 at granite's training activations, x (8192, 2048) bf16, scale f32:
    held against its plain version in both dtypes, timed in bf16 in device
    time, in turns with ``torch.nn.functional.rms_norm`` (with the scale cast
    to bf16, the dtype its fused kernel needs; timed only here), the
    CUDA-event times beside; its plain version in CUDA events."""
    import warnings
    F = torch.nn.functional
    rows, d = 8192, 2048
    x32 = torch.randn((rows, d), generator=gen, device="cuda")
    scale = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    check("K7 y, training activations, float32", rn.rmsnorm(x32, scale),
          rn.rmsnorm_plain(x32, scale), RMS_TOL["float32"])
    x = x32.to(torch.bfloat16)
    err = check("K7 y, training activations, bfloat16", rn.rmsnorm(x, scale),
                rn.rmsnorm_plain(x, scale), RMS_TOL["bfloat16"])
    nbytes = 2 * 2 * x.numel() + 4 * d                 # x read, y written, scale read
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 4 * x.numel() / H100_F32_FLOP_PER_S * 1e3  # square, add, two multiplies (f32)
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    sb = scale.to(x.dtype)
    ms, lib_ms, dev, ev = in_turns(torch, lambda: rn.rmsnorm(x, scale),
                                   lambda: F.rms_norm(x, (d,), weight=sb, eps=1e-6), n=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")                # mixed dtypes: the unfused path
        mixed = device_ms(torch, lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6))
    row = dict(max_abs_err=err, ms=ms, plain_ms=time_ms(torch, lambda: rn.rmsnorm_plain(x, scale)),
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               shape="x (8192,2048) bf16, scale (2048,) f32")
    log(f"[time] K7 at {row['shape']}: {turns_text('K7', 'F.rms_norm', dev, ev)}; bound "
        f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms / ms:.1%} of it; for scale only, F.rms_norm "
        f"with the f32 scale as it is (mixed dtypes, unfused): device time {mixed:.4f} ms; {smi}")
    return {"rmsnorm": row}


def phase_train_cli(torch, build, store, train_loop, launch_train, infer, TrainSession,
                    InMemoryTracker, stepfn, ParallelismConfig, DataConfig, smi):
    """The training CLI at full width, ``CLI["n_layers"]`` layers (the disk
    cap, see ``CLI``), in this process so that launches are counted:
    ``--fail-at 6`` must end in the injected crash with a checkpoint at step
    4; the same command without it resumes there, and the losses of steps 4
    and 5 must equal the crashed run's.  The config is cut through the
    session's ``get_config``; the store's calls and the background writer
    are timed through wrappers, and every logged step is recorded with its
    time by a tracker handed to ``run``.  Bare ``step()`` on the same config
    and batch is timed first, for the loop's overhead."""
    import gc
    import shutil
    c = CLI
    cfg = dataclasses.replace(infer.get_config(c["arch"]), n_layers=c["n_layers"])
    sess = TrainSession(cfg, seed=0, plan=ParallelismConfig(gas=c["gas"]),
                        train_cfg=stepfn.TrainConfig(total_steps=c["steps"], warmup=1),
                        data_cfg=DataConfig(seq_len=c["seq"], global_batch=c["batch"]))
    walls = []
    for i in range(4):
        sess.batches(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(sess.step()["loss"])
        walls.append(time.perf_counter() - t0)
    bare_step_ms = sum(walls[1:]) / 3 * 1e3
    del sess
    torch.cuda.empty_cache()
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free = shutil.disk_usage(d).free
    log(f"[cli] checkpoints under {d}: {free / 1e9:.1f} GB free on its disk")
    argv = ["--arch", c["arch"], "--seq", str(c["seq"]), "--batch", str(c["batch"]),
            "--gas", str(c["gas"]), "--steps", str(c["steps"]), "--ckpt-every",
            str(c["ckpt_every"]), "--ckpt-dir", str(d)]
    timings = {"snapshot_s": [], "write_s": [], "restore_s": []}
    trackers = []

    class TimedTracker(InMemoryTracker):
        def log_metrics(self, step, metrics):
            super().log_metrics(step, metrics)
            self.rows[-1]["t"] = time.perf_counter()

    orig = (TrainSession.run, train_loop.save_checkpoint, train_loop.restore_latest,
            store.CheckpointWriter._run, infer.get_config)

    def run(self, *a, **kw):
        trackers.append(TimedTracker())
        return orig[0](self, *a, tracker=trackers[-1], **kw)

    def save(*a, **kw):
        t0 = time.perf_counter()
        w = orig[1](*a, **kw)
        timings["snapshot_s"].append(time.perf_counter() - t0)
        return w

    def restore(*a, **kw):
        t0 = time.perf_counter()
        r = orig[2](*a, **kw)
        torch.cuda.synchronize()
        if r[0] is not None:                   # a state was restored
            timings["restore_s"].append(time.perf_counter() - t0)
        return r

    def writer_run(self, fn):
        t0 = time.perf_counter()
        orig[3](self, fn)
        timings["write_s"].append(time.perf_counter() - t0)

    TrainSession.run, train_loop.save_checkpoint, train_loop.restore_latest, \
        store.CheckpointWriter._run = run, save, restore, writer_run
    infer.get_config = lambda name: cfg if name == c["arch"] else orig[4](name)
    try:
        runs, peaks, walls, crash = [], [], [], None
        for i, extra in enumerate((["--fail-at", str(c["fail_at"])], [])):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            build.launch_counts.clear()
            t0 = time.perf_counter()
            try:
                out = launch_train.main(argv + extra)
            except RuntimeError as e:
                if i != 0 or f"injected failure at step {c['fail_at']}" not in str(e):
                    raise
                crash, out = str(e), None
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            runs.append(dict(build.launch_counts))
            peaks.append(torch.cuda.max_memory_allocated())
            if i == 0:
                require(crash is not None, "the --fail-at run did not crash")
                require(store.list_steps(d) == [c["ckpt_every"]],
                        f"after the crash the checkpoints are {store.list_steps(d)}")
                ck_bytes = sum(f.stat().st_size for f in (d / f"step_{c['ckpt_every']:08d}").iterdir())
    finally:
        TrainSession.run, train_loop.save_checkpoint, train_loop.restore_latest, \
            store.CheckpointWriter._run, infer.get_config = orig
    require(out["resumed_from"] == c["ckpt_every"], f"resumed from {out['resumed_from']}")
    steps1 = [r["step"] for r in trackers[0].rows]
    steps2 = [r["step"] for r in trackers[1].rows]
    require(steps1 == list(range(c["fail_at"])) and steps2 == list(range(4, c["steps"])),
            f"logged steps {steps1} then {steps2}")
    loss1 = {r["step"]: r["loss"] for r in trackers[0].rows}
    loss2 = {r["step"]: r["loss"] for r in trackers[1].rows}
    same = {s: loss1[s] == loss2[s] for s in (4, 5)}
    rel = max(abs(loss1[s] - loss2[s]) / abs(loss1[s]) for s in (4, 5))
    log(f"[cli] crash at step {c['fail_at']} ({crash!r}), resumed from step "
        f"{out['resumed_from']}; losses of steps 4, 5 before the crash "
        f"{[loss1[4], loss1[5]]}, after the resume {[loss2[4], loss2[5]]}: bitwise equal "
        f"{same} (max rel diff {rel:.3g})")
    require(all(same.values()), f"the resumed losses differ: {loss1} vs {loss2}")
    require(all(math.isfinite(v) for v in [*loss1.values(), *loss2.values()]),
            "non-finite losses")
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * c["gas"], "flash_delta": L * c["gas"],
            "flash_dq": L * c["gas"], "flash_dkv": L * c["gas"]}
    for counts, n in zip(runs, (len(steps1), len(steps2))):
        require(all(counts.get(k, 0) == v * n for k, v in want.items()),
                f"CLI launches {counts} over {n} steps, expected {want} per step")
    t1 = [r["t"] for r in trackers[0].rows]
    t2 = [r["t"] for r in trackers[1].rows]
    clean = [t1[2] - t1[1], t1[3] - t1[2], t2[2] - t2[1], t2[3] - t2[2]]
    step_ms = sum(clean) / len(clean) * 1e3
    snap, wr, rs = timings["snapshot_s"], timings["write_s"], timings["restore_s"]
    log(f"[cli] launches per run {runs} ({len(steps1)} and {len(steps2)} steps: K1 "
        f"{want['flash_fwd']}, K2-K4 {want['flash_dq']} a step); wall {walls[0]:.1f} s and "
        f"{walls[1]:.1f} s; peak memory {peaks[0]} B and {peaks[1]} B "
        f"({max(peaks) / 1e9:.2f} GB); {smi}")
    log(f"[cli] checkpoint {ck_bytes} B ({ck_bytes / 1e9:.2f} GB) a step: snapshot to the host "
        f"(in the loop) {[round(x, 2) for x in snap]} s ({ck_bytes / snap[0] / 1e9:.2f} GB/s); "
        f"background write (sha256 + np.save + rename) {[round(x, 2) for x in wr]} s "
        f"({ck_bytes / wr[0] / 1e9:.3f} GB/s); restore (read + sha256 + to the card) "
        f"{[round(x, 2) for x in rs]} s ({ck_bytes / rs[-1] / 1e9:.3f} GB/s)")
    log(f"[cli] {cfg.name} at full width, {cfg.n_layers} layers, batch {c['batch']} x "
        f"{c['seq']}, gas {c['gas']}: ms per step inside run(): {step_ms:.1f} (steps 2-3 and "
        f"6-7, host clock between logged steps) against {bare_step_ms:.1f} ms of bare step() "
        f"on the same config (steps 1-3); step 4 (after the snapshot) "
        f"{(t1[4] - t1[3]) * 1e3:.1f} ms, step 5 while the background write runs "
        f"{(t1[5] - t1[4]) * 1e3:.1f} ms")
    require(max(peaks) < 80e9, f"peak memory {max(peaks)} B does not fit the card")
    del out
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _drill(name, make, d, FaultPlan, RetryPolicy, FleetController):
    """One scenario of ``benchmarks/run.py:resilience_bench`` through
    ``TrainSession.run``: its fault plan, cadence and step count."""
    run = dict(log_every=1, log=lambda m: None)
    if name == "skip":
        sess = make(12, dict(max_consecutive_skips=3))
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=FaultPlan(nan_grad_steps=(6,)), **run)
    elif name == "rollback":
        sess = make(16, dict(max_consecutive_skips=3, rewarm_steps=4))
        out = sess.run(16, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=FaultPlan(nan_grad_steps=(6, 7, 8)), **run)
    elif name == "crash_restart":
        crashed = False
        try:
            make(12).run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                         chaos=FaultPlan(crash_at=10), **run)
        except RuntimeError as e:
            if "injected failure at step 10" not in str(e):
                raise
            crashed = True
        require(crashed, "crash_restart: the run did not crash")
        sess = make(12)
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False, **run)
    elif name == "ckpt_retry":
        sess = make(8)
        out = sess.run(8, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=FaultPlan(ckpt_write_failures=2),
                       ckpt_retry=RetryPolicy(attempts=4, backoff_s=0.001, sleep=lambda s: None),
                       **run)
    elif name == "consensus_skip":
        sess = make(8, dict(consensus_replicas=2), dict(dp=2))
        out = sess.run(8, chaos=FaultPlan(replica_nan={4: (1,)}, replicas=2), **run)
    else:
        sess = make(12, plan_kw=dict(dp=2))
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=FaultPlan(lose_replica={7: 1}), fleet=FleetController(2), **run)
    return out, sess


def _drill_figures(name, out):
    """The scenario's figures as ``BENCH_resilience.json`` records them
    (its timings left out)."""
    ev = lambda kind: next(e for e in out["events"] if e.kind == kind).detail
    if name == "skip":
        return {"injected_nan_steps": 1, "steps_skipped": out["skipped_steps"],
                "rollbacks": out["rollbacks"]}
    if name == "rollback":
        return {k: ev("rollback")[k] for k in ("steps_lost", "data_skipped", "rewarm_steps")}
    if name == "crash_restart":
        return {"crash_at": 10, "resumed_from": out["resumed_from"],
                "steps_lost": 10 - out["resumed_from"]}
    if name == "ckpt_retry":
        return {"injected_failures": 2, "retry_attempts": 4,
                "write_gave_up": sum(e.kind == "ckpt_write_failed" for e in out["events"]),
                "resumable": out["resumed_from"] is None}
    if name == "consensus_skip":
        return {"replicas": 2, "injected_divergent_replicas": 1,
                "steps_skipped": out["skipped_steps"],
                "verdict": "masked" if not out["skipped_steps"] else "skipped"}
    return {"lost_replica_at_step": 7, "replans": out["replans"], "new_dp": out["plan"].dp,
            "steps_lost": ev("replan")["steps_lost"]}


def _events(out):
    return [(e.step, e.kind) for e in out["events"] if e.kind != "straggler"]


def _drill_maker(torch, TrainSession, stepfn, ParallelismConfig, DataConfig, ResilienceConfig,
                 cfg, **data):
    def make(steps, rs_kw=None, plan_kw=None):
        return TrainSession(
            cfg, seed=0, plan=ParallelismConfig(**(plan_kw or {})),
            train_cfg=stepfn.TrainConfig(peak_lr=DRILL["lr"], warmup=2, total_steps=steps,
                                         resilience=ResilienceConfig(**(rs_kw or {}))),
            data_cfg=DataConfig(seq_len=data.get("seq", DRILL["seq"]),
                                global_batch=data.get("batch", DRILL["batch"])))
    return make


def phase_drills(torch, get_config, TrainSession, stepfn, ParallelismConfig, DataConfig,
                 ResilienceConfig, FaultPlan, RetryPolicy, FleetController, smi):
    """The six resilience drills at granite's full width, ``DRILL["n_layers"]``
    layer(s) (the disk cap, see ``CLI``), bf16, on the card, with
    resilience_bench's fault plans, cadences, step counts and data (batch 8
    x 128, peak LR 1e-3): each figure must equal the benchmark's (CPU runs
    of the reference).  Then the in-step detection on vs off, ms per
    step."""
    import shutil
    cfg = dataclasses.replace(get_config(DRILL["arch"]), n_layers=DRILL["n_layers"])
    make = _drill_maker(torch, TrainSession, stepfn, ParallelismConfig, DataConfig,
                        ResilienceConfig, cfg)
    bench = json.loads((ROOT / "BENCH_resilience.json").read_text())["scenarios"]
    root = ROOT / "build" / "chip_smoke_drills"
    for name in DRILLS:
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, sess = _drill(name, make, str(d), FaultPlan, RetryPolicy, FleetController)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _drill_figures(name, out)
        want = {k: v for k, v in bench[name].items() if k in got}
        losses = [h["loss"] for h in out["history"]]
        steps = [p for p in d.glob("step_*") if p.is_dir()] if d.exists() else []
        size = sum(f.stat().st_size for f in steps[0].iterdir()) if steps else 0
        log(f"[drill] {name}: {got}; events {_events(out)}; {len(losses)} steps, losses "
            f"{losses[0]:.4f} .. {losses[-1]:.4f}; {wall:.1f} s; checkpoint {size} B; {smi}")
        require(got == want, f"drill {name}: {got}, the benchmark's {want}")
        require(math.isfinite(losses[-1]), f"drill {name}: final loss {losses[-1]}")
        del out, sess
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    log(f"[drill] {cfg.name} at full width, {cfg.n_layers} layers: all {len(DRILLS)} drills give "
        f"the benchmark's figures")
    ms = {}
    for label, kw in (("off", dict(enabled=False)), ("on", {}), ("off", dict(enabled=False)),
                      ("on", {})):
        sess = make(16, kw)
        float(sess.step()["loss"])                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            float(sess.step()["loss"])
        ms.setdefault(label, []).append((time.perf_counter() - t0) / 8 * 1e3)
        del sess
        torch.cuda.empty_cache()
    on, off = min(ms["on"]), min(ms["off"])
    log(f"[drill] detection (anomaly signals + skip gate) on vs off, {cfg.n_layers} layers, "
        f"batch {DRILL['batch']} x {DRILL['seq']}, ms per step (off, on, off, on): "
        f"off {ms['off']}, on {ms['on']}; best {on:.2f} vs {off:.2f} ms "
        f"({on / off - 1:+.1%}); {smi}")


def phase_drills_f32_identity(torch, get_config, TrainSession, stepfn, ParallelismConfig,
                              DataConfig, ResilienceConfig, FaultPlan, RetryPolicy,
                              FleetController):
    """granite's attention and MLP widths, ``F32_DRILL``'s layer count and
    vocabulary (the disk cap, see ``CLI``), f32: the rollback and consensus
    drills with the kernels and with their plain versions give the same
    events (``straggler`` left out), losses within 1e-5 relative and params
    within 1e-4."""
    import shutil
    from repro_torch.core.tree import tree_leaves
    cfg = dataclasses.replace(get_config(DRILL["arch"]), **F32_DRILL)
    make = _drill_maker(torch, TrainSession, stepfn, ParallelismConfig, DataConfig,
                        ResilienceConfig, cfg)
    root = ROOT / "build" / "chip_smoke_f32_drills"
    for name in ("rollback", "consensus_skip"):
        res = {}
        for plain in (False, True):
            shutil.rmtree(root, ignore_errors=True)
            with plain_versions() if plain else contextlib.nullcontext():
                out, sess = _drill(name, make, str(root), FaultPlan, RetryPolicy,
                                   FleetController)
            res[plain] = (out, sess.state["params"])
            del sess
        (ok_, pk), (op, pp) = res[False], res[True]
        lk = [h["loss"] for h in ok_["history"]]
        lp = [h["loss"] for h in op["history"]]
        rel = max((abs(a - b) / abs(b) for a, b in zip(lk, lp) if math.isfinite(b)), default=0.0)
        same_nan = [math.isfinite(a) for a in lk] == [math.isfinite(b) for b in lp]
        errs = [close(a, b, 1e-4) for (_, a), (_, b) in zip(tree_leaves(pk), tree_leaves(pp))]
        worst = max(e for e, _ in errs)
        log(f"[f32 drill] {name}, {cfg.name}, {cfg.n_layers} layer(s), vocab {cfg.vocab_size}, "
            f"f32: events kernel "
            f"{_events(ok_)}, plain {_events(op)}; losses max rel diff {rel:.3g} (tol 1e-5); "
            f"params max |kernel - plain| {worst:.3g} ({rule(1e-4)})")
        require(_events(ok_) == _events(op), f"f32 drill {name}: events differ")
        require(same_nan and rel <= 1e-5, f"f32 drill {name}: losses differ by {rel:.3g}")
        require(all(ok for _, ok in errs), f"f32 drill {name}: params differ by {worst:.3g}")
        del res
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


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
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.checkpoint import RetryPolicy, store
    from repro_torch.core import stepfn
    from repro_torch.core.recipe import ParallelismConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import flags, train_loop
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.fleet import FleetConfig, FleetController
    from repro_torch.runtime.resilience import ResilienceConfig
    from repro_torch.session import EvalSession, InferenceSession, TrainSession, infer
    from repro_torch.session.tracker import InMemoryTracker

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

    seconds = {}

    def timed(name, fn, *args, **kw):
        """Run a phase and log its seconds (host clock, synchronized)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {seconds[name]:.1f} s")
        return out

    timed("2 build", phase_build, build)
    timed("3 K1 sweep", phase_flash_sweep, torch, fa)
    timed("3 K2-K4 sweep", phase_flash_bwd_sweep, torch, fa)
    timed("4 K5 sweep", phase_decode_sweep, torch, da)
    timed("4 K6 sweep", phase_paged_sweep, torch, da)
    timed("4 K7 sweep", phase_rmsnorm_sweep, torch, build, rn, ops, flags)
    serve_launches = timed("5 generate", phase_slice, torch, np, build, fa, da,
                           InferenceSession, tree_map)
    timed("6 f32 generate", phase_f32_identity, torch, np, fa, da, get_config, InferenceSession)
    stream_launches = timed("7 stream", phase_stream, torch, np, build, InferenceSession,
                            tree_map, smi)
    timed("8 f32 stream", phase_stream_f32_identity, torch, np, fa, da, get_config,
          InferenceSession)
    eval_launches = {}
    train_launches, train_measured = timed(
        "9 train + eval", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi,
        after=lambda sess, floor: eval_launches.update(
            phase_eval(torch, build, EvalSession, sess, floor)))
    timed("10 f32 train", phase_train_f32_identity, torch, fa, da, get_config, TrainSession,
          stepfn, ParallelismConfig, DataConfig)
    cli_launches = timed("11 training CLI", phase_train_cli, torch, build, store, train_loop,
                         launch_train, infer, TrainSession, InMemoryTracker, stepfn,
                         ParallelismConfig, DataConfig, smi)
    # the replica_loss_replan drill's fleet keeps its loss arm and loses the
    # wall-time straggler arm (a step over 2x the fleet median, 3 in a row),
    # as the CPU tests' fleets do: the chaos-driven loss at step 7 decides
    fleet = functools.partial(FleetController, cfg=FleetConfig(straggler_factor=float("inf")))
    drill_args = (torch, get_config, TrainSession, stepfn, ParallelismConfig, DataConfig,
                  ResilienceConfig, FaultPlan, RetryPolicy, fleet)
    timed("12 drills", phase_drills, *drill_args, smi)
    timed("13 f32 drills", phase_drills_f32_identity, *drill_args)
    dense_launches = timed("15 dense arm", phase_dense, torch, np, build, get_config,
                           InferenceSession, tree_map, smi)
    h2o_stream_launches = timed("16 h2o stream", phase_dense_stream, torch, np, build,
                                InferenceSession, smi)
    h2o_train_launches, h2o_measured = timed(
        "17 h2o train", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_H2O, tag="h2o train")
    planning = timed("19 planning", phase_planning, torch, get_config, ParallelismConfig, smi,
                     {"train": train_measured, "h2o train": h2o_measured})
    for arch, n_layers in F32_DENSE:
        timed(f"18 f32 generate {arch}", phase_f32_identity, torch, np, fa, da, get_config,
              InferenceSession, arch, n_layers)
        timed(f"18 f32 train {arch}", phase_train_f32_identity, torch, fa, da, get_config,
              TrainSession, stepfn, ParallelismConfig, DataConfig, arch, n_layers)
    timing = timed("14 timing", phase_timing, torch, fa, da, rn, smi)
    log(f"[phase] all phases {sum(seconds.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

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
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:17"),
    ]
    # launches: the counted main-path runs: the served generate, one train
    # step, the stream on each arm, the training CLI's crashed and resumed
    # runs, the eval sweep, and the dense arm's: each model's prefill and
    # generate, h2o's stream on each arm and one h2o train step.  K7 is
    # reached only through ops.rmsnorm under the fused_rmsnorm flag, as in
    # the reference, so no main path launches it
    runs = [serve_launches, train_launches, *stream_launches.values(), *cli_launches,
            eval_launches, *(c for pair in dense_launches.values() for c in pair),
            *h2o_stream_launches.values(), h2o_train_launches]
    log(f"[launches] generate {serve_launches}; train step {train_launches}; stream "
        f"{stream_launches}; training CLI (crashed, resumed) {cli_launches}; eval sweep "
        f"{eval_launches}; dense arm (prefill, generate) {dense_launches}; h2o stream "
        f"{h2o_stream_launches}; h2o train step {h2o_train_launches}")
    for kr in kernels:
        r = timing[kr["name"]]
        n = sum(c.get(kr["name"], 0) for c in runs)
        kr.update(launches=n, max_abs_err=r["max_abs_err"],
                  ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r["library_ms"])
    log(f"[env] card: {smi}")
    print(json.dumps({"planning": planning}), flush=True)
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
