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
   over head groupings (h2o-danube's 32/8 and internvl2's 14/2 among them),
   head dims 16, 64, 96,
   120 and 128, lengths 128/200/500 (ragged to its 128-row tiles), masks and
   dtypes;
   and non-causal over queries and keys of two lengths (200 over 500, and
   Whisper's 448 over 1500 at 8/8 heads);
   then K2, K3 and K4 (flash backward: delta, dQ, dK and dV) the same way,
   over the edges of their tiles (lengths 200/500/1024, windows of 64 and
   16, MHA and GQA 4/1, 8/2, 32/8, 14/2), and two launches of K2, of K3 and
   of K4
   on equal inputs must give equal bits; K2 alone over a ragged length (1000)
   at head dims 64, 96, 120 and 128, one position, 40 heads, h2o's training
   shape, a long prompt and strided inputs, each launched twice for equal
   bits; and the autograd ``FlashAttention`` against autograd through K1's
   plain version;
4. holds K5 (decode attention) against its plain version the same way (GQA
   groups of 1, 4 and internvl2's 7), and
   over long caches that span many of its splits (4096 and 4100 slots at
   B 1 and 4; full, wrapped, and not full so that whole splits are empty;
   a window that excludes whole splits; g 1 at D 128);
   then K6 (paged decode attention) against its plain version over page
   sizes 16/64/128, head groupings (7 among them), head dims, windows and
   dtypes (pages
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
20. (run after 19; phases 20-22, 25 and 26 run their ranks in one world
   of two processes, and 21, 22 and 29 theirs in one world of four, each
   phase in turn: a world costs ~12 s to start.  This process computes
   20-22's references first, then runs the two worlds, then checks each
   phase; 25, 26 and 29 check theirs in their turn) tensor parallelism at
   tp = 2 as two processes on the one card (``torch.multiprocessing``
   spawn, gloo over localhost, both on ``cuda:0``; NCCL takes one rank per
   card), each result held to tp = 1 on the same card and seed, computed
   first in this process: granite-3-2b
   (GQA 32/8 heads, 16/4 a rank; its 49155-token table left whole) and
   gpt-3.6b (MHA; a vocab-parallel tied table) at published width and depth
   through ``InferenceSession.generate`` (bf16: the first token equal, the
   agreement by step printed) and gpt-3.6b's ``prefill`` (phase 5's rule);
   both at 2 layers in f32 (tokens over 16 steps equal, prefill logits
   within 1e-4 of the largest); gpt-3.6b training at 2 of 30 layers (2 x
   1024 a micro-batch, gas 2, remat full) one step in f32 without and with
   sequence parallel (loss 1e-5 relative, every parameter 1e-5 but for
   Adam's noise-floor entries), then one bf16 step.  Each run's K1-K5
   launches and the head counts they ran at (16/4 and 16/16), and its
   collectives by kind (``core/tp.py``'s counter) are exact, beside the
   cost model's 4 all-reduces a layer; the compute mode must not be
   ``Exclusive_Process``; times are labelled as two time-sliced ranks;
21. (run after 20) sharded data parallelism at dp = 2 as two processes on
   the one card, as 20 runs them: gpt-3.6b at published width, 1 of 30
   layers, 4 x 1024 tokens in 2 micro-batches, remat full, bf16 over f32
   masters, one counted step after a first at ZeRO 0, 1, 2 and 3, then
   ``overlap_zero`` at stage 2 and ``gather_params_once`` at stage 3 (the
   GAS path, consensus off): each rank's peak memory beside
   ``core.memory.per_device_bytes``, the collectives by kind and group
   exact (``expected_dp_collectives``) beside the cost model's ``t_dp``
   bytes, K1-K4 launches exact, host and event times labelled as
   time-sliced ranks; the vote (the reference's default) at every stage
   with NaN in replica 0, in replica 1 (masked, not skipped) and in both
   (skipped, params frozen), the ranks' bits equal; the f32 identities at
   1 layer and a 4096-token vocabulary (every stage against one device
   with 2 simulated replicas, 1e-5, and ZeRO 1-3 against ZeRO 0's bits);
   tp = 2 x dp = 2 as four ranks at ZeRO-1 (f32 identity at 2 layers and
   the whole vocabulary, and a bf16 step); a ZeRO-3 crash ->
   resume of ``TrainSession.run`` (bitwise against a run that never
   crashed, the ranks' events equal) and its checkpoint restored on one
   device (the same loss);
22. (run after 21) pipeline parallelism at pp = 2 as two processes on the
   one card, as 20 and 21 run them: gpt-3.6b at published width, 4 of 30
   layers (1 a chunk at vpp 2), 8 x 1024 tokens in 4 micro-batches (mbs
   2), remat full, bf16 over f32 masters, one counted step (at vpp 1 after
   a first), at vpp 1, vpp 2 and vpp 2 under remat "stage", then vpp 1 at
   gas 8 (16 x 1024): each rank's K1-K4 launches exact (K1 2 a layer of its stage a
   micro-batch, 3 under remat "stage"; K2-K4 1), its messages over the pp
   line and their bytes exact (``expected_pp_p2p``) beside the cost model's
   ``t_pp`` bytes, the schedule's activations in flight exact (min(gas, pp -
   p) for 1F1B, the interleaved formula), peak memory beside
   ``per_device_bytes``, stage 0's peak at gas 8 within one micro-batch's
   stash of its peak at gas 4, times labelled as time-sliced ranks; the
   per-token losses after the first step against pp = 1's (computed first
   in this process) within 2x bf16's own error; the f32 identities at 4
   layers and a 4096-token vocabulary (vpp 1 and 2 against one device at
   the same plan, the stages in one process, and against pp = 1: loss 1e-5
   relative, params 1e-5 but for Adam's noise floor) with the leaves every
   stage holds equal in bits on every rank; pp 2 x dp 2 as four ranks at ZeRO-1 (the f32 identity and
   a bf16 step, counted).  No checkpoint on the card (the run's disk writes
   are spent): the pipeline's checkpoint and re-plan are held on the CPU;
23. (run after 22) the MoE family at published width, bf16:
   olmoe-1b-7b at full depth (16 layers): ``generate`` of 4 x 128
   prompts, 32 new tokens (K5 once a layer a position: the prompt goes in
   through the decode scan, no K1), ``prefill(last_only=False)`` (K1 once
   a layer) with the kernels, their plain versions and the plain versions
   on an f32 copy (phase 5's rule), the routing choices that differ
   between those paths counted, a stream of 8 requests on 4 slots (K5 a
   layer a decode step and a layer a prompt token at admission); 3 training
   steps at 4 of its 16 layers, 4 x 1024, remat full (phase 9's checks,
   the load-balance loss finite and > 0, peak memory beside
   ``per_device_bytes``) and ``EvalSession.perplexity``; the f32 identities
   of 6 and 10 at 2 layers; then deepseek-moe-16b at full depth (28
   layers): the block-by-block build, ``generate`` of 4 x 64 prompts, 16
   new tokens, and ``prefill``, launches exact, peak memory of the build
   and of the run beside 80 GB; ms a decode step and a training step; two
   bf16 runs of 2 olmoe steps (2 layers) equal in bits;
24. (run after 23) the VLM family at published width and depth, bf16:
   internvl2-1b (24 layers, GQA 14/2, vocab 151655) over [256 random vision
   embeddings; 256 text tokens]: ``prefill`` (K1 once a layer; held to
   phase 5's rule), the cache-populating prefill of the same batch and 32
   decode steps (K1 once a layer, K5 once a layer a step), a decode step's
   host and device time, ``generate`` (text only) at B 8, a stream on 4
   contiguous slots, ``paged=True`` refused; 3 training steps, 8 x 1024
   in 2 micro-batches (phase 9's checks; peak memory beside
   ``per_device_bytes``; the f32 unembed's device time against the step's);
   K1-K5 at its shapes (a group of 7) timed beside their bounds, plain
   versions and SDPA; the f32 identities of 6 and 10 at 2 layers;
25. (its ranks in the world of two, after 22's; checked after 24) the MoE
   family under pipeline parallelism: olmoe at published width, 4 of 16
   layers, pp = 2 as two processes on the one card (as 22), 4 x 1024 tokens in 4 micro-batches, remat full, vpp 1 and
   2: in f32 the mesh's loss, xent and load-balance loss equal the
   one-device pipeline's bit for bit; in bf16 one counted step (K1-K4
   launches and the messages over the pp line exact, in flight, peak
   memory beside ``per_device_bytes``), then the plain versions and the
   kernels on the plain run's routes (``routing(replay=)``): loss, xent and
   aux within 2e-2;
26. (run after 25) the hybrid family at published width, bf16: hymba-1.5b
   (32 layers, d 1600, 25/5 heads of 64, 25 SSM heads of 128 channels,
   state 16, vocab 32001; a window of 1024 but on layers 0, 16 and 31) at
   full depth: ``generate`` at B 4 of a 64-token prompt and 64 new tokens
   (the prompt through the decode scan: K5 once a layer a position, no
   K1), a decode step's host and device time, ``prefill`` at 2 x 2048 (the
   window binds; K1 once a layer) held to phase 5's rule, a stream on 4
   contiguous slots (K5 a layer a decode step and a layer a prompt token),
   ``paged=True`` refused; 3 training steps at full depth, 4 x 2048 in one
   micro-batch, remat full (phase 9's checks; peak memory beside
   ``per_device_bytes``); K1-K5 at its shapes (a group of 5; K1-K4 with
   the window and without, K5 over a 1024-slot and a 128-slot ring) timed
   beside their bounds, plain versions and SDPA; the f32 identities of 6
   and 10 at 4 layers (global 0, 2, 3; SWA 1); pp = 2 as two ranks on the
   card at 8 layers, vpp 1 and 2: the f32 loss and xent equal the
   one-device pipeline's in bits, one bf16 step of vpp 2 counted (launches
   and messages exact);
27. (run after 26) the xLSTM family at published width and depth, bf16:
   xlstm-125m (12 layers, d 768, 4 heads, sLSTM at 1 and 3, an mLSTM
   inner width of 1536, vocab 50304): ``generate`` at B 4 of a 64-token
   prompt and 64 new tokens (the prompt through the decode scan), a decode
   step's host and device time, ``prefill`` at 2 x 1024 (8 mLSTM chunks),
   and at 4 layers in f32 its last-position logits held to the decode
   scan's over the same 1024 positions (1e-4 relative), a stream on 2
   contiguous slots,
   ``paged=True`` refused; 3 training steps, 4 x 1024, remat full (phase
   9's checks; peak memory beside ``per_device_bytes``); every run
   launches no kernel (no attention); in f32 at 4 layers (mLSTM, sLSTM,
   mLSTM, sLSTM) one training step on the card against the same step on
   the CPU (loss and grad_norm 1e-5 relative, params 1e-4);
28. (run after 27) the encoder-decoder family at published width and
   depth, bf16: whisper-base (6 + 6 layers, d 512, 8 heads of 64, 1500
   random frames from seed 0): ``generate`` at B 4 of a 16-token prompt
   and 64 new tokens over frames (K1 once an encoder layer at the cache
   init, K5 once a decoder layer a position; the cross K/V read through
   the masked einsum, as the reference's), ``prefill`` at 4 x 448 (K1 18:
   the encoder non-causal, the decoder causal and its cross-attention, 448
   queries over 1500 keys) held to phase 5's rule, a stream on 2
   contiguous slots over the stub frames; 3 training steps, 8 x 448 over
   1500 frames, remat full (K1 36, K2-K4 18 each a step; phase 9's
   checks); K1-K4 at the encoder's and the cross shapes
   and K5 over the decoder's ring timed beside their bounds, plain
   versions and SDPA; the f32 identity at 2 + 2 layers (tokens and prefill
   logits of kernels and plain versions);
29. (run after 28) every family under the paper's tp and dp, as ranks
   time-sliced on the card over gloo, each held to one device on the same
   card and seeds (the references first, in this process): hymba-1.5b at
   tp 5 in a world of five (5/1 attention heads and 5 SSM heads a rank, a
   GQA group of 5; its d_ff of 5504 whole on every rank) at published
   width, ``generate`` and ``prefill`` (2 x 1280) at full depth, the f32
   tokens and one f32 step at 4 of 32 layers (a global layer and a
   windowed one), and so that the full depth is held in f32 too, the
   ``prefill`` of the same weights in f32 at full depth within 1e-4 of the
   largest logit plus 2x what one f32 rounding of one device's embedding
   (either way) moves its logits; xlstm-125m and whisper-base at tp 2 x dp 2 in the
   world of four at full depth (``generate``, ``prefill``, the f32 tokens
   and one f32 step at ZeRO-3).  The f32 tokens exact, the f32 step's loss
   1e-5 relative, the bf16 prefill logits and the first token's logits
   within 2x the bf16 floor and the first token equal wherever one
   device's top-1 margin exceeds that; K1-K5's launches exact at the local
   heads;
   collectives by group and bytes beside the cost model's ``t_tp`` and
   ``t_dp``, peak memory a rank beside ``per_device_bytes`` (reported);
30. prints each phase's seconds, a ``{"planning": {...}}`` line, a
   ``{"tp": {...}}`` line, a ``{"dp": {...}}`` line, a ``{"pp": {...}}``
   line, a ``{"families": {...}}`` line, a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

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
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

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
# phase 23: the MoE family.  olmoe served at full depth, its stream's 8
# prompt lengths distinct (each admission its own decode scan), trained at
# 4 of 16 layers (~1.78 B parameters); deepseek served at full depth
MOE = dict(arch="olmoe_1b_7b", batch=4, prompt_len=128, new_tokens=32, slots=4,
           stream_lens=(19, 32, 11, 45, 25, 38, 6, 51), stream_gens=(24, 8, 16, 8, 32, 8, 12, 16))
TRAIN_OLMOE = dict(arch="olmoe_1b_7b", n_layers=4, seq_len=1024, global_batch=4, gas=1, steps=3)
MOE_BIG = dict(arch="deepseek_moe_16b", batch=4, prompt_len=64, new_tokens=16)
# phase 24: the VLM family.  internvl2-1b at full depth (24 layers, GQA 14/2:
# 7 query heads a KV head) serves [256 vision embeddings; 256 text tokens]:
# the prefill, the cache-populating prefill and 32 decode steps, generate
# (text only) at B 8 and a short stream on contiguous slots; it trains at
# full depth, 8 x 1024 tokens in 2 micro-batches (each 4096 tokens x 151655
# f32 logits, 2.5 GB before their gradient)
VLM = dict(arch="internvl2_1b", batch=4, text_len=256, new_tokens=32, gen_batch=8,
           gen_prompt=128, slots=4, stream_lens=(40, 96, 17, 64, 128, 33),
           stream_gens=(24, 8, 16, 32, 8, 12))
TRAIN_VLM = dict(arch="internvl2_1b", seq_len=1024, global_batch=8, gas=2, steps=3)
# phase 25: the MoE family under pipeline parallelism.  olmoe at full width,
# 4 of its 16 layers, pp 2 as two ranks on the card over gloo, 4 x 1024
# tokens in 4 micro-batches, at vpp 1 and 2, remat full
MOE_PP = dict(ranks=2, arch="olmoe_1b_7b", n_layers=4, seq_len=1024, global_batch=4, gas=4,
              vpps=(1, 2))
MOE_PP_LABEL = "two ranks time-sliced on one card over gloo"
# phase 26: the hybrid family.  hymba-1.5b at full depth (32 layers, d 1600,
# 25/5 heads of 64, 25 SSM heads of 128 channels, state 16; a window of 1024
# but on layers 0, 16 and 31): generate at B 4 (a 64-token prompt through
# the decode scan, 64 new tokens), prefill at 2 x 2048 (the window binds),
# a stream on contiguous slots; trained at full depth, 4 x 2048 in one
# micro-batch (the SSD's chunk carry over 8 chunks of 256); pp 2 over two
# ranks at 8 layers (global layers 0, 4 and 7: on both stages)
HYBRID = dict(arch="hymba_15b", batch=4, prompt_len=64, new_tokens=64, prefill=(2, 2048),
              slots=4, stream_lens=(24, 40, 9, 33, 17), stream_gens=(16, 8, 12, 8, 4))
TRAIN_HYMBA = dict(arch="hymba_15b", seq_len=2048, global_batch=4, gas=1, steps=3)
HYBRID_PP = dict(ranks=2, arch="hymba_15b", n_layers=8, seq_len=1024, global_batch=4, gas=2,
                 vpps=(1, 2))
# phase 27: xlstm-125m at full width and depth (12 layers, d 768, 4 heads,
# sLSTM at 1 and 3, an mLSTM inner width of 1536): generate at B 4 (a
# 64-token prompt through the decode scan, 64 new tokens), prefill at 2 x
# 1024 (8 mLSTM chunks of 128), a stream on contiguous slots, 3 training
# steps at 4 x 1024; the card's f32 step against the CPU's at 4 layers
XLSTM = dict(arch="xlstm_125m", batch=4, prompt_len=64, new_tokens=64, prefill=(2, 1024),
             slots=2, stream_lens=(24, 40, 9, 33, 17), stream_gens=(16, 8, 12, 8, 4),
             f32_layers=4, f32_seq=256)
TRAIN_XLSTM = dict(arch="xlstm_125m", seq_len=1024, global_batch=4, gas=1, steps=3)
# phase 28: whisper-base at full width and depth (6 + 6 layers, d 512, 8
# heads of 64, 1500 frames): generate at B 4 over random frames (a 16-token
# prompt through the decode scan, 64 new tokens), prefill at 4 x 448 (the
# decoder's real context), a stream on contiguous slots over the stub
# frames, 3 training steps at 8 x 448 over 1500 frames; the f32 identity at
# 2 + 2 layers
WHISPER = dict(arch="whisper_base", batch=4, prompt_len=16, new_tokens=64, prefill=(4, 448),
               slots=2, stream_lens=(24, 40, 9, 33, 17), stream_gens=(16, 8, 12, 8, 4),
               f32_layers=2)
TRAIN_WHISPER = dict(arch="whisper_base", seq_len=448, global_batch=8, gas=1, steps=3)
# phase 29: every family under the paper's tp and dp, as ranks time-sliced
# on the one card over gloo, each held to one device on the same card and
# seeds.  hymba-1.5b at tp 5 (25/5 attention heads and 25 SSM heads: 5/1 and
# 5 a rank, a GQA group of 5; d_ff 5504, which 5 does not divide, whole on
# every rank) at full width: generate and prefill at full depth (32
# layers), the f32 tokens and one f32 training step cut to 4 layers (global
# attention on 0, 2 and 3, a window of 1024 on 1, which the 1280-token
# sequences pass).  xlstm-125m and whisper-base at tp 2 x dp 2 in one world
# of four at full width and depth: generate, prefill (whisper over random
# frames), the f32 tokens and one f32 step at ZeRO-3 on the GAS path
FAMILY_TP = {
    "hybrid": dict(ranks=5, tp=5, archs=("hymba_15b",), batch=2, prompt_len=8, new_tokens=6,
                   prefill=(2, 1280), f32_layers=4, zero_stage=1,
                   train=dict(seq_len=1280, global_batch=1, gas=1)),
    "tp_dp": dict(ranks=4, tp=2, archs=("xlstm_125m", "whisper_base"), batch=4, prompt_len=16,
                  new_tokens=8, prefill=(4, 448), f32_layers=None, zero_stage=3,
                  train=dict(seq_len=256, global_batch=4, gas=1)),
}
FAMILY_TP_LABEL = "ranks time-sliced on one card over gloo"
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


# phase 20: tensor parallelism as two ranks on the one card over gloo (NCCL
# takes one rank per card).  granite (GQA 32/8, its 49155-token tied table
# left whole: 2 does not divide it) and gpt-3.6b (MHA, a vocab-parallel tied
# table) at published width and depth serve greedy tokens; both at 2 layers
# in f32 for the identities; gpt-3.6b trains at 2 of its 30 layers (4 until
# phases 27 and 28 took the time), 2 x 1024 tokens a micro-batch, 2
# micro-batches, remat full
TP = dict(ranks=2, batch=2, prompt_len=128, new_tokens=16, prefill=(2, 256), f32_layers=2,
          train=dict(arch="gpt_36b", n_layers=2, seq_len=1024, global_batch=4, gas=2))
TP_DIR = ROOT / "build" / "chip_smoke_tp"
TP_LABEL = "two ranks time-sliced on one card over gloo"
# phase 21: sharded data parallelism, dp = 2 as two ranks on the one card
# over gloo (and tp = 2 x dp = 2 as four): gpt-3.6b at published width, 1 of
# its 30 layers (4 until phases 24 and 25, 2 until phases 27 and 28 took the
# time), global batch 4 x 1024 in 2 micro-batches, remat full, bf16 over f32
# masters; the dp = 2 f32 identities and the checkpoint at 1 layer and a
# 4096-token vocabulary (every byte of state crosses gloo through the host,
# so their time goes with the table's size; the checkpoint writes 1.5 GB: the
# 45 GiB the card's host lets a run write holds no more beside phases 11-13
# and 20); tp = 2 x dp = 2's f32 identity at 2 layers and the whole
# vocabulary (at 1 layer and 4096 tokens one parameter parted from one
# device by 1.11e-5, past the check's 1e-5)
DP = dict(ranks=2, arch="gpt_36b", n_layers=1, seq_len=1024, global_batch=4, gas=2,
          f32_layers=1, f32_vocab=4096, tp_dp_f32_layers=2,
          ckpt=dict(n_layers=1, vocab=4096, global_batch=4, steps=3, ckpt_every=2, fail_at=2))
DP_RUNS = ((0, {}), (1, {}), (2, {}), (3, {}), (2, {"overlap_zero": True}),
           (3, {"gather_params_once": True}))
DP_VOTES = ("bad0", "bad1", "both")
# the bf16 sweep: DP_RUNS on the GAS path, then ZeRO-3 under the vote (its
# masters gathered whole once a step)
DP_SWEEP = (*((z, kw, False) for z, kw in DP_RUNS), (3, {}, True))
DP_DIR = ROOT / "build" / "chip_smoke_dp"
DP_LABEL = "ranks time-sliced on one card over gloo: they say nothing of NVLink"
# phase 22: gpt-3.6b at published width, 4 of its 30 layers (1 a chunk at pp
# 2 x vpp 2; 8 until phase 26 took the time), 8 x 1024 tokens in 4
# micro-batches, bf16 over f32 masters; the f32 identities at 4 layers and
# a 4096-token vocabulary (every byte of their state crosses gloo through
# the host, so their time goes with the table's size); the memory check at
# gas 8 (16 x 1024)
PP = dict(ranks=2, arch="gpt_36b", n_layers=4, f32_layers=4, f32_vocab=4096, seq_len=1024,
          global_batch=8, gas=4, big_gas=8, eval_step=5)
PP_RUNS = (("pp2", {}), ("pp2-vpp2", {"vpp": 2}),
           ("pp2-vpp2-stage", {"vpp": 2, "remat_policy": "stage"}),
           ("pp2-gas8", {"gas": 8, "global_batch": 16}))
PP_F32 = (("vpp1", {}), ("vpp2", {"vpp": 2}))
PP_LABEL = "ranks time-sliced on one card over gloo: no bubble or NVLink figure"
# the spawned worlds: each world of two or four ranks that phases 20-22, 25,
# 26 and 29 run is one spawn of that size, the phases in turn in it (a
# world costs ~12 s to start); hymba's world of five is phase 29's own
WORLDS_DIR = ROOT / "build" / "chip_smoke_worlds"


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
    most of it as (ms, launches, name), and every kernel as ``all``.  Only
    the device's activity is traced, and the device records are summed by
    name straight from the trace: the profiler's own event tree (its
    ``key_averages``) cost ~30 s for a window of ~10^5 launches, the host's
    operator events a minute more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    rows = sorted(((ms, n, name[:90]) for name, (ms, n) in by_name.items()), reverse=True)
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
    # (32, 8): granite's and h2o's; (14, 2): internvl2's group of 7, at its D 64
    for Hq, Hkv in ((4, 4), (8, 2), (32, 8), (14, 2)):
        for D in HEAD_DIMS if Hq != 14 else (64,):
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
    # queries and keys of two lengths, every key visible (an encoder-
    # decoder's cross-attention): ragged both ways, and Whisper's 448 decoder
    # tokens over its 1500 frames, at its 8/8 heads of 64
    for B, Sq, Sk in ((2, 200, 500), (2, 448, 1500)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Sq, 8, 64), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((B, Sk, 8, 64), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            (o, lse), (o_ref, lse_ref) = (f(q, k, v, causal=False)
                                          for f in (fa.flash_fwd, fa.flash_fwd_plain))
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            eo, ok_o = close(o, o_ref, TOL[name])
            el, ok_l = close(lse, lse_ref, TOL[name])
            worst[name][0] = max(worst[name][0], eo)
            worst[name][1] = max(worst[name][1], el)
            n += 1
            log(f"[K1 sweep] Sq {Sq} != Sk {Sk}, none, 8/8 heads of 64, {name}: max |O - "
                f"plain| {eo:.3g}, max |lse - plain| {el:.3g} ({rule(TOL[name])})")
            if not (ok_o and ok_l):
                failures.append(f"Sq={Sq} Sk={Sk} none {name}: O err {eo:.3g}, lse err "
                                f"{el:.3g}")
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
    none, segment ids, and queries and keys of two lengths (200 and 500,
    and Whisper's cross-attention, 448 over 1500 at 8/8 heads, none);
    in every case two launches of K3 and of K4 on the same inputs
    must give equal bits (no atomics: the bitwise crash -> resume relies on
    it); then the whole ``FlashAttention`` against autograd through
    ``flash_fwd_plain``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    worst = {dt: [0.0] * 4 for dt in TOL}
    failures, unequal, n = [], [], 0
    # (32, 8): granite's, h2o's; (14, 2): internvl2's group of 7
    cases = [(Hq, Hkv, D, S, S, mask)
             for Hq, Hkv in ((4, 4), (4, 1), (8, 2), (32, 8), (14, 2))
             for D in HEAD_DIMS if (Hq != 32 or D in (64, 120)) and (Hq != 14 or D == 64)
             for S in (200, 500, 1024)
             for mask in ("causal", "window", "window16", "none", "segments")]
    # queries and keys of two lengths (no segment ids then), and Whisper's
    # cross-attention: 448 decoder tokens over 1500 frames, 8/8 heads of 64
    cases += [(8, 2, D, Sq, Sk, mask) for D in (64, 120) for Sq, Sk in ((200, 500), (500, 200))
              for mask in ("causal", "window16", "none")]
    cases += [(8, 8, 64, 448, 1500, "none")]
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
        for g in (1, 4, 7):                          # 7: internvl2's group, at its D 64
            for D in HEAD_DIMS if g != 7 else (64,):
                for ring in [dict(fill=f) for f in (0, 300, S - 1)] + [dict(t_wrap=2000)]:
                    for window in (None, 128):
                        cases.append((2, S, 2, g, D, ring, window))
    for B in (1, 4):
        for S in (4096, 4100):
            for g, D in ((4, 64), (1, 128), (7, 64)):
                for ring in (dict(fill=S - 1), dict(fill=300), dict(t_wrap=10000)):
                    for window in (None, 1000):
                        cases.append((B, S, 8 if g != 7 else 2, g, D, ring, window))
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
        for g in (1, 4, 7):                          # 7: internvl2's group, at its D 64
            for D in HEAD_DIMS if g != 7 else (64,):
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
    for g in (1, 4, 7):
        for D in HEAD_DIMS if g != 7 else (64,):
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
        _log_profile(name, prof, wall * 1e3)
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


@contextlib.contextmanager
def routing(replay=None):
    """Inside this block every MoE routing appends its expert ids (T, k) to
    the list it yields.  Given ``replay`` (such a list from another run of
    the same calls), the i-th routing takes ``replay[i]``'s experts in place
    of its own top-k, its gate weights renormalized from its own router
    probabilities as ``moe.route`` does: two runs then send every token to
    the same experts and differ by their arithmetic alone."""
    import torch
    from repro_torch.models import moe
    seen, real = [], moe.route

    def route(cfg, router, xf):
        probs, idx, gate_w = real(cfg, router, xf)
        if replay is not None:
            idx = replay[len(seen)]
            gate_w = torch.gather(probs, 1, idx)
            gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
        seen.append(idx)
        return probs, idx, gate_w

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def route_flips(routes) -> str:
    """How many (token, slot) expert choices differ between the kernel path
    and the plain path, and between the plain path in bf16 and in f32 (a
    flip near a tie sends a token to another expert)."""
    out = []
    for a, b in (("kernel", "plain"), ("plain", "plain f32")):
        n = sum(x.numel() for x in routes[a])
        d = sum(int((x.sort(-1).values != y.sort(-1).values).sum())
                for x, y in zip(routes[a], routes[b]))
        out.append(f"{a} vs {b}: {d} of {n} choices differ ({d / max(n, 1):.3g})")
    return "; ".join(out)


def phase_moe(torch, np, build, get_config, InferenceSession, tree_map, smi):
    """Phase 23's serving part (the training part is ``phase_train`` with
    ``TRAIN_OLMOE``): olmoe at full depth, then deepseek at full depth.
    Returns the counted runs' launches."""
    runs = []
    spec = MOE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    L, B, P, N, V = cfg.n_layers, spec["batch"], spec["prompt_len"], spec["new_tokens"], \
        cfg.vocab_size
    build_peak = torch.cuda.max_memory_allocated()
    log(f"[moe] {_describe(cfg, L)}; {cfg.n_experts} experts of {cfg.moe_d_ff} (top "
        f"{cfg.top_k}, {cfg.n_shared_experts} shared, {cfg.first_k_dense} dense first), "
        f"{cfg.dtype}; build {time.perf_counter() - t0:.1f} s, peak {build_peak} B "
        f"({build_peak / 1e9:.2f} GB) for {2 * cfg.n_params() / 1e9:.2f} GB of bf16 weights")
    prompts = np.random.RandomState(0).randint(0, V, size=(B, P)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    toks = sess.generate(prompts, N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    want = {"decode_attention": L * (P + N - 1)}
    out = toks.cpu().numpy()
    log(f"[moe] {cfg.name} generate {tuple(toks.shape)} in {gen_s:.2f} s (first call, the "
        f"prompt through the decode scan); launches {counts}, expected {want}; peak "
        f"{torch.cuda.max_memory_allocated()} B")
    require(counts == want, f"{cfg.name} generate launched {counts}, expected {want}")
    require(out.shape == (B, P + N) and bool((out[:, :P] == prompts).all())
            and bool(((out >= 0) & (out < V)).all()),
            f"{cfg.name} generate returned {out.shape} tokens, altered or out of range")
    runs.append(counts)
    dec_ms, prof = _decode_ms(torch, sess, prompts, N)
    log(f"[moe] {cfg.name} decode: {dec_ms:.3f} ms a step at batch {B} (host clock, mean of "
        f"{N - 1} steps after the decode-scan prefill); {smi}")
    _log_profile("moe decode", prof, dec_ms * (N - 1))

    # the counted prefill routes as a user's does; the held ones (kernels,
    # plain f32) replay the plain bf16 run's experts, so a routing flip near
    # a tie moves neither the difference nor the floor
    batch = {"tokens": prompts}
    routes = {}
    build.launch_counts.clear()
    with routing() as routes["kernel"]:
        lk = sess.prefill(batch, last_only=False)
    torch.cuda.synchronize()
    pre = dict(build.launch_counts)
    require(pre == {"flash_fwd": L}, f"{cfg.name} prefill launched {pre}, expected K1 {L}")
    require(tuple(lk.shape) == (B, P, V) and bool(lk.isfinite().all()),
            f"{cfg.name} prefill gave {tuple(lk.shape)}, or non-finite logits")
    runs.append(pre)
    with plain_versions(), routing() as routes["plain"]:
        lp = sess.prefill(batch, last_only=False)
    with routing(replay=routes["plain"]):
        lk = sess.prefill(batch, last_only=False)
    with plain_versions():
        sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                  tree_map(lambda x: x.float(), sess.params), device=sess.device)
        with routing() as routes["plain f32"]:
            sess32.prefill(batch, last_only=False)
        with routing(replay=routes["plain"]):
            lf = sess32.prefill(batch, last_only=False)
        del sess32
    torch.cuda.empty_cache()
    log(f"[moe] {cfg.name} prefill routing, each run its own: {route_flips(routes)}")
    hold_to_floor("moe", f"{cfg.name} prefill logits (B, S, V) = {tuple(lk.shape)}, every run "
                  f"routed as the plain bf16 run", lk, lp, lf)
    del lk, lp, lf, routes
    torch.cuda.empty_cache()

    rs = np.random.RandomState(3)
    lens, gens = spec["stream_lens"], list(spec["stream_gens"])
    stream = [rs.randint(1, V, size=n).astype(np.int32) for n in lens]
    build.launch_counts.clear()
    t0 = time.perf_counter()
    outs, st = sess.serve(stream, gens, n_slots=spec["slots"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(build.launch_counts)
    want = {"decode_attention": L * (st.decode_steps + sum(lens))}
    log(f"[moe] {cfg.name} stream: {st.requests} requests on {spec['slots']} slots, "
        f"{st.generated_tokens} tokens, {st.decode_steps} decode steps, {st.prefill_tokens} "
        f"prompt tokens through the decode scan, in {wall:.2f} s (host clock); launches {c}, "
        f"expected {want}")
    require(c == want, f"{cfg.name} stream launched {c}, expected {want}")
    require(st.requests == len(stream) and st.generated_tokens == sum(gens)
            and st.prefill_tokens == sum(lens), f"{cfg.name} stream served {st}")
    for pr, m, o in zip(stream, gens, outs):
        require(len(o) == len(pr) + m and bool((o[:len(pr)] == pr).all()),
                f"{cfg.name} stream: a request came back with {len(o)} tokens")
    runs.append(c)
    del sess, toks
    torch.cuda.empty_cache()

    # deepseek-moe-16b: 32.8 GB of bf16 weights, built a block at a time
    spec = MOE_BIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    L, B, P, N, V = cfg.n_layers, spec["batch"], spec["prompt_len"], spec["new_tokens"], \
        cfg.vocab_size
    build_peak = torch.cuda.max_memory_allocated()
    log(f"[moe] {_describe(cfg, L)}; {cfg.n_experts} experts of {cfg.moe_d_ff} (top "
        f"{cfg.top_k}, {cfg.n_shared_experts} shared, {cfg.first_k_dense} dense first of d_ff "
        f"{cfg.d_ff}); build {time.perf_counter() - t0:.1f} s, peak {build_peak} B "
        f"({build_peak / 1e9:.2f} GB; the card has 80 GB) for {2 * cfg.n_params() / 1e9:.2f} "
        f"GB of bf16 weights")
    require(build_peak < 80e9, f"{cfg.name} build peak {build_peak} B")
    prompts = np.random.RandomState(0).randint(0, V, size=(B, P)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    toks = sess.generate(prompts, N)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    want = {"decode_attention": L * (P + N - 1)}
    require(counts == want, f"{cfg.name} generate launched {counts}, expected {want}")
    out = toks.cpu().numpy()
    require(out.shape == (B, P + N) and bool((out[:, :P] == prompts).all())
            and bool(((out >= 0) & (out < V)).all()),
            f"{cfg.name} generate returned {out.shape} tokens, altered or out of range")
    runs.append(counts)
    build.launch_counts.clear()
    lk = sess.prefill({"tokens": prompts}, last_only=False)
    torch.cuda.synchronize()
    pre = dict(build.launch_counts)
    require(pre == {"flash_fwd": L}, f"{cfg.name} prefill launched {pre}, expected K1 {L}")
    require(tuple(lk.shape) == (B, P, V) and bool(lk.isfinite().all()),
            f"{cfg.name} prefill gave {tuple(lk.shape)}, or non-finite logits")
    runs.append(pre)
    first = float((toks[:, P] == lk[:, -1].argmax(-1).to(torch.int32)).float().mean())
    run_peak = torch.cuda.max_memory_allocated()
    dec_ms, _ = _decode_ms(torch, sess, prompts, N, profile=False)
    log(f"[moe] {cfg.name}: generate launches {counts}, prefill launches {pre} (expected K5 "
        f"{L * (P + N - 1)}, K1 {L}); first generated token = the prefill's argmax in "
        f"{first:.2f} of rows (reported: the decode scan and the parallel prefill route and "
        f"round differently); run peak {run_peak} B ({run_peak / 1e9:.2f} GB of the card's 80 "
        f"GB); decode {dec_ms:.3f} ms a step at batch {B} (host clock); {smi}")
    require(run_peak < 80e9, f"{cfg.name} run peak {run_peak} B")
    del sess, toks, lk
    torch.cuda.empty_cache()
    return runs


def phase_moe_repeat(torch, get_config, TrainSession, stepfn, ParallelismConfig, DataConfig):
    """olmoe at full width, 2 layers, bf16: two runs of 2 steps from one
    seed give the same losses and parameters bit for bit (no atomics in the
    MoE layer, forward or backward: a resume must not change training)."""
    from repro_torch.core.tree import tree_leaves
    cfg = dataclasses.replace(get_config(MOE["arch"]), n_layers=2)

    def run():
        sess = TrainSession.from_recipe(
            cfg, seed=1, plan=ParallelismConfig(remat_policy="full"),
            train_cfg=stepfn.TrainConfig(total_steps=2, warmup=1),
            data_cfg=DataConfig(seq_len=256, global_batch=4))
        losses = [float(sess.step()["loss"]) for _ in range(2)]
        return losses, [x.detach().clone() for _, x in tree_leaves(sess.state["params"])]

    (la, pa), (lb, pb) = run(), run()
    same = la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))
    log(f"[moe] {cfg.name} at full width, 2 layers, bf16, two runs of 2 steps: losses {la} and "
        f"{lb}; every parameter equal in bits: {same}")
    require(same, "two MoE training runs from one seed differ")
    del pa, pb
    torch.cuda.empty_cache()


def _decode_ms(torch, sess, prompts, N, profile=True, profile_steps=None):
    """(ms a decode step, host clock, mean over N - 1 steps after the
    prefill; the profile of those steps, or of the first ``profile_steps``
    of them, or None)."""
    B, P = prompts.shape
    pt = torch.from_numpy(prompts).cuda()
    with torch.inference_mode():
        caches = sess.init_cache(B, P + N)
        logits, caches = sess.prefill_cache_step(sess.params, {"tokens": pt}, caches)
        tok0 = logits.argmax(-1).to(torch.int32)

        def decode(steps=N - 1):
            tok = tok0
            for t in range(P, P + steps):
                tok, _ = sess.serve_step(sess.params, tok, t, caches)

        decode()                                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (N - 1) * 1e3
        prof = None
        if profile:
            prof = profile_window(torch, functools.partial(decode, profile_steps or N - 1),
                                  top=12)
    return ms, prof


def _log_profile(name, prof, wall_ms):
    """A profiled window's device time beside the unprofiled wall time, and
    its kernels that took most of it."""
    if prof is None:
        return
    if prof["device_ms"] == 0:
        log(f"[profile] {name}: device time not measured (no device events)")
        return
    log(f"[profile] {name}: device busy {prof['device_ms']:.2f} ms of {wall_ms:.2f} ms "
        f"unprofiled wall ({prof['device_ms'] / wall_ms:.1%}); profiled wall "
        f"{prof['wall_ms']:.2f} ms")
    for ms, count, key in prof["top"]:
        log(f"[profile] {name}:   {ms:8.3f} ms  {count:5d}x  {key}")


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


def _attentions(cfg) -> int:
    """The attentions a forward runs (K1 launches): one a layer, none in the
    xLSTM, an encoder-decoder's encoder layers and two a decoder layer
    (self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


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
    (K1 twice per attention (``_attentions``) per micro-batch, forward and
    remat; K2, K3 and K4 once; nothing at all in the xLSTM); the last step
    is profiled; then one batch is evaluated
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
    A, G = _attentions(cfg), spec["gas"]
    log(f"[{tag}] {_describe(cfg, full)} ({cfg.dtype} compute, f32 masters); gas {G}, "
        f"remat full, batch {spec['global_batch']} x {spec['seq_len']}; {A} attentions a "
        f"forward; init {time.perf_counter() - t0:.1f} s")
    want = {"flash_fwd": 2 * A * G, "flash_delta": A * G, "flash_dq": A * G,
            "flash_dkv": A * G}
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
        aux = float(metrics["aux"])
        losses.append(loss)
        log(f"[{tag}] step {i}: loss {loss:.6f}, aux {aux:.6f}, grad_norm "
            f"{float(metrics['grad_norm']):.4f}, lr {float(metrics['lr']):.3g}, skipped "
            f"{skipped:.0f}, {walls[-1] * 1e3:.1f} ms{' (profiled)' if last else ''}; launches "
            f"{counts}")
        if cfg.family == "moe":
            require(math.isfinite(aux) and aux > 0, f"step {i}: load-balance loss {aux}")
        require(all(counts.get(k, 0) == n for k, n in want.items())
                and (A or not any(counts.values())),
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
    from repro_torch.models import api as model_api
    from repro_torch.models import layers
    host_batch = sess.batches(spec["steps"])
    batch = sess._to_device(host_batch)
    mask = batch["loss_mask"].float()

    routes = {}

    def token_nll(c, plain, key, replay=None):
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with torch.no_grad(), ctx, routing(replay) as seen:
            logits = model_api.forward(c, sess.state["params"], batch)
            routes[key] = seen
            return torch.logsumexp(logits, -1) - layers.gold_logit(logits, batch["labels"])

    f32 = dataclasses.replace(cfg, dtype="float32")
    xent_eval = float(sess.evaluate(host_batch)["xent"])
    nll_k, nll_p = token_nll(cfg, False, "kernel"), token_nll(cfg, True, "plain")
    nll_f = token_nll(f32, True, "plain f32")
    xent_k = float((nll_k * mask).sum() / mask.sum())
    if cfg.family == "moe":
        # as phase 23's prefill: the held runs replay the plain bf16 run's experts
        log(f"[{tag}] per-token losses' routing, each run its own: {route_flips(routes)}")
        nll_k = token_nll(cfg, False, "kernel, replayed", replay=routes["plain"])
        nll_f = token_nll(f32, True, "plain f32, replayed", replay=routes["plain"])
        log(f"[{tag}] the per-token losses held below: every run routed as the plain bf16 run")
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
    require(math.isfinite(xent_eval) and abs(xent_eval - xent_k) <= 1e-5 * xent_eval,
            f"evaluate() gave {xent_eval}, its per-token losses {xent_k}")
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


def phase_eval(torch, build, EvalSession, sess, floor, spec=TRAIN):
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
    masked = dict(sess.batches(spec["steps"] + 1))
    whole = {k: v for k, v in sess.batches(spec["steps"] + 2).items() if k != "loss_mask"}
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
        f"perplexity over 2 batches of {spec['global_batch']} x {spec['seq_len']} (one with "
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
                             ParallelismConfig, DataConfig, arch=TRAIN["arch"], n_layers=2,
                             f32_floor=False):
    """``arch`` at full width, ``n_layers`` layers, f32: the kernels and the
    plain versions each take 3 steps from the same state (the same seed).
    With ``f32_floor`` (a model whose f32 training is itself sensitive to
    one rounding: hymba's SSD subtracts chunk sums that reach thousands), a
    third run, the plain versions from the same state with the embedding
    table scaled by 1 + 2^-23 (one f32 rounding), gives the floor: the
    params of kernels and plain versions may differ by at most 2x what that
    rounding moves them (phase 5's rule, in f32), where the other configs
    are held to 1e-4."""
    from repro_torch.core.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")

    def run(plain, nudge=False):
        sess = TrainSession.from_recipe(
            cfg, seed=1, plan=ParallelismConfig(gas=2, remat_policy="full"),
            train_cfg=stepfn.TrainConfig(total_steps=3, warmup=1),
            data_cfg=DataConfig(seq_len=256, global_batch=4))
        if nudge:
            with torch.no_grad():
                sess.state["params"]["embed"].mul_(1 + 2.0 ** -23)
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            losses = [float(sess.step()["loss"]) for _ in range(3)]
        return losses, sess.state["params"]

    losses_k, params_k = run(False)
    losses_p, params_p = run(True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    errs = [("/".join(map(str, path)), close(a, b, 1e-4))
            for (path, a), (_, b) in zip(tree_leaves(params_k), tree_leaves(params_p))]
    worst, at = max((e, p) for p, (e, _) in errs)
    text = (f"[f32 train] {cfg.name} at full width, {n_layers} layer(s), f32, 3 steps: losses "
            f"kernel {losses_k}, plain {losses_p} (max rel diff {rel:.3g}, tol 1e-5); params "
            f"max |kernel - plain| {worst:.3g} at {at}")
    require(rel <= 1e-5, f"f32 losses differ by {rel:.3g} relative")
    if f32_floor:
        _, params_n = run(True, nudge=True)
        floor, f_at = max((float((a - b).detach().abs().max()), "/".join(map(str, path)))
                          for (path, a), (_, b) in zip(tree_leaves(params_p),
                                                       tree_leaves(params_n)))
        log(f"{text}; f32 floor: the plain run with its embedding scaled by 1 + 2^-23 moves "
            f"the params by up to {floor:.3g} (at {f_at}) (tol: kernel - plain <= "
            f"{LOGIT_FLOOR_FACTOR} x floor)")
        require(worst <= LOGIT_FLOOR_FACTOR * floor,
                f"f32 params differ by up to {worst:.3g}, more than {LOGIT_FLOOR_FACTOR} x "
                f"the f32 floor {floor:.3g}")
        del params_n
    else:
        log(f"{text} ({rule(1e-4)})")
        require(all(ok for _, (_, ok) in errs), f"f32 params differ by up to {worst:.3g}")
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

# ---------------------------------------------------------------------------
# phase 20: tensor parallelism, two ranks on the one card
# ---------------------------------------------------------------------------

def expected_collectives(L: int, G: int, *, remat: str, sp: bool, vocab_parallel: bool):
    """The collectives one train step at tp > 1 calls, by kind, as the code
    implies them (``core/tp.py``'s regions), at L layers and G micro-batches.

    Per micro-batch without sequence parallel: all-reduces for the
    vocab-parallel embedding, two a block forward (the row-parallel exits),
    two a block backward (the column-parallel entries), one a block again
    under remat "full"/"dots" (the recomputed attention exit: the replay
    stops once the MLP's saved input is rebuilt, before the MLP's exit), the
    unembed entry's backward and the cross-entropy's sums (with a vocab-
    parallel table; its max is ``all_reduce_max``) and the finite check.
    Under sequence parallel the block's entries are all-gathers and its
    exits reduce-scatters (their backwards the other way round), the
    recompute replays the attention's two and the MLP's entry, the last
    hidden states are gathered (a reduce-scatter backward with a
    vocab-parallel table), the embedded sequence split (an all-gather
    backward), and one all-reduce sums the norms' gradients.  Per step the
    skip gate's gradient norm adds an all-reduce (AdamW clips by the same
    norm)."""
    vp, rec = int(vocab_parallel), 0 if remat == "none" else 1
    if sp:
        per = {"all_reduce": 2 * vp + 2, "all_reduce_max": vp,
               "all_gather": 2 * L + 1 + rec * 2 * L + 2 * L + 1,
               "reduce_scatter": 2 * L + rec * L + 2 * L + vp}
    else:
        per = {"all_reduce": 3 * vp + (4 + rec) * L + 1, "all_reduce_max": vp}
    out = {k: G * v for k, v in per.items() if v}
    out["all_reduce"] += 1
    return out


def expected_dp_collectives(layout, L: int, G: int, *, vote: bool, remat: str = "full"):
    """The data-parallel collectives one train step calls over a mesh without
    tp, by ``"<kind>@<group>"``, as the code implies them from ``layout``
    (the step's ``core.zero.Layout``), at L layers and G micro-batches.

    One norm a step (the skip gate's, over the world; AdamW clips by it); on
    the GAS path a finite check a micro-batch (the vote's is its replica's
    own).
    Over the plane: one all-reduce of the loss and metrics (on the vote's
    path of the verdict too), then a leaf's gradient sum: an all-reduce,
    from ZeRO-2 a reduce-scatter where the optimizer shard cuts the leaf
    (a micro-batch at a time under ``overlap_zero``), and one all-gather of
    each such leaf's updated shard.  A ZeRO-3 leaf is gathered over the data
    axis where it is read (a block's again in a remat recompute) and its
    gradient reduce-scattered at every read; gathered once a step on the
    vote's path or under ``gather_params_once``, reduce-scattered once."""
    import collections
    plan, mesh = layout.plan, layout.mesh
    live = [a for a in ("pod", "data") if mesh.shape[a] > 1]
    plane = ",".join(live)
    fsdp = [lf for lf in layout.leaves if lf.fsdp_dim is not None]
    f_blocks = sum(1 for lf in fsdp if lf.path[0] == "blocks")
    z = sum(1 for lf in layout.leaves if lf.z_dim is not None)
    rest = len(layout.leaves) - len(fsdp) - z
    times = G if plan.overlap_zero and plan.zero_stage >= 2 and not vote else 1
    out = collections.Counter({"all_reduce@world": 1 + (0 if vote else G),
                               f"all_reduce@{plane}": 1 + times * rest})
    if plan.zero_stage >= 2:
        out[f"reduce_scatter@{plane}"] += times * z
    else:
        out[f"all_reduce@{plane}"] += z
    out[f"all_gather@{plane}"] += z
    if fsdp:
        if vote or plan.gather_params_once:
            out["all_gather@data"] += len(fsdp)
            out["reduce_scatter@data"] += len(fsdp)
        else:
            rec = 0 if remat == "none" else 1
            out["all_gather@data"] += G * ((1 + rec) * f_blocks + len(fsdp) - f_blocks)
            out["reduce_scatter@data"] += G * len(fsdp)
        if mesh.shape["pod"] > 1:
            out["all_reduce@pod"] += len(fsdp)
    return {k: v for k, v in out.items() if v}


def expected_pp_p2p(pp: int, vpp: int, gas: int, stage: int, tp: int = 1, *, mbs: int,
                    seq: int, d_model: int, itemsize: int, sp: bool = False):
    """One train step's point-to-point messages on the rank of pipeline
    stage ``stage``: ({"send@pp": n, "recv@pp": n}, their bytes).  Each
    stage runs gas·vpp forwards and as many backwards; every forward but
    the last chunk's (stage pp-1's last row) sends its activation on, and
    every backward but chunk 0's (stage 0's first row) sends the input's
    gradient back, each received once.  A message is one micro-batch's
    activation: this rank's ``mbs`` rows x ``seq`` positions (``seq / tp``
    under sequence parallel) x ``d_model``, ``itemsize`` bytes an entry."""
    total = gas * vpp
    first, last = stage == 0, stage == pp - 1
    fwd_out = total - (gas if last else 0)
    bwd_out = total - (gas if first else 0)
    n = {"send@pp": fwd_out + bwd_out, "recv@pp": bwd_out + fwd_out}
    msg = mbs * (seq // tp if sp else seq) * d_model * itemsize
    return n, {k: v * msg for k, v in n.items()}


def expected_serving_collectives(L: int, decode_steps: int, *, vocab_parallel: bool,
                                 sp: bool = False, whole_mlp: bool = False):
    """The collectives of a prefill and ``decode_steps`` decode steps at
    tp > 1: a block's two row-parallel exits (all-reduces; under sequence
    parallel, in the prefill, reduce-scatters, with its entries
    all-gathers and the last hidden states gathered), one where tp does not
    divide the MLP (``whole_mlp``: every rank computes it whole), and with a
    vocab-parallel table the embedding's and the gathered logits'
    all-reduces each pass.  Decode steps run without sequence parallel."""
    vp, x = int(vocab_parallel), 2 - int(whole_mlp)
    out = {"all_reduce": 2 * vp + (0 if sp else x * L) + decode_steps * (x * L + 2 * vp)}
    if sp:
        out.update(all_gather=x * L + 1, reduce_scatter=x * L)
    return {k: v for k, v in out.items() if v}


@contextlib.contextmanager
def recording_heads(heads):
    """Inside this block every launch of K1-K5 also adds one to
    ``heads[(kernel, Hq, Hkv)]``: the head counts the kernel ran at."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    wrapped = [(fa, "flash_fwd", 0, 1), (fa, "flash_delta", 0, 0), (fa, "flash_dq", 0, 1),
               (fa, "flash_dkv", 0, 1), (da, "decode_attention", 0, 1)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in wrapped]

    def wrap(name, fn, iq, ik):
        def rec(*a, **k):
            heads[(name, a[iq].shape[2], a[ik].shape[2])] += 1
            return fn(*a, **k)
        return rec

    for (mod, name, iq, ik), (_, _, fn) in zip(wrapped, saved):
        setattr(mod, name, wrap(name, fn, iq, ik))
    try:
        yield heads
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _tp_prompts(np, vocab, shape, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


def _adam_close(got, want, m_want, lr):
    """(worst |got - want| off the floor, entries on it, entries) for params
    after one AdamW step: its first update is lr·g/(|g| + eps), so an entry
    whose gradient is at the f32 noise floor (|g| <= 1e-6 of its leaf's
    largest: ~1e-9, the order of eps) can move by up to 2·lr when the sums
    are reordered; every other entry is held to 1e-5 (abs + rel)."""
    d = (got.float() - want.float()).abs()
    ok = d <= 1e-5 + 1e-5 * want.float().abs()
    g = m_want.float().abs()
    floor = (~ok) & (g <= 1e-6 * g.max()) & (d <= 2 * lr)
    if not bool((ok | floor).all()):
        return float("inf"), int(floor.sum()), d.numel()
    return float((d * ok).max()), int(floor.sum()), d.numel()


def _tp_train_session(get_config, TrainSession, stepfn, ParallelismConfig, DataConfig,
                      dtype, *, plan_kw=None, mesh=None):
    spec = TP["train"]
    cfg, full = _dense_cfg(get_config, spec)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    plan = ParallelismConfig(gas=spec["gas"], remat_policy="full", **(plan_kw or {}))
    sess = TrainSession.from_recipe(
        cfg, seed=0, plan=plan, mesh=mesh,
        train_cfg=stepfn.TrainConfig(total_steps=4, warmup=2),
        data_cfg=DataConfig(seq_len=spec["seq_len"], global_batch=spec["global_batch"]))
    return sess, cfg, full


def _timed_step(torch, sess):
    """One step: (metrics as floats, host seconds, CUDA-event ms on this
    process's stream)."""
    sess.batches(sess._next_step)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    m = sess.step()
    ev[1].record()
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in m.items()}, time.perf_counter() - t0,
            ev[0].elapsed_time(ev[1]))


def phase_tp_refs(torch, np, get_config, InferenceSession, TrainSession, stepfn,
                  ParallelismConfig, DataConfig, tree_map, smi):
    """Phase 20's tp = 1 references on the card (this process, kept on the
    host, the card freed; the f32 step's state to ``TP_DIR`` for the ranks),
    before the world of two runs its ranks (``_tp_rank_runs``), whose
    results ``_tp_check`` holds to these.  → (the references, the card's
    compute mode)."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    log(f"[tp] compute mode {mode}; {smi}")
    require(mode != "Exclusive_Process",
            "the card's compute mode is Exclusive_Process: two ranks cannot share it")
    TP_DIR.mkdir(parents=True, exist_ok=True)
    B, P, N = TP["batch"], TP["prompt_len"], TP["new_tokens"]
    ref = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for arch in ("granite_3_2b", "gpt_36b"):
            sess = InferenceSession.from_recipe(arch, seed=0)
            prompts = _tp_prompts(np, sess.cfg.vocab_size, (B, P), 2)
            ts = time.perf_counter()
            ref[f"{arch}/tokens"] = sess.generate(prompts, N).cpu()
            torch.cuda.synchronize()
            ref[f"{arch}/generate_s"] = time.perf_counter() - ts
            if arch == "gpt_36b":
                pt = _tp_prompts(np, sess.cfg.vocab_size, TP["prefill"], 3)
                ref["gpt_36b/prefill"] = sess.prefill({"tokens": pt}, last_only=False).cpu()
                cfg32 = dataclasses.replace(sess.cfg, dtype="float32")
                params32 = tree_map(lambda x: x.float(), sess.params)
                device = sess.device
                del sess
                s32 = InferenceSession(cfg32, params32, device=device)
                ref["gpt_36b/prefill_f32"] = s32.prefill({"tokens": pt}, last_only=False).cpu()
                del s32, params32
            else:
                del sess
            torch.cuda.empty_cache()
        for arch in ("granite_3_2b", "gpt_36b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=TP["f32_layers"],
                                      dtype="float32")
            sess = InferenceSession.from_recipe(cfg, seed=1)
            prompts = _tp_prompts(np, cfg.vocab_size, (B, P), 4)
            ref[f"{arch}/f32_tokens"] = sess.generate(prompts, N).cpu()
            ref[f"{arch}/f32_prefill"] = sess.prefill({"tokens": prompts}, last_only=False).cpu()
            del sess
            torch.cuda.empty_cache()
    sess, cfg, full = _tp_train_session(get_config, TrainSession, stepfn, ParallelismConfig,
                                        DataConfig, "float32")
    m, _, _ = _timed_step(torch, sess)
    torch.save({"params": tree_map(lambda x: x.detach().cpu(), sess.state["params"]),
                "m": tree_map(lambda x: x.detach().cpu(), sess.state["opt"]["m"])},
               TP_DIR / "train_f32.pt")
    _, host_s, ev_ms = _timed_step(torch, sess)          # warm: the time of a step
    ref["train_f32"] = dict(metrics=m, s=host_s, event_ms=ev_ms)
    del sess
    torch.cuda.empty_cache()
    sess, _, _ = _tp_train_session(get_config, TrainSession, stepfn, ParallelismConfig,
                                   DataConfig, None)
    m, _, _ = _timed_step(torch, sess)
    _, host_s, ev_ms = _timed_step(torch, sess)
    ref["train_bf16"] = dict(metrics=m, s=host_s, event_ms=ev_ms)
    del sess
    torch.cuda.empty_cache()
    log(f"[tp] tp = 1 references on the card in {time.perf_counter() - t0:.1f} s: "
        f"train ({_describe(cfg, full)}) f32 loss {ref['train_f32']['metrics']['loss']:.6f}, "
        f"bf16 loss {ref['train_bf16']['metrics']['loss']:.6f}")
    return ref, mode


@contextlib.contextmanager
def _rank(rank: int, world: int, port: int):
    """A spawned rank's process → its ``torch``: the port on the path, TF32
    off, its share of the host's cores as torch's CPU threads (ranks that
    each take every core spin against each other), ``cuda:0``, gloo over
    localhost, the group destroyed on the way out."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        yield torch
    finally:
        dist.destroy_process_group()


def _tp_rank_runs(torch, np, world):
    """One rank of phase 20: every tp = 2 run, its results and checks."""
    import collections
    from repro_torch.configs import get_config
    from repro_torch.core import sharding, stepfn, tp
    from repro_torch.core.recipe import ParallelismConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataConfig
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    from repro_torch.session import InferenceSession, TrainSession
    mesh = make_recipe_mesh(tp=world, device_type="cuda")
    B, P, N = TP["batch"], TP["prompt_len"], TP["new_tokens"]
    out = {"mesh": describe(mesh)}

    def counted(key, fn):
        """``fn()`` with the launch, head and collective counts zeroed just
        before and read just after, timed on the host."""
        heads = collections.Counter()
        build.launch_counts.clear()
        tp.counts.clear()
        tp.nbytes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_heads(heads):
            res = fn()
        torch.cuda.synchronize()
        out[key] = dict(s=time.perf_counter() - t0, launches=dict(build.launch_counts),
                        heads=dict(heads), collectives=dict(tp.counts), bytes=dict(tp.nbytes))
        return res

    plan = ParallelismConfig(tp=world)
    with torch.inference_mode():
        for arch in ("granite_3_2b", "gpt_36b"):
            sess = InferenceSession.from_recipe(arch, seed=0, plan=plan, mesh=mesh)
            prompts = _tp_prompts(np, sess.cfg.vocab_size, (B, P), 2)
            out[f"{arch}/tokens"] = counted(f"{arch}/generate",
                                            lambda: sess.generate(prompts, N)).cpu()
            if arch == "gpt_36b":
                pt = _tp_prompts(np, sess.cfg.vocab_size, TP["prefill"], 3)
                out["gpt_36b/prefill"] = counted(
                    "gpt_36b/prefill_run",
                    lambda: sess.prefill({"tokens": pt}, last_only=False)).cpu()
            out[f"{arch}/peak_bytes"] = torch.cuda.max_memory_allocated()
            del sess
            torch.cuda.empty_cache()
        for arch in ("granite_3_2b", "gpt_36b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=TP["f32_layers"],
                                      dtype="float32")
            sess = InferenceSession.from_recipe(cfg, seed=1, plan=plan, mesh=mesh)
            prompts = _tp_prompts(np, cfg.vocab_size, (B, P), 4)
            out[f"{arch}/f32_tokens"] = sess.generate(prompts, N).cpu()
            out[f"{arch}/f32_prefill"] = sess.prefill({"tokens": prompts},
                                                      last_only=False).cpu()
            del sess
            torch.cuda.empty_cache()

    ref = torch.load(TP_DIR / "train_f32.pt", mmap=True, weights_only=False)
    for sp in (False, True):
        tag = "train_f32_sp" if sp else "train_f32"
        sess, cfg, _ = _tp_train_session(
            get_config, TrainSession, stepfn, ParallelismConfig, DataConfig, "float32",
            plan_kw=dict(tp=world, sequence_parallel=sp), mesh=mesh)
        m, _, _ = counted(tag, lambda: _timed_step(torch, sess))
        want = sharding.shard_params(ref["params"], mesh, sess.plan)
        m_want = sharding.shard_params(ref["m"], mesh, sess.plan)
        worst, on_floor, n = 0.0, 0, 0
        for (path, got), (_, w), (_, mw) in zip(tree_leaves(sess.state["params"]),
                                                 tree_leaves(want), tree_leaves(m_want)):
            e, f, k = _adam_close(got.detach().cpu(), w, mw, m["lr"])
            worst, on_floor, n = max(worst, e), on_floor + f, n + k
        _, host_s, ev_ms = _timed_step(torch, sess)      # warm: the time of a step
        out[tag].update(metrics=m, step_s=host_s, event_ms=ev_ms, params_worst=worst,
                        params_on_floor=on_floor, params_n=n)
        del sess, want, m_want
        torch.cuda.empty_cache()
    del ref
    sess, _, _ = _tp_train_session(get_config, TrainSession, stepfn, ParallelismConfig,
                                   DataConfig, None, plan_kw=dict(tp=world), mesh=mesh)
    m, _, _ = counted("train_bf16", lambda: _timed_step(torch, sess))
    _, host_s, ev_ms = _timed_step(torch, sess)
    out["train_bf16"].update(metrics=m, step_s=host_s, event_ms=ev_ms,
                             peak_bytes=torch.cuda.max_memory_allocated())
    return out


def _tp_check(torch, get_config, ref, outs, ranks_s, mode, smi):
    """Phase 20's checks on the ranks' results; returns (the ``{"tp": ...}``
    summary, rank 0's counted main-path launches)."""
    out, B, P, N = outs[0], TP["batch"], TP["prompt_len"], TP["new_tokens"]
    log(f"[tp] {TP['ranks']} ranks ({out['mesh']}) ran in {ranks_s:.1f} s")
    for r, o in enumerate(outs[1:], 1):
        for key in ("granite_3_2b/tokens", "gpt_36b/tokens", "granite_3_2b/f32_tokens",
                    "gpt_36b/f32_tokens"):
            require(torch.equal(o[key], out[key]), f"rank {r}'s {key} differ from rank 0's")
        require(o["train_f32"]["metrics"]["loss"] == out["train_f32"]["metrics"]["loss"],
                f"rank {r}'s loss differs from rank 0's")
    summary = {"compute_mode": mode, "card": smi, "ranks": TP["ranks"],
               "gloo_cuda_collectives": sorted({k for o in outs for run in o.values()
                                                if isinstance(run, dict)
                                                for k in run.get("collectives", {})}),
               "times_label": TP_LABEL, "times": {}, "collectives": {}}
    launch_runs = []
    n = TP["ranks"]
    for arch in ("granite_3_2b", "gpt_36b"):
        cfg = get_config(arch)
        L, hq, hkv = cfg.n_layers, cfg.n_heads // n, cfg.n_kv_heads // n
        got, want = out[f"{arch}/tokens"], ref[f"{arch}/tokens"]
        agree = (got[:, P:] == want[:, P:]).float().mean(0).tolist()
        log(f"[tp] {arch} bf16 generate {B} x {P} + {N} at tp 2 vs tp 1: first token equal "
            f"{bool(torch.equal(got[:, P], want[:, P]))}; agreement by step "
            f"{[round(a, 2) for a in agree]} (bf16 near-ties may part later)")
        require(torch.equal(got[:, :P + 1], want[:, :P + 1]),
                f"{arch}: tp 2's first generated token differs from tp 1's")
        run = out[f"{arch}/generate"]
        vp = cfg.vocab_size % n == 0
        want_c = expected_serving_collectives(L, N - 1, vocab_parallel=vp)
        want_l = {"flash_fwd": L, "decode_attention": L * (N - 1)}
        want_h = {("flash_fwd", hq, hkv): L, ("decode_attention", hq, hkv): L * (N - 1)}
        log(f"[tp] {arch} generate: launches {run['launches']} (expected {want_l}), heads "
            f"{run['heads']}, collectives {run['collectives']} (expected {want_c}), bytes "
            f"{run['bytes']}; {run['s']:.2f} s at tp 2 ({TP_LABEL}), "
            f"{ref[f'{arch}/generate_s']:.2f} s at tp 1; peak {out[f'{arch}/peak_bytes']} B")
        require(run["launches"] == want_l, f"{arch} generate launches {run['launches']}")
        require(run["heads"] == want_h, f"{arch} generate ran K1/K5 at {run['heads']}")
        require(run["collectives"] == want_c, f"{arch} generate collectives {run['collectives']}")
        launch_runs.append(run["launches"])
        summary["times"][f"{arch} generate s"] = [run["s"], ref[f"{arch}/generate_s"]]

    # gpt-3.6b prefill logits at every position, bf16: held to phase 5's rule
    run = out["gpt_36b/prefill_run"]
    gpt = get_config("gpt_36b")
    L, hq = gpt.n_layers, gpt.n_heads // n
    tp2, tp1, f32 = out["gpt_36b/prefill"], ref["gpt_36b/prefill"], ref["gpt_36b/prefill_f32"]
    require(bool(tp2.isfinite().all()), "gpt-3.6b prefill at tp 2: non-finite logits")
    diff, floor = float((tp2 - tp1).abs().max()), float((tp1 - f32).abs().max())
    log(f"[tp] gpt_36b bf16 prefill {TP['prefill']} logits: max |tp 2 - tp 1| {diff:.4g}, bf16 "
        f"noise floor max |tp 1 - tp 1 f32| {floor:.4g} (tol: <= {LOGIT_FLOOR_FACTOR} x "
        f"floor); top-1 agreement {float((tp2.argmax(-1) == tp1.argmax(-1)).float().mean()):.4f}"
        f"; launches {run['launches']}, collectives {run['collectives']}")
    require(diff <= LOGIT_FLOOR_FACTOR * floor,
            f"gpt-3.6b prefill: tp 2 and tp 1 differ by {diff:.4g}, more than "
            f"{LOGIT_FLOOR_FACTOR} x bf16's own error {floor:.4g}")
    require(run["launches"] == {"flash_fwd": L} and run["heads"] == {("flash_fwd", hq, hq): L},
            f"gpt-3.6b prefill launches {run['launches']}, heads {run['heads']}")
    require(run["collectives"] == expected_serving_collectives(L, 0, vocab_parallel=True),
            f"gpt-3.6b prefill collectives {run['collectives']}")
    launch_runs.append(run["launches"])

    # the f32 identities at 2 layers, full width
    for arch in ("granite_3_2b", "gpt_36b"):
        got, want = out[f"{arch}/f32_tokens"], ref[f"{arch}/f32_tokens"]
        lg, lw = out[f"{arch}/f32_prefill"], ref[f"{arch}/f32_prefill"]
        d, top = float((lg - lw).abs().max()), float(lw.abs().max())
        log(f"[tp] {arch} f32, {TP['f32_layers']} layers, full width: greedy tokens tp 2 == tp 1 "
            f"over {N} steps: {bool(torch.equal(got, want))}; prefill logits max |tp 2 - tp 1| "
            f"{d:.4g} ({d / top:.3g} of max |logit|, tol 1e-4)")
        require(torch.equal(got, want), f"{arch} f32: tp 2's tokens differ from tp 1's")
        require(d <= 1e-4 * top, f"{arch} f32: prefill logits differ by {d:.4g}")

    # gpt-3.6b training, TP["train"]["n_layers"] of 30 layers
    spec = TP["train"]
    L, G = spec["n_layers"], spec["gas"]
    mbs = spec["global_batch"] // G
    cm_bytes = mbs * spec["seq_len"] * gpt.d_model * 2
    want_l = {"flash_fwd": 2 * L * G, "flash_delta": L * G, "flash_dq": L * G, "flash_dkv": L * G}
    want_h = {(k, hq, hq): c for k, c in want_l.items()}
    rm = ref["train_f32"]["metrics"]
    for tag, sp in (("train_f32", False), ("train_f32_sp", True), ("train_bf16", False)):
        run = out[tag]
        m = run["metrics"]
        want_c = expected_collectives(L, G, remat="full", sp=sp, vocab_parallel=True)
        base = ref["train_bf16"] if tag == "train_bf16" else ref["train_f32"]
        log(f"[tp] gpt_36b {tag} at tp 2 (sp {sp}): loss {m['loss']:.6f} (tp 1 "
            f"{base['metrics']['loss']:.6f}), grad_norm {m['grad_norm']:.6f} (tp 1 "
            f"{base['metrics']['grad_norm']:.6f}), skipped {m['skipped']:.0f}; the second "
            f"step {run['step_s'] * 1e3:.1f} ms host, {run['event_ms']:.1f} ms CUDA events at tp "
            f"2 ({TP_LABEL}); tp 1 {base['s'] * 1e3:.1f} ms host, {base['event_ms']:.1f} ms "
            "events")
        log(f"[tp] gpt_36b {tag}: launches {run['launches']}, heads {run['heads']}; collectives "
            f"{run['collectives']} (expected {want_c}), bytes {run['bytes']}; the cost model "
            f"assumes {4 * L * G} all-reduces of {cm_bytes} B ({4 * L * G * cm_bytes} B) a step")
        require(run["launches"] == want_l and run["heads"] == want_h,
                f"{tag}: launches {run['launches']}, heads {run['heads']}")
        require(run["collectives"] == want_c, f"{tag}: collectives {run['collectives']}")
        require(math.isfinite(m["loss"]) and m["skipped"] == 0.0, f"{tag}: {m}")
        summary["times"][f"{tag} step ms (host, events)"] = [run["step_s"] * 1e3,
                                                             run["event_ms"]]
        summary["collectives"][tag] = {"calls": run["collectives"], "bytes": run["bytes"],
                                       "cost_model_all_reduces": 4 * L * G,
                                       "cost_model_bytes": 4 * L * G * cm_bytes}
        launch_runs.append(run["launches"])
        if tag == "train_bf16":
            continue
        rel = abs(m["loss"] - rm["loss"]) / abs(rm["loss"])
        log(f"[tp] gpt_36b {tag}: loss rel diff {rel:.3g} (tol 1e-5); params after the step "
            f"max |tp 2 - tp 1| {run['params_worst']:.3g} ({rule(1e-5)}), "
            f"{run['params_on_floor']} of {run['params_n']} entries at Adam's noise floor "
            f"(|g| <= 1e-6 of the leaf's max; held to 2 x lr)")
        require(rel <= 1e-5, f"{tag}: loss differs by {rel:.3g} relative")
        require(math.isfinite(run["params_worst"]), f"{tag}: params differ beyond the rule")
        require(run["params_on_floor"] <= 1e-4 * run["params_n"],
                f"{tag}: {run['params_on_floor']} entries at the noise floor")
    summary["times"]["tp 1 train_f32 step ms (host, events)"] = [
        ref["train_f32"]["s"] * 1e3, ref["train_f32"]["event_ms"]]
    summary["times"]["tp 1 train_bf16 step ms (host, events)"] = [
        ref["train_bf16"]["s"] * 1e3, ref["train_bf16"]["event_ms"]]
    summary["sequence_parallel_on_card"] = True
    return summary, launch_runs


# ---------------------------------------------------------------------------
# phase 21: sharded data parallelism, two (and four) ranks on the one card
# ---------------------------------------------------------------------------

def _dp_cfg(get_config, n_layers, dtype=None, vocab=None):
    cfg = dataclasses.replace(get_config(DP["arch"]), n_layers=n_layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg


def _dp_session(mods, cfg, *, mesh=None, vote=True, replicas=0, global_batch=None, seed=0,
                total_steps=8, **plan_kw):
    """A TrainSession of phase 21: remat full, gas 2, 1024 tokens a row;
    ``vote`` keeps the reference's default consensus (over the mesh's
    replicas, or ``replicas`` simulated ones on one device)."""
    shape = mesh.shape if mesh is not None else {"tp": 1, "data": 1, "pod": 1}
    plan = mods.ParallelismConfig(gas=DP["gas"], remat_policy="full", tp=shape["tp"],
                                  dp=shape["data"], pods=shape["pod"], **plan_kw)
    rs = mods.ResilienceConfig(consensus=vote, consensus_replicas=replicas)
    return mods.TrainSession.from_recipe(
        cfg, seed=seed, plan=plan, mesh=mesh,
        train_cfg=mods.stepfn.TrainConfig(total_steps=total_steps, warmup=2, resilience=rs),
        data_cfg=mods.DataConfig(seq_len=DP["seq_len"],
                                 global_batch=global_batch or DP["global_batch"]))


def _dp_mods():
    from repro_torch.core import stepfn
    from repro_torch.core.recipe import ParallelismConfig
    from repro_torch.data import DataConfig
    from repro_torch.runtime.resilience import ResilienceConfig
    from repro_torch.session import TrainSession
    return SimpleNamespace(stepfn=stepfn, ParallelismConfig=ParallelismConfig,
                           DataConfig=DataConfig, ResilienceConfig=ResilienceConfig,
                           TrainSession=TrainSession)


def _digest(torch, tree):
    """Per leaf, the sum of its f32 words' bit patterns: equal trees give
    equal digests (the ranks' cross-check of bits)."""
    from repro_torch.core.tree import tree_leaves
    return [int(x.detach().float().contiguous().view(torch.int32).sum(dtype=torch.int64))
            for _, x in tree_leaves(tree)]


def _whole_params(sess):
    from repro_torch.core import sharding
    return sharding.gather_params(sess.state["params"], sess.mesh, sess.plan, sess.cfg)


def _dp_tag(z, kw, vote=False):
    return f"z{z}" + "".join(f"-{k}" for k in kw) + ("-vote" if vote else "")


def _params_and_m(sess, keep=True):
    """{reference path: host array} of the whole params and ``m`` (after a
    first step 0.1 x the clipped gradient); on a mesh gathered leaf by leaf,
    ``{}`` where not ``keep``."""
    from repro_torch.checkpoint.bridge import state_to_numpy
    from repro_torch.checkpoint.elastic import host_snapshot
    part = {"params": sess.state["params"], "opt": {"m": sess.state["opt"]["m"]}}
    if sess.mesh is None:
        return state_to_numpy(part)
    return dict(host_snapshot(part, sess.plan, mesh=sess.mesh, cfg=sess.cfg, keep=keep))


def _held_to(np, got, ref, lr):
    """A first step's params and gradient against one device's, as the CPU
    tests hold them: a param within 1e-5 + 1e-5 |p|, except Adam's noise
    floor (|m| <= 1e-6 max |m| of its leaf: its update is the sign of a
    rounding error), held to 2 lr and counted; each leaf's ``m`` within
    1e-5 of its largest entry.  The same f32 arithmetic as numpy's, done
    by torch on the card where there is one (a leaf's arrays at a time):
    numpy took ~18 s a call over 0.6 B entries."""
    import torch
    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = dict(max_param_diff=0.0, floor=0, entries=0, worst_m=0.0, ok=True)
    for key in ref:
        if not key.startswith("params/"):
            continue
        m_key = "opt/m/" + key[len("params/"):]
        p_ref, m_ref = t(ref[key]), t(ref[m_key])
        top = float(m_ref.abs().max())
        d = (t(got[key]) - p_ref).abs()
        ok = d <= 1e-5 + 1e-5 * p_ref.abs()
        noise = m_ref.abs() <= 1e-6 * top
        out["ok"] &= bool((ok | (noise & (d <= 2 * lr))).all())
        out["max_param_diff"] = max(out["max_param_diff"], float(d.max()))
        out["floor"] += int((~ok).sum())
        out["entries"] += d.numel()
        dm = float((t(got[m_key]) - m_ref).abs().max())
        out["worst_m"] = max(out["worst_m"], dm / top if top else dm)
        del p_ref, m_ref, d, ok, noise
    out["ok"] &= out["floor"] <= 1e-4 * out["entries"] and out["worst_m"] <= 1e-5
    return out


def phase_dp_ref(torch, get_config):
    """Phase 21's dp = 1 reference on the card (this process): the second
    bf16 step of the sweep's config, as the ranks count theirs.  The ranks
    (``_dp_rank_runs``: dp = 2 in the world of two, tp = 2 x dp = 2 in the
    world of four) hold their f32 runs to one device themselves."""
    mods = _dp_mods()
    if DP_DIR.exists():
        shutil.rmtree(DP_DIR)
    DP_DIR.mkdir(parents=True)
    cfg = _dp_cfg(get_config, DP["n_layers"])
    full = get_config(DP["arch"]).n_layers
    ref = {}
    sess = _dp_session(mods, cfg, vote=False)
    _timed_step(torch, sess)
    m, host_s, ev_ms = _timed_step(torch, sess)     # the second step, as the ranks count
    ref["dp1"] = dict(metrics=m, s=host_s, event_ms=ev_ms,
                      peak_bytes=torch.cuda.max_memory_allocated())
    del sess
    torch.cuda.empty_cache()
    log(f"[dp] dp = 1 reference ({_describe(cfg, full)}): the second step's loss "
        f"{m['loss']:.6f}, {host_s * 1e3:.1f} ms host, {ev_ms:.1f} ms CUDA events")
    return ref


def phase_dp_checks(torch, get_config, store, smi, ref, outs, ranks_s):
    """Phase 21 after the worlds: the ranks' ZeRO-3 checkpoint restored on
    one device, then ``_dp_check`` on ``outs`` ({world: each rank's
    results})."""
    mods = _dp_mods()
    ck = DP["ckpt"]
    ccfg = _dp_cfg(get_config, ck["n_layers"], "float32", ck["vocab"])
    sess = _dp_session(mods, ccfg, vote=True, replicas=DP["ranks"],
                       global_batch=ck["global_batch"], seed=2)
    restored, extra, step = store.restore_latest(DP_DIR / "ck", sess.state, log=log)
    sess.state = restored
    dp1_xent = float(sess.evaluate(sess.batches(ck["fail_at"]))["xent"])
    del sess, restored
    torch.cuda.empty_cache()
    shutil.rmtree(DP_DIR)
    return _dp_check(get_config, ref, outs, ranks_s, smi,
                     dict(step=step, next_step=extra["next_step"], xent=dp1_xent))


def _dp_rank_runs(torch, np, world):
    """One rank of phase 21 at dp = 2 (``world`` 2) or tp = 2 x dp = 2 (4):
    its runs, results and checks."""
    import collections
    import torch.distributed as dist
    from repro_torch.checkpoint.elastic import host_snapshot
    from repro_torch.configs import get_config
    from repro_torch.core import tp, zero
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    mods = _dp_mods()
    rank = dist.get_rank()
    mesh = make_recipe_mesh(tp=1 if world == DP["ranks"] else 2, device_type="cuda")
    out = {"mesh": describe(mesh), "seconds": {}}
    t_part = [time.perf_counter()]

    def part(name):
        """This rank's host seconds since the last part ended, as ``name``."""
        now = time.perf_counter()
        out["seconds"][name] = now - t_part[0]
        t_part[0] = now

    def counted(key, fn):
        """``fn()`` with the launch and collective counts zeroed just before
        and read just after."""
        heads = collections.Counter()
        build.launch_counts.clear()
        tp.reset()
        with recording_heads(heads):
            res = fn()
        out[key] = dict(launches=dict(build.launch_counts), heads=dict(heads),
                        collectives=dict(tp.by_group), bytes=dict(tp.bytes_by_group))
        return res

    # the f32 identities: one device with 2 simulated replicas and, at dp 2,
    # without the vote (rank 0 alone); then the mesh at every ZeRO stage, the
    # vote on, and at dp 2 the GAS path at every setting of the bf16 sweep
    if world == DP["ranks"]:
        f32 = _dp_cfg(get_config, DP["f32_layers"], "float32", DP["f32_vocab"])
    else:
        f32 = _dp_cfg(get_config, DP["tp_dp_f32_layers"], "float32")
    ref = gas_ref = None
    if rank == 0:
        # kept on the card, where the stages are held to it
        sess = _dp_session(mods, f32, replicas=mesh.plane_size, seed=1)
        m = sess.step()
        ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   params=[x.detach().clone() for _, x in tree_leaves(sess.state["params"])])
        del sess
        if world == DP["ranks"]:
            sess = _dp_session(mods, f32, vote=False, seed=1)
            m = sess.step()
            gas_ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                           lr=float(m["lr"]), state=_params_and_m(sess))
            del sess
        torch.cuda.empty_cache()
    dist.barrier()
    part("f32 one-device references")
    stages = (0, 1, 2, 3) if world == DP["ranks"] else (1,)
    z0 = None
    for z in stages:
        sess = _dp_session(mods, f32, mesh=mesh, seed=1, zero_stage=z)
        m = sess.step()
        whole = [x.detach().clone() for _, x in tree_leaves(_whole_params(sess))]
        res = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   skipped=float(m["skipped"]), digest=_digest(torch, whole))
        if ref is not None:
            d = max(float((a - b).abs().max()) for a, b in zip(whole, ref["params"]))
            res.update(ref_loss=ref["loss"], ref_grad_norm=ref["grad_norm"], max_diff=d,
                       bitwise=all(torch.equal(a, b) for a, b in zip(whole, ref["params"])))
            if z0 is None:
                z0 = whole
            res["bitwise_z0"] = all(torch.equal(a, b) for a, b in zip(whole, z0))
        out[f"f32/z{z}"] = res
        del sess, whole
        torch.cuda.empty_cache()
    del ref, z0
    part("f32 ZeRO stages")
    for z, kw in DP_RUNS if world == DP["ranks"] else ():
        sess = _dp_session(mods, f32, mesh=mesh, vote=False, seed=1, zero_stage=z, **kw)
        m = sess.step()
        got = _params_and_m(sess, keep=rank == 0)
        res = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   skipped=float(m["skipped"]))
        if gas_ref is not None:
            res.update(ref_loss=gas_ref["loss"], ref_grad_norm=gas_ref["grad_norm"],
                       **_held_to(np, got, gas_ref["state"], gas_ref["lr"]))
        out[f"f32-gas/{_dp_tag(z, kw)}"] = res
        del sess, got
        torch.cuda.empty_cache()
    del gas_ref
    part("f32 GAS path")

    # bf16 at full width: the ZeRO sweep on the GAS path (consensus off, so
    # ZeRO-3 gathers as the blocks run and overlap_zero applies); then the
    # vote (the reference's default) at every stage
    cfg = _dp_cfg(get_config, DP["n_layers"])
    runs = DP_SWEEP if world == DP["ranks"] else ((1, {}, True),)
    for z, kw, vote in runs:
        tag = _dp_tag(z, kw, vote and world == DP["ranks"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sess = _dp_session(mods, cfg, mesh=mesh, vote=vote, zero_stage=z, **kw)
        init_peak = torch.cuda.max_memory_allocated()
        _timed_step(torch, sess)
        torch.cuda.reset_peak_memory_stats()
        m, host_s, ev_ms = counted(tag, lambda: _timed_step(torch, sess))
        layout = zero.Layout(sess.cfg, sess.plan, mesh, sess.state["params"])
        out[tag].update(metrics=m, step_s=host_s, event_ms=ev_ms, init_peak=init_peak,
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        expected=expected_dp_collectives(layout, cfg.n_layers, DP["gas"],
                                                         vote=vote),
                        state_bytes={k: sum(x.numel() * x.element_size()
                                            for _, x in tree_leaves(t))
                                     for k, t in (("params", sess.state["params"]),
                                                  ("m", sess.state["opt"]["m"]),
                                                  ("v", sess.state["opt"]["v"]))})
        del sess
    part("bf16 sweep")
    if world != DP["ranks"]:
        return out
    torch.cuda.empty_cache()
    for z in (0, 1, 2, 3):
        # one session a stage: each case steps from a copy of its first state
        sess = _dp_session(mods, cfg, mesh=mesh, zero_stage=z)
        initial = tree_map(lambda x: x.detach().clone(), sess.state)
        for case in DP_VOTES:
            sess.state = tree_map(lambda x: x.clone(), initial)
            before = [x.detach().clone() for _, x in tree_leaves(sess.state["params"])]
            batch = dict(sess.batches(0), _chaos_grad_scale=_dp_vote_scale(np, case))
            m = {k: float(v) for k, v in sess.step(batch).items()}
            frozen = all(torch.equal(a, b) for a, (_, b) in
                         zip(before, tree_leaves(sess.state["params"])))
            out[f"vote/z{z}/{case}"] = dict(metrics=m, frozen=frozen,
                                            digest=_digest(torch, _whole_params(sess)))
            del before
        del sess, initial
        torch.cuda.empty_cache()
    part("votes")

    # the checkpoint: ZeRO-3, f32, crashed after the step-2 checkpoint,
    # resumed in a fresh session, against a run that never crashed
    ck = DP["ckpt"]
    ccfg = _dp_cfg(get_config, ck["n_layers"], "float32", ck["vocab"])

    def session():
        return _dp_session(mods, ccfg, mesh=mesh, zero_stage=3, seed=2,
                           global_batch=ck["global_batch"])

    quiet = lambda _m: None  # noqa: E731
    sess = session()
    try:
        sess.run(ck["steps"], ckpt_dir=str(DP_DIR / "ck"), ckpt_every=ck["ckpt_every"],
                 fail_at_step=ck["fail_at"], log=quiet)
        crashed = False
    except RuntimeError as e:
        crashed = f"injected failure at step {ck['fail_at']}" in str(e)
    del sess
    sess = session()
    t0 = time.perf_counter()
    res = sess.run(ck["steps"], ckpt_dir=str(DP_DIR / "ck"), ckpt_every=ck["ckpt_every"],
                   log=quiet)
    resume_s = time.perf_counter() - t0
    resumed = host_snapshot(sess.state, sess.plan, mesh=mesh, cfg=ccfg)
    events = [(e.step, e.kind) for e in res["events"]]
    del sess
    sess = session()                     # the checkpoint alone, restored at dp 2
    sess.run(ck["fail_at"], ckpt_dir=str(DP_DIR / "ck"), log=quiet)
    xent = float(sess.evaluate(sess.batches(ck["fail_at"]))["xent"])
    del sess
    sess = session()
    sess.run(ck["steps"], log=quiet)
    straight = host_snapshot(sess.state, sess.plan, mesh=mesh, cfg=ccfg)
    bitwise = [k for k, _ in resumed] == [k for k, _ in straight] and all(
        a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(resumed, straight))
    out["ckpt"] = dict(crashed=crashed, resumed_from=res["resumed_from"], bitwise=bitwise,
                       xent=xent, events=events, resume_s=resume_s)
    part("checkpoint")
    return out


def _dp_vote_scale(np, case):
    """Per (replica, micro-batch) gradient scale: NaN in the bad replicas."""
    bad = {"bad0": (0,), "bad1": (1,), "both": (0, 1)}[case]
    s = np.ones((DP["ranks"], DP["gas"]), np.float32)
    for r in bad:
        s[r] = np.nan
    return s.reshape(-1)


def _dp_check(get_config, ref, outs, ranks_s, smi, dp1):
    """Phase 21's checks on the ranks' results; returns (the ``{"dp": ...}``
    summary, rank 0's counted main-path launches)."""
    from repro_torch.core.memory import per_device_bytes
    two, four = outs[DP["ranks"]], outs[4]
    out = two[0]
    cfg = _dp_cfg(get_config, DP["n_layers"])
    L, G = cfg.n_layers, DP["gas"]
    n = cfg.n_params()
    log(f"[dp] {DP['ranks']} ranks ({out['mesh']}) then 4 ({four[0]['mesh']}) ran in "
        f"{ranks_s:.1f} s ({DP_LABEL}); rank 0's parts (host s): "
        + "; ".join(f"world {w}: " + ", ".join(f"{k} {v:.1f}" for k, v in o[0]["seconds"].items())
                    for w, o in ((DP["ranks"], two), (4, four))))
    summary = {"card": smi, "times_label": DP_LABEL, "memory": {}, "collectives": {},
               "times": {}, "f32": {}, "vote": {}}
    # the f32 identities
    for z in (0, 1, 2, 3):
        r = out[f"f32/z{z}"]
        rel = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        log(f"[dp] f32 {DP['f32_layers']} layer(s), vocab {DP['f32_vocab']}, ZeRO-{z}, the vote "
            f"over 2 ranks vs one device with 2 simulated replicas: loss {r['loss']:.7f} vs "
            f"{r['ref_loss']:.7f}, grad_norm "
            f"{r['grad_norm']:.7f} vs {r['ref_grad_norm']:.7f}; params max |diff| "
            f"{r['max_diff']:.3g}, bitwise {r['bitwise']}; bitwise to ZeRO-0 {r['bitwise_z0']}")
        require(rel <= 1e-5 and r["max_diff"] <= 1e-5 and r["skipped"] == 0.0,
                f"f32 ZeRO-{z}: the mesh parts from one device (loss rel {rel:.3g}, params "
                f"{r['max_diff']:.3g})")
        require(r["bitwise_z0"], f"f32 ZeRO-{z}: params differ from ZeRO-0's bits")
        require(two[1][f"f32/z{z}"]["digest"] == r["digest"],
                f"f32 ZeRO-{z}: rank 1's params differ from rank 0's")
        summary["f32"][f"z{z}"] = dict(bitwise_to_one_device=r["bitwise"],
                                       bitwise_to_z0=r["bitwise_z0"], max_diff=r["max_diff"])
    r4 = four[0]["f32/z1"]
    log(f"[dp] f32 tp 2 x dp 2, {DP['tp_dp_f32_layers']} layers, ZeRO-1: loss {r4['loss']:.7f} "
        f"vs one device {r4['ref_loss']:.7f}"
        f"; params max |diff| {r4['max_diff']:.3g} (tol 1e-5)")
    require(abs(r4["loss"] - r4["ref_loss"]) <= 1e-5 * abs(r4["ref_loss"])
            and r4["max_diff"] <= 1e-5, "f32 tp 2 x dp 2 parts from one device")
    require(all(o["f32/z1"]["digest"] == r4["digest"] for o in four[1:]),
            "f32 tp 2 x dp 2: the ranks' params differ")
    summary["f32"]["tp2dp2_z1_max_diff"] = r4["max_diff"]
    for z, kw in DP_RUNS:
        tag = _dp_tag(z, kw)
        r = out[f"f32-gas/{tag}"]
        rel = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        rel_n = abs(r["grad_norm"] - r["ref_grad_norm"]) / abs(r["ref_grad_norm"])
        log(f"[dp] f32 {DP['f32_layers']} layer(s), vocab {DP['f32_vocab']}, {tag}, the GAS "
            f"path over 2 ranks vs one device: loss {r['loss']:.7f} vs {r['ref_loss']:.7f}, "
            f"grad_norm "
            f"{r['grad_norm']:.7f} vs {r['ref_grad_norm']:.7f}; params max |diff| "
            f"{r['max_param_diff']:.3g}, {r['floor']} of {r['entries']} past 1e-5 (Adam's "
            f"noise floor, each within 2 lr); m max |diff| {r['worst_m']:.3g} of its "
            f"leaf's largest")
        require(rel <= 1e-5 and rel_n <= 1e-5 and r["skipped"] == 0.0 and r["ok"],
                f"f32 GAS {tag}: the mesh parts from one device (loss rel {rel:.3g}, "
                f"grad_norm rel {rel_n:.3g}, {r})")
        require(two[1][f"f32-gas/{tag}"]["loss"] == r["loss"], f"f32 GAS {tag}: rank 1's loss")
        summary["f32"][f"gas/{tag}"] = dict(loss_rel=rel, grad_norm_rel=rel_n,
                                            max_param_diff=r["max_param_diff"],
                                            floor=r["floor"], m_rel=r["worst_m"])

    # the bf16 sweep: collectives, memory and times
    want_l = {"flash_fwd": 2 * L * G, "flash_delta": L * G, "flash_dq": L * G,
              "flash_dkv": L * G}
    hq = cfg.n_heads
    want_h = {(k, hq, hq): c for k, c in want_l.items()}
    t_dp = 2.0 * (2.0 * n) * (DP["ranks"] - 1) / DP["ranks"]
    launch_runs = []
    for z, kw, vote in DP_SWEEP:
        tag = _dp_tag(z, kw, vote)
        run, m = out[tag], out[tag]["metrics"]
        model = per_device_bytes(cfg, dp=DP["ranks"], tp=1, pp=1, zero_stage=z, mbs=1, gas=G,
                                 seq=DP["seq_len"], remat="full")
        grad_bytes = sum(v for k, v in run["bytes"].items()
                         if k.split("@")[1] == "data")
        log(f"[dp] bf16 {tag}: loss {m['loss']:.6f} (dp 1 {ref['dp1']['metrics']['loss']:.6f}), "
            f"skipped {m['skipped']:.0f}; peak {run['peak_bytes'] / 2**30:.3f} GiB a rank in "
            f"the step ({run['init_peak'] / 2**30:.3f} GiB at init), memory model "
            f"{model['total'] / 2**30:.3f} GiB (params {model['params'] / 2**30:.3f}, grads "
            f"{model['grads'] / 2**30:.3f}, optimizer {model['optimizer'] / 2**30:.3f}, "
            f"activations {model['activations'] / 2**30:.3f}, logits "
            f"{model['logits'] / 2**30:.3f}); state a rank {run['state_bytes']}")
        log(f"[dp] bf16 {tag}: collectives {run['collectives']} (expected {run['expected']}), "
            f"bytes {run['bytes']}; over the data axis {grad_bytes} B, the cost model's t_dp "
            f"{t_dp:.0f} B (reduce-scatter + all-gather of bf16 gradients); the second step "
            f"{run['step_s'] * 1e3:.1f} ms host, {run['event_ms']:.1f} ms CUDA events "
            f"({DP_LABEL}); launches {run['launches']}")
        require(math.isfinite(m["loss"]) and m["skipped"] == 0.0, f"bf16 {tag}: {m}")
        require(abs(m["loss"] - ref["dp1"]["metrics"]["loss"]) <= TOL["bfloat16"] * abs(m["loss"]),
                f"bf16 {tag}: loss {m['loss']} vs dp 1's {ref['dp1']['metrics']['loss']}")
        require(run["collectives"] == run["expected"], f"bf16 {tag}: collectives")
        require(run["launches"] == want_l and run["heads"] == want_h,
                f"bf16 {tag}: launches {run['launches']}, heads {run['heads']}")
        require(two[1][tag]["metrics"]["loss"] == m["loss"], f"bf16 {tag}: rank 1's loss")
        launch_runs.append(run["launches"])
        summary["memory"][tag] = dict(peak_bytes=run["peak_bytes"], init_peak=run["init_peak"],
                                      model_bytes=model)
        summary["collectives"][tag] = dict(calls=run["collectives"], bytes=run["bytes"],
                                           data_axis_bytes=grad_bytes, cost_model_t_dp_bytes=t_dp)
        summary["times"][f"{tag} step ms (host, events)"] = [run["step_s"] * 1e3,
                                                             run["event_ms"]]
    summary["times"]["dp 1 step ms (host, events)"] = [ref["dp1"]["s"] * 1e3,
                                                       ref["dp1"]["event_ms"]]
    r4 = four[0]["z1"]
    log(f"[dp] bf16 tp 2 x dp 2, ZeRO-1, the vote: loss {r4['metrics']['loss']:.6f}, collectives "
        f"{r4['collectives']}; the second step {r4['step_s'] * 1e3:.1f} ms host "
        f"({DP_LABEL}, four ranks)")
    require(math.isfinite(r4["metrics"]["loss"]) and r4["metrics"]["skipped"] == 0.0
            and all(o["z1"]["metrics"]["loss"] == r4["metrics"]["loss"] for o in four[1:]),
            "bf16 tp 2 x dp 2 step")
    require({k: v for k, v in r4["collectives"].items() if k.endswith("@data")}
            == {k: v for k, v in r4["expected"].items() if k.endswith("@data")},
            f"tp 2 x dp 2: data-axis collectives {r4['collectives']}")
    summary["times"]["tp2dp2 z1 step ms (host, events)"] = [r4["step_s"] * 1e3,
                                                            r4["event_ms"]]
    # the vote
    for z in (0, 1, 2, 3):
        for case in DP_VOTES:
            v = out[f"vote/z{z}/{case}"]
            m = v["metrics"]
            log(f"[dp] vote ZeRO-{z} NaN in {case}: bad_replicas {m['bad_replicas']:.0f}, "
                f"skipped {m['skipped']:.0f}, n_replicas {m['n_replicas']:.0f}, loss "
                f"{m['loss']:.6f}, params frozen {v['frozen']}")
            want = (2.0, 1.0) if case == "both" else (1.0, 0.0)
            require((m["bad_replicas"], m["skipped"]) == want and m["n_replicas"] == 2.0,
                    f"vote ZeRO-{z} {case}: {m}")
            require(v["frozen"] == (case == "both"), f"vote ZeRO-{z} {case}: frozen")
            require(two[1][f"vote/z{z}/{case}"]["digest"] == v["digest"],
                    f"vote ZeRO-{z} {case}: the ranks' params differ")
            summary["vote"][f"z{z}/{case}"] = [m["bad_replicas"], m["skipped"]]
    # the checkpoint
    c = out["ckpt"]
    log(f"[dp] checkpoint (ZeRO-3, dp 2, f32, {DP['ckpt']['n_layers']} layer(s), vocab "
        f"{DP['ckpt']['vocab']}): crashed {c['crashed']}, resumed from {c['resumed_from']}, "
        f"resumed == never crashed bitwise {c['bitwise']}; restored at dp 1 from step "
        f"{dp1['step']}: xent {dp1['xent']:.7f} vs the mesh's {c['xent']:.7f}")
    require(c["crashed"] and c["resumed_from"] == DP["ckpt"]["fail_at"] and c["bitwise"],
            f"checkpoint: {c}")
    require(two[1]["ckpt"]["events"] == c["events"], "checkpoint: the ranks' events differ")
    require(abs(dp1["xent"] - c["xent"]) <= 1e-6 * abs(c["xent"]),
            f"checkpoint restored at dp 1: xent {dp1['xent']} vs {c['xent']}")
    summary["checkpoint"] = dict(c, dp1=dp1)
    return summary, launch_runs


# ---------------------------------------------------------------------------
# 22: pipeline parallelism as ranks on the one card
# ---------------------------------------------------------------------------

def _pp_cfg(get_config, n_layers, dtype=None, vocab=None):
    cfg = dataclasses.replace(get_config(PP["arch"]), n_layers=n_layers)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _pp_session(mods, cfg, *, mesh=None, seed=0, gas=None, global_batch=None, pp=None,
                **plan_kw):
    """A TrainSession of phase 22: remat full unless given, gas 4 (mbs 2),
    1024 tokens a row; ``pp`` stages over ``mesh``, or in this process."""
    shape = mesh.shape if mesh is not None else {"tp": 1, "data": 1, "pod": 1, "pp": pp}
    plan_kw.setdefault("remat_policy", "full")
    plan = mods.ParallelismConfig(gas=gas or PP["gas"], pp=shape["pp"], tp=shape["tp"],
                                  dp=shape["data"], pods=shape["pod"], **plan_kw)
    return mods.TrainSession.from_recipe(
        cfg, seed=seed, plan=plan, mesh=mesh,
        train_cfg=mods.stepfn.TrainConfig(total_steps=8, warmup=2),
        data_cfg=mods.DataConfig(seq_len=PP["seq_len"],
                                 global_batch=global_batch or PP["global_batch"]))


def _token_nll(torch, cfg, params, batch):
    """Per-token losses (B, S) of ``params`` on ``batch`` (one device)."""
    from repro_torch.models import layers, transformer
    with torch.no_grad():
        logits = transformer.lm_forward(cfg, params, batch, remat_policy="none")
        return (torch.logsumexp(logits, -1) - layers.gold_logit(logits, batch["labels"])).cpu()


def phase_pp_ref(torch, get_config):
    """Phase 22's pp = 1 reference (this process): one bf16 step, then its
    per-token losses after it, in bf16 and on the f32 masters (the floor).
    The ranks (``_pp_rank_runs``: pp = 2 in the world of two, pp 2 x dp 2 in
    the world of four) hold their f32 runs to one device themselves (rank 0
    computes the one-device runs first)."""
    mods = _dp_mods()
    cfg, full = _pp_cfg(get_config, PP["n_layers"]), get_config(PP["arch"]).n_layers
    sess = _pp_session(mods, cfg, pp=1)
    m = {k: float(v) for k, v in sess.step().items()}
    batch = sess._to_device(sess.batches(PP["eval_step"]))
    ref = dict(loss=m["loss"], nll=_token_nll(torch, cfg, sess.state["params"], batch),
               nll_f32=_token_nll(torch, dataclasses.replace(cfg, dtype="float32"),
                                  sess.state["params"], batch))
    del sess, batch
    torch.cuda.empty_cache()
    log(f"[pp] pp = 1 reference ({_describe(cfg, full)}): the first step's loss "
        f"{ref['loss']:.6f}; per-token losses after it on batch {PP['eval_step']}")
    return ref


def _own_digest(torch, sess):
    """The digest of this rank's leaves outside the blocks (every stage
    holds them)."""
    return _digest(torch, {k: v for k, v in sess.state["params"].items() if k != "blocks"})


def _pass_peaks(torch, pipeline):
    """Record, for every pipeline pass, the most device memory it held above
    what was allocated when it began (its stash, the gradients it
    accumulates and its transients): ``pipeline.run_pipeline`` wrapped in
    this process (the caller puts the original back).  → the list the
    wrapper appends to."""
    peaks, real = [], pipeline.run_pipeline

    def measured(*args, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    pipeline.run_pipeline = measured
    return peaks


def _pp_rank_runs(torch, np, world):
    """One rank of phase 22 at pp = 2 (``world`` 2) or pp 2 x dp 2 (4)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline, tp
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    mods = _dp_mods()
    rank = dist.get_rank()
    mesh = make_recipe_mesh(pp=2, device_type="cuda")
    out = {"mesh": describe(mesh), "stage": mesh.coords["pp"], "coords": dict(mesh.coords)}

    def counted(key, fn):
        """``fn()`` with the launch and message counts zeroed just before
        and read just after."""
        build.launch_counts.clear()
        tp.reset()
        res = fn()
        out[key] = dict(launches=dict(build.launch_counts), collectives=dict(tp.by_group),
                        bytes=dict(tp.bytes_by_group))
        return res

    # the f32 identities at 4 layers: one device at the same plan (the
    # stages in one process) and at pp 1, rank 0 alone; then the mesh
    f32 = _pp_cfg(get_config, PP["f32_layers"], "float32", PP["f32_vocab"])
    runs = PP_F32 if world == PP["ranks"] else (("dp2-z1", {"zero_stage": 1}),)
    refs = {}
    if rank == 0:
        for tag, kw in runs:
            sess = _pp_session(mods, f32, seed=1, pp=2, **kw)
            m = sess.step()
            refs[tag] = dict(loss=float(m["loss"]), lr=float(m["lr"]),
                             state=_params_and_m(sess))
            del sess
        if world == PP["ranks"]:
            sess = _pp_session(mods, f32, seed=1, pp=1)
            m = sess.step()
            refs["pp1"] = dict(loss=float(m["loss"]), lr=float(m["lr"]),
                               state=_params_and_m(sess))
            del sess
        torch.cuda.empty_cache()
    dist.barrier()
    for tag, kw in runs:
        sess = _pp_session(mods, f32, mesh=mesh, seed=1, **kw)
        m = sess.step()
        got = _params_and_m(sess, keep=rank == 0)
        res = dict(loss=float(m["loss"]), skipped=float(m["skipped"]),
                   shared=_own_digest(torch, sess))
        for key in (tag, "pp1"):
            if key in refs:
                r = refs[key]
                res[f"vs_{'one' if key == tag else 'pp1'}"] = dict(
                    ref_loss=r["loss"], **_held_to(np, got, r["state"], r["lr"]))
        out[f"f32/{tag}"] = res
        del sess, got
        torch.cuda.empty_cache()
    del refs

    # bf16: one counted step (launches, messages, collectives, peak memory,
    # times); at pp 2 it follows a first, after which the per-token losses
    # are taken
    cfg = _pp_cfg(get_config, PP["n_layers"])
    bf16 = PP_RUNS if world == PP["ranks"] else (("dp2-z1", {"zero_stage": 1}),)
    for tag, kw in bf16:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sess = _pp_session(mods, cfg, mesh=mesh, **kw)
        init_peak = torch.cuda.max_memory_allocated()
        first = None
        if tag == "pp2":
            first, _, _ = _timed_step(torch, sess)
            # per-token losses after the first step, the whole model on rank 0
            whole = _whole_params(sess)
            if rank == 0:
                out["nll"] = _token_nll(torch, cfg, whole,
                                        sess._to_device(sess.batches(PP["eval_step"])))
            del whole
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        real_run = pipeline.run_pipeline
        peaks = _pass_peaks(torch, pipeline)
        try:
            m, host_s, ev_ms = counted(tag, lambda: _timed_step(torch, sess))
        finally:
            pipeline.run_pipeline = real_run
        # the pass's wrapper reset the peak as the pass began: what is read
        # here covers the pass and the update, where the step peaks
        step_peak = torch.cuda.max_memory_allocated()
        out[tag].update(metrics=m, first_loss=first and first["loss"], step_s=host_s,
                        event_ms=ev_ms,
                        init_peak=init_peak, peak_bytes=step_peak, pass_bytes=peaks[0],
                        in_flight=list(sess.train_step.in_flight), plan=sess.plan)
        del sess
    return out


def _pp_check(get_config, ref, outs, ranks_s, smi):
    """Phase 22's checks on the ranks' results; returns (the ``{"pp": ...}``
    summary, rank 0's counted main-path launches)."""
    from repro_torch.core import pipeline
    from repro_torch.core.memory import activation_bytes_per_layer, per_device_bytes
    two, four = outs[PP["ranks"]], outs[4]
    cfg = _pp_cfg(get_config, PP["n_layers"])
    L, d, seq = cfg.n_layers, cfg.d_model, PP["seq_len"]
    log(f"[pp] {PP['ranks']} ranks ({two[0]['mesh']}) then 4 ({four[0]['mesh']}) ran in "
        f"{ranks_s:.1f} s ({PP_LABEL})")
    summary = {"card": smi, "times_label": PP_LABEL, "f32": {}, "messages": {}, "memory": {},
               "in_flight": {}, "times": {}}
    # the f32 identities
    for world, outs_w, runs in ((PP["ranks"], two, PP_F32), (4, four, (("dp2-z1", {}),))):
        for tag, _ in runs:
            r = outs_w[0][f"f32/{tag}"]
            for key in ("vs_one", "vs_pp1"):
                if key not in r:
                    continue
                h = r[key]
                rel = abs(r["loss"] - h["ref_loss"]) / abs(h["ref_loss"])
                log(f"[pp] f32 {PP['f32_layers']} layers, vocab {PP['f32_vocab']}, {tag} over "
                    f"{world} ranks "
                    f"{'vs one device, the same plan' if key == 'vs_one' else 'vs pp 1'}: "
                    f"loss {r['loss']:.7f} vs {h['ref_loss']:.7f} (rel {rel:.3g}); params max "
                    f"|diff| {h['max_param_diff']:.3g}, {h['floor']} of {h['entries']} past "
                    f"1e-5 (Adam's noise floor, each within 2 lr); m max |diff| "
                    f"{h['worst_m']:.3g} of its leaf's largest")
                require(rel <= 1e-5 and h["ok"] and r["skipped"] == 0.0,
                        f"f32 {tag} {key}: the pipeline parts from one device ({h})")
                summary["f32"][f"{tag}/{key}"] = dict(loss_rel=rel,
                                                      max_param_diff=h["max_param_diff"],
                                                      floor=h["floor"], m_rel=h["worst_m"])
            require(all(o[f"f32/{tag}"]["shared"] == r["shared"] for o in outs_w),
                    f"f32 {tag}: the leaves every stage holds differ in bits between ranks")
            require(all(o[f"f32/{tag}"]["loss"] == r["loss"] for o in outs_w),
                    f"f32 {tag}: the ranks' losses differ")
    # bf16: per-token losses after the first step against pp 1
    nll = two[0]["nll"]
    diff = float((nll - ref["nll"]).abs().max())
    floor = float((ref["nll"] - ref["nll_f32"]).abs().max())
    log(f"[pp] bf16 per-token loss after one step, (B, S) = {tuple(nll.shape)}: max |pp 2 - "
        f"pp 1| {diff:.4g}; bf16 noise floor max |pp 1 - pp 1 on the f32 masters| {floor:.4g} "
        f"(tol: {LOGIT_FLOOR_FACTOR} x floor); first-step loss pp 2 "
        f"{two[0]['pp2']['first_loss']:.6f} vs pp 1 {ref['loss']:.6f}")
    require(bool(nll.isfinite().all()) and diff <= LOGIT_FLOOR_FACTOR * floor,
            f"bf16 per-token losses differ from pp 1 by {diff:.4g}, more than "
            f"{LOGIT_FLOOR_FACTOR} x bf16's own error {floor:.4g}")
    summary["bf16_per_token"] = dict(max_diff=diff, floor=floor)
    # bf16: launches, messages, in flight, memory, times
    mbs = PP["global_batch"] // PP["gas"]
    stash = activation_bytes_per_layer(cfg, mbs, seq, remat="full") * (L // PP["ranks"])
    launch_runs = []
    for world, outs_w, runs in ((PP["ranks"], two, PP_RUNS), (4, four, (("dp2-z1", {}),))):
        for tag, _ in runs:
            for o in outs_w:
                run = o[tag]
                plan, p, m = run["plan"], o["stage"], run["metrics"]
                sched = pipeline.Schedule(plan.pp, plan.vpp, plan.gas)
                per_layer = 3 if plan.remat_policy == "stage" else 2
                lp = L // plan.pp
                want_l = {"flash_fwd": per_layer * lp * plan.gas, "flash_delta": lp * plan.gas,
                          "flash_dq": lp * plan.gas, "flash_dkv": lp * plan.gas}
                n, nbytes = expected_pp_p2p(plan.pp, plan.vpp, plan.gas, p, plan.tp,
                                            mbs=mbs // plan.dp, seq=seq, d_model=d,
                                            itemsize=cfg.compute_dtype.itemsize,
                                            sp=plan.sequence_parallel)
                got_n = {k: run["collectives"].get(k, 0) for k in n}
                got_b = {k: run["bytes"].get(k, 0) for k in n}
                supersteps = plan.vpp * plan.gas + plan.pp - 1
                t_pp = 2.0 * mbs * seq * d * 2.0 * supersteps
                model = per_device_bytes(cfg, dp=plan.dp, tp=1, pp=plan.pp, mbs=mbs,
                                         gas=plan.gas, seq=seq, zero_stage=plan.zero_stage,
                                         remat=plan.remat_policy)
                flight = sched.in_flight_formula(p)
                log(f"[pp] bf16 {tag} rank {o['coords']} (stage {p}): loss {m['loss']:.6f}, "
                    f"skipped {m['skipped']:.0f}; launches {run['launches']} (expected "
                    f"{want_l}); messages {got_n}, {got_b} B (expected {n}, {nbytes}); the "
                    f"cost model's t_pp bytes {t_pp:.0f} (2 x mbs x seq x d x 2 B x "
                    f"{supersteps} supersteps); collectives {run['collectives']}; in flight "
                    f"{run['in_flight']} (formula {flight}); peak {run['peak_bytes'] / 2**30:.3f}"
                    f" GiB in the step ({run['init_peak'] / 2**30:.3f} GiB at init; the "
                    f"pipeline pass {run['pass_bytes'] / 2**30:.3f} GiB above its start), memory "
                    f"model {model['total'] / 2**30:.3f} GiB (activations "
                    f"{model['activations'] / 2**30:.3f}); the second step "
                    f"{run['step_s'] * 1e3:.1f} ms host, {run['event_ms']:.1f} ms CUDA events "
                    f"({PP_LABEL})")
                require(math.isfinite(m["loss"]) and m["skipped"] == 0.0, f"bf16 {tag}: {m}")
                require(run["launches"] == want_l, f"bf16 {tag} stage {p}: launches "
                        f"{run['launches']}, expected {want_l}")
                require(got_n == n and got_b == nbytes, f"bf16 {tag} stage {p}: messages "
                        f"{got_n} {got_b}, expected {n} {nbytes}")
                require(run["collectives"].get("all_reduce@pp") == 2
                        and run["collectives"].get("all_reduce@world") == 2,
                        f"bf16 {tag} stage {p}: collectives {run['collectives']}")
                require(run["in_flight"] == [flight], f"bf16 {tag} stage {p}: in flight "
                        f"{run['in_flight']}, the schedule's {flight}")
                require(run["peak_bytes"] < 80e9, f"bf16 {tag}: peak {run['peak_bytes']} B")
                require(m["loss"] == outs_w[0][tag]["metrics"]["loss"],
                        f"bf16 {tag}: the ranks' losses differ")
                key = f"{tag}/rank{o['coords']['data']}{p}"
                summary["messages"][key] = dict(calls=got_n, bytes=got_b, t_pp_bytes=t_pp)
                summary["in_flight"][key] = run["in_flight"][0]
                summary["memory"][key] = dict(peak_bytes=run["peak_bytes"],
                                              init_peak=run["init_peak"],
                                              pass_bytes=run["pass_bytes"],
                                              model_bytes=model["total"])
                summary["times"][f"{key} step ms (host, events)"] = [run["step_s"] * 1e3,
                                                                     run["event_ms"]]
            launch_runs.append(outs_w[0][tag]["launches"])
    g4, g8 = two[0]["pp2"]["pass_bytes"], two[0]["pp2-gas8"]["pass_bytes"]
    s4, s8 = two[0]["pp2"]["peak_bytes"], two[0]["pp2-gas8"]["peak_bytes"]
    grow = PP["big_gas"] - PP["gas"]
    log(f"[pp] stage 0 from gas 4 to gas 8: its pipeline pass held at most "
        f"{g4 / 2**30:.3f} -> {g8 / 2**30:.3f} GiB above its start (+{(g8 - g4) / 2**20:.1f} "
        f"MiB), the step's peak {s4 / 2**30:.3f} -> {s8 / 2**30:.3f} GiB "
        f"(+{(s8 - s4) / 2**20:.1f} MiB); one micro-batch's stash {stash / 2**20:.1f} MiB (the "
        f"memory model: 2 x mbs x seq x d B a layer x {L // PP['ranks']} layers); a schedule "
        f"that kept every micro-batch would grow by {grow} of them "
        f"({grow * stash / 2**20:.1f} MiB)")
    require(g8 - g4 < stash and s8 - s4 < stash,
            f"stage 0 grew from gas 4 to gas 8 by {g8 - g4} B in the pass and {s8 - s4} B "
            f"at the step's peak, not less than one micro-batch's stash {stash:.0f} B")
    summary["memory"]["gas4_to_gas8_stage0"] = dict(pass_growth=g8 - g4,
                                                    peak_growth=s8 - s4, stash=stash)
    return summary, launch_runs


# ---------------------------------------------------------------------------
# phase 24: the VLM family
# ---------------------------------------------------------------------------

def phase_vlm(torch, np, build, InferenceSession, tree_map, smi):
    """Phase 24's serving part (the training part is ``phase_train`` with
    ``TRAIN_VLM``): internvl2-1b at full depth, random bf16 weights from
    seed 0, its vision positions random embeddings.  Returns the counted
    runs' launches."""
    spec = VLM
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    L, V, nv, d = cfg.n_layers, cfg.vocab_size, cfg.n_vision_tokens, cfg.d_model
    B, N = spec["batch"], spec["new_tokens"]
    S = nv + spec["text_len"]
    build_peak = torch.cuda.max_memory_allocated()
    log(f"[vlm] {_describe(cfg, L)}; {nv} vision positions, {cfg.n_heads // cfg.n_kv_heads} "
        f"query heads a KV head, {cfg.dtype}; build {time.perf_counter() - t0:.1f} s, peak "
        f"{build_peak} B ({build_peak / 1e9:.3f} GB) for {2 * cfg.n_params() / 1e9:.3f} GB of "
        f"bf16 weights")
    rs = np.random.RandomState(0)
    host = {"tokens": rs.randint(0, V, size=(B, S)).astype(np.int32),
            "vision_embeds": rs.standard_normal((B, nv, d)).astype(np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}

    # the prefill over [vision; text], counted; held to the plain versions
    # and to the plain versions on an f32 copy of the weights
    build.launch_counts.clear()
    lk = sess.prefill(batch, last_only=False)
    torch.cuda.synchronize()
    pre = dict(build.launch_counts)
    require(pre == {"flash_fwd": L}, f"prefill launched {pre}, expected K1 {L}")
    require(tuple(lk.shape) == (B, S, V) and bool(lk.isfinite().all()),
            f"prefill gave {tuple(lk.shape)}, or non-finite logits")
    runs.append(pre)
    text = sess.prefill({"tokens": batch["tokens"]}, last_only=False)
    moved = float((text[:, :nv] - lk[:, :nv]).abs().max())
    del text
    require(moved > 0, "the vision embeddings moved no logit of the vision positions")
    with plain_versions():
        lp = sess.prefill(batch, last_only=False)
        sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                  tree_map(lambda x: x.float(), sess.params), device=sess.device)
        lf = sess32.prefill(batch, last_only=False)
        del sess32
    floor = hold_to_floor("vlm", f"prefill logits over [{nv} vision; {S - nv} text] (B, S, V) = "
                          f"{tuple(lk.shape)}", lk, lp, lf)
    last = lk[:, -1].clone()
    del lk, lp, lf
    torch.cuda.empty_cache()

    # the cache-populating prefill of the same batch, then N decode steps
    # (token-only, as the reference's), counted
    with torch.inference_mode():
        caches = sess.init_cache(B, S + N)
        build.launch_counts.clear()
        logits, caches = sess.prefill_cache_step(sess.params, batch, caches)
        tok = logits.argmax(-1).to(torch.int32)
        toks = [tok]
        for t in range(S, S + N):
            tok, caches = sess.serve_step(sess.params, tok, t, caches)
            toks.append(tok)
        torch.cuda.synchronize()
    c = dict(build.launch_counts)
    want = {"flash_fwd": L, "decode_attention": L * N}
    diff = float((logits - last).abs().max())
    out = torch.stack(toks, 1).cpu().numpy()
    log(f"[vlm] cache-populating prefill of the same batch, then {N} decode steps: launches "
        f"{c} (expected {want}); its last-position logits against the prefill's: max |diff| "
        f"{diff:.4g} (tol {LOGIT_FLOOR_FACTOR} x floor {floor:.4g})")
    require(c == want, f"prefill_cache + {N} decode steps launched {c}, expected {want}")
    require(diff <= LOGIT_FLOOR_FACTOR * floor, f"the cache prefill's logits differ by {diff}")
    require(bool(((out >= 0) & (out < V)).all()), "decoded ids out of range")
    runs.append(c)

    # a decode step's host and device time, at the depth just served
    with torch.inference_mode():
        caches = sess.init_cache(B, S + N)
        logits, caches = sess.prefill_cache_step(sess.params, batch, caches)
        tok0 = logits.argmax(-1).to(torch.int32)

        def decode():
            tok = tok0
            for t in range(S, S + N):
                tok, _ = sess.serve_step(sess.params, tok, t, caches)

        decode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / N * 1e3
        prof = profile_window(torch, decode, top=8)
    dev = prof["device_ms"] / N if prof["device_ms"] else float("nan")
    log(f"[vlm] decode step at batch {B}, positions {S}-{S + N - 1}: {host_ms:.3f} ms host "
        f"clock, {dev:.3f} ms device time (profiled, {N} steps); {smi}")
    _log_profile("vlm decode", prof, host_ms * N)
    del caches, logits
    torch.cuda.empty_cache()

    # generate, text only, at B 8
    P, G = spec["gen_prompt"], spec["gen_batch"]
    prompts = rs.randint(0, V, size=(G, P)).astype(np.int32)
    build.launch_counts.clear()
    t0 = time.perf_counter()
    gen = sess.generate(prompts, N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    c = dict(build.launch_counts)
    want = {"flash_fwd": L, "decode_attention": L * (N - 1)}
    g = gen.cpu().numpy()
    log(f"[vlm] generate (text only) {tuple(gen.shape)} in {gen_s:.2f} s; launches {c} "
        f"(expected {want})")
    require(c == want, f"generate launched {c}, expected {want}")
    require(g.shape == (G, P + N) and bool((g[:, :P] == prompts).all())
            and bool(((g >= 0) & (g < V)).all()), "generate altered the prompts or ids")
    runs.append(c)

    # a short stream on contiguous slots; the paged pool refused
    lens, gens = spec["stream_lens"], list(spec["stream_gens"])
    stream = [rs.randint(1, V, size=n).astype(np.int32) for n in lens]
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    outs, st = sess.serve(stream, gens, n_slots=spec["slots"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(build.launch_counts)
    log(f"[vlm] stream: {st.requests} requests on {spec['slots']} slots, {st.generated_tokens} "
        f"tokens, {st.decode_steps} decode steps in {wall:.2f} s (host clock); occupancy "
        f"{st.occupancy:.4f}, stranded_fraction {st.stranded_fraction:.4f}; launches {c}; peak "
        f"{torch.cuda.max_memory_allocated()} B")
    require(st.requests == len(stream) and st.generated_tokens == sum(gens),
            f"the stream served {st}")
    require(c.get("decode_attention", 0) == L * st.decode_steps,
            f"K5 launched {c.get('decode_attention', 0)} times, expected {L} x {st.decode_steps}")
    require(c.get("flash_fwd", 0) > 0 and c["flash_fwd"] % L == 0,
            f"K1 launched {c.get('flash_fwd', 0)} times, not a positive multiple of {L}")
    require(c.get("paged_decode_attention", 0) == 0, "K6 ran on slots")
    for pr, m, o in zip(stream, gens, outs):
        require(len(o) == len(pr) + m and bool((o[:len(pr)] == pr).all()),
                f"a request came back with {len(o)} tokens or altered")
    runs.append(c)
    try:
        sess.serve(stream[:2], [2, 2], paged=True)
        refused = ""
    except ValueError as e:
        refused = str(e)
    log(f"[vlm] serve(paged=True) raises ValueError: {refused[:120]!r}")
    require("paged" in refused, "the VLM served from the paged pool")
    del sess, gen
    torch.cuda.empty_cache()
    return runs


def _train_memory(get_config, measured, spec, tag):
    """A training phase's peak beside ``core.memory.per_device_bytes``."""
    from repro_torch.core.memory import per_device_bytes
    cfg, _ = _dense_cfg(get_config, spec)
    est = per_device_bytes(cfg, dp=1, tp=1, pp=1, mbs=spec["global_batch"] // spec["gas"],
                           gas=spec["gas"], seq=spec["seq_len"], remat="full")
    log(f"[{tag}] peak {measured['peak_bytes']} B ({measured['peak_bytes'] / 1e9:.2f} GB) "
        f"beside per_device_bytes {est['total']:.4g} B (params {est['params']:.4g}, grads "
        f"{est['grads']:.4g}, optimizer {est['optimizer']:.4g}, activations "
        f"{est['activations']:.4g}, logits {est['logits']:.4g}; ratio "
        f"{measured['peak_bytes'] / est['total']:.3f}) and the card's 80 GB; profiled step "
        f"{measured['device_ms']:.2f} ms of device time")
    return est


def _unembed_share(torch, get_config, measured, smi):
    """The unembed's part of phase 24's training step: its forward and
    backward (the f32 product of the hidden states with the tied table, and
    the two products of its gradient) at one micro-batch's shape, in device
    time, times the micro-batches, beside the step's profiled device time."""
    from repro_torch.models import layers
    cfg, _ = _dense_cfg(get_config, TRAIN_VLM)
    T = TRAIN_VLM["global_batch"] // TRAIN_VLM["gas"] * TRAIN_VLM["seq_len"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda").to(
        cfg.compute_dtype).requires_grad_()
    table = (0.02 * torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                device="cuda")).requires_grad_()
    cot = torch.randn((T, cfg.vocab_size), generator=gen, device="cuda")

    def fwd_bwd():
        torch.autograd.grad(layers.unembed(table, x), (x, table), cot)

    ms = device_ms(torch, fwd_bwd, n=5)
    step = ms * TRAIN_VLM["gas"]
    flops = 3 * 2.0 * T * cfg.d_model * cfg.vocab_size
    share = step / measured["device_ms"] if measured["device_ms"] else float("nan")
    log(f"[vlm train] the unembed (f32, {T} x {cfg.d_model} by {cfg.d_model} x "
        f"{cfg.vocab_size}, forward and backward) {ms:.3f} ms of device time a micro-batch, "
        f"{step:.3f} ms a step of {TRAIN_VLM['gas']}: {share:.1%} of the step's "
        f"{measured['device_ms']:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s against the f32 "
        f"peak {H100_F32_FLOP_PER_S / 1e12:.0f}); {smi}")
    del x, table, cot
    torch.cuda.empty_cache()
    return dict(ms_per_micro=ms, share=share)


# ---------------------------------------------------------------------------
# phase 25: the MoE family under pipeline parallelism
# ---------------------------------------------------------------------------

def _family_pp_session(mods, cfg, spec, vpp, mesh=None):
    """A TrainSession of phase 25 or 26 (``spec``: ``MOE_PP`` or
    ``HYBRID_PP``): pp 2 over ``mesh``, or its stages in this process."""
    plan = mods.ParallelismConfig(pp=2, vpp=vpp, gas=spec["gas"], remat_policy="full")
    return mods.TrainSession.from_recipe(
        cfg, seed=0, plan=plan, mesh=mesh,
        train_cfg=mods.stepfn.TrainConfig(total_steps=8, warmup=2),
        data_cfg=mods.DataConfig(seq_len=spec["seq_len"], global_batch=spec["global_batch"]))


def _spawn_ranks(torch, runs: str, ranks: int, out_dir: Path):
    """``runs`` (the name of a function of this module) in ``ranks``
    processes on the one card over gloo (``_rank_main``), as phase 22 runs
    them → (each rank's results, the seconds they took)."""
    import socket
    import torch.multiprocessing as mp
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    mp.start_processes(_rank_main, args=(ranks, port, runs, str(out_dir)), nprocs=ranks,
                       join=True, start_method="spawn")
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(ranks)]
    seconds = time.perf_counter() - t0
    shutil.rmtree(out_dir)
    return outs, seconds


def _rank_main(rank: int, world: int, port: int, runs: str, out_dir: str) -> None:
    """One spawned rank of ``_spawn_ranks``: gloo over localhost on
    ``cuda:0``, ``runs``'s results to ``out_dir/rank<r>.pt``."""
    with _rank(rank, world, port) as torch:
        torch.save(globals()[runs](torch), Path(out_dir) / f"rank{rank}.pt")


def run_world(torch, runs: str, ranks: int):
    """The world ``runs`` names (``_world_of_two`` or ``_world_of_four``)
    in ``ranks`` processes on the one card → ({phase: each rank's results},
    {phase: rank 0's host seconds}), the seconds logged."""
    outs, seconds = _spawn_ranks(torch, runs, ranks, WORLDS_DIR)
    by_phase = outs[0].pop("seconds")
    log(f"[worlds] {ranks} ranks ran in {seconds:.1f} s ({FAMILY_TP_LABEL}); rank 0's host "
        f"seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in by_phase.items())
        + f"; starting and joining the processes {seconds - sum(by_phase.values()):.1f}")
    return {k: [o[k] for o in outs] for k in by_phase}, by_phase


def _world_of_two(torch):
    """Each rank of the world of two: phase 20's tp = 2, 21's dp = 2, 22's
    pp = 2, then 25's and 26's pipelines, in turn."""
    import numpy as np
    return _in_turn(torch, (("20", lambda: _tp_rank_runs(torch, np, 2)),
                            ("21", lambda: _dp_rank_runs(torch, np, 2)),
                            ("22", lambda: _pp_rank_runs(torch, np, 2)),
                            ("25", lambda: _moe_pp_rank_runs(torch)),
                            ("26", lambda: _hybrid_pp_rank_runs(torch))))


def _world_of_four(torch):
    """Each rank of the world of four: phase 21's tp = 2 x dp = 2, 22's pp 2
    x dp 2, then 29's xlstm and whisper at tp 2 x dp 2, in turn."""
    import numpy as np
    return _in_turn(torch, (("21", lambda: _dp_rank_runs(torch, np, 4)),
                            ("22", lambda: _pp_rank_runs(torch, np, 4)),
                            ("29", lambda: _family_tp_runs(torch, FAMILY_TP["tp_dp"]))))


def _in_turn(torch, phases):
    """Each phase's runs, the card's cache emptied after each → {phase: its
    results, "seconds": {phase: host seconds}}."""
    import gc
    out = {"seconds": {}}
    for name, fn in phases:
        t0 = time.perf_counter()
        out[name] = fn()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["seconds"][name] = time.perf_counter() - t0
    return out


def _moe_pp_rank_runs(torch):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    mods = _dp_mods()
    rank = dist.get_rank()
    mesh = make_recipe_mesh(pp=2, device_type="cuda")
    cfg = dataclasses.replace(get_config(MOE_PP["arch"]), n_layers=MOE_PP["n_layers"])
    f32 = dataclasses.replace(cfg, dtype="float32")
    out = {"mesh": describe(mesh), "stage": mesh.coords["pp"]}
    keys = ("loss", "xent", "aux", "skipped")

    def step(sess):
        m = sess.step()
        return {k: float(m[k]) for k in keys}

    for vpp in MOE_PP["vpps"]:
        # f32: the one-device pipeline (its stages in one process) on rank 0,
        # the other rank waiting; then the mesh
        one = None
        if rank == 0:
            sess = _family_pp_session(mods, f32, MOE_PP, vpp)
            one = step(sess)
            del sess
            torch.cuda.empty_cache()
        dist.barrier()
        sess = _family_pp_session(mods, f32, MOE_PP, vpp, mesh)
        out[f"f32/vpp{vpp}"] = dict(mesh=step(sess), one=one)
        del sess
        torch.cuda.empty_cache()
        # bf16: the counted step (launches, messages, memory, time) as a user
        # routes; then the plain versions, their routes recorded, and the
        # kernels again on those routes
        torch.cuda.reset_peak_memory_stats()
        sess = _family_pp_session(mods, cfg, MOE_PP, vpp, mesh)
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        build.launch_counts.clear()
        tp.reset()
        t0 = time.perf_counter()
        counted = step(sess)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        run = dict(metrics=counted, launches=dict(build.launch_counts),
                   collectives=dict(tp.by_group), bytes=dict(tp.bytes_by_group),
                   peak_bytes=torch.cuda.max_memory_allocated(), init_peak=init_peak,
                   step_s=host_s, in_flight=list(sess.train_step.in_flight))
        del sess
        torch.cuda.empty_cache()
        with plain_versions(), routing() as seen:
            run["plain"] = step(_family_pp_session(mods, cfg, MOE_PP, vpp, mesh))
        torch.cuda.empty_cache()
        with routing(replay=seen):
            run["pinned"] = step(_family_pp_session(mods, cfg, MOE_PP, vpp, mesh))
        del seen
        torch.cuda.empty_cache()
        out[f"bf16/vpp{vpp}"] = run
    return out


def _moe_pp_check(get_config, outs, ranks_s, smi):
    """Phase 25's checks on the ranks' results → rank 0's counted
    launches."""
    from repro_torch.core import pipeline
    from repro_torch.core.memory import per_device_bytes
    cfg = dataclasses.replace(get_config(MOE_PP["arch"]), n_layers=MOE_PP["n_layers"])
    full = get_config(MOE_PP["arch"]).n_layers
    L, gas, seq = cfg.n_layers, MOE_PP["gas"], MOE_PP["seq_len"]
    mbs = MOE_PP["global_batch"] // gas
    log(f"[moe pp] {_describe(cfg, full)}; {MOE_PP['ranks']} ranks ({outs[0]['mesh']}) ran in "
        f"{ranks_s:.1f} s ({MOE_PP_LABEL}); pp 2, gas {gas}, {MOE_PP['global_batch']} x {seq}, "
        f"remat full")
    launches = []
    for vpp in MOE_PP["vpps"]:
        one = outs[0][f"f32/vpp{vpp}"]["one"]
        for o in outs:
            got = o[f"f32/vpp{vpp}"]["mesh"]
            log(f"[moe pp] f32 vpp {vpp}, stage {o['stage']}: loss {got['loss']!r}, xent "
                f"{got['xent']!r}, aux {got['aux']!r}; the one-device pipeline loss "
                f"{one['loss']!r}, xent {one['xent']!r}, aux {one['aux']!r}")
            require(all(got[k] == one[k] for k in ("loss", "xent", "aux"))
                    and got["skipped"] == 0.0,
                    f"f32 vpp {vpp}: the mesh's {got} are not the one-device pipeline's {one}")
        sched = pipeline.Schedule(2, vpp, gas)
        model = per_device_bytes(cfg, dp=1, tp=1, pp=2, mbs=mbs, gas=gas, seq=seq,
                                 remat="full")
        peaks = []
        for o in outs:
            run, p = o[f"bf16/vpp{vpp}"], o["stage"]
            m = run["metrics"]
            lp = L // 2
            want = {"flash_fwd": 2 * lp * gas, "flash_delta": lp * gas, "flash_dq": lp * gas,
                    "flash_dkv": lp * gas}
            n, nbytes = expected_pp_p2p(2, vpp, gas, p, mbs=mbs, seq=seq, d_model=cfg.d_model,
                                        itemsize=cfg.compute_dtype.itemsize)
            got_n = {k: run["collectives"].get(k, 0) for k in n}
            got_b = {k: run["bytes"].get(k, 0) for k in n}
            rel = {k: abs(run["pinned"][k] - run["plain"][k]) / abs(run["plain"][k])
                   for k in ("loss", "xent", "aux")}
            peaks.append(run["peak_bytes"])
            log(f"[moe pp] bf16 vpp {vpp}, stage {p}: loss {m['loss']:.6f}, xent "
                f"{m['xent']:.6f}, aux {m['aux']:.6f}, skipped {m['skipped']:.0f}; launches "
                f"{run['launches']} (expected {want}); messages {got_n}, {got_b} B (expected "
                f"{n}, {nbytes}); in flight {run['in_flight']} (formula "
                f"{sched.in_flight_formula(p)}); the routing pinned to the plain run's: "
                f"kernels loss {run['pinned']['loss']:.6f}, xent {run['pinned']['xent']:.6f}, "
                f"aux {run['pinned']['aux']:.6f}, plain {run['plain']['loss']:.6f}, "
                f"{run['plain']['xent']:.6f}, {run['plain']['aux']:.6f} (relative "
                f"differences {', '.join(f'{k} {v:.3g}' for k, v in rel.items())}; "
                f"{rule(TOL['bfloat16'])}); peak {run['peak_bytes'] / 1e9:.3f} GB in the step "
                f"({run['init_peak'] / 1e9:.3f} GB at init), memory model "
                f"{model['total'] / 1e9:.3f} GB; the step {run['step_s'] * 1e3:.1f} ms host "
                f"(the first: it also warms up; {MOE_PP_LABEL})")
            require(math.isfinite(m["loss"]) and m["skipped"] == 0.0
                    and math.isfinite(m["aux"]) and m["aux"] > 0, f"bf16 vpp {vpp}: {m}")
            require(run["launches"] == want, f"bf16 vpp {vpp} stage {p}: launches "
                    f"{run['launches']}, expected {want}")
            require(got_n == n and got_b == nbytes, f"bf16 vpp {vpp} stage {p}: messages "
                    f"{got_n} {got_b}, expected {n} {nbytes}")
            require(run["in_flight"] == [sched.in_flight_formula(p)],
                    f"bf16 vpp {vpp} stage {p}: in flight {run['in_flight']}")
            require(all(v <= TOL["bfloat16"] for v in rel.values()),
                    f"bf16 vpp {vpp}: kernels and plain versions part on pinned routes: {rel}")
            require(m["loss"] == outs[0][f"bf16/vpp{vpp}"]["metrics"]["loss"],
                    f"bf16 vpp {vpp}: the ranks' losses differ")
        log(f"[moe pp] bf16 vpp {vpp}: the ranks' peaks together {sum(peaks) / 1e9:.3f} GB "
            f"({', '.join(f'{x / 1e9:.3f}' for x in peaks)}); {smi}")
        launches.append(outs[0][f"bf16/vpp{vpp}"]["launches"])
    return launches


# ---------------------------------------------------------------------------
# kernels at a model's attention shapes (phases 24 and 26)
# ---------------------------------------------------------------------------

def _causal_pairs(S: int, window=None) -> int:
    """The (query, key) pairs a causal mask of ``window`` (None: none) keeps
    over S positions."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _time_shapes(torch, fa, da, smi, tag, *, B, S, Hq, Hkv, D=64, window=None, ring=None,
                 Sk=None, causal=True):
    """K1-K4 at one training micro-batch's attention, q (B,S,Hq,D) and k/v
    (B,Sk,Hkv,D) bf16 (Sk = S by default), causal within ``window`` or
    (``causal=False``) every key visible, and K5 (when ``ring``) at a
    decode step, q (B,1,Hq,D) over a full ring of ``ring`` slots: each held
    to its plain version (2e-2), timed in device time (``device_ms``), its
    plain version in CUDA events, beside its bound (phase 14's counts of
    bytes and operations over the pairs the mask keeps) and one library
    call in turns with it (kernel, library, library, kernel): SDPA's
    forward for K1 (``is_causal``, or the window as a boolean mask), its
    backward alone for K3 and K4, ``linalg.vecdot`` for K2 (a yardstick of
    time), SDPA masked to the ring's valid keys for K5.  → {kernel: row}."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    bf = torch.bfloat16
    Sk = S if Sk is None else Sk
    q, do = (torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(bf) for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(bf) for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = fa.flash_delta_plain(o, do)
    pairs = _causal_pairs(S, window) if causal else S * Sk
    prod = 2 * B * Hq * D * pairs                         # one (q, k, d) product
    qb, kb, stats = 2 * q.numel(), 2 * k.numel(), 2 * 4 * lse.numel()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    if not causal:
        sdpa_kw = {}
    elif window is None:
        sdpa_kw = dict(is_causal=True)
    else:
        i = torch.arange(S, device="cuda")
        sdpa_kw = dict(attn_mask=(i[None] <= i[:, None]) & (i[None] > i[:, None] - window))
    out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)
    sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt.detach(), kt.detach(), vt.detach(), enable_gqa=True, **sdpa_kw)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                           retain_graph=True)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw)[0],
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)[0],
                      bound(2 * qb + 2 * kb + stats / 2, 2 * prod), sdpa_fwd),
        "flash_delta": (lambda: fa.flash_delta(o, do), lambda: fa.flash_delta_plain(o, do),
                        bound(2 * qb + stats / 2, 0),
                        lambda: torch.linalg.vecdot(o, do, dim=-1)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw),
                     lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, **kw),
                     bound(3 * qb + 2 * kb + stats, 3 * prod), sdpa_bwd),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw)[0],
                      lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, **kw)[0],
                      bound(2 * qb + 4 * kb + stats, 4 * prod), sdpa_bwd),
    }
    if ring is not None:
        qd = torch.randn((B, 1, Hq, D), generator=gen, device="cuda").to(bf)
        kr, vr = (torch.randn((B, ring, Hkv, D), generator=gen, device="cuda").to(bf)
                  for _ in range(2))
        kpos, t = _ring(torch, B, ring, fill=ring - 1)
        qdt, krt, vrt = (x.transpose(1, 2).contiguous() for x in (qd, kr, vr))
        mask = ((kpos >= 0) & (kpos <= t))[:, None, None, :]
        calls["decode_attention"] = (
            lambda: da.decode_attention(qd, kr, vr, kpos, t=t),
            lambda: da.decode_attention_plain(qd, kr, vr, kpos, t=t),
            bound(2 * (2 * kr.numel() + 2 * qd.numel()) + 4 * kpos.numel(),
                  4 * B * Hq * D * ring),
            lambda: F.scaled_dot_product_attention(qdt, krt, vrt, attn_mask=mask,
                                                   enable_gqa=True))
    where = (f"q ({B},{S},{Hq},{D}), k/v ({B},{Sk},{Hkv},{D}) bf16, "
             + (f"causal, window {window}" if causal else "every key visible"))
    rows = {}
    for name, (kern, plain, (b_ms, b_by), lib) in calls.items():
        err, ok = close(kern(), plain(), TOL["bfloat16"])
        ms, lib_ms, dev, ev = in_turns(torch, kern, lib, n=20)
        plain_ms = time_ms(torch, plain, iters=5)
        shape = (f"q ({B},1,{Hq},{D}) over a full ring of {ring} slots"
                 if name == "decode_attention" else where)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms, max_abs_err=err, shape=shape)
        lib_name = {"flash_fwd": "SDPA forward", "flash_delta": "vecdot",
                    "decode_attention": "masked SDPA"}.get(name, "SDPA backward")
        log(f"[{tag}] {name} at {shape}: {turns_text(name, lib_name, dev, ev)}; bound "
            f"{b_ms * 1e3:.2f} us ({b_by}), {ms / b_ms:.1f}x it; plain {plain_ms:.4f} ms "
            f"(CUDA events); max |kernel - plain| {err:.3g} ({rule(TOL['bfloat16'])}); {smi}")
        require(ok, f"{name} at {tag}'s shape disagrees with its plain version: {err}")
    return rows


# ---------------------------------------------------------------------------
# phase 26: the hybrid family
# ---------------------------------------------------------------------------

def phase_hybrid(torch, np, build, InferenceSession, tree_map, smi):
    """Phase 26's serving part (the training part is ``phase_train`` with
    ``TRAIN_HYMBA``): hymba-1.5b at full depth, random bf16 weights from
    seed 0.  No paged pool and no padded prefill (as the reference's): a
    prompt goes into the caches through the decode scan, K5 once a layer a
    position.  Returns the counted runs' launches."""
    from repro_torch.models import ssm, transformer
    spec = HYBRID
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    L, V, B, P, N = cfg.n_layers, cfg.vocab_size, spec["batch"], spec["prompt_len"], \
        spec["new_tokens"]
    H, Pd, Ns = ssm.ssm_dims(cfg)
    windows = transformer.layer_windows(cfg)
    build_peak = torch.cuda.max_memory_allocated()
    log(f"[hybrid] {_describe(cfg, L)}; SSM heads {H} of {Pd} channels, state {Ns}; global "
        f"attention on layers {[i for i, w in enumerate(windows) if w is None]}, a window of "
        f"{cfg.swa_window} on the other {sum(w is not None for w in windows)}; {cfg.dtype}; "
        f"build {time.perf_counter() - t0:.1f} s, peak {build_peak} B "
        f"({build_peak / 1e9:.3f} GB) for {2 * cfg.n_params() / 1e9:.3f} GB of bf16 weights")
    rs = np.random.RandomState(0)

    # generate: the prompt through the decode scan, then N - 1 decode steps
    prompts = rs.randint(0, V, size=(B, P)).astype(np.int32)
    _, c = _generate_checked(torch, np, build, sess, prompts, N,
                             {"decode_attention": L * (P + N - 1)}, "hybrid")
    runs.append(c)
    # a decode step's host time over 16 steps after a 16-token prompt, and
    # the device's busy share over 4 of them
    short, steps, window = prompts[:, :16], 17, 4
    dec_ms, prof = _decode_ms(torch, sess, short, steps, profile_steps=window)
    log(f"[hybrid] decode {dec_ms:.3f} ms a step at batch {B}, positions 16-{15 + steps - 1} "
        f"(host clock, mean of {steps - 1}); {smi}")
    _log_profile("hybrid decode", prof, dec_ms * window)

    # prefill past the window: every position's logits, counted, held to
    # the plain versions and to the plain versions on an f32 copy
    Bp, S = spec["prefill"]
    batch = {"tokens": torch.from_numpy(rs.randint(0, V, size=(Bp, S)).astype(np.int32)).cuda()}
    build.launch_counts.clear()
    t0 = time.perf_counter()
    lk = sess.prefill(batch, last_only=False)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = dict(build.launch_counts)
    require(pre == {"flash_fwd": L}, f"prefill launched {pre}, expected K1 {L}")
    require(tuple(lk.shape) == (Bp, S, V), f"prefill gave {tuple(lk.shape)}")
    runs.append(pre)
    with plain_versions():
        lp = sess.prefill(batch, last_only=False)
        sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                  tree_map(lambda x: x.float(), sess.params), device=sess.device)
        lf = sess32.prefill(batch, last_only=False)
        del sess32
    log(f"[hybrid] prefill (B, S) = ({Bp}, {S}) in {pre_s:.2f} s (host clock, first call); "
        f"launches {pre}")
    hold_to_floor("hybrid", f"prefill logits (B, S, V) = {tuple(lk.shape)}, the window "
                  f"binding on {sum(w is not None for w in windows)} layers", lk, lp, lf)
    del lk, lp, lf
    torch.cuda.empty_cache()

    # a stream on contiguous slots: each admission a decode scan over its
    # prompt; the paged pool refused
    runs.append(_stream_and_refusal(
        torch, np, build, sess, spec, rs, "hybrid",
        lambda st, lens: {"decode_attention": L * (st.decode_steps + sum(lens))}))
    del sess
    torch.cuda.empty_cache()
    return runs


def _time_hybrid(torch, fa, da, smi):
    """K1-K5 at hymba's shapes (25/5 heads of 64: a GQA group of 5): K1-K4
    at a training micro-batch (4 x 2048) with the window of 1024 and with
    none (the global layers), K5 over its SWA ring (1024 slots) and over a
    global layer's ring at phase 26's generate (128 slots).  → {(kernel,
    variant): row}."""
    B, S = TRAIN_HYMBA["global_batch"] // TRAIN_HYMBA["gas"], TRAIN_HYMBA["seq_len"]
    rows = {}
    for window, ring in ((1024, 1024), (None, HYBRID["prompt_len"] + HYBRID["new_tokens"])):
        got = _time_shapes(torch, fa, da, smi, f"hybrid kernels, window {window}", B=B, S=S,
                           Hq=25, Hkv=5, window=window, ring=ring)
        rows.update({(n, f"window {window}" if n != "decode_attention" else f"ring {ring}"): r
                     for n, r in got.items()})
    return rows


# ---------------------------------------------------------------------------
# phase 26: the hybrid family under pipeline parallelism
# ---------------------------------------------------------------------------

def _hybrid_pp_rank_runs(torch):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    mods = _dp_mods()
    rank = dist.get_rank()
    mesh = make_recipe_mesh(pp=2, device_type="cuda")
    cfg = dataclasses.replace(get_config(HYBRID_PP["arch"]), n_layers=HYBRID_PP["n_layers"])
    f32 = dataclasses.replace(cfg, dtype="float32")
    out = {"mesh": describe(mesh), "stage": mesh.coords["pp"]}
    keys = ("loss", "xent", "grad_norm", "skipped")

    def step(sess):
        m = sess.step()
        return {k: float(m[k]) for k in keys}

    for vpp in HYBRID_PP["vpps"]:
        one = None
        if rank == 0:
            sess = _family_pp_session(mods, f32, HYBRID_PP, vpp)
            one = step(sess)
            del sess
            torch.cuda.empty_cache()
        dist.barrier()
        sess = _family_pp_session(mods, f32, HYBRID_PP, vpp, mesh)
        out[f"f32/vpp{vpp}"] = dict(mesh=step(sess), one=one)
        del sess
        torch.cuda.empty_cache()
    # bf16: one counted step at the last vpp (launches, messages, memory)
    torch.cuda.reset_peak_memory_stats()
    sess = _family_pp_session(mods, cfg, HYBRID_PP, HYBRID_PP["vpps"][-1], mesh)
    torch.cuda.synchronize()
    build.launch_counts.clear()
    tp.reset()
    t0 = time.perf_counter()
    counted = step(sess)
    torch.cuda.synchronize()
    out["bf16"] = dict(metrics=counted, launches=dict(build.launch_counts),
                       collectives=dict(tp.by_group), bytes=dict(tp.bytes_by_group),
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       step_s=time.perf_counter() - t0)
    return out


def _hybrid_pp_check(get_config, outs, ranks_s, smi):
    """Phase 26's pipeline checks on the ranks' results → rank 0's counted
    launches."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config(HYBRID_PP["arch"]), n_layers=HYBRID_PP["n_layers"])
    full = get_config(HYBRID_PP["arch"]).n_layers
    L, gas, seq = cfg.n_layers, HYBRID_PP["gas"], HYBRID_PP["seq_len"]
    mbs = HYBRID_PP["global_batch"] // gas
    glob = [i for i, w in enumerate(transformer.layer_windows(cfg)) if w is None]
    log(f"[hybrid pp] {_describe(cfg, full)}; global layers {glob}; {HYBRID_PP['ranks']} "
        f"ranks ({outs[0]['mesh']}) ran in {ranks_s:.1f} s ({MOE_PP_LABEL}); pp 2, gas {gas}, "
        f"{HYBRID_PP['global_batch']} x {seq}, remat full")
    for vpp in HYBRID_PP["vpps"]:
        one = outs[0][f"f32/vpp{vpp}"]["one"]
        for o in outs:
            got = o[f"f32/vpp{vpp}"]["mesh"]
            log(f"[hybrid pp] f32 vpp {vpp}, stage {o['stage']}: loss {got['loss']!r}, xent "
                f"{got['xent']!r}, grad_norm {got['grad_norm']!r}; the one-device pipeline "
                f"loss {one['loss']!r}, xent {one['xent']!r}, grad_norm {one['grad_norm']!r}")
            require(all(got[k] == one[k] for k in ("loss", "xent")) and got["skipped"] == 0.0,
                    f"f32 vpp {vpp}: the mesh's {got} are not the one-device pipeline's {one}")
    vpp = HYBRID_PP["vpps"][-1]
    lp = L // 2
    want = {"flash_fwd": 2 * lp * gas, "flash_delta": lp * gas, "flash_dq": lp * gas,
            "flash_dkv": lp * gas}
    for o in outs:
        run, p = o["bf16"], o["stage"]
        m = run["metrics"]
        n, nbytes = expected_pp_p2p(2, vpp, gas, p, mbs=mbs, seq=seq, d_model=cfg.d_model,
                                    itemsize=cfg.compute_dtype.itemsize)
        got_n = {k: run["collectives"].get(k, 0) for k in n}
        got_b = {k: run["bytes"].get(k, 0) for k in n}
        log(f"[hybrid pp] bf16 vpp {vpp}, stage {p}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.4f}, skipped {m['skipped']:.0f}; launches {run['launches']} "
            f"(expected {want}); messages {got_n}, {got_b} B (expected {n}, {nbytes}); peak "
            f"{run['peak_bytes'] / 1e9:.3f} GB; the step {run['step_s'] * 1e3:.1f} ms host "
            f"(the first: it also warms up; {MOE_PP_LABEL}); {smi}")
        require(math.isfinite(m["loss"]) and m["skipped"] == 0.0, f"bf16 vpp {vpp}: {m}")
        require(run["launches"] == want, f"bf16 stage {p}: launches {run['launches']}, "
                f"expected {want}")
        require(got_n == n and got_b == nbytes, f"bf16 stage {p}: messages {got_n} {got_b}, "
                f"expected {n} {nbytes}")
        require(m["loss"] == outs[0]["bf16"]["metrics"]["loss"], "the ranks' losses differ")
    return [outs[0]["bf16"]["launches"]]


# ---------------------------------------------------------------------------
# phases 27 and 28: the xLSTM and the encoder-decoder
# ---------------------------------------------------------------------------

def _stream_and_refusal(torch, np, build, sess, spec, rs, tag, want_fn):
    """A stream of ``spec``'s requests on contiguous slots (each admission a
    decode scan), its launches held to ``want_fn(stats, lens)``, every
    request's tokens whole; then ``paged=True`` refused.  → the launches."""
    lens, gens = spec["stream_lens"], list(spec["stream_gens"])
    stream = [rs.randint(1, sess.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    build.launch_counts.clear()
    t0 = time.perf_counter()
    outs, st = sess.serve(stream, gens, n_slots=spec["slots"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(build.launch_counts)
    want = want_fn(st, lens)
    log(f"[{tag}] stream: {st.requests} requests on {spec['slots']} slots, "
        f"{st.generated_tokens} tokens, {st.decode_steps} decode steps, {st.prefill_tokens} "
        f"prompt tokens through the decode scan, in {wall:.2f} s (host clock); occupancy "
        f"{st.occupancy:.4f}; launches {c}, expected {want}")
    require(c == want, f"the stream launched {c}, expected {want}")
    require(st.requests == len(stream) and st.generated_tokens == sum(gens)
            and st.prefill_tokens == sum(lens), f"the stream served {st}")
    for pr, m, o in zip(stream, gens, outs):
        require(len(o) == len(pr) + m and bool((o[:len(pr)] == pr).all()),
                f"a request came back with {len(o)} tokens or altered")
    try:
        sess.serve(stream[:2], [2, 2], paged=True)
        refused = ""
    except ValueError as e:
        refused = str(e)
    log(f"[{tag}] serve(paged=True) raises ValueError: {refused[:120]!r}")
    require("paged" in refused, f"{tag}: served from the paged pool")
    return c


def _generate_checked(torch, np, build, sess, prompts, N, want, tag, **kw):
    """``generate`` of ``prompts`` and N new tokens, its launches held to
    ``want``, the tokens in range and the prompts kept.  → (tokens, the
    launches)."""
    B, P = prompts.shape
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    toks = sess.generate(prompts, N, **kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    c = dict(build.launch_counts)
    out = toks.cpu().numpy()
    log(f"[{tag}] generate {tuple(toks.shape)} in {gen_s:.2f} s (first call, the prompt "
        f"through the decode scan); launches {c}, expected {want}; peak "
        f"{torch.cuda.max_memory_allocated()} B")
    require(c == want, f"generate launched {c}, expected {want}")
    require(out.shape == (B, P + N) and bool((out[:, :P] == prompts).all())
            and bool(((out >= 0) & (out < sess.cfg.vocab_size)).all()),
            f"generate returned {out.shape} tokens, altered or out of range")
    return toks, c


def _build_session(torch, InferenceSession, spec, tag, extra=""):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = InferenceSession.from_recipe(spec["arch"], seed=0)
    torch.cuda.synchronize()
    cfg = sess.cfg
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {_describe(cfg, cfg.n_layers)}{extra(cfg) if extra else ''}; {cfg.dtype}; "
        f"build {time.perf_counter() - t0:.1f} s, peak {peak} B ({peak / 1e9:.3f} GB) for "
        f"{2 * cfg.n_params() / 1e9:.3f} GB of bf16 weights")
    return sess


def phase_xlstm(torch, np, build, InferenceSession, tree_map, smi):
    """Phase 27's serving part (the training part is ``phase_train`` with
    ``TRAIN_XLSTM``): xlstm-125m at full depth, random bf16 weights from
    seed 0.  No attention, so no kernel launches: every count must stay 0.
    The prompt goes into the recurrent states through the decode scan; in
    f32 at ``XLSTM["f32_layers"]`` layers the chunked prefill's
    last-position logits equal the decode scan's.  Returns the counted
    runs' launches."""
    from repro_torch.models import transformer
    spec = XLSTM
    sess = _build_session(torch, InferenceSession, spec, "xlstm", lambda c: (
        f"; sLSTM at {list(c.slstm_at)}, mLSTM inner width {int(c.proj_factor * c.d_model)}"))
    cfg = sess.cfg
    B, P, N, V = spec["batch"], spec["prompt_len"], spec["new_tokens"], cfg.vocab_size
    rs = np.random.RandomState(0)
    runs = []
    prompts = rs.randint(0, V, size=(B, P)).astype(np.int32)
    _, c = _generate_checked(torch, np, build, sess, prompts, N, {}, "xlstm")
    runs.append(c)
    short, steps, window = prompts[:, :16], 17, 4
    dec_ms, prof = _decode_ms(torch, sess, short, steps, profile_steps=window)
    log(f"[xlstm] decode {dec_ms:.3f} ms a step at batch {B}, positions 16-{15 + steps - 1} "
        f"(host clock, mean of {steps - 1}); {smi}")
    _log_profile("xlstm decode", prof, dec_ms * window)

    # prefill over 8 mLSTM chunks: bf16 timed and counted; in f32 the
    # chunked form's last-position logits against the decode scan's
    Bp, S = spec["prefill"]
    tokens = torch.from_numpy(rs.randint(0, V, size=(Bp, S)).astype(np.int32)).cuda()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    lk = sess.prefill({"tokens": tokens}, last_only=False)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = dict(build.launch_counts)
    require(pre == {} and tuple(lk.shape) == (Bp, S, V) and bool(lk.isfinite().all()),
            f"prefill launched {pre}, gave {tuple(lk.shape)}")
    runs.append(pre)
    del lk
    cut = dataclasses.replace(cfg, n_layers=spec["f32_layers"], dtype="float32")
    sess32 = InferenceSession.from_recipe(cut, seed=1)
    chunked = sess32.prefill({"tokens": tokens}, last_only=True)[:, 0]
    t0 = time.perf_counter()
    with torch.inference_mode():
        scan, _ = sess32.prefill_cache_step(sess32.params, {"tokens": tokens},
                                            sess32.init_cache(Bp, S))
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    rel = float((chunked - scan).abs().max() / scan.abs().max())
    log(f"[xlstm] prefill (B, S) = ({Bp}, {S}) in {pre_s:.2f} s (host clock, first call, "
        f"{S // 128} chunks of 128); launches {pre}; f32 at full width, {cut.n_layers} layers "
        f"({', '.join(k for _, k in transformer.layer_plan(cut)[2])}): the chunked "
        f"last-position logits against the decode scan's over the {S} positions "
        f"({scan_s:.2f} s): max |diff| / max |scan| {rel:.3g} (tol 1e-4)")
    require(rel <= 1e-4, f"the chunked prefill and the decode scan differ by {rel:.3g}")
    del sess32, chunked, scan
    torch.cuda.empty_cache()

    runs.append(_stream_and_refusal(torch, np, build, sess, spec, rs, "xlstm",
                                    lambda st, lens: {}))
    del sess
    torch.cuda.empty_cache()
    return runs


def phase_xlstm_f32_cpu(torch, get_config, TrainSession, stepfn, ParallelismConfig,
                        DataConfig, tree_map):
    """xlstm at full width, ``XLSTM["f32_layers"]`` layers (mLSTM, sLSTM,
    mLSTM, sLSTM), f32: one training step on the card against the same
    step on the CPU from the same state and batch (the recurrences have no
    kernel, so the CPU's plain PyTorch is the reference): loss and
    grad_norm within 1e-5 relative, every parameter within 1e-4."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config(XLSTM["arch"]), n_layers=XLSTM["f32_layers"],
                              dtype="float32")
    kw = dict(plan=ParallelismConfig(remat_policy="full"),
              train_cfg=stepfn.TrainConfig(total_steps=3, warmup=1),
              data_cfg=DataConfig(seq_len=XLSTM["f32_seq"], global_batch=2))
    card = TrainSession(cfg, seed=1, **kw)
    cpu = TrainSession(cfg, seed=1, device="cpu", **kw)
    cpu.state = tree_map(lambda x: x.detach().cpu().clone(), card.state)
    got = {k: float(v) for k, v in card.step(card.batches(0)).items()}
    t0 = time.perf_counter()
    want = {k: float(v) for k, v in cpu.step(cpu.batches(0)).items()}
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    errs = [(close(a.detach().cpu(), b, 1e-4), "/".join(map(str, p)))
            for (p, a), (_, b) in zip(tree_leaves(card.state["params"]),
                                      tree_leaves(cpu.state["params"]))]
    (worst, _), at = max(errs)
    kinds = [k for _, k in transformer.layer_plan(cfg)[2]]
    log(f"[xlstm f32] {cfg.name} at full width, {cfg.n_layers} layers {kinds}, f32, one step "
        f"of 2 x {XLSTM['f32_seq']}: card loss {got['loss']!r}, CPU {want['loss']!r} (rel "
        f"{rel['loss']:.3g}), grad_norm {got['grad_norm']!r} / {want['grad_norm']!r} (rel "
        f"{rel['grad_norm']:.3g}), tol 1e-5; params max |card - CPU| {worst:.3g} at {at} "
        f"({rule(1e-4)}); the CPU step {cpu_s:.1f} s")
    require(all(r <= 1e-5 for r in rel.values()), f"card and CPU steps differ: {rel}")
    require(all(ok for (_, ok), _ in errs), f"card and CPU params differ by {worst:.3g}")
    del card, cpu
    torch.cuda.empty_cache()


def _frames(np, cfg, B, seed):
    """Random encoder frames (B, enc_frames, d) f32 from ``seed``: the
    stub frontend's output, as the data pipeline draws it."""
    return np.random.RandomState(seed).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def phase_whisper(torch, np, build, InferenceSession, tree_map, smi):
    """Phase 28's serving part (the training part is ``phase_train`` with
    ``TRAIN_WHISPER``): whisper-base at full depth, random bf16 weights from
    seed 0, random frames from seed 0.  The cache init runs the encoder
    once (K1 non-causal, once an encoder layer) and computes each decoder
    layer's cross K/V; the prompt goes in through the decode scan; a decode
    step runs K5 once a decoder layer on its self-attention ring and reads
    the cross K/V through the masked einsum (no kernel).  The prefill runs
    K1 once an attention: encoder, decoder self (causal) and cross (448
    queries over 1500 keys).  Returns the counted runs' launches."""
    spec = WHISPER
    sess = _build_session(torch, InferenceSession, spec, "whisper", lambda c: (
        f"; {c.enc_layers} encoder layers over {c.enc_frames} frames, learned positions, "
        f"LayerNorm, GELU"))
    cfg = sess.cfg
    E, L = cfg.enc_layers, cfg.n_layers
    B, P, N, V = spec["batch"], spec["prompt_len"], spec["new_tokens"], cfg.vocab_size
    rs = np.random.RandomState(0)
    runs = []
    prompts = rs.randint(0, V, size=(B, P)).astype(np.int32)
    frames = _frames(np, cfg, B, 0)
    _, c = _generate_checked(torch, np, build, sess, prompts, N,
                             {"flash_fwd": E, "decode_attention": L * (P + N - 1)}, "whisper",
                             frames=frames)
    runs.append(c)
    dec_ms, prof = _decode_ms(torch, sess, prompts, 17, profile_steps=4)
    log(f"[whisper] decode {dec_ms:.3f} ms a step at batch {B}, positions {P}-{P + 15} (host "
        f"clock, mean of 16; the stub frames' cross K/V); {smi}")
    _log_profile("whisper decode", prof, dec_ms * 4)

    # prefill at the decoder's context over random frames, held to the
    # plain versions and to the plain versions on an f32 copy
    Bp, S = spec["prefill"]
    batch = {"tokens": torch.from_numpy(rs.randint(0, V, size=(Bp, S)).astype(np.int32)).cuda(),
             "frames": torch.from_numpy(_frames(np, cfg, Bp, 1)).cuda()}
    build.launch_counts.clear()
    t0 = time.perf_counter()
    lk = sess.prefill(batch, last_only=False)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = dict(build.launch_counts)
    want = {"flash_fwd": E + 2 * L}
    require(pre == want, f"prefill launched {pre}, expected {want}")
    require(tuple(lk.shape) == (Bp, S, V), f"prefill gave {tuple(lk.shape)}")
    runs.append(pre)
    with plain_versions():
        lp = sess.prefill(batch, last_only=False)
        sess32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                  tree_map(lambda x: x.float(), sess.params), device=sess.device)
        lf = sess32.prefill(batch, last_only=False)
        del sess32
    log(f"[whisper] prefill (B, S) = ({Bp}, {S}) over {cfg.enc_frames} frames in {pre_s:.2f} s "
        f"(host clock, first call); launches {pre}")
    hold_to_floor("whisper", f"prefill logits (B, S, V) = {tuple(lk.shape)}, K1 non-causal "
                  f"over the frames and {S} x {cfg.enc_frames} cross", lk, lp, lf)
    del lk, lp, lf, batch
    torch.cuda.empty_cache()

    # the stream: the scheduler's two cache inits (its slots and its
    # admission template, both over the stub frames) run the encoder
    runs.append(_stream_and_refusal(
        torch, np, build, sess, spec, rs, "whisper",
        lambda st, lens: {"flash_fwd": 2 * E,
                          "decode_attention": L * (st.decode_steps + sum(lens))}))
    del sess
    torch.cuda.empty_cache()
    return runs


def phase_whisper_f32_identity(torch, np, get_config, InferenceSession):
    """whisper at full width, ``WHISPER["f32_layers"]`` encoder and decoder
    layers, f32: greedy tokens over random frames with the kernels and with
    their plain versions must be equal, and so must the prefill's logits
    (1e-4)."""
    cfg = dataclasses.replace(get_config(WHISPER["arch"]), n_layers=WHISPER["f32_layers"],
                              enc_layers=WHISPER["f32_layers"], dtype="float32")
    sess = InferenceSession.from_recipe(cfg, seed=1)
    rs = np.random.RandomState(1)
    prompts = rs.randint(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    frames = _frames(np, cfg, 2, 1)
    batch = {"tokens": prompts, "frames": frames}
    toks_k, lk = sess.generate(prompts, 32, frames=frames), sess.prefill(batch, last_only=False)
    with plain_versions():
        toks_p, lp = sess.generate(prompts, 32, frames=frames), sess.prefill(batch,
                                                                            last_only=False)
    same = bool(torch.equal(toks_k, toks_p))
    err, ok = close(lk, lp, 1e-4)
    log(f"[f32] {cfg.name} at full width, {cfg.enc_layers} + {cfg.n_layers} layers, f32, over "
        f"{cfg.enc_frames} random frames: greedy tokens kernel == plain: {same}; prefill "
        f"logits max |kernel - plain| {err:.3g} ({rule(1e-4)})")
    require(same, f"f32 greedy tokens differ:\n{toks_k[:, 64:]}\n{toks_p[:, 64:]}")
    require(ok, f"f32 prefill logits differ by {err:.3g}")
    del sess
    torch.cuda.empty_cache()


def _time_whisper(torch, fa, da, smi):
    """K1-K5 at whisper's shapes (8/8 heads of 64) at the training
    micro-batch (8 x 448 tokens over 1500 frames): K1-K4 at the encoder's
    non-causal self-attention (1500 x 1500) and at the decoder's
    cross-attention (448 queries over 1500 keys), the two regimes no other
    model runs; K5 over phase 28's decoder ring (80 slots).  → {(kernel,
    variant): row}."""
    B, S = TRAIN_WHISPER["global_batch"] // TRAIN_WHISPER["gas"], TRAIN_WHISPER["seq_len"]
    F = 1500
    rows = {}
    ring = WHISPER["prompt_len"] + WHISPER["new_tokens"]
    for variant, kw in (("encoder", dict(S=F, causal=False, ring=ring)),
                        ("cross", dict(S=S, Sk=F, causal=False))):
        got = _time_shapes(torch, fa, da, smi, f"whisper kernels, {variant}", B=B, Hq=8,
                           Hkv=8, **kw)
        rows.update({(n, variant if n != "decode_attention" else f"ring {ring}"): r
                     for n, r in got.items()})
    return rows


# ---------------------------------------------------------------------------
# phase 29: every family under the paper's tp and dp
# ---------------------------------------------------------------------------

def _family_cfgs(get_config, spec, arch):
    """(the served config, the f32 tokens' and training step's: cut where
    the spec says)."""
    cfg = get_config(arch)
    cut = cfg if spec["f32_layers"] is None else dataclasses.replace(
        cfg, n_layers=spec["f32_layers"])
    return cfg, dataclasses.replace(cut, dtype="float32")


def _family_inputs(np, cfg, spec, arch):
    """(the generate prompts and its keywords, the prefill batch), from a
    seed: an encoder-decoder's frames random."""
    rs = np.random.RandomState(29)
    B, P = spec["batch"], spec["prompt_len"]
    Bp, S = spec["prefill"]
    prompts = rs.randint(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, size=(Bp, S)).astype(np.int32)}
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = _frames(np, cfg, B, 29)
        batch["frames"] = _frames(np, cfg, Bp, 30)
    return prompts, kw, batch


def _family_train(mods, cfg, spec, mesh=None):
    """A TrainSession of phase 29: remat full, the GAS path (no vote), the
    spec's tp x dp on a mesh at its ZeRO stage."""
    t = spec["train"]
    shape = mesh.shape if mesh is not None else {"tp": 1, "data": 1}
    plan = mods.ParallelismConfig(tp=shape["tp"], dp=shape["data"], gas=t["gas"],
                                  remat_policy="full",
                                  zero_stage=spec["zero_stage"] if mesh is not None else 1)
    return mods.TrainSession.from_recipe(
        cfg, seed=0, plan=plan, mesh=mesh,
        train_cfg=mods.stepfn.TrainConfig(total_steps=4, warmup=2,
                                          resilience=mods.ResilienceConfig(consensus=False)),
        data_cfg=mods.DataConfig(seq_len=t["seq_len"], global_batch=t["global_batch"]))


def phase_family_tp(torch, np, get_config, InferenceSession, tree_map, smi, tp_dp, tp_dp_s):
    """Phase 29: the one-device references on the card (this process, kept
    on the host), then hymba's world of five (``_family_tp_runs``), and
    each result held to the references: hymba's, and ``tp_dp``, each rank's
    results of the xLSTM and Whisper at tp 2 x dp 2 from the world of four
    (``tp_dp_s`` its host seconds there).  → (the ``{"families": ...}``
    summary, rank 0's counted launches)."""
    mods = _dp_mods()
    ref = {}
    t0 = time.perf_counter()
    for key, spec in FAMILY_TP.items():
        N = spec["new_tokens"]
        for arch in spec["archs"]:
            cfg, f32 = _family_cfgs(get_config, spec, arch)
            prompts, kw, batch = _family_inputs(np, cfg, spec, arch)
            with torch.inference_mode():
                sess = InferenceSession.from_recipe(arch, seed=0)
                ts = time.perf_counter()
                ref[f"{arch}/tokens"] = sess.generate(prompts, N, **kw).cpu()
                torch.cuda.synchronize()
                ref[f"{arch}/generate_s"] = time.perf_counter() - ts
                ref[f"{arch}/prefill"] = sess.prefill(batch, last_only=False).cpu()
                ref[f"{arch}/first"] = sess.prefill(dict(kw, tokens=prompts)).cpu()
                params32 = tree_map(lambda x: x.float(), sess.params)
                device = sess.device
                del sess
                s32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"), params32,
                                       device=device)
                ref[f"{arch}/prefill_f32"] = s32.prefill(batch, last_only=False).cpu()
                ref[f"{arch}/first_f32"] = s32.prefill(dict(kw, tokens=prompts)).cpu()
                if spec["f32_layers"] is not None:
                    # the f32 floor at full depth: the most the same prefill
                    # moves with the embedding scaled by 1 ± 2^-23 (one f32
                    # rounding either way)
                    embed, floor = params32["embed"].clone(), 0.0
                    for e in (2.0 ** -23, -2.0 ** -23):
                        params32["embed"].copy_(embed * (1 + e))
                        floor = max(floor, float((s32.prefill(batch, last_only=False).cpu()
                                                  - ref[f"{arch}/prefill_f32"]).abs().max()))
                    ref[f"{arch}/prefill_f32_floor"] = floor
                    del embed
                del s32, params32
                torch.cuda.empty_cache()
                sess = InferenceSession.from_recipe(f32, seed=1)
                ref[f"{arch}/f32_tokens"] = sess.generate(prompts, N, **kw).cpu()
                del sess
                torch.cuda.empty_cache()
            sess = _family_train(mods, f32, spec)
            m = sess.step()
            ref[f"{arch}/train"] = {k: float(m[k]) for k in ("loss", "xent", "grad_norm")}
            del sess
            torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    log(f"[families] one-device references on the card in {ref_s:.1f} s")
    summary, runs, failed = {"label": FAMILY_TP_LABEL, "card": smi}, [], []
    for key, spec in FAMILY_TP.items():
        if key == "tp_dp":
            outs, ranks_s = tp_dp, tp_dp_s
        else:
            outs, ranks_s = _spawn_ranks(torch, f"_family_tp_runs_{key}", spec["ranks"],
                                         WORLDS_DIR)
        log(f"[families] {key}: {spec['ranks']} ranks ({outs[0]['mesh']}) ran in "
            f"{ranks_s:.1f} s ({FAMILY_TP_LABEL})")
        summary[key] = {"ranks_s": ranks_s}
        for arch in spec["archs"]:
            got = _family_check(torch, get_config, spec, arch, ref, outs, smi)
            summary[key][arch] = got["summary"]
            runs.extend(got["launches"])
            failed.extend(got["failed"])
    if failed:
        raise SmokeFailure(f"phase 29: {len(failed)} check(s) failed: {failed}")
    return summary, runs


def _family_tp_runs_hybrid(torch):
    return _family_tp_runs(torch, FAMILY_TP["hybrid"])


def _family_tp_runs(torch, spec):
    """One rank of phase 29: every family of ``spec`` served and trained on
    its mesh, with the launches, the heads K1-K5 ran at and the collectives
    by group counted around each run; the prefill logits on rank 0 only."""
    import collections
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tp
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import describe, make_recipe_mesh
    from repro_torch.session import InferenceSession
    mods = _dp_mods()
    mesh = make_recipe_mesh(tp=spec["tp"], device_type="cuda")
    plan = mods.ParallelismConfig(tp=mesh.shape["tp"], dp=mesh.shape["data"])
    rank = dist.get_rank()
    out = {"mesh": describe(mesh)}
    N = spec["new_tokens"]

    def counted(key, fn):
        heads = collections.Counter()
        build.launch_counts.clear()
        tp.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_heads(heads):
            res = fn()
        torch.cuda.synchronize()
        out[key] = dict(s=time.perf_counter() - t0, launches=dict(build.launch_counts),
                        heads=dict(heads), collectives=dict(tp.by_group),
                        bytes=dict(tp.bytes_by_group),
                        peak_bytes=torch.cuda.max_memory_allocated())
        return res

    for arch in spec["archs"]:
        cfg, f32 = _family_cfgs(get_config, spec, arch)
        prompts, kw, batch = _family_inputs(np, cfg, spec, arch)
        with torch.inference_mode():
            sess = InferenceSession.from_recipe(arch, seed=0, plan=plan, mesh=mesh)
            out[f"{arch}/tokens"] = counted(f"{arch}/generate",
                                            lambda: sess.generate(prompts, N, **kw)).cpu()
            lg = counted(f"{arch}/prefill_run", lambda: sess.prefill(batch, last_only=False))
            first = sess.prefill(dict(kw, tokens=prompts))      # every rank takes part
            if rank == 0:
                out[f"{arch}/prefill"], out[f"{arch}/first"] = lg.cpu(), first.cpu()
            del lg, first
            if spec["f32_layers"] is not None:
                # the f32 tokens run at a cut depth: the same weights in f32
                # prefill at full depth on the mesh, held to one device's
                s32 = InferenceSession(dataclasses.replace(cfg, dtype="float32"),
                                       tree_map(lambda x: x.float(), sess.params),
                                       device=sess.device, plan=sess.plan, mesh=mesh)
                del sess
                lg = s32.prefill(batch, last_only=False)
                if rank == 0:
                    out[f"{arch}/prefill_f32"] = lg.cpu()
                del s32, lg
            else:
                del sess
            torch.cuda.empty_cache()
            sess = InferenceSession.from_recipe(f32, seed=1, plan=plan, mesh=mesh)
            out[f"{arch}/f32_tokens"] = sess.generate(prompts, N, **kw).cpu()
            del sess
            torch.cuda.empty_cache()
        sess = _family_train(mods, f32, spec, mesh)
        sess.batches(0)
        m = counted(f"{arch}/train", sess.step)
        out[f"{arch}/train"].update(metrics={k: float(m[k]) for k in ("loss", "xent",
                                                                      "grad_norm", "skipped")},
                                    plan=str(sess.plan))
        del sess
        torch.cuda.empty_cache()
    return out


def _family_check(torch, get_config, spec, arch, ref, outs, smi):
    """Phase 29's checks of one family: the ranks agree; f32 tokens exact,
    bf16 first token exact and prefill logits within 2 x the bf16 floor
    against one device; the f32 step's loss 1e-5 relative; K1-K5's launches
    exact at the local head counts; collectives by group and bytes beside
    the cost model's, peak memory a rank beside ``per_device_bytes``
    (reported)."""
    from repro_torch.core.memory import per_device_bytes
    out, P, N = outs[0], spec["prompt_len"], spec["new_tokens"]
    failed = []

    def require(cond, msg):          # every check logged before the phase fails
        if not cond:
            log(f"[families] FAILED: {msg}")
            failed.append(msg)
    cfg, f32t = _family_cfgs(get_config, spec, arch)
    n_tp = spec["tp"]
    dp = spec["ranks"] // n_tp
    hq, hkv = cfg.n_heads // n_tp, cfg.n_kv_heads // n_tp
    for r, o in enumerate(outs[1:], 1):
        for k in ("tokens", "f32_tokens"):
            require(torch.equal(o[f"{arch}/{k}"], out[f"{arch}/{k}"]),
                    f"{arch}: rank {r}'s {k} differ from rank 0's")
        require(o[f"{arch}/train"]["metrics"]["loss"] == out[f"{arch}/train"]["metrics"]["loss"],
                f"{arch}: rank {r}'s loss differs from rank 0's")
    # the first token: the logits it is drawn from (the prompts' last) within
    # 2 x the bf16 floor there, and the token itself equal on every row where
    # one device's top-1 leads its top-2 by more than 2 x that floor (where
    # bf16 can decide it at all)
    got, want = out[f"{arch}/tokens"], ref[f"{arch}/tokens"]
    agree = float((got[:, P:] == want[:, P:]).float().mean())
    one1 = ref[f"{arch}/first"][:, -1]
    d1 = float((out[f"{arch}/first"][:, -1] - one1).abs().max())
    floor1 = float((one1 - ref[f"{arch}/first_f32"][:, -1]).abs().max())
    top2 = one1.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > LOGIT_FLOOR_FACTOR * floor1
    log(f"[families] {arch} bf16 generate at tp {n_tp} x dp {dp} vs one device: first token "
        f"equal by row {(got[:, P] == want[:, P]).tolist()}, {agree:.3f} of the {N} new tokens "
        f"equal (bf16 near-ties may part later); the first token's logits max |mesh - one "
        f"device| {d1:.4g}, the bf16 floor there {floor1:.4g} (tol <= {LOGIT_FLOOR_FACTOR} x "
        f"floor); one device's top-1 - top-2 margin by row {margin.tolist()}: rows bf16 "
        f"decides {decided.tolist()}")
    require(d1 <= LOGIT_FLOOR_FACTOR * floor1,
            f"{arch}: the first token's logits differ by {d1:.4g}, over {LOGIT_FLOOR_FACTOR} x "
            f"{floor1:.4g}")
    require(torch.equal(got[decided, :P + 1], want[decided, :P + 1]),
            f"{arch}: the first generated token differs from one device's where bf16 "
            f"decides it")
    got32, want32 = out[f"{arch}/f32_tokens"], ref[f"{arch}/f32_tokens"]
    log(f"[families] {arch} f32 generate tokens equal to one device's: "
        f"{bool(torch.equal(got32, want32))}")
    require(torch.equal(got32, want32), f"{arch}: the f32 tokens differ from one device's")
    tpl, one, f32 = out[f"{arch}/prefill"], ref[f"{arch}/prefill"], ref[f"{arch}/prefill_f32"]
    require(bool(tpl.isfinite().all()), f"{arch}: non-finite prefill logits")
    diff, floor = float((tpl - one).abs().max()), float((one - f32).abs().max())
    log(f"[families] {arch} bf16 prefill {tuple(tpl.shape)}: max |mesh - one device| "
        f"{diff:.4g}, the bf16 floor {floor:.4g} (tol <= {LOGIT_FLOOR_FACTOR} x floor)")
    require(diff <= LOGIT_FLOOR_FACTOR * floor,
            f"{arch}: prefill differs by {diff:.4g}, over {LOGIT_FLOOR_FACTOR} x {floor:.4g}")
    if spec["f32_layers"] is not None:
        # at full depth in f32: 1e-4 of the largest logit, plus twice what one
        # f32 rounding of the embedding, either way, moves one device's
        # logits (the SSD's chunk sums make the hybrid's f32 logits sensitive
        # to it, as the CPU tests' S 300 rule says)
        got32, f32_floor = out[f"{arch}/prefill_f32"], ref[f"{arch}/prefill_f32_floor"]
        d32 = float((got32 - f32).abs().max())
        tol32 = 1e-4 * float(f32.abs().max()) + LOGIT_FLOOR_FACTOR * f32_floor
        log(f"[families] {arch} f32 prefill at full depth ({cfg.n_layers} layers) "
            f"{tuple(got32.shape)}: max |mesh - one device| {d32:.4g}, the largest logit "
            f"{float(f32.abs().max()):.4g}, one device's change under one f32 rounding of its "
            f"embedding either way {f32_floor:.4g} (tol <= 1e-4 x largest + "
            f"{LOGIT_FLOOR_FACTOR} x that: {tol32:.4g})")
        require(bool(got32.isfinite().all()) and d32 <= tol32,
                f"{arch}: the f32 prefill at full depth differs by {d32:.4g}, over {tol32:.4g}")
    m, rm = out[f"{arch}/train"]["metrics"], ref[f"{arch}/train"]
    rel = abs(m["loss"] - rm["loss"]) / abs(rm["loss"])
    log(f"[families] {arch} f32 step ({out[f'{arch}/train']['plan']}, {f32t.n_layers} layers, "
        f"{spec['train']['global_batch']} x {spec['train']['seq_len']}): loss {m['loss']!r} vs "
        f"one device {rm['loss']!r} (rel {rel:.3g}, tol 1e-5), grad_norm {m['grad_norm']!r} vs "
        f"{rm['grad_norm']!r}")
    require(rel <= 1e-5 and m["skipped"] == 0.0, f"{arch}: f32 step {m} vs one device's {rm}")
    # launches at the local heads
    E, L, Lt = cfg.enc_layers, cfg.n_layers, f32t.n_layers
    A, At = _attentions(cfg), _attentions(f32t)
    if cfg.family == "encdec":
        gen = {"flash_fwd": E, "decode_attention": L * (P + N - 1)}
    elif cfg.family == "ssm":
        gen = {}
    else:
        gen = {"decode_attention": L * (P + N - 1)}
    pre = {"flash_fwd": A} if A else {}
    train = {"flash_fwd": 2 * At, "flash_delta": At, "flash_dq": At, "flash_dkv": At} if At \
        else {}
    summary, launches = {}, []
    for key, want_l in (("generate", gen), ("prefill_run", pre), ("train", train)):
        run = out[f"{arch}/{key}"]
        want_h = {(k, hq, hq if k == "flash_delta" else hkv): c for k, c in want_l.items()}
        log(f"[families] {arch} {key}: launches {run['launches']} (expected {want_l}), heads "
            f"{run['heads']}; collectives {run['collectives']}, bytes {run['bytes']}; "
            f"{run['s']:.2f} s host ({FAMILY_TP_LABEL}); peak {run['peak_bytes'] / 2**30:.3f} "
            f"GiB a rank")
        require(run["launches"] == want_l, f"{arch} {key}: launches {run['launches']}")
        require(run["heads"] == want_h, f"{arch} {key}: K1-K5 ran at {run['heads']}")
        launches.append(run["launches"])
        summary[key] = {"collectives": run["collectives"], "bytes": run["bytes"],
                        "s": run["s"], "peak_bytes": run["peak_bytes"]}
    t = spec["train"]
    mbs = t["global_batch"] // t["gas"] // dp
    cm_tp = 4 * Lt * t["gas"] * mbs * t["seq_len"] * f32t.d_model * 2
    n = f32t.n_params()
    cm_dp = 2.0 * (2.0 * n) * (dp - 1) / dp
    model = per_device_bytes(f32t, dp=dp, tp=n_tp, pp=1, zero_stage=spec["zero_stage"], mbs=mbs,
                             gas=t["gas"], seq=t["seq_len"], remat="full")
    run = out[f"{arch}/train"]
    log(f"[families] {arch} f32 step: the cost model's t_tp {4 * Lt * t['gas']} all-reduces of "
        f"{cm_tp // max(4 * Lt * t['gas'], 1)} B ({cm_tp} B, bf16 activations), t_dp "
        f"{cm_dp:.0f} B (bf16 gradients); measured in f32 {run['collectives']} / "
        f"{run['bytes']} (the SSM's and xLSTM's norms and gathers are outside the model's 4 a "
        f"layer); peak {run['peak_bytes'] / 2**30:.3f} GiB a rank, "
        f"memory model {model['total'] / 2**30:.3f} GiB; {smi}")
    summary["train"].update(cost_model_tp_bytes=cm_tp, cost_model_dp_bytes=cm_dp,
                            per_device_bytes=model["total"], loss_rel=rel,
                            prefill_diff=diff, prefill_floor=floor)
    summary["train"].update(first_token_diff=d1, first_token_floor=floor1,
                            first_token_margins=margin.tolist())
    if spec["f32_layers"] is not None:
        summary["prefill_f32"] = dict(diff=d32, tol=tol32, floor=f32_floor)
    return {"summary": summary, "launches": launches, "failed": failed}


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
    # phases 20-22, 25, 26 and 29's worlds of two and four ranks: the
    # references this process holds them to, each world in one spawn, then
    # the checks
    tp_ref, tp_mode = timed("20 references", phase_tp_refs, torch, np, get_config,
                            InferenceSession, TrainSession, stepfn, ParallelismConfig,
                            DataConfig, tree_map, smi)
    dp_ref = timed("21 reference", phase_dp_ref, torch, get_config)
    pp_ref = timed("22 reference", phase_pp_ref, torch, get_config)
    two, two_s = timed("20, 21, 22, 25, 26 the world of two", run_world, torch,
                       "_world_of_two", 2)
    shutil.rmtree(TP_DIR)
    four, four_s = timed("21, 22, 29 the world of four", run_world, torch, "_world_of_four", 4)
    tp_summary, tp_launches = timed("20 checks", _tp_check, torch, get_config, tp_ref,
                                    two["20"], two_s["20"], tp_mode, smi)
    dp_summary, dp_launches = timed("21 checkpoint and checks", phase_dp_checks, torch,
                                    get_config, store, smi, dp_ref,
                                    {DP["ranks"]: two["21"], 4: four["21"]},
                                    two_s["21"] + four_s["21"])
    pp_summary, pp_launches = timed("22 checks", _pp_check, get_config, pp_ref,
                                    {PP["ranks"]: two["22"], 4: four["22"]},
                                    two_s["22"] + four_s["22"], smi)
    moe_pp_launches = timed("25 checks", _moe_pp_check, get_config, two["25"], two_s["25"], smi)
    hybrid_pp_launches = timed("26 pipeline checks", _hybrid_pp_check, get_config, two["26"],
                               two_s["26"], smi)
    moe_launches = timed("23 moe serve", phase_moe, torch, np, build, get_config,
                         InferenceSession, tree_map, smi)
    moe_eval = {}
    moe_train, moe_measured = timed(
        "23 moe train + eval", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_OLMOE, tag="olmoe train",
        after=lambda sess, floor: moe_eval.update(
            phase_eval(torch, build, EvalSession, sess, floor, TRAIN_OLMOE)))
    _train_memory(get_config, moe_measured, TRAIN_OLMOE, "olmoe train")
    timed("23 moe f32 generate", phase_f32_identity, torch, np, fa, da, get_config,
          InferenceSession, MOE["arch"], 2)
    timed("23 moe f32 train", phase_train_f32_identity, torch, fa, da, get_config,
          TrainSession, stepfn, ParallelismConfig, DataConfig, MOE["arch"], 2)
    timed("23 moe repeat", phase_moe_repeat, torch, get_config, TrainSession, stepfn,
          ParallelismConfig, DataConfig)
    vlm_launches = timed("24 vlm serve", phase_vlm, torch, np, build, InferenceSession,
                         tree_map, smi)
    vlm_train, vlm_measured = timed(
        "24 vlm train", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_VLM, tag="vlm train")
    _train_memory(get_config, vlm_measured, TRAIN_VLM, "vlm train")
    timed("24 vlm unembed", _unembed_share, torch, get_config, vlm_measured, smi)
    # K1-K5 at internvl2's shapes: a GQA group of 7, one training
    # micro-batch, the ring of phase 24's decode
    timed("24 vlm kernels", _time_shapes, torch, fa, da, smi, "vlm kernels", B=4, S=1024,
          Hq=14, Hkv=2, ring=544)
    timed("24 vlm f32 generate", phase_f32_identity, torch, np, fa, da, get_config,
          InferenceSession, VLM["arch"], 2)
    timed("24 vlm f32 train", phase_train_f32_identity, torch, fa, da, get_config,
          TrainSession, stepfn, ParallelismConfig, DataConfig, VLM["arch"], 2)
    hybrid_launches = timed("26 hybrid serve", phase_hybrid, torch, np, build,
                            InferenceSession, tree_map, smi)
    hybrid_train, hybrid_measured = timed(
        "26 hybrid train", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_HYMBA, tag="hybrid train")
    _train_memory(get_config, hybrid_measured, TRAIN_HYMBA, "hybrid train")
    timed("26 hybrid kernels", _time_hybrid, torch, fa, da, smi)
    timed("26 hybrid f32 generate", phase_f32_identity, torch, np, fa, da, get_config,
          InferenceSession, HYBRID["arch"], 4)
    timed("26 hybrid f32 train", phase_train_f32_identity, torch, fa, da, get_config,
          TrainSession, stepfn, ParallelismConfig, DataConfig, HYBRID["arch"], 4,
          f32_floor=True)
    xlstm_launches = timed("27 xlstm serve", phase_xlstm, torch, np, build, InferenceSession,
                           tree_map, smi)
    xlstm_train, xlstm_measured = timed(
        "27 xlstm train", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_XLSTM, tag="xlstm train")
    _train_memory(get_config, xlstm_measured, TRAIN_XLSTM, "xlstm train")
    timed("27 xlstm f32 card vs CPU", phase_xlstm_f32_cpu, torch, get_config, TrainSession,
          stepfn, ParallelismConfig, DataConfig, tree_map)
    whisper_launches = timed("28 whisper serve", phase_whisper, torch, np, build,
                             InferenceSession, tree_map, smi)
    whisper_train, whisper_measured = timed(
        "28 whisper train", phase_train, torch, build, get_config, TrainSession, stepfn,
        ParallelismConfig, DataConfig, smi, spec=TRAIN_WHISPER, tag="whisper train")
    _train_memory(get_config, whisper_measured, TRAIN_WHISPER, "whisper train")
    timed("28 whisper kernels", _time_whisper, torch, fa, da, smi)
    timed("28 whisper f32", phase_whisper_f32_identity, torch, np, get_config, InferenceSession)
    family_summary, family_launches = timed("29 every family under tp and dp", phase_family_tp,
                                            torch, np, get_config, InferenceSession, tree_map,
                                            smi, four["29"], four_s["29"])
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
            *h2o_stream_launches.values(), h2o_train_launches, *tp_launches, *dp_launches,
            *pp_launches, *moe_launches, moe_train, moe_eval, *vlm_launches, vlm_train,
            *moe_pp_launches, *hybrid_launches, hybrid_train, *hybrid_pp_launches,
            *xlstm_launches, xlstm_train, *whisper_launches, whisper_train,
            *family_launches]
    log(f"[launches] generate {serve_launches}; train step {train_launches}; stream "
        f"{stream_launches}; training CLI (crashed, resumed) {cli_launches}; eval sweep "
        f"{eval_launches}; dense arm (prefill, generate) {dense_launches}; h2o stream "
        f"{h2o_stream_launches}; h2o train step {h2o_train_launches}; tp = 2 rank 0 "
        f"(granite and gpt-3.6b generate, gpt-3.6b prefill, three train steps) {tp_launches}"
        f"; dp = 2 rank 0 (a step at each of seven ZeRO settings) {dp_launches}; pp = 2 "
        f"rank 0 (stage 0: a step of vpp 1, vpp 2, remat stage, gas 8, and pp 2 x dp 2) "
        f"{pp_launches}; MoE (olmoe generate, prefill, stream; deepseek generate, prefill) "
        f"{moe_launches}; olmoe train step {moe_train}; olmoe eval sweep {moe_eval}; VLM "
        f"(internvl2 prefill, cache prefill + decode, generate, stream) {vlm_launches}; "
        f"internvl2 train step {vlm_train}; olmoe pp = 2 rank 0 (stage 0: a step of vpp 1 "
        f"and vpp 2) {moe_pp_launches}; hybrid (hymba generate, prefill, stream) "
        f"{hybrid_launches}; hymba train step {hybrid_train}; hymba pp = 2 rank 0 (stage 0: "
        f"a step of vpp 2) {hybrid_pp_launches}; xLSTM (xlstm generate, prefill, stream) "
        f"{xlstm_launches}; xlstm train step {xlstm_train}; encoder-decoder (whisper "
        f"generate, prefill, stream) {whisper_launches}; whisper train step {whisper_train}; "
        f"every family under tp and dp rank 0 (hymba at tp 5, xlstm and whisper at tp 2 x dp "
        f"2: generate, prefill, an f32 step each) {family_launches}")
    for kr in kernels:
        r = timing[kr["name"]]
        n = sum(c.get(kr["name"], 0) for c in runs)
        kr.update(launches=n, max_abs_err=r["max_abs_err"],
                  ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r["library_ms"])
    log(f"[env] card: {smi}")
    print(json.dumps({"planning": planning}), flush=True)
    print(json.dumps({"tp": tp_summary}), flush=True)
    print(json.dumps({"dp": dp_summary}), flush=True)
    print(json.dumps({"pp": pp_summary}), flush=True)
    print(json.dumps({"families": family_summary}), flush=True)
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
