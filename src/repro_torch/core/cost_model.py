"""Analytic step-time model for the recipe, a copy of
``repro.core.cost_model``: the engine behind the paper's Figs 1-3 and 5 and
the Bayesian search's objective (§5).  All terms are napkin math over a
``System``'s constants, in host-side Python floats, bit for bit the
reference's.  Its default system is the port's card, ``H100_SXM``.

Terms modeled per optimizer step under (interleaved) 1F1B with GAS
micro-batches and VPP virtual stages per physical stage:
  compute   : 6·N_active·tokens (+attention) with remat multiplier & GEMM eff
  TP comm   : 4 all-reduces/layer of (mbs·s·d) activations — domain-aware BW
              (the paper's Fig-1 cliff when TP crosses the fast domain)
  PP p2p    : 2 boundary transfers per superstep per stage — VPP·GAS+PP-1
              supersteps, so interleaving multiplies P2P traffic ~VPP×
  bubble    : (PP-1)/(VPP·GAS+PP-1)  — the paper's PP/M law, divided by the
              virtual-stage count (Megatron interleaved-1F1B)
  DP sync   : ZeRO-1 reduce-scatter(grads) + all-gather(params); with
              ``plan.overlap_zero`` the async collectives hide under stage
              compute up to the compute time (``t_overlap``), otherwise a
              fixed ``dp_overlap`` fraction overlaps the pipeline flush

What it leaves out: the compute term counts GEMM FLOPs only, at
``System.gemm_eff``; elementwise passes, copies and an f32 unembed are not
in it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import memory
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.systems import H100_SXM, System
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class StepCost:
    t_compute: float
    t_tp: float
    t_pp: float
    t_dp_exposed: float
    t_overlap: float             # ZeRO collective time hidden under compute
    t_step: float
    bubble: float
    model_tflops_per_device: float
    hw_utilization: float        # fraction of per-device peak
    feasible: bool
    mem_total: float
    mem_limit: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: routed top-k + shared only)."""
    n = cfg.n_params()
    if cfg.family != "moe":
        return n
    moe_layers = cfg.n_layers - cfg.first_k_dense
    all_expert = moe_layers * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff
    act_expert = moe_layers * cfg.top_k * 3 * cfg.d_model * cfg.moe_d_ff
    return n - all_expert + act_expert


# Flash-trained attention recomputes the score tiles in the backward pass.
# The split-sweep backward (dQ with K innermost, dK/dV with Q innermost; K3
# and K4 here) recomputes S and dP in each, so backward is 7 tile-matmuls
# (2·S, 2·dP, dQ, dK, dV) vs autodiff's 4 — attention fwd+bwd goes from 6 to
# 9 units: 1.5×.
FLASH_BWD_ATTN_MULT = 1.5


def model_flops_per_token(cfg: ModelConfig, seq: int, *,
                          flash_backward: bool = False,
                          avg_docs_per_seq: float = 1.0) -> float:
    """Useful fwd+bwd FLOPs per token: 6·N_active + causal attention term.

    ``flash_backward=True`` models the fused flash backward: the split-sweep
    recompute brings attention fwd+bwd from 6 to 9 matmul units
    (``FLASH_BWD_ATTN_MULT`` = 1.5).

    ``avg_docs_per_seq > 1`` models packed-sequence training (segment-masked
    attention): a token's attention span is its document, not the row, so
    the quadratic term shrinks to the mean document length ``seq / docs`` —
    the same work the segment-aware kernels' block skipping avoids."""
    n = active_params(cfg)
    seq_eff = seq / max(avg_docs_per_seq, 1.0)
    w = min(cfg.swa_window or seq_eff, seq_eff)
    attn = 6.0 * cfg.n_layers * cfg.n_heads * cfg.hd * w  # 12·d_attn·s, halved causal
    if cfg.family == "ssm":
        attn = 0.0
    if flash_backward:
        attn *= FLASH_BWD_ATTN_MULT
    return 6.0 * n + attn


def flash_block_skip_fraction(segment_ids, *, bq: int = 128, bk: int = 128,
                              causal: bool = True,
                              window: Optional[int] = None) -> float:
    """Fraction of (q-block, k-block) tiles that a segment-aware flash kernel
    skips for a concrete packed batch: the reference kernels'
    ``_block_relevant`` test (causal / window clip + segment-id interval
    overlap), computed on the host.

    The defaults ``bq = bk = 128`` are the reference's.  ``bq=64, bk=128``
    is the port's K1 grid (``csrc/flash_fwd.cu``: each consumer warpgroup
    of 64 query rows over 128-key tiles); K1 tests each key's id against
    the rows' id range, so it skips at least the tiles counted here."""
    seg = np.asarray(segment_ids)
    if seg.ndim == 1:
        seg = seg[None]
    B, S = seg.shape
    bq, bk = min(bq, S), min(bk, S)
    nq, nk = S // bq, S // bk
    live = 0
    for b in range(B):
        qmin = seg[b, :nq * bq].reshape(nq, bq).min(axis=1)
        qmax = seg[b, :nq * bq].reshape(nq, bq).max(axis=1)
        kmin = seg[b, :nk * bk].reshape(nk, bk).min(axis=1)
        kmax = seg[b, :nk * bk].reshape(nk, bk).max(axis=1)
        for iq in range(nq):
            for ik in range(nk):
                rel = True
                if causal:
                    rel &= ik * bk <= iq * bq + bq - 1
                if window is not None:
                    rel &= ik * bk + bk - 1 > iq * bq - window
                rel = rel and qmax[iq] >= kmin[ik] and kmax[ik] >= qmin[iq]
                live += rel
    total = B * nq * nk
    return 1.0 - live / total


def estimate_step(cfg: ModelConfig, plan: ParallelismConfig, *,
                  system: System = H100_SXM, seq: int = 2048,
                  dp_overlap: float = 0.6,
                  flash_backward: bool = False,
                  avg_docs_per_seq: float = 1.0) -> StepCost:
    tokens_replica = plan.mbs * plan.gas * seq
    fpt = model_flops_per_token(cfg, seq, flash_backward=flash_backward,
                                avg_docs_per_seq=avg_docs_per_seq)
    flops_replica = fpt * tokens_replica
    # no "stage" key: the reference raises KeyError for it, and so does this
    remat_mult = {"none": 1.0, "dots": 1.15, "full": 4.0 / 3.0}[plan.remat_policy]

    # --- compute (per superstep = one chunk of one micro-batch, per device) ---
    m_dim = plan.mbs * seq                        # GEMM token dim per device
    eff = system.gemm_eff * m_dim / (m_dim + system.eff_knee_m)
    flops_chunk_dev = (flops_replica * remat_mult
                       / plan.gas / plan.pp / plan.vpp / plan.tp)
    t_compute_chunk = flops_chunk_dev / (system.peak_flops * eff)

    # --- TP collectives (per chunk, per stage) ---
    layers_chunk = cfg.n_layers / plan.pp / plan.vpp
    if plan.tp > 1:
        ar_bytes = plan.mbs * seq * cfg.d_model * 2.0
        crosses_pod = plan.tp > (system.pod_size or 1 << 30)
        bw = system.domain_bw(plan.tp, crosses_pod=crosses_pod)
        n_coll = 4.0                               # 2 fwd + 2 bwd per layer
        t_ar = 2.0 * (plan.tp - 1) / plan.tp * ar_bytes / bw
        if plan.sequence_parallel:
            t_ar *= 0.75                           # RS+AG overlap better than AR
        t_tp_chunk = layers_chunk * n_coll * t_ar
    else:
        t_tp_chunk = 0.0

    # --- PP point-to-point (per superstep, per boundary) — a micro-batch
    # loops the ring VPP times, so interleaving costs ~VPP× the P2P bytes ---
    if plan.pp > 1:
        p2p_bytes = plan.mbs * seq * cfg.d_model * 2.0
        t_pp_chunk = 2.0 * p2p_bytes / system.slow_bw
    else:
        t_pp_chunk = 0.0

    # --- (interleaved) 1F1B assembly: VPP·GAS + PP - 1 chunk supersteps ---
    supersteps = plan.vpp * plan.gas + plan.pp - 1
    t_pipe = supersteps * (t_compute_chunk + t_tp_chunk + t_pp_chunk)
    bubble = plan.bubble_fraction

    # --- ZeRO-DP sync ---
    dpw = plan.dp * plan.pods
    if dpw > 1:
        shard = 2.0 * cfg.n_params() / (plan.tp * plan.pp)    # bf16 grads bytes
        crosses_pod = plan.pods > 1
        bw = system.domain_bw(dpw, crosses_pod=crosses_pod)
        if not crosses_pod and plan.dp <= system.fast_domain:
            bw = system.fast_bw if plan.tp == 1 else system.slow_bw
        t_dp = 2.0 * shard * (dpw - 1) / dpw / bw             # RS + AG
    else:
        t_dp = 0.0
    if plan.overlap_zero:
        # async gather/scatter streams behind the superstep compute: the
        # hideable budget is the step's compute time itself (link and HBM
        # traffic contend beyond that) — the remainder stays exposed
        t_overlap = min(t_dp, supersteps * t_compute_chunk)
        t_dp_exposed = t_dp - t_overlap
    else:
        t_overlap = t_dp * dp_overlap              # pipeline-flush overlap only
        t_dp_exposed = t_dp * (1.0 - dp_overlap)

    t_step = t_pipe + t_dp_exposed

    # --- memory feasibility ---
    mem = memory.per_device_bytes(
        cfg, dp=plan.dp, tp=plan.tp, pp=plan.pp, pods=plan.pods,
        mbs=plan.mbs, gas=plan.gas, seq=seq, zero_stage=plan.zero_stage,
        remat=plan.remat_policy)
    feasible = mem["total"] <= system.hbm_bytes

    useful = fpt * tokens_replica * plan.dp * plan.pods       # no remat multiplier
    tflops_dev = useful / t_step / plan.world / 1e12
    return StepCost(
        t_compute=supersteps * t_compute_chunk,
        t_tp=supersteps * t_tp_chunk,
        t_pp=supersteps * t_pp_chunk,
        t_dp_exposed=t_dp_exposed,
        t_overlap=t_overlap,
        t_step=t_step,
        bubble=bubble,
        model_tflops_per_device=tflops_dev,
        hw_utilization=tflops_dev * 1e12 / system.peak_flops,
        feasible=feasible,
        mem_total=mem["total"],
        mem_limit=system.hbm_bytes,
    )
