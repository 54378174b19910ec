"""The paper's parallelism recipe: ``ParallelismConfig``, the mesh
functions (``factorize_production_mesh``, ``axis_mapping``, ``fsdp_axes``)
and the ``RecipeAdvisor`` (the paper's §7 checklist), copies of
``repro.core.recipe``'s.  ``factorize_production_mesh`` reshapes a grid of
process ranks (``launch/mesh.py``) where the reference reshapes a grid of
devices.

Without a mesh the train step computes ``tp``, ``dp`` and ``pods`` as one
device, as the reference does (one replica group computes; the consensus
drills simulate replicas with ``ResilienceConfig.consensus_replicas``); on
a mesh it runs ``tp`` over ``torch.distributed`` (``core/tp.py``), and
``core.stepfn.check_plan`` says what else waits.  ``zero_stage``,
``overlap_zero`` and ``gather_params_once`` change nothing without a mesh,
exactly as in the reference.  ``flash_bq``/``flash_bk`` are accepted and
ignored: the port's flash kernels choose their own tiles.  The advisor's
default system is an H100 node (``core.systems.H100_SXM``, a fast domain
of 8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.systems import H100_SXM, System


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    tp: int = 1              # tensor-parallel degree  (paper: {4, 8}, ≤ node)
    pp: int = 1              # pipeline stages          (paper: {12,16,20,24})
    dp: int = 1              # data-parallel ways inside a pod
    pods: int = 1            # pod axis (outer, slowest domain)
    mbs: int = 1             # micro-batch size         (paper: [1,10])
    gas: int = 1             # micro-batches per optimizer step (paper GAS)
    zero_stage: int = 1      # ZeRO stage for the DP axis (paper uses 1)
    sequence_parallel: bool = False   # beyond-paper: RS/AG TP variant
    remat_policy: str = "full"        # none | dots | full | stage (pipeline)
    gather_params_once: bool = False  # ZeRO-3 + pipeline: one bf16 gather a step
    flash_bq: Optional[int] = None    # the reference's flash block-size override;
    flash_bk: Optional[int] = None    # ignored here (the kernels pick their tiles)
    vpp: int = 1             # virtual pipeline stages per physical stage
    overlap_zero: bool = False        # overlap ZeRO collectives with compute

    @property
    def world(self) -> int:
        return self.tp * self.pp * self.dp * self.pods

    @property
    def global_batch(self) -> int:
        return self.mbs * self.gas * self.dp * self.pods

    @property
    def bubble_fraction(self) -> float:
        """1F1B bubble ≈ (PP-1)/(VPP·GAS+PP-1)."""
        if self.pp <= 1:
            return 0.0
        return (self.pp - 1) / (self.vpp * self.gas + self.pp - 1)

    def validate(self, n_layers: int, *, devices: Optional[int] = None) -> None:
        if self.vpp < 1:
            raise ValueError(f"vpp={self.vpp} must be >= 1")
        if n_layers % (self.pp * self.vpp):
            raise ValueError(
                f"pp*vpp={self.pp}*{self.vpp} does not divide n_layers={n_layers}")
        if self.vpp > 1 and self.gas % self.pp:
            raise ValueError(
                f"interleaved schedule needs gas % pp == 0 "
                f"(gas={self.gas}, pp={self.pp}) — micro-batches flow through "
                f"the chunk ring in rounds of pp")
        if devices is not None and self.world != devices:
            raise ValueError(f"world={self.world} != devices={devices}")


def factorize_production_mesh(grid: np.ndarray, plan: ParallelismConfig) -> np.ndarray:
    """Reshape a production grid of ranks, ``(data, model)`` or ``(pod,
    data, model)``, into the logical ``(pod, data, pp, tp)`` recipe grid.

    The TP axis is innermost (consecutive ranks share a TP group, the
    paper's "TP inside the node" rule); PP is the next axis out; DP and pod
    outermost."""
    grid = np.asarray(grid)
    if grid.ndim == 2:           # (data, model)
        pods = 1
        data, model = grid.shape
    else:                        # (pod, data, model)
        pods, data, model = grid.shape
    if plan.pods != pods or plan.dp != data or plan.tp * plan.pp != model:
        raise ValueError(
            f"plan (pods={plan.pods}, dp={plan.dp}, pp*tp={plan.pp * plan.tp}) "
            f"does not factorize mesh {grid.shape}")
    return grid.reshape(pods, data, plan.pp, plan.tp)


def axis_mapping(plan: ParallelismConfig) -> Dict[str, object]:
    """Logical axis → mesh axis mapping for `repro_torch.core.sharding`."""
    mapping: Dict[str, object] = {
        "tp": "tp",
        "stage": "pp",
        "chunks": None,            # virtual-stage axis: chunks co-reside on
        # their physical stage's devices, so the leading VPP axis of
        # interleaved-stacked block params is never sharded
        "batch": ("pod", "data"),
        "expert": "tp",            # EP rides the model axis (beyond-paper)
        "layers": None,
        "embed": None,
        "seq": "tp" if plan.sequence_parallel else None,
    }
    if plan.zero_stage >= 3:
        mapping["embed"] = "data"  # FSDP params over the intra-pod data axis
    return mapping


def fsdp_axes(plan: ParallelismConfig) -> Tuple[str, ...]:
    """Mesh axes the ZeRO optimizer-state shard spreads over."""
    return ("pod", "data") if plan.zero_stage >= 1 else ()


# ---------------------------------------------------------------------------
# the paper's §7 checklist as an advisor
# ---------------------------------------------------------------------------

class RecipeAdvisor:
    """Encodes the paper's conclusions: TP ≤ fast domain; keep the pipeline
    full (GAS ≥ 4·PP keeps bubble < 25 %); scale out via (ZeRO-)DP."""

    def __init__(self, system: System = H100_SXM):
        self.system = system

    # unpacked rows whose mean document is shorter than seq_len/PACK_RATIO
    # waste most of their FLOPs on padding/cross-document tokens
    PACK_RATIO = 4.0

    # interleaving more than ~4 chunks per stage buys little extra bubble
    # reduction while multiplying the stage-boundary P2P traffic (Megatron's
    # own guidance); stay at or below this unless layers/stage forces less
    MAX_VPP = 4

    @staticmethod
    def suggest_vpp(n_layers: int, pp: int, gas: int,
                    max_vpp: int = MAX_VPP) -> int:
        """Largest virtual-stage count the layer count and schedule admit:
        vpp must divide layers/stage, and the interleaved rotation needs
        gas % pp == 0 (micro-batches loop the ring in rounds of pp)."""
        if pp <= 1 or n_layers % pp or gas % pp:
            return 1
        layers_stage = n_layers // pp
        for v in range(min(max_vpp, layers_stage), 0, -1):
            if layers_stage % v == 0:
                return v
        return 1

    def check(self, plan: ParallelismConfig, *, data_cfg=None,
              mean_doc_len: Optional[float] = None,
              n_layers: Optional[int] = None) -> Dict[str, str]:
        warnings = {}
        if plan.tp > self.system.fast_domain:
            warnings["tp"] = (
                f"TP={plan.tp} crosses the fast domain ({self.system.fast_domain}): "
                "per-layer all-reduces will hit the slow interconnect (paper Fig 1)")
        if plan.pp > 1 and plan.vpp * plan.gas < 4 * plan.pp:
            warnings["bubble"] = (
                f"GAS={plan.gas} gives bubble {plan.bubble_fraction:.1%}; "
                f"paper Fig 2 recommends GAS ≥ {4 * plan.pp} for PP={plan.pp}")
        if plan.pp > 1 and plan.vpp == 1 and n_layers is not None:
            v = self.suggest_vpp(n_layers, plan.pp, plan.gas)
            if v > 1:
                # interleaving v chunks equals raising GAS to v·GAS in the
                # bubble law — but at fixed global batch and memory
                interleaved = (plan.pp - 1) / (v * plan.gas + plan.pp - 1)
                if plan.bubble_fraction - interleaved > 0.02:
                    warnings["interleave"] = (
                        f"vpp={v} (layers/stage={n_layers // plan.pp}) cuts the "
                        f"bubble {plan.bubble_fraction:.1%} → {interleaved:.1%} "
                        f"at fixed global batch — the bubble raising GAS to "
                        f"{v * plan.gas} would reach only by growing the "
                        f"per-replica batch and activation memory v×")
        if plan.zero_stage >= 3 and plan.pods > 1:
            warnings["zero"] = ("ZeRO-3 param all-gathers would cross the pod "
                                "boundary every layer; keep ZeRO-3 intra-pod")
        if (data_cfg is not None and not data_cfg.pack_documents
                and mean_doc_len is not None
                and mean_doc_len * self.PACK_RATIO <= data_cfg.seq_len):
            warnings["pack"] = (
                f"mean document length ~{mean_doc_len:.0f} is far below "
                f"seq_len={data_cfg.seq_len}: set DataConfig.pack_documents "
                "to pack EOS-delimited documents edge-to-edge (segment-aware "
                "attention keeps losses exact; no FLOPs spent on padding)")
        return warnings

    def suggest(self, n_layers: int, devices: int, *, min_gas: int = 8) -> ParallelismConfig:
        """Greedy recipe: max TP inside the fast domain that divides heads,
        then PP to fit, then DP; interleave whatever layers/stage admits."""
        tp = min(self.system.fast_domain, devices)
        pp = 1
        dp = devices // (tp * pp)
        gas = max(min_gas, 4 * pp)
        return ParallelismConfig(tp=tp, pp=pp, dp=dp, gas=gas,
                                 vpp=self.suggest_vpp(n_layers, pp, gas))
