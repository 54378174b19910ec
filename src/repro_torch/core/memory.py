"""Memory model, a copy of ``repro.core.memory``: the paper's Table 1, then
per-device accounting under the parallelism recipe (the feasibility oracle
that ``cost_model.estimate_step`` and the Bayesian search read).

Paper's accounting (mixed precision, Adam), bytes per parameter:
    parameters  6x  (bf16 compute copy 2 + fp32 master 4)
    gradients   2x  (bf16)
    optimizer   8x  (fp32 Adam m and v)
    total      16x

Host-side Python floats, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

GiB = 2**30


@dataclasses.dataclass(frozen=True)
class MemoryBreakdown:
    params: float
    grads: float
    optimizer: float

    @property
    def total(self) -> float:
        return self.params + self.grads + self.optimizer


def model_state_bytes(n_params: int) -> MemoryBreakdown:
    """Table 1: total state bytes for a model of ``n_params`` parameters."""
    return MemoryBreakdown(params=6.0 * n_params, grads=2.0 * n_params,
                           optimizer=8.0 * n_params)


def activation_bytes_per_layer(cfg: ModelConfig, mbs: int, seq: int,
                               *, remat: str = "full") -> float:
    """Per-microbatch activation footprint of one transformer layer (bytes).

    Megatron-style estimate (Korthikanti et al.): full activations
    ≈ s·b·h·(34 + 5·a·s/h) bytes in bf16 without remat; with full remat only
    the layer-boundary activation (2·s·b·h) survives.  Any other policy
    (``"stage"`` among them) takes the no-remat formula, as in the reference.
    """
    h, a = cfg.d_model, cfg.n_heads
    if remat == "full":
        return 2.0 * seq * mbs * h
    if remat == "dots":
        return seq * mbs * h * 10.0
    flash = 0.0 if cfg.swa_window else 5.0 * a * seq / h  # flash kernels drop the S^2 term
    return seq * mbs * h * (34.0 + flash)


def per_device_bytes(cfg: ModelConfig, *, dp: int, tp: int, pp: int, pods: int = 1,
                     mbs: int = 1, gas: int = 1, seq: int = 2048,
                     zero_stage: int = 1, remat: str = "full") -> Dict[str, float]:
    """Per-device memory under the recipe. The search's feasibility oracle."""
    n = cfg.n_params()
    model_shard = tp * pp                      # model-parallel ways
    zero_ways_opt = dp * pods if zero_stage >= 1 else 1
    zero_ways_grad = dp * pods if zero_stage >= 2 else 1
    zero_ways_param = dp if zero_stage >= 3 else 1   # ZeRO-3 stays intra-pod (recipe)

    params = 6.0 * n / model_shard / zero_ways_param
    grads = 2.0 * n / model_shard / zero_ways_grad
    opt = 8.0 * n / model_shard / zero_ways_opt

    layers_per_stage = max(1, cfg.n_layers // pp)
    act_layer = activation_bytes_per_layer(cfg, mbs, seq, remat=remat) / tp
    # 1F1B: stage s stashes at most pp in-flight microbatches
    in_flight = min(gas, pp)
    acts = act_layer * layers_per_stage * in_flight
    # embedding activations + logits on the last stage
    logits = 4.0 * mbs * seq * cfg.vocab_size / tp if pp == 1 else 0.0

    return {
        "params": params,
        "grads": grads,
        "optimizer": opt,
        "activations": acts,
        "logits": logits,
        "total": params + grads + opt + acts + logits,
    }


def table1() -> Dict[str, Dict[str, float]]:
    """The paper's Table 1, in GB, computed from the 16 B/param model."""
    sizes = {"3.6B": 3.6e9, "20B": 20e9, "175B": 175e9}
    out = {}
    for name, n in sizes.items():
        mb = model_state_bytes(int(n))
        out[name] = {
            "params_GB": mb.params / 1e9,
            "grads_GB": mb.grads / 1e9,
            "optimizer_GB": mb.optimizer / 1e9,
            "total_GB": mb.total / 1e9,
        }
    return out
