"""The paper's parallelism recipe as a dataclass, a copy of
``repro.core.recipe.ParallelismConfig`` (without the mesh functions and the
``RecipeAdvisor``, which come with the parallel recipe's port).

On one device the single-device train step accepts ``tp = pp = dp = pods =
1`` and raises ``NotImplementedError`` for more.  ``zero_stage``,
``overlap_zero`` and ``gather_params_once`` change nothing without a mesh,
exactly as in the reference.  ``flash_bq``/``flash_bk`` are accepted and
ignored: the port's flash kernels choose their own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
                f"(gas={self.gas}, pp={self.pp})")
        if devices is not None and self.world != devices:
            raise ValueError(f"world={self.world} != devices={devices}")
