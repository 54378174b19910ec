"""Hardware profiles: the reference's ``System`` (``repro.core.systems``),
field for field, and the systems the port's planning models read.

* ``H100_SXM``: one NVIDIA H100 SXM in an HGX node of 8, joined all to all
  by NVLink (NVIDIA's data sheet: 989 TFLOP/s dense bf16, 80 GB of HBM3 at
  3.35 TB/s, 900 GB/s of NVLink per card, 450 GB/s each way), 400 Gb/s of
  InfiniBand per card between nodes.  The fast domain is the node: 8 cards.
  The card the port runs on, and the default of its planning models.
* ``SMNG_P2``: the paper's system (Intel Data Center GPU Max 1550 tiles,
  Xe-Link inside a node, 2 x HDR200 InfiniBand between nodes), a copy of the
  reference's.  Its figures are the paper's, not a card's measured here; it
  validates the cost model against the paper's numbers (Table 1, Figs 1-5,
  Table 2).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class System:
    name: str
    peak_flops: float            # bf16 FLOP/s per device (tile / chip)
    hbm_bytes: float             # HBM capacity per device
    hbm_bw: float                # bytes/s per device
    fast_domain: int             # devices sharing the fast interconnect domain
    fast_bw: float               # all-reduce-effective bytes/s per device, intra-domain
    slow_bw: float               # bytes/s per device crossing domains (IB / DCI)
    pod_size: int = 0            # devices per pod, 0 if N/A
    pod_bw: float = 0.0          # inter-pod bytes/s per device
    # compute-efficiency model: fraction of peak attainable by big GEMMs,
    # and the matmul M-dim at which efficiency halves (small-batch penalty).
    gemm_eff: float = 0.55
    eff_knee_m: float = 256.0

    def domain_bw(self, group: int, *, crosses_pod: bool = False) -> float:
        """Effective per-device collective bandwidth for a group of devices."""
        if crosses_pod and self.pod_bw:
            return self.pod_bw
        if group <= self.fast_domain:
            return self.fast_bw
        return self.slow_bw


H100_SXM = System(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    fast_domain=8,
    fast_bw=450e9,
    slow_bw=50e9,
    # measured, not fitted to a step time: chip_smoke.py's GEMM sweep (bf16
    # torch.matmul, (M x 2048) @ (2048 x 8192), M 16..16384, device time) on
    # an NVIDIA H100 80GB HBM3 at a 700.00 W power limit derived 0.7480 and
    # M 102.9 in its first run, two significant figures kept; the final run
    # of the same tree derived 0.7599 and M 112.9 (PERF.md, section 5)
    gemm_eff=0.75,
    eff_knee_m=100.0,
)

# SuperMUC-NG Phase 2: per-tile figures. 4x PVC (8 tiles)/node; Xe-Link
# intra-node; 2x HDR200 IB (50 GB/s/node aggregate = 6.25 GB/s/tile).
SMNG_P2 = System(
    name="smng_p2",
    peak_flops=570e12,           # implied by paper: 57 TF/s ~ 10 % of peak
    hbm_bytes=64 * 2**30,
    hbm_bw=1.6e12,
    fast_domain=8,               # one node = 8 tiles (the paper's TP ≤ 8 rule)
    fast_bw=60e9,                # Xe-Link effective per tile
    slow_bw=6.25e9,              # 400 Gb/s / 8 tiles
    pod_size=0,
    gemm_eff=0.16,               # out-of-the-box stack, power-capped (paper: ~10 % peak e2e)
    eff_knee_m=512.0,
)

SYSTEMS = {s.name: s for s in (H100_SXM, SMNG_P2)}
