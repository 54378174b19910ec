"""Hardware profile for the port's ``RecipeAdvisor``: a minimal ``System``
(the reference's ``repro.core.systems`` fields that the advisor and a
cost estimate read), and the card the port runs on.

``H100_SXM``: one NVIDIA H100 SXM in an HGX node of 8, joined all to all by
NVLink (NVIDIA's data sheet: 989 TFLOP/s dense bf16, 80 GB of HBM3 at 3.35
TB/s, 900 GB/s of NVLink per card, 450 GB/s each way), 400 Gb/s of
InfiniBand per card between nodes.  The fast domain is the node: 8 cards.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class System:
    name: str
    peak_flops: float            # bf16 FLOP/s per device
    hbm_bytes: float             # device memory capacity
    hbm_bw: float                # device memory bytes/s
    fast_domain: int             # devices sharing the fast interconnect domain
    fast_bw: float               # bytes/s per device, one way, inside the domain
    slow_bw: float               # bytes/s per device crossing domains


H100_SXM = System(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    fast_domain=8,
    fast_bw=450e9,
    slow_bw=50e9,
)

SYSTEMS = {s.name: s for s in (H100_SXM,)}
