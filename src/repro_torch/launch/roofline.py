"""Three-term roofline model of a dry-run record (port of
:mod:`repro.launch.roofline`), with NVIDIA H100 SXM constants in place of
TPU v5e's.

H100 SXM constants (per card; NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit):
  peak bf16 tensor-core compute: 989 TFLOP/s
  HBM3 bandwidth:                3.35 TB/s
  link:                          50 GB/s, one 400 Gb/s ConnectX-7 NIC a card
                                 (DGX H100): the inter-host link that a
                                 16-wide mesh axis crosses.  NVLink inside
                                 a host moves 450 GB/s each way a card, but
                                 a host holds 8 cards, so a 16-wide axis
                                 runs at the NIC's rate.

  compute term    = flops / peak          (flops per device)
  memory term     = bytes / hbm_bw        (bytes per device)
  collective term = collective_bytes / link_bw

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load, so a share of a roofline measured on a card is printed
with the card's name and power limit.  ``model_flops`` (6·N·D to train,
2·N·D to serve, N active for MoE) gives the useful-fraction check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 / card, dense (H100 SXM data sheet)
HBM_BW = 3.35e12             # B/s / card (H100 SXM, HBM3)
LINK_BW = 50e9               # B/s / card: 400 Gb/s ConnectX-7 (DGX H100)
HBM_BYTES = 80e9             # device memory / card (H100 80GB)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per-device FLOPs
    hlo_bytes: float          # per-device HBM traffic
    collective_bytes: float   # per-device link traffic
    model_flops: float        # 6*N(active)*tokens, global
    peak_bytes_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (chips * flops per device): how much of the counted
        compute is model math (catches remat and redundant compute)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilisation at the roofline step time."""
        t = self.step_time
        return self.model_flops / (self.chips * PEAK_FLOPS * t) if t > 0 else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_fraction": round(self.useful_fraction, 4),
            "mfu_at_roofline": round(self.mfu, 4),
            "peak_bytes_per_device": self.peak_bytes_per_device,
        }


def model_flops(n_active_params: int, tokens: int, phase: str) -> float:
    """6ND for training (fwd+bwd), 2ND for inference fwd."""
    mult = 6.0 if phase == "train" else 2.0
    return mult * n_active_params * tokens
