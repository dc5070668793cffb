"""Three-term roofline of one step on one NVIDIA H100 (port of
``repro/analysis/roofline.py``).

    compute term    = dot FLOPs / peak FLOP/s           [s]
    memory term     = least bytes / HBM bytes/s         [s]
    collective term = wire bytes / NVLink bytes/s       [s]

The step's dot FLOPs, least bytes and wire bytes come from
``analysis/cost.py`` (the counterpart of the reference's HLO parse),
per device.  The constants are NVIDIA's data-sheet figures for the H100
SXM part (80 GB HBM3) at its full power limit of 700 W, dense rates
without sparsity: 989 TFLOP/s of bf16 on the tensor cores, 3.35 TB/s of
HBM, and 900 GB/s of NVLink (both directions together; a ring moves a
device's wire bytes out at half of it).  A card set below 700 W (as
``nvidia-smi --query-gpu=name,power.limit`` reports) runs slower under
load, so a share of this bound is stated beside the card's name and
power limit.  On one card a step moves no wire bytes: the collective
term is zero.  Only the three terms, the bound and its bottleneck are
kept; the reference's report fields (``row``, ``useful_ratio``,
``mfu_bound``, memory per chip) wait for a dry run that prints them.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM 80 GB, data sheet, 700 W
PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 900e9 / 2        # bytes/s a device sends (900 GB/s both ways)


@dataclasses.dataclass
class Roofline:
    hlo_flops: float
    hbm_bytes: float
    wire_bytes: float
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""

    def finalize(self):
        self.t_compute = self.hlo_flops / PEAK_FLOPS
        self.t_memory = self.hbm_bytes / HBM_BW
        self.t_collective = self.wire_bytes / NVLINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        return self

    @property
    def t_bound(self) -> float:
        """The least time of the step: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def from_cost(cost) -> Roofline:
    """The roofline of a ``cost.StepCost`` (or any record with ``flops``,
    ``hbm_bytes`` and ``wire_bytes``)."""
    return Roofline(hlo_flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                    wire_bytes=cost.wire_bytes).finalize()
