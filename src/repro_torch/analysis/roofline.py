"""Three-term roofline of one step on NVIDIA H100s (port of
``repro/analysis/roofline.py``).

    compute term    = dot FLOPs / peak FLOP/s                [s]
    memory term     = least bytes / HBM bytes/s              [s]
    collective term = wire bytes / link bytes/s a card sends [s]

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
term is zero.

``from_cost(cost, target=...)`` takes the link rate from the target
(``TargetSpec.ici_bw``: NVLink's for ``nvidia:h100``, one InfiniBand
port's for the cluster targets, whose model axis crosses nodes) and
fills the reference's report fields (``arch``, ``shape``, ``mesh``,
``chips``, ``model_flops``, ``useful_ratio``, ``roofline_fraction``,
``mfu_bound``, ``collective_breakdown``, ``memory_per_chip``, ``row()``)
with the reference's formulas.  Without them (``from_cost(cost)``) it
is the one card's three terms, as before.
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
    arch: str = ""
    shape: str = ""
    mesh: str = ""
    chips: int = 1
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0       # model_flops / (dot FLOPs * chips)
    roofline_fraction: float = 0.0  # t_compute / t_dominant
    mfu_bound: float = 0.0          # model_flops/chips/peak / t_dominant
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    memory_per_chip: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    def finalize(self):
        self.t_compute = self.hlo_flops / self.peak_flops
        self.t_memory = self.hbm_bytes / self.hbm_bw
        self.t_collective = self.wire_bytes / self.link_bw
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        t_dom = max(terms.values())
        self.roofline_fraction = self.t_compute / t_dom if t_dom else 0.0
        total = self.hlo_flops * self.chips
        self.useful_ratio = self.model_flops / total if total else 0.0
        self.mfu_bound = (self.model_flops / self.chips / self.peak_flops) \
            / t_dom if t_dom else 0.0
        return self

    @property
    def t_bound(self) -> float:
        """The least time of the step: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "model_flops": self.model_flops,
            "hlo_flops_per_chip": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
        }


def from_cost(cost, *, target=None, arch: str = "", shape: str = "",
              mesh: str = "", chips: int = 1, model_flops: float = 0.0,
              memory_per_chip: dict | None = None) -> Roofline:
    """The roofline of a ``cost.StepCost`` (or any record with ``flops``,
    ``hbm_bytes`` and ``wire_bytes``, and optionally a
    ``collective_breakdown``), on ``target``'s per-card rates (default:
    one H100's)."""
    rates = {} if target is None else {
        "peak_flops": target.peak_flops, "hbm_bw": target.hbm_bw,
        "link_bw": target.ici_bw}
    return Roofline(hlo_flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                    wire_bytes=cost.wire_bytes, arch=arch, shape=shape,
                    mesh=mesh, chips=chips, model_flops=model_flops,
                    collective_breakdown=dict(getattr(
                        cost, "collective_breakdown", {}) or {}),
                    memory_per_chip=memory_per_chip or {},
                    **rates).finalize()
