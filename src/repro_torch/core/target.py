"""TargetSpec registry (port of ``repro/core/target.py``).

A TargetSpec carries what the tuner needs: the chip's roofline
constants, device-memory capacity, mesh, scheduler dialect, and which
kernel library the target runs (``"cuda"`` for the hand-written Hopper
kernels, ``"reference"`` for the plain PyTorch versions).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    name: str
    chip: str                       # h100 | cpu
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    peak_flops: float               # per chip, bf16
    hbm_bw: float                   # bytes/s per chip
    hbm_bytes: float                # capacity per chip
    ici_bw: float                   # bytes/s per link
    scheduler: str = "slurm"        # slurm | pbs | local
    kernels: str = "cuda"           # cuda | reference
    # shared memory one thread block may use: the static budget the
    # hand-written kernels size their tiles against (replaces the
    # reference's per-core VMEM figure)
    smem_bytes: int = 232_448
    description: str = ""

    @property
    def num_chips(self) -> int:
        return math.prod(self.mesh_shape)


TARGETS: dict[str, TargetSpec] = {}


def register(t: TargetSpec) -> TargetSpec:
    TARGETS[t.name] = t
    return t


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB, NVLink 450 GB/s each way, 227 KB (232,448 B) shared memory per
# block.  Rated at the full 700 W power limit.
register(TargetSpec(
    name="nvidia:h100", chip="h100",
    mesh_shape=(1,), mesh_axes=("data",),
    peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9, ici_bw=450e9,
    scheduler="local", kernels="cuda", smem_bytes=232_448,
    description="one NVIDIA H100 SXM (sm_90a), hand-written CUDA kernels"))

# The counterparts of the reference's two TPU pods: H100 SXM cards in
# HGX/DGX H100 nodes of 8, the reference's mesh shapes and axes, so the
# rules give its specs entry for entry.  Per card, the data sheet's
# figures above.  A card's traffic off its node goes through its one
# 400 Gb/s NDR InfiniBand port (ConnectX-7; DGX H100 data sheet), 50e9
# B/s: the model axis of 16 spans two nodes, so its ring crosses
# InfiniBand, not NVLink.  No machine here holds their ranks: building on
# them gives a description (the dry run reads it), and a step on one
# raises "no ranks".
_H100_CLUSTER = dict(chip="h100", peak_flops=989e12, hbm_bw=3.35e12,
                     hbm_bytes=80e9, ici_bw=50e9, scheduler="slurm",
                     kernels="cuda", smem_bytes=232_448)

register(TargetSpec(
    name="nvidia:h100x256", mesh_shape=(16, 16), mesh_axes=("data", "model"),
    description="256 H100 SXM cards, 32 nodes of 8, 16x16 (data, model)",
    **_H100_CLUSTER))

register(TargetSpec(
    name="nvidia:h100x512", mesh_shape=(2, 16, 16),
    mesh_axes=("pod", "data", "model"),
    description="512 H100 SXM cards, two 256-card pods, pod axis is pure "
                "data parallel", **_H100_CLUSTER))

register(TargetSpec(
    name="local:cpu", chip="cpu",
    mesh_shape=(1,), mesh_axes=("data",),
    peak_flops=5e10, hbm_bw=2e10, hbm_bytes=8e9, ici_bw=1e9,
    scheduler="local", kernels="reference",
    description="single-process CPU debug target (smoke tests, examples)"))

# one CPU process per device, over gloo (the reference forces 8 host
# devices into one process instead)
register(TargetSpec(
    name="local:cpu-mesh8", chip="cpu",
    mesh_shape=(2, 4), mesh_axes=("data", "model"),
    peak_flops=5e10, hbm_bw=2e10, hbm_bytes=8e9, ici_bw=1e9,
    scheduler="local", kernels="reference",
    description="8 CPU ranks over gloo — integration tests of the SPMD "
                "path"))


def get_target(name: str) -> TargetSpec:
    if name not in TARGETS:
        raise KeyError(f"unknown target {name!r}; known: {sorted(TARGETS)}")
    return TARGETS[name]


def resolve_device(device) -> torch.device:
    """CUDA unless the caller asks for the CPU; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def default_target(device: torch.device) -> str:
    """The target a device runs when the caller names none: the H100 (its
    hand-written kernels) for CUDA, the CPU debug target otherwise."""
    return "nvidia:h100" if device.type == "cuda" else "local:cpu"


def device_for(target: TargetSpec) -> torch.device:
    """The device a target's deployment runs on: the CPU for the CPU
    target, the card otherwise."""
    return torch.device("cpu" if target.chip == "cpu" else "cuda")
