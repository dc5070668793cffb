"""LULESH-analogue: Sedov-blast hydrodynamics proxy (the paper's §4 app),
port of ``repro/models/lulesh.py``.

The paper deploys the DASH/PGAS port of LULESH through EASEY.  Here the
mesh is a structured 3-D grid on one device; the per-zone hot loop is
the hand-written CUDA stencil kernel (``kernels/csrc/sedov_stencil.cu``)
and this module is its plain PyTorch oracle.

Physics (simplified staggered-free Sedov proxy, 6-point stencil):
  p   = (gamma-1)·rho·e                       ideal-gas EOS
  a   = -grad(p+q)/rho ; v += dt·a            momentum
  dv  = div(v)                                volume strain rate
  q   = c_q·rho·dv²  where dv<0 else 0        artificial viscosity
  e  += -dt·(p+q)·dv/rho ; rho -= dt·rho·dv   energy / mass
  dt  = CFL·min(dx/(c_s+|v|))                 global reduction

FOM is LULESH's: zones × iterations / seconds (higher is better).

A state is a dict of tensors on one device: ``rho`` and ``e`` (n, n, n),
``v`` (3, n, n, n) and the time ``t`` as a 0-d tensor, all f32.  The
state stays on its device across steps: ``dt`` and ``t`` are never read
back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GAMMA = 1.4
C_Q = 2.0
CFL = 0.3


@dataclasses.dataclass(frozen=True)
class LuleshConfig:
    name: str = "lulesh-dash"
    family: str = "stencil"
    grid: int = 48                 # cube side (zones per side)
    iters: int = 10
    dtype: torch.dtype = torch.float32


def init_state(cfg: LuleshConfig, device="cpu") -> dict:
    """Sedov problem: cold uniform gas, energy spike at the corner zone."""
    n = cfg.grid
    rho = torch.ones((n, n, n), dtype=cfg.dtype, device=device)
    e = torch.full((n, n, n), 1e-6, dtype=cfg.dtype, device=device)
    e[0, 0, 0] = 3.948746e7        # LULESH's initial energy deposition
    v = torch.zeros((3, n, n, n), dtype=cfg.dtype, device=device)
    return {"rho": rho, "e": e, "v": v,
            "t": torch.zeros((), dtype=cfg.dtype, device=device)}


def state_from_numpy(arrays: dict, device="cpu") -> dict:
    """A state from numpy arrays (e.g. the reference's), bit for bit."""
    return {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
            for k in ("rho", "e", "v", "t")}


def state_to_numpy(state: dict) -> dict:
    return {k: state[k].detach().cpu().numpy() for k in ("rho", "e", "v", "t")}


def _shift(f: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """Neighbor value along axis with reflective (edge-clamped) boundary."""
    n = f.shape[axis]
    if d > 0:
        return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                         dim=axis)
    return torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                     dim=axis)


def _grad(f: torch.Tensor, dx: float) -> torch.Tensor:
    return torch.stack([(_shift(f, a, +1) - _shift(f, a, -1)) / (2 * dx)
                        for a in range(3)])


def _div(v: torch.Tensor, dx: float) -> torch.Tensor:
    out = None
    for a in range(3):
        g = (_shift(v[a], a, +1) - _shift(v[a], a, -1)) / (2 * dx)
        out = g if out is None else out + g
    return out


def cfl_dt(state: dict, *, dx: float = 1.0) -> torch.Tensor:
    """Global CFL reduction (the step's only collective on a real mesh),
    as a 0-d tensor on the state's device: never read back to the host."""
    rho, e, v = state["rho"], state["e"], state["v"]
    p = (GAMMA - 1.0) * rho * e
    cs = torch.sqrt(GAMMA * p / torch.clamp_min(rho, 1e-12))
    vmag = torch.sqrt((v * v).sum(0))
    return CFL * dx / torch.max(cs + vmag + 1e-12)


def step(state: dict, cfg: LuleshConfig, mesh=None, dx: float = 1.0) -> dict:
    """One explicit hydro step: the plain oracle of the fused kernel.  One
    device only, so the reference's sharding constraints are the
    identity."""
    if mesh is not None:
        raise NotImplementedError("multi-device meshes are not ported yet "
                                  "(ROADMAP slice G)")
    rho, e, v = state["rho"], state["e"], state["v"]

    p = (GAMMA - 1.0) * rho * e
    dv = _div(v, dx)
    q = torch.where(dv < 0, C_Q * rho * dv * dv,
                    torch.zeros((), dtype=p.dtype, device=p.device))

    dt = cfl_dt(state, dx=dx)     # an all-reduce on a mesh; on the device
    g = _grad(p + q, dx)
    v = v - dt * g / torch.clamp_min(rho, 1e-12)[None]
    dv = _div(v, dx)
    e = e - dt * (p + q) * dv / torch.clamp_min(rho, 1e-12)
    e = torch.clamp_min(e, 0.0)
    rho = torch.clamp_min(rho * (1.0 - dt * dv), 1e-12)
    return {"rho": rho, "e": e, "v": v, "t": state["t"] + dt}


def run(state: dict, cfg: LuleshConfig, iters: int, mesh=None,
        use_kernel: bool = False) -> dict:
    """``iters`` steps (the '-i' flag of the paper's Listing 1.5): the
    fused kernel step (``kernels.ops.sedov_step_kernel``) or the plain
    oracle step."""
    if use_kernel:
        from repro_torch.kernels.ops import sedov_step_kernel
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet (ROADMAP slice G)")

        def step_fn(s):
            return sedov_step_kernel(s, cfg)
    else:
        def step_fn(s):
            return step(s, cfg, mesh)
    for _ in range(iters):
        state = step_fn(state)
    return state


def fom(zones: int, iters: int, seconds: float) -> float:
    """LULESH figure-of-merit: zone-iterations per second."""
    return zones * iters / max(seconds, 1e-12)
