"""LULESH-analogue: Sedov-blast hydrodynamics proxy (the paper's §4 app),
port of ``repro/models/lulesh.py``.

The paper deploys the DASH/PGAS port of LULESH through EASEY.  Here the
mesh is a structured 3-D grid; the per-zone hot loop is the hand-written
CUDA stencil kernel (``kernels/csrc/sedov_stencil.cu``) on one device,
and this module is its plain PyTorch oracle.

On a mesh of ranks (``launch.mesh``) the fields are split as the
sharding rules split them, ``grid_x`` over ``data`` and ``grid_y`` over
``model``, each rank holding one block, as DASH splits them across
units.  The plain step runs on the block: where a shift crosses a split
axis it reads the neighbour's face plane, sent by a halo exchange (the
6-point stencil needs faces only; three exchanges a step, for ``v``,
``p + q`` and the new ``v``), a block on the domain's edge keeps the
clamp to its own edge plane, and ``dt``'s max is all-reduced over the
mesh.  Every zone sees the operations of one device in the same order,
so the result is one device's bit for bit.  The fused kernel steps the
global grid, as in the reference: on a mesh of ranks each rank gathers
the fields whole, steps the whole grid with the kernel and keeps its
block (``run``).

Physics (simplified staggered-free Sedov proxy, 6-point stencil):
  p   = (gamma-1)·rho·e                       ideal-gas EOS
  a   = -grad(p+q)/rho ; v += dt·a            momentum
  dv  = div(v)                                volume strain rate
  q   = c_q·rho·dv²  where dv<0 else 0        artificial viscosity
  e  += -dt·(p+q)·dv/rho ; rho -= dt·rho·dv   energy / mass
  dt  = CFL·min(dx/(c_s+|v|))                 global reduction

FOM is LULESH's: zones × iterations / seconds (higher is better).

A state is a dict of tensors on one device: ``rho`` and ``e`` (n, n, n),
``v`` (3, n, n, n) and the time ``t`` as a 0-d tensor, all f32; on a
mesh, DTensors of those (``t`` replicated).  The state stays on its
device across steps: ``dt`` and ``t`` are never read back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sharding.rules import (DEFAULT_RULES, PartitionSpec,
                                        local_slices, logical_to_spec,
                                        placements, shard_constraint)

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


def _device(device) -> torch.device:
    """The card unless the caller names a device (``device="cpu"``); raises
    where there is no card and none is named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: LULESH states live on the "
                               "GPU; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def init_state(cfg: LuleshConfig, device=None) -> dict:
    """Sedov problem: cold uniform gas, energy spike at the corner zone.
    ``device=None`` is the card."""
    device = _device(device)
    n = cfg.grid
    rho = torch.ones((n, n, n), dtype=cfg.dtype, device=device)
    e = torch.full((n, n, n), 1e-6, dtype=cfg.dtype, device=device)
    e[0, 0, 0] = 3.948746e7        # LULESH's initial energy deposition
    v = torch.zeros((3, n, n, n), dtype=cfg.dtype, device=device)
    return {"rho": rho, "e": e, "v": v,
            "t": torch.zeros((), dtype=cfg.dtype, device=device)}


def state_from_numpy(arrays: dict, device=None) -> dict:
    """A state from numpy arrays (e.g. the reference's), bit for bit, on
    ``device`` (None: the card)."""
    device = _device(device)
    return {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
            for k in ("rho", "e", "v", "t")}


def state_to_numpy(state: dict) -> dict:
    """The whole state as numpy arrays (a mesh's fields gathered)."""
    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x
    return {k: whole(state[k]).detach().cpu().numpy()
            for k in ("rho", "e", "v", "t")}


FIELD_AXES = ("act_grid_x", "act_grid_y", "act_grid_z")


def _shift(f: torch.Tensor, axis: int, d: int, halo=None) -> torch.Tensor:
    """Neighbor value along axis with reflective (edge-clamped) boundary;
    ``halo`` maps ``(axis, d)`` to the neighbouring block's face plane
    where the axis is split and a neighbour lies that way."""
    n = f.shape[axis]
    face = None if halo is None else halo.get((axis, d))
    if d > 0:
        return torch.cat([f.narrow(axis, 1, n - 1),
                          f.narrow(axis, n - 1, 1) if face is None else face],
                         dim=axis)
    return torch.cat([f.narrow(axis, 0, 1) if face is None else face,
                      f.narrow(axis, 0, n - 1)], dim=axis)


def _grad(f: torch.Tensor, dx: float, halo=None) -> torch.Tensor:
    return torch.stack([(_shift(f, a, +1, halo) - _shift(f, a, -1, halo))
                        / (2 * dx) for a in range(3)])


def _div(v: torch.Tensor, dx: float, halos=(None,) * 3) -> torch.Tensor:
    """div(v); ``halos[a]``: the faces of ``v[a]`` along axis a."""
    out = None
    for a in range(3):
        g = (_shift(v[a], a, +1, halos[a]) - _shift(v[a], a, -1, halos[a])) \
            / (2 * dx)
        out = g if out is None else out + g
    return out


def _cfl_max(rho, e, v) -> torch.Tensor:
    p = (GAMMA - 1.0) * rho * e
    cs = torch.sqrt(GAMMA * p / torch.clamp_min(rho, 1e-12))
    vmag = torch.sqrt((v * v).sum(0))
    return torch.max(cs + vmag + 1e-12)


def cfl_dt(state: dict, *, dx: float = 1.0) -> torch.Tensor:
    """Global CFL reduction (the step's only collective on a real mesh),
    as a 0-d tensor on the state's device: never read back to the host."""
    return CFL * dx / _cfl_max(state["rho"], state["e"], state["v"])


def _hydro(rho, e, v, t, dx, dt_of, halos) -> dict:
    """The step's arithmetic on a block (the whole grid on one device);
    ``dt_of(max)`` turns the block's CFL max into ``dt``; ``halos(pairs)``
    gives, for each (field, axis) pair, the neighbours' face planes that
    ``_shift`` reads (none on one device)."""
    p = (GAMMA - 1.0) * rho * e
    dv = _div(v, dx, halos([(v[a], a) for a in range(3)]))
    q = torch.where(dv < 0, C_Q * rho * dv * dv,
                    torch.zeros((), dtype=p.dtype, device=p.device))

    dt = dt_of(_cfl_max(rho, e, v))     # on the device, never read back
    pq = p + q
    g = _grad(pq, dx, {k: f for h in halos([(pq, a) for a in range(3)])
                       for k, f in h.items()})
    v = v - dt * g / torch.clamp_min(rho, 1e-12)[None]
    dv = _div(v, dx, halos([(v[a], a) for a in range(3)]))
    e = e - dt * pq * dv / torch.clamp_min(rho, 1e-12)
    e = torch.clamp_min(e, 0.0)
    rho = torch.clamp_min(rho * (1.0 - dt * dv), 1e-12)
    return {"rho": rho, "e": e, "v": v, "t": t + dt}


class _Blocks:
    """A mesh's split of the grid: the mesh dimension and the two
    neighbours' global ranks (None past the domain's edge) of each field
    axis, and the halo exchange."""

    def __init__(self, mesh, n: int):
        self.mesh, self.dm = mesh, mesh.device_mesh
        self.spec = logical_to_spec(FIELD_AXES, (n,) * 3, mesh, DEFAULT_RULES)
        self.coord = self.dm.get_coordinate()
        if self.coord is None:
            raise ValueError("this rank is not on the mesh")
        names = tuple(mesh.axis_names)
        self.nbrs = {}
        for a, entry in enumerate(self.spec):
            if isinstance(entry, tuple):
                raise NotImplementedError(f"grid axis {a} split over several "
                                          f"mesh axes {entry}")
            if entry is None or self.dm.size(names.index(entry)) == 1:
                continue
            m = names.index(entry)
            ranks = []
            for d in (-1, +1):
                c = list(self.coord)
                c[m] += d
                inside = 0 <= c[m] < self.dm.size(m)
                ranks.append(int(self.dm.mesh[tuple(c)]) if inside else None)
            self.nbrs[a] = ranks

    def local(self, x, extra: int = 0) -> torch.Tensor:
        """This rank's block of a field (a DTensor on the mesh, or the
        whole field every rank holds); ``extra`` leading unsplit axes."""
        axes = (None,) * extra + FIELD_AXES
        if hasattr(x, "to_local"):
            return shard_constraint(x, axes, self.mesh).to_local()
        spec = PartitionSpec(*((None,) * extra + tuple(self.spec)))
        return x[local_slices(spec, x.shape, self.mesh, self.coord)]

    def wrap(self, x: torch.Tensor, extra: int = 0):
        """A block as the DTensor of the whole field (``t``: replicated)."""
        from torch.distributed.tensor import DTensor, Replicate
        if x.dim() == 0:
            pl = [Replicate()] * self.dm.ndim
        else:
            pl = placements(PartitionSpec(*((None,) * extra
                                            + tuple(self.spec))), self.mesh)
        return DTensor.from_local(x, self.dm, pl, run_check=False)

    def halos(self, pairs) -> list[dict]:
        """One halo exchange: for each (field, axis) pair, the neighbours'
        face planes of the field along the axis where it is split, keyed
        ``(axis, d)`` as ``_shift`` reads them.  Each block sends its
        first plane back and its last plane forward, all pairs' sends and
        receives in one batch (tag: the axis and the way the plane
        travels)."""
        import torch.distributed as dist
        ops, out = [], []
        for f, a in pairs:
            faces = {}
            out.append(faces)
            if a not in self.nbrs:
                continue
            n = f.shape[a]
            for d, peer in zip((-1, +1), self.nbrs[a]):
                if peer is None:
                    continue
                mine = f.narrow(a, 0 if d < 0 else n - 1, 1).contiguous()
                faces[a, d] = torch.empty_like(mine)
                ops += [dist.P2POp(dist.isend, mine, peer,
                                   tag=2 * a + (d > 0)),
                        dist.P2POp(dist.irecv, faces[a, d], peer,
                                   tag=2 * a + (d < 0))]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def dt_of(self, m: torch.Tensor, dx: float) -> torch.Tensor:
        """``dt`` from the block's CFL max, all-reduced (MAX) over every
        mesh dimension (max is order-free, so the bits are one device's)."""
        import torch.distributed as dist
        m = m.clone()
        for i in range(self.dm.ndim):
            dist.all_reduce(m, op=dist.ReduceOp.MAX,
                            group=self.dm.get_group(i))
        return CFL * dx / m


def _mesh_step(state: dict, mesh, dx: float) -> dict:
    blocks = _Blocks(mesh, state["rho"].shape[0])
    t = state["t"]
    t = t.to_local() if hasattr(t, "to_local") else t
    out = _hydro(blocks.local(state["rho"]), blocks.local(state["e"]),
                 blocks.local(state["v"], extra=1), t, dx,
                 lambda m: blocks.dt_of(m, dx), blocks.halos)
    return {k: blocks.wrap(x, extra=int(k == "v")) for k, x in out.items()}


def _on_mesh(mesh) -> bool:
    """Whether a step runs on ``mesh``'s ranks (False: on one device);
    raises for a mesh of several devices with no ranks behind it."""
    if mesh is None or mesh.device_mesh is None and mesh.size == 1:
        return False
    if mesh.device_mesh is None:
        raise RuntimeError(f"mesh {mesh.shape} over {mesh.axis_names} has "
                           f"no ranks: build it with launch.mesh in each of "
                           f"{mesh.size} processes of a process group")
    return True


def step(state: dict, cfg: LuleshConfig, mesh=None, dx: float = 1.0) -> dict:
    """One explicit hydro step: the plain oracle of the fused kernel.  On a
    mesh of ranks (``launch.mesh.Mesh``), each rank steps its block with
    halo exchanges and returns the state as DTensors; off-mesh or on a
    one-device mesh, the whole grid on one device."""
    if _on_mesh(mesh):
        return _mesh_step(state, mesh, dx)

    def no_halo(pairs):
        return [{} for _ in pairs]
    return _hydro(state["rho"], state["e"], state["v"], state["t"], dx,
                  lambda m: CFL * dx / m, no_halo)


def run(state: dict, cfg: LuleshConfig, iters: int, mesh=None,
        use_kernel: bool = False) -> dict:
    """``iters`` steps (the '-i' flag of the paper's Listing 1.5): the
    fused kernel step (``kernels.ops.sedov_step_kernel``) or the plain
    oracle step, on ``mesh``'s ranks where it has several.  The kernel
    steps the global grid, as the reference's does whatever the mesh: on
    a mesh of ranks each rank gathers the fields whole, runs the
    kernel's steps on the whole grid (``cfl_dt``'s global max,
    then the fused step) and keeps its own block at rest, so every rank
    holds one device's kernel run, bit for bit."""
    if use_kernel:
        from repro_torch.kernels.ops import sedov_step_kernel
        if _on_mesh(mesh):
            return _kernel_on_mesh(state, cfg, iters, mesh)
        for _ in range(iters):
            state = sedov_step_kernel(state, cfg)
        return state
    for _ in range(iters):
        state = step(state, cfg, mesh)
    return state


def _kernel_on_mesh(state: dict, cfg: LuleshConfig, iters: int,
                    mesh) -> dict:
    """``run``'s kernel steps on a mesh of ranks: the fields gathered
    whole once, ``iters`` kernel steps on the whole grid (every rank
    computes the same), each rank's block kept at rest under the fields'
    specs (``t`` replicated)."""
    from repro_torch.kernels.ops import sedov_step_kernel
    blocks = _Blocks(mesh, state["rho"].shape[0])
    # each rank's block all-gathered (a plain tensor is whole already)
    whole = {k: x.full_tensor() if hasattr(x, "full_tensor") else x
             for k, x in state.items()}
    for _ in range(iters):
        whole = sedov_step_kernel(whole, cfg)
    return {k: blocks.wrap(x if k == "t" else
                           blocks.local(x, extra=int(k == "v")).contiguous(),
                           extra=int(k == "v"))
            for k, x in whole.items()}


def fom(zones: int, iters: int, seconds: float) -> float:
    """LULESH figure-of-merit: zone-iterations per second."""
    return zones * iters / max(seconds, 1e-12)
