"""Wrapper of the CUDA Sedov stencil kernel (``csrc/sedov_stencil.cu``),
the port of the Pallas kernel
``repro/kernels/sedov_stencil.py:sedov_step_pallas``.

One launch is one fused LULESH step for a given ``dt``: EOS, divergence,
viscosity, momentum, re-divergence, energy and mass, edge-clamped at the
domain boundary, and ``t + dt``.  The kernel marches along axis 0: each
block owns a 16 x 32 tile of axes (1, 2) and a chunk of 64 planes,
streams the input planes into a shared-memory ring and computes pq, v_n
and the outputs one plane behind each other, so each input zone is
loaded once per block.  ``dt`` (from ``ref.cfl_dt``) stays a
device scalar: the kernel reads it through a pointer, so a step never
waits for the host.  Its plain version is ``ref.sedov_step_ref``;
``ops.sedov_step_kernel`` picks between the two by the tensors' device.
This wrapper takes CUDA tensors only and raises on anything the kernel
does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
# grid side whose 16-row tiles along axis 1 stay within CUDA's 65,535
# blocks on grid dimension y
MAX_GRID = 65_535 * 16


@functools.cache
def _lib():
    """The built library, its C signatures declared once."""
    lib = _build.load("sedov_stencil")
    lib.sedov_stencil_launch.argtypes = [_P] * 9 + [_I, ctypes.c_float, _P]
    lib.sedov_stencil_launch.restype = _I
    return lib


def sedov_step_cuda(state: dict, dt: torch.Tensor, *, dx: float = 1.0) -> dict:
    """One fused Sedov step on the card.  state: ``rho``, ``e`` (n, n, n),
    ``v`` (3, n, n, n), ``t`` () f32 CUDA tensors; dt: () f32 on the same
    device.  Returns the new state (new tensors)."""
    rho, e, v, t = state["rho"], state["e"], state["v"], state["t"]
    tensors = (rho, e, v, t, dt)
    if not all(x.is_cuda and x.device == rho.device for x in tensors):
        raise ValueError("sedov_step_cuda takes CUDA tensors on one device; "
                         "CPU tensors go to ref.sedov_step_ref")
    if not all(x.dtype == torch.float32 for x in tensors):
        raise ValueError(f"kernel takes float32; got "
                         f"{[str(x.dtype) for x in tensors]}")
    n = rho.shape[0] if rho.dim() == 3 else 0
    if not (n >= 1 and rho.shape == e.shape == (n, n, n)
            and v.shape == (3, n, n, n) and t.dim() == 0 and dt.dim() == 0):
        raise ValueError(f"shapes rho {tuple(rho.shape)}, e {tuple(e.shape)},"
                         f" v {tuple(v.shape)}, t {tuple(t.shape)}, dt "
                         f"{tuple(dt.shape)}: want (n,n,n), (n,n,n), "
                         f"(3,n,n,n), (), ()")
    if n > MAX_GRID:
        raise ValueError(f"grid side {n} > {MAX_GRID}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sedov_step_cuda takes contiguous tensors")
    out = {"rho": torch.empty_like(rho), "e": torch.empty_like(e),
           "v": torch.empty_like(v), "t": torch.empty_like(t)}
    rc = _lib().sedov_stencil_launch(
        rho.data_ptr(), e.data_ptr(), v.data_ptr(), dt.data_ptr(),
        t.data_ptr(), out["rho"].data_ptr(), out["e"].data_ptr(),
        out["v"].data_ptr(), out["t"].data_ptr(), n, dx,
        _build.stream_of(rho))
    if rc != 0:
        raise RuntimeError(f"sedov_stencil kernel launch failed: CUDA error "
                           f"{rc}")
    sedov_step_cuda.launches += 1
    return out


sedov_step_cuda.launches = 0
