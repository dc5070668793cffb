"""Wrappers of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), the port of
the Pallas kernel ``repro/kernels/rmsnorm.py:rmsnorm_pallas``.

Two entries of one kernel.  ``rmsnorm_cuda(x, w)`` normalizes the rows of
x (bf16, or f32): an f32 sum of squares, ``rsqrt(ms + eps)``, a multiply
by the weight in f32 and one rounding to bf16.  ``add_rmsnorm_cuda(x, a,
w, norm_of_rounded=...)`` takes the model's residual add into the same
pass: it returns the new residual stream ``r = bf16(x + a)`` and the norm
of the f32 sum (``norm_of_rounded=False``) or of r (True), so a layer's
residual adds and norms are two launches where they were seven.  The
plain versions are ``ref.rmsnorm_ref`` and ``ref.add_rmsnorm_ref``;
``ops.rmsnorm`` and ``ops.add_rmsnorm`` pick by the tensors' device.
These wrappers take CUDA tensors only.

One CTA takes a row, its block size and vectors per thread picked from
d alone (``plan``).  The decode tick is bound by the host, so the
wrappers do little per call: one allocation for both outputs, the
stream's raw handle, the checks the kernel needs and the plan from a
cache.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_THREADS = 512              # threads per CTA (128 registers each)
MAX_NV = 8                     # 8-element vectors a thread holds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    """The built library, its C signatures declared once."""
    lib = _build.load("rmsnorm")
    lib.rmsnorm_launch.argtypes = [_P, _I, _P, _P, _I, _I, _F, _I, _I, _P]
    lib.add_rmsnorm_launch.argtypes = [_P] * 5 + [_I, _I, _F] + [_I] * 3 + \
        [_P]
    for fn in (lib.rmsnorm_launch, lib.add_rmsnorm_launch):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=256)
def plan(d: int) -> tuple[int, int]:
    """(threads, nv) for a row of ``d``: the fewest vectors of 8 elements
    per thread (1, 2, 4, 8) that need at most 512 threads, and the threads
    rounded up to whole warps."""
    vecs = -(-d // 8)
    nv = 1
    while nv < MAX_NV and vecs > MAX_THREADS * nv:
        nv *= 2
    threads = 32 * -(-vecs // (32 * nv))
    if threads > MAX_THREADS:
        raise ValueError(f"d={d} is wider than the kernel takes "
                         f"({MAX_THREADS * MAX_NV * 8})")
    return threads, nv


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: (..., d) bf16 or f32, w: (d,) bf16 -> RMS-normalized x in bf16
    (``out_dtype`` must be bf16 or None for a bf16 x)."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rmsnorm_cuda takes CUDA tensors on one device; "
                         "CPU tensors go to ref.rmsnorm_ref")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            w.dtype != torch.bfloat16 or \
            (out_dtype or x.dtype) != torch.bfloat16:
        raise ValueError(f"kernel takes bf16/f32 x, bf16 w, bf16 out; got "
                         f"{x.dtype}, {w.dtype}, {out_dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or d % 8:
        raise ValueError(f"w {tuple(w.shape)} vs d={d}; kernel takes d % 8 == 0")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda takes contiguous tensors")
    xp, wp = x.data_ptr(), w.data_ptr()
    if (xp | wp) % 16:
        raise ValueError("rmsnorm_cuda takes 16-byte aligned tensors")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    rows = x.numel() // d if d else 0
    rc = _lib().rmsnorm_launch(xp, int(x.dtype == torch.float32), wp,
                               out.data_ptr(), rows, d, eps, *plan(d),
                               _build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


def add_rmsnorm_cuda(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, *,
                     eps: float = 1e-6, norm_of_rounded: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (..., d) bf16, w: (d,) bf16 -> (r, y), both bf16 of x's shape:
    the residual r = bf16(x + a) and the RMSNorm of the f32 sum x + a
    (``norm_of_rounded=False``) or of r (True).  r and y are the two
    halves of one allocation."""
    dev = x.get_device()                        # -1 on the CPU
    if dev < 0 or a.get_device() != dev or w.get_device() != dev:
        raise ValueError("add_rmsnorm_cuda takes CUDA tensors on one device;"
                         " CPU tensors go to ref.add_rmsnorm_ref")
    bf16 = torch.bfloat16
    if not (x.dtype == a.dtype == w.dtype == bf16):
        raise ValueError(f"kernel takes bf16 x, a and w; got {x.dtype}, "
                         f"{a.dtype}, {w.dtype}")
    d = x.shape[-1]
    if a.shape != x.shape or w.shape != (d,) or d % 8:
        raise ValueError(f"x {tuple(x.shape)}, a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}: kernel takes x and a of one "
                         f"shape, w (d,), d % 8 == 0")
    if not (x.is_contiguous() and a.is_contiguous() and w.is_contiguous()):
        raise ValueError("add_rmsnorm_cuda takes contiguous tensors")
    xp, ap, wp = x.data_ptr(), a.data_ptr(), w.data_ptr()
    if (xp | ap | wp) % 16:
        raise ValueError("add_rmsnorm_cuda takes 16-byte aligned tensors")
    out = torch.empty((2,) + x.shape, dtype=bf16, device=dev)
    rows = x.numel() // d
    rp = out.data_ptr()
    rc = _lib().add_rmsnorm_launch(xp, ap, wp, rp, rp + 2 * rows * d, rows,
                                   d, eps, int(norm_of_rounded), *plan(d),
                                   _build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"add_rmsnorm kernel launch failed: CUDA error "
                           f"{rc}")
    add_rmsnorm_cuda.launches += 1
    return out.unbind(0)


add_rmsnorm_cuda.launches = 0

