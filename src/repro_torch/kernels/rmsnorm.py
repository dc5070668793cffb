"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), the port of
the Pallas kernel ``repro/kernels/rmsnorm.py:rmsnorm_pallas``.

One block per row: an f32 sum of squares, ``rsqrt(ms + eps)``, a multiply
by the weight in f32 and one rounding to bf16.  Its plain version is
``ref.rmsnorm_ref``; ``ops.rmsnorm`` picks between the two by the
tensor's device.  This wrapper takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    """The built library, its C signature declared once."""
    lib = _build.load("rmsnorm")
    lib.rmsnorm_launch.argtypes = [_P, _I, _P, _P, _I, _I, ctypes.c_float, _P]
    lib.rmsnorm_launch.restype = _I
    return lib


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
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm_cuda takes 16-byte aligned tensors")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    rows = x.numel() // d if d else 0
    rc = _lib().rmsnorm_launch(x.data_ptr(), int(x.dtype == torch.float32),
                               w.data_ptr(), out.data_ptr(), rows, d, eps,
                               _build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
