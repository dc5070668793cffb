"""Public kernel entry points of the port, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises on anything
it does not take); a CPU tensor goes to the kernel's plain PyTorch
version in ``kernels/ref.py``.  There is no other fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.sedov_stencil import sedov_step_cuda


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    kv_len: torch.Tensor) -> torch.Tensor:
    """Paged single-token decode attention (see kernels/paged_attention.py).

    q: (slots, H, dh); k_pages/v_pages: (num_pages, page_size, K, dh);
    page_table: (slots, max_pages) int32; kv_len: (slots,) int32.
    """
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_table, kv_len)
    _check_cpu(q)
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table, kv_len)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row-wise RMSNorm over the last axis, output in ``out_dtype``
    (default: x's dtype; see kernels/rmsnorm.py)."""
    if x.is_cuda:
        return rmsnorm_cuda(x, w, eps=eps, out_dtype=out_dtype)
    _check_cpu(x)
    return ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype)


def sedov_step_kernel(state: dict, cfg=None, *, dx: float = 1.0) -> dict:
    """Fused LULESH step: the global CFL reduction (plain PyTorch, on the
    state's device) and the stencil update given that ``dt`` (see
    kernels/sedov_stencil.py).  ``cfg`` is accepted for the reference's
    signature; the grid comes from the state."""
    dt = ref.cfl_dt(state, dx=dx)
    if state["rho"].is_cuda:
        return sedov_step_cuda(state, dt, dx=dx)
    _check_cpu(state["rho"])
    return ref.sedov_step_ref(state, dt, dx=dx)


def _check_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no kernel and no plain path for device {t.device}")
