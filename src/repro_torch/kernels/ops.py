"""Public kernel entry points of the port, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises on anything
it does not take); a CPU tensor goes to the kernel's plain PyTorch
version in ``kernels/ref.py``, and so does a ``meta`` tensor (a dry
run's trace, which computes nothing).  There is no other fallback.

The RMSNorm entries are differentiable: under grad mode, with an input
that requires grad, they run through a ``torch.autograd.Function``
whose forward is the same dispatch (the kernel on the card) and whose
backward is the plain ``ref.rmsnorm_bwd_ref`` / ``add_rmsnorm_bwd_ref``
on every device.  Otherwise (serving) they call the forward directly:
``Function.apply`` costs host time on each of a decode tick's norms.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
from repro_torch.kernels.sedov_stencil import sedov_step_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    kv_len: int | None = None) -> torch.Tensor:
    """Blockwise GQA attention (see kernels/flash_attention.py), with the
    reference op's signature and checks.  q: (b, s, H, dh); k/v:
    (b, t, K, dh).  ``block_q = min(block_q, s)`` must divide s and
    ``block_k = min(block_k, t)`` must divide t, and ``0 <= kv_len <= t``
    (AssertionError otherwise, as the reference); the blocks only select
    these checks and do not change the result."""
    s, t = q.shape[1], k.shape[1]
    block_q, block_k = min(block_q, s), min(block_k, t)
    assert s % block_q == 0 and t % block_k == 0, (s, t, block_q, block_k)
    assert kv_len is None or 0 <= kv_len <= t, (kv_len, t)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
    _check_cpu(q)
    return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    kv_len: torch.Tensor, kv0: int = 0,
                    kv_heads: int | None = None) -> torch.Tensor:
    """Paged single-token decode attention (see kernels/paged_attention.py).

    q: (slots, H, dh); k_pages/v_pages: (num_pages, page_size, Kp, dh), of
    whose kv heads ``kv_heads`` (default all) from ``kv0`` on are read;
    page_table: (slots, max_pages) int32; kv_len: (slots,) int32.
    """
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_table, kv_len,
                                    kv0, kv_heads)
    _check_cpu(q)
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table, kv_len,
                                   kv0, kv_heads)


def _rmsnorm_fwd(x, w, eps, out_dtype):
    if x.is_cuda:
        return rmsnorm_cuda(x, w, eps=eps, out_dtype=out_dtype)
    _check_cpu(x)
    return ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype)


def _add_rmsnorm_fwd(x, a, w, eps, norm_of_rounded):
    if x.is_cuda:
        return add_rmsnorm_cuda(x, a, w, eps=eps,
                                norm_of_rounded=norm_of_rounded)
    _check_cpu(x)
    return ref.add_rmsnorm_ref(x, a, w, eps=eps,
                               norm_of_rounded=norm_of_rounded)


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with a gradient: saves x and w only."""

    @staticmethod
    def forward(ctx, x, w, eps, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx, dw = ref.rmsnorm_bwd_ref(x, w, gy, eps=ctx.eps)
        return dx, dw, None, None


class _AddRMSNorm(torch.autograd.Function):
    """``add_rmsnorm`` with a gradient: saves x, a and w only.  The
    kernel's r and y are two views of one allocation; autograd takes
    them as two outputs of this node (nothing writes to them in place)."""

    @staticmethod
    def forward(ctx, x, a, w, eps, norm_of_rounded):
        ctx.save_for_backward(x, a, w)
        ctx.eps, ctx.norm_of_rounded = eps, norm_of_rounded
        ctx.set_materialize_grads(False)
        return _add_rmsnorm_fwd(x, a, w, eps, norm_of_rounded)

    @staticmethod
    def backward(ctx, gr, gy):
        x, a, w = ctx.saved_tensors
        if gy is None:
            return gr, gr, None, None, None
        d, dw = ref.add_rmsnorm_bwd_ref(x, a, w, gr, gy, eps=ctx.eps,
                                        norm_of_rounded=ctx.norm_of_rounded)
        return d, d, dw, None, None


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row-wise RMSNorm over the last axis, output in ``out_dtype``
    (default: x's dtype; see kernels/rmsnorm.py)."""
    if _wants_grad(x, w):
        return _RMSNorm.apply(x, w, eps, out_dtype)
    return _rmsnorm_fwd(x, w, eps, out_dtype)


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6, *, norm_of_rounded: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + a`` fused into the RMSNorm of the sum:
    ``(r, y)``, the sum rounded to x's dtype and the norm of the f32 sum
    (``norm_of_rounded=False``) or of r (True); see kernels/rmsnorm.py."""
    if _wants_grad(x, a, w):
        return _AddRMSNorm.apply(x, a, w, eps, norm_of_rounded)
    return _add_rmsnorm_fwd(x, a, w, eps, norm_of_rounded)


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
    """The plain versions run on the CPU, and on ``meta`` tensors, which
    hold shapes only: a dry run's trace (``analysis/cost.trace``) counts
    a kernel's work through its plain version's operations."""
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel and no plain path for device {t.device}")
