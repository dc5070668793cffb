"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, with the same rounding
points, on any device.  The CPU path of the port runs on them
(``kernels/ops.py`` dispatches by device), the tests hold the reference
against them, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  ``paged_attention_ref`` is also the engine's gather path
(``kv_kernel="gather"``), taken on the card only when named; nothing on
the main path calls these functions for CUDA tensors.  ``cfl_dt`` is the
exception and no kernel's plain version: the reference computes LULESH's
global CFL reduction outside its stencil kernel, and the port runs the
model's own (``models/lulesh.py``, re-exported here) in plain PyTorch on
every device, leaving ``dt`` on the device.  ``attention_ref`` is the
reference's full-softmax oracle, whose causal mask is aligned otherwise
than the flash kernel's (see its docstring); the flash kernel's plain
version is ``flash_attention_ref``.  ``rmsnorm_bwd_ref`` and
``add_rmsnorm_bwd_ref`` are the RMSNorm kernel's backward on every device
(the reference has no backward kernel: XLA differentiates its norm).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.lulesh import C_Q, GAMMA, _div, _grad, cfl_dt  # noqa: F401


NEG_INF = -1e30          # the flash kernel's mask value


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Plain full-softmax GQA attention in f32 (the reference's
    ``kernels/ref.py:attention_ref``).  q: (b, s, H, dh); k/v:
    (b, t, K, dh).  Output in q's dtype.

    Its causal mask is aligned at the BOTTOM RIGHT (``tril(k=t-s)``: query
    i sees keys j <= i + t - s), while the flash kernel's is aligned at
    the top left (j <= i; ``flash_attention_ref``).  The two agree only
    when ``s == t`` (and the kernel has no ``kv_len``)."""
    b, s, H, dh = q.shape
    t, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(b, s, K, G, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, H, dh).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_len: int | None = None) -> torch.Tensor:
    """What the flash kernel computes, in one pass instead of its online
    one.  q: (b, s, H, dh); k/v: (b, t, K, dh), H % K == 0; f32 math,
    output in q's dtype.

    Scores ``(q . k) * scale`` in f32; key j is valid when ``j < kv_len``
    (default t) and, if causal, ``j <= i`` — aligned at the TOP LEFT, as
    the TPU kernel's ``k_pos <= q_pos``.  Invalid scores become -1e30 and
    their probabilities are zeroed; ``out = (p @ v) / max(sum p, 1e-20)``,
    so a row with no valid key returns exact zeros.  ``attention_ref``
    masks causally at the bottom right instead: the two agree only when
    ``s == t`` and ``kv_len`` is None."""
    b, s, H, dh = q.shape
    t, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(b, s, K, G, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * \
        (1.0 / math.sqrt(dh))
    k_pos = torch.arange(t, device=q.device)
    mask = (k_pos < (t if kv_len is None else kv_len))[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <=
                       torch.arange(s, device=q.device)[:, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, H, dh).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        kv_len: torch.Tensor, kv0: int = 0,
                        kv_heads: int | None = None) -> torch.Tensor:
    """Gather-then-attend single-token decode attention over a page pool.

    q: (slots, H, dh); k/v_pages: (num_pages, page_size, Kp, dh), of whose
    Kp kv heads the ``kv_heads`` (default all) from ``kv0`` on are read;
    page_table: (slots, max_pages) int32; kv_len: (slots,) int32.
    Returns (slots, H, dh) in q's dtype.

    The recipe is ``layers.dot_attention``'s over the gathered KV: f32
    scores with the scale applied after the q.k dot, an f32 max and
    denominator, probabilities normalized and THEN rounded to the value
    dtype before an f32 PV contraction.  Positions routed through the
    junk page 0 or at/after ``kv_len`` get probability exactly 0, so a
    slot with no live page returns exact zeros.
    """
    if kv_heads is not None or kv0:
        stop = kv0 + (k_pages.shape[2] - kv0 if kv_heads is None
                      else kv_heads)
        k_pages, v_pages = k_pages[:, :, kv0:stop], v_pages[:, :, kv0:stop]
    slots, H, dh = q.shape
    _, psize, K, _ = k_pages.shape
    G = H // K
    max_pages = page_table.shape[1]
    t = max_pages * psize
    idx = page_table.long()
    k_all = k_pages[idx].reshape(slots, t, K, dh)
    v_all = v_pages[idx].reshape(slots, t, K, dh)
    qg = q.reshape(slots, K, G, dh).float()
    scores = torch.einsum("skgd,stkd->skgt", qg, k_all.float()) * \
        (1.0 / math.sqrt(dh))
    pos = torch.arange(t, device=q.device)
    live = (page_table != 0).repeat_interleave(psize, dim=1)
    mask = ((pos[None, :] < kv_len[:, None]) & live)[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.where(denom > 0, denom, torch.ones_like(denom)))
    probs = probs.to(v_pages.dtype).float()
    out = torch.einsum("skgt,stkd->skgd", probs, v_all.float())
    return out.reshape(slots, H, dh).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row-wise RMSNorm: f32 mean of x^2, x * rsqrt(ms + eps) * w in f32,
    cast to ``out_dtype`` (default: x's dtype)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(out_dtype or x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, *,
                    eps: float = 1e-6, norm_of_rounded: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + a`` and the RMSNorm of the sum, as the model
    composed them before the fused kernel (the same ops, so the same
    bits): returns ``(r, y)``, r the sum rounded to x's dtype.  With
    ``norm_of_rounded=False`` y is the norm of the unrounded f32 sum
    (``x.float() + a.float()``), cast to x's dtype; with True, of r (the
    add in x's dtype, as ``x + a``)."""
    if norm_of_rounded:
        r = x + a
        return r, rmsnorm_ref(r, w, eps=eps)
    s = x.float() + a.float()
    return s.to(x.dtype), rmsnorm_ref(s, w, eps=eps, out_dtype=x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor, *,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx, dw)`` of ``rmsnorm_ref(x, w)`` for the output
    cotangent ``gy``, as the reference differentiates its norm: f32 math
    (``rsqrt(ms + eps)`` recomputed from x, nothing saved but x and w),
    rsqrt's derivative in its JVP's form ``-0.5 * r / (ms + eps)``, dx
    cast to x's dtype (``layers._match_dgrad_dtype``) and dw summed over
    the rows in f32, cast to w's dtype.  The backward of both devices:
    the kernel has no backward of its own."""
    xf, wf, gf = x.float(), w.float(), gy.float()
    var = (xf * xf).mean(dim=-1, keepdim=True) + eps
    r = torch.rsqrt(var)
    rows = tuple(range(x.dim() - 1))
    dw = (gf * (xf * r)).sum(dim=rows) if rows else gf * (xf * r)
    dyhat = gf * wf
    dvar = (dyhat * xf).sum(dim=-1, keepdim=True) * (-0.5 * (r / var))
    dx = dyhat * r + xf * (dvar * (2.0 / x.shape[-1]))
    return dx.to(x.dtype), dw.to(w.dtype)


def add_rmsnorm_bwd_ref(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                        gr: torch.Tensor | None, gy: torch.Tensor, *,
                        eps: float = 1e-6, norm_of_rounded: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx_or_da, dw)`` of ``add_rmsnorm_ref(x, a, w)`` for
    the cotangents ``gr`` of the stream (None: unused) and ``gy`` of the
    norm: the norm's input cotangent (f32, of the sum it read) cast to
    x's dtype, then added to ``gr`` in x's dtype, as the reference adds
    the residual's and the norm's cotangents of its bf16 stream.  x and a
    receive the same gradient."""
    s = x.float() + a.float()
    dn, dw = rmsnorm_bwd_ref(s.to(x.dtype) if norm_of_rounded else s, w, gy,
                             eps=eps)
    dn = dn.to(x.dtype)
    return (dn if gr is None else gr + dn), dw


def sedov_step_ref(state: dict, dt: torch.Tensor, *, dx: float = 1.0) -> dict:
    """One fused Sedov hydro step for a given ``dt`` (0-d tensor), in the
    kernel's own operation order (the reference kernel's
    ``_sedov_kernel``): EOS, divergence, viscosity, pq = p + q, momentum
    with grad(pq) * (1 / rho), re-divergence, energy, mass.  Every derived
    field is itself edge-clamped: its value at a neighbour past the
    domain edge is its value at the edge zone."""
    rho, e, v = state["rho"], state["e"], state["v"]
    rho_inv = 1.0 / torch.clamp_min(rho, 1e-12)
    p = (GAMMA - 1.0) * rho * e
    dv = _div(v, dx)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    q = torch.where(dv < 0, C_Q * rho * dv * dv, zero)
    pq = p + q
    v_n = v - dt * _grad(pq, dx) * rho_inv
    dv_n = _div(v_n, dx)
    e_n = torch.clamp_min(e - dt * pq * dv_n * rho_inv, 0.0)
    rho_n = torch.clamp_min(rho * (1.0 - dt * dv_n), 1e-12)
    return {"rho": rho_n, "e": e_n, "v": v_n, "t": state["t"] + dt}
