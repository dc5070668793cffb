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
every device, leaving ``dt`` on the device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.lulesh import C_Q, GAMMA, _div, _grad, cfl_dt  # noqa: F401


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        kv_len: torch.Tensor) -> torch.Tensor:
    """Gather-then-attend single-token decode attention over a page pool.

    q: (slots, H, dh); k/v_pages: (num_pages, page_size, K, dh);
    page_table: (slots, max_pages) int32; kv_len: (slots,) int32.
    Returns (slots, H, dh) in q's dtype.

    The recipe is ``layers.dot_attention``'s over the gathered KV: f32
    scores with the scale applied after the q.k dot, an f32 max and
    denominator, probabilities normalized and THEN rounded to the value
    dtype before an f32 PV contraction.  Positions routed through the
    junk page 0 or at/after ``kv_len`` get probability exactly 0, so a
    slot with no live page returns exact zeros.
    """
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
