"""Token-choice top-k Mixture-of-Experts, granite-moe and dbrx (port of
``repro/models/moe.py``).

Dispatch is the reference's: GShard capacity per batch row, a token's k
choices ranked in ``lax.top_k``'s order, slots assigned in token order,
assignments past an expert's capacity ``C`` dropped to the sentinel slot
``E·C``; a slot -> token scatter, a row gather with a zero pad row, the
three expert products, and the gate-weighted combine.  The layer runs
chunked over the sequence as the reference's does.

Rounding follows XLA's CPU compilation of the reference (its HLO): the
router product and the softmax in f32, each expert product rounded once
to bf16, the SiLU rounded step by step (``layers.silu``), and the gates
rounded to bf16 before an f32 weighted sum over the k choices, itself
rounded once.  Two things torch would otherwise do differently:

* XLA's CPU flushes denormals to zero; torch keeps them.  A saturated
  router row leaves probabilities such as 1e-40, whose order would then
  decide which zero-weight experts a token takes — and those still
  take capacity from later tokens.  ``route_tokens`` flushes them.
* ``torch.topk`` breaks ties in no fixed order; ``lax.top_k`` ranks the
  larger value first and a tie by the lower index, which a stable
  descending sort gives.

The expert and router products are plain matrix products (the
reference computes them as XLA einsums outside any Pallas kernel).

In a train step split over a mesh (``tp``, a ``sharding.split.Split``)
the Switch aux loss's statistics, the per-expert assignment counts and
the token count, are summed over the data-parallel ranks, and each rank
adds ``E * sum_e frac_e * P_e`` with the whole batch's ``frac`` and
token count but its own rows' sum of probabilities: the ranks' terms sum
to the whole batch's loss, and so do their gradients.  The router is
computed by every rank (its columns gathered over the model axis where
``experts`` is split), so routing is one device's; each model rank runs
its own experts' products (or, where ``experts`` does not divide the
axis and ``mlp`` does, its columns of every expert) and combines only
what lands on them, the f32 sums all-reduced over ``model``.  A split
serve step (``ServeSplit``) splits the experts the same way and computes
no aux loss.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import DenseLM
from repro_torch.sharding.split import ServeSplit

_MOE_SEQ_CHUNK = 2048
_F32_TINY = torch.finfo(torch.float32).tiny


def moe_defs(cfg) -> dict:
    E, m, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    d = {
        "router": ParamDef((m, E), ("embed", "experts")),
        "wi": ParamDef((E, m, f), ("experts", "embed", "mlp")),
        "wo": ParamDef((E, f, m), ("experts", "mlp", "embed")),
    }
    if cfg.activation in ("silu", "geglu"):
        d["wg"] = ParamDef((E, m, f), ("experts", "embed", "mlp"))
    return d


def expert_capacity(cfg, S: int) -> int:
    """Slots per expert for a chunk of S tokens a batch row: the
    capacity factor's share, at least 1, rounded up to a multiple of 8."""
    C = max(int(cfg.capacity_factor * cfg.experts_per_token * S
                / cfg.num_experts), 1)
    return -(-C // 8) * 8


def route_tokens(router_logits: torch.Tensor, k: int, capacity: int,
                 tp=None, with_aux: bool = True):
    """router_logits: (b, s, E) f32.  Returns (slot, gates, keep, aux).

    slot: (b, s*k) int32 in [0, E*C]; E*C is the drop sentinel.
    Position-in-expert is assigned in token order per batch row (GShard).
    gates: (b, s, k) f32, renormalized over the k choices; keep: (b, s*k)
    bool; aux: the Switch load-balance loss E * sum_e f_e * P_e, or with
    ``tp`` and data-parallel ranks this rank's term of it (f and the
    token count the whole batch's, the probabilities summed over this
    rank's rows); None with ``with_aux=False`` (a split serve step, which
    computes no loss).
    """
    b, s, E = router_logits.shape
    probs = L._softmax(router_logits)
    probs = probs.masked_fill(probs < _F32_TINY, 0.0)   # XLA's flush
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = ranked[..., :k], order[..., :k]
    # summed in rank order, as XLA's reduce loop does: the same bits on
    # every device (a tree sum of 8 x f32(1/40) is 0.2, in order 0.20000002)
    total = gate_vals[..., 0]
    for i in range(1, k):
        total = total + gate_vals[..., i]
    gate_vals = gate_vals / total.clamp_min(1e-9)[..., None]
    flat_e = expert_idx.reshape(b, s * k)
    experts = torch.arange(E, device=flat_e.device)
    oh = (flat_e[..., None] == experts).to(torch.int32)  # (b, s*k, E)
    pos = oh.cumsum(1, dtype=torch.int32) - oh           # rank within expert
    pos_in_e = pos.gather(-1, flat_e[..., None])[..., 0]
    keep = pos_in_e < capacity
    slot = torch.where(keep, flat_e * capacity + pos_in_e,
                       E * capacity).to(torch.int32)
    if not with_aux:
        return slot, gate_vals, keep, None
    counts = oh.reshape(b, s, k, E).sum(2)
    if tp is None or not tp.dp:
        frac = counts.float().mean((0, 1)) / k
        aux = E * (frac * probs.mean((0, 1))).sum()
        return slot, gate_vals, keep, aux
    stats = tp.dp_sum(torch.cat([counts.sum((0, 1)).float(),
                                 counts.new_full((1,), b * s).float()]))
    n = stats[E]
    frac = stats[:E] / n / k
    aux = E * (frac * probs.sum((0, 1))).sum() / n
    return slot, gate_vals, keep, aux


def moe_mlp_chunk(p: dict, x: torch.Tensor, cfg, tp=None):
    """x: (b, S, m) one sequence chunk.  Returns (y, aux).  With ``tp``,
    this rank's experts (or columns of them) on a split step."""
    b, S, m = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = expert_capacity(cfg, S)
    E_l = p["wi"].shape[0]
    dt = x.dtype
    by_experts = tp is not None and E_l < E
    by_columns = tp is not None and p["wi"].shape[-1] < cfg.d_ff
    split = by_experts or by_columns
    # the router: every rank routes every token (its columns gathered
    # where ``experts`` is split)
    if tp is not None and p["router"].shape[-1] < E:
        logits = tp.gather_out(L.split_product(
            tp, "bsm,me->bse", x, p["router"], torch.float32), -1)
    else:
        logits = torch.einsum("bsm,me->bse", x.float(), p["router"].float())
    slot, gates, keep, aux = route_tokens(
        logits, k, C, tp, with_aux=not isinstance(tp, ServeSplit))

    # the experts' input: by experts, each rank's whole products over its
    # experts' tokens in one device's dtype (a token's k assignments land
    # on other ranks, whose bf16 gradients the f32 sum adds as one
    # device adds them); by columns, partial products in f32
    if by_experts:
        x = tp.copy_in(x)
    elif by_columns:
        x = L.split_input(tp, x)
    # slot -> token scatter (column E*C takes every dropped assignment and
    # is cut off), then the row gather; row S of x_pad is the zero pad
    rows = torch.arange(b, device=x.device)[:, None]
    tok_ids = (torch.arange(S * k, device=x.device) // k).expand(b, S * k)
    slot_tok = torch.full((b, E * C + 1), S, dtype=torch.int64,
                          device=x.device)
    slot_tok.scatter_(1, slot.long(), tok_ids)
    x_pad = torch.cat([x, x.new_zeros(b, 1, m)], dim=1)
    # this rank's experts' slots (every expert's off a split step)
    e0 = tp.tp_rank * E_l if by_experts else 0
    ex = x_pad[rows, slot_tok[:, e0 * C:(e0 + E_l) * C]].reshape(
        b, E_l, C, m)

    def proj(w):
        return torch.einsum("becm,emf->becf", ex, w.float()).to(dt) \
            if by_columns else torch.einsum("becm,emf->becf", ex, w)
    h = proj(p["wi"])
    if "wg" in p:
        h = L.silu(proj(p["wg"])) * h
    elif cfg.activation == "sq_relu":
        h = L.sq_relu(h)
    else:
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet "
            f"(ROADMAP: other arch configs)")
    if by_columns:
        # f32: a partial sum over this rank's columns of every expert,
        # rounded once after the sum over the model axis
        ye = torch.einsum("becf,efm->becm", h.float(), p["wo"].float())
    else:
        ye = torch.einsum("becf,efm->becm", h, p["wo"])

    ye_pad = torch.cat([ye.reshape(b, E_l * C, m), ye.new_zeros(b, 1, m)],
                       dim=1)
    at = slot.long() - e0 * C
    if by_experts:
        # an assignment to another rank's expert reads the zero pad row
        at = torch.where((at >= 0) & (at < E_l * C), at, E_l * C)
    y_assign = ye_pad[rows, at].reshape(b, S, k, m)
    w = (gates * keep.reshape(b, S, k)).to(dt)
    # on a split step each rank's gradient of the gates is partial (its
    # experts' assignments, or its columns' share), summed in f32
    w = L.split_input(tp, w) if split else w.float()
    y = torch.einsum("bskm,bsk->bsm", y_assign.float(), w)
    if split:
        y = tp.reduce_out(y)
    return y.to(dt), aux


def moe_mlp(p: dict, x: torch.Tensor, cfg, tp=None):
    """Chunked over the sequence; returns (y, mean aux loss; None in a
    split serve step)."""
    b, s, m = x.shape
    chunk = min(_MOE_SEQ_CHUNK, s)
    if s <= chunk:
        return moe_mlp_chunk(p, x, cfg, tp)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the MoE chunk "
                         f"{chunk}")
    ys, auxs = zip(*(moe_mlp_chunk(p, x[:, i:i + chunk], cfg, tp)
                     for i in range(0, s, chunk)))
    aux = None if auxs[0] is None else torch.stack(auxs).mean()
    return torch.cat(ys, dim=1), aux


class MoELM(DenseLM):
    """Dense attention + MoE FFN.  Each MoE layer's aux loss is left on
    ``_last_aux``; the training forward hands it out of each block and
    its loss adds ``router_aux_coef`` times the mean over the layers, as
    the reference's ``full`` mode does."""

    def mlp_defs(self) -> dict:
        return moe_defs(self.cfg)

    def mlp_apply(self, p, h):
        y, self._last_aux = moe_mlp(p, h, self.cfg, self.tp)
        return y

    def _full_block(self, p, x, delta, positions):
        x, out, _ = super()._full_block(p, x, delta, positions)
        return x, out, self._last_aux

    def loss(self, leaves, batch, weight=None):
        """The cross entropy (scaled by a mesh step's ``weight``, this
        rank's share of the tokens) plus the aux loss's term, unscaled:
        on a split step each rank's aux is its term of the whole batch's
        already."""
        logits, aux_sum = self.full_forward(leaves, batch)
        loss = self.xent(logits, batch)
        if weight is not None:
            loss = loss * weight
        aux = aux_sum / self.cfg.num_layers
        total = loss + self.cfg.router_aux_coef * aux
        return total, {"loss": total, "aux_loss": aux}
