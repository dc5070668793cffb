"""xLSTM (sLSTM + mLSTM blocks), arch ``xlstm-1.3b`` (port of
``repro/models/ssm.py``).

mLSTM: a matrix-memory cell with exponential input gating.  Training and
prefill run the exact stabilized chunkwise-parallel form (a loop over
chunks, quadratic only within one); decode runs the O(1)-state
recurrence, as does a prompt's ragged tail.  sLSTM: a scalar-memory cell
with recurrent block-diagonal gates, a loop over time.  Every
``slstm_every``-th block is an sLSTM block.

The reference's many-operand einsums run here as pairwise products, so
no (b, h, i, j, d) intermediate is ever built.  Each path starts from the
reference's own initial state: the mLSTM from the cache's zeros (``m =
0``) on every path, the sLSTM from ``m = -1e30`` in the training forward
(``slstm_zero_state``) but from the cache's zeros in prefill; the
stabilizer shows in the output (``hid = o c / max(n, 1)``), so the two
paths compute different first steps, as in the reference.

The group norm, the scans and the time loop are plain PyTorch on every
device: the reference computes them outside any Pallas kernel.  An
xLSTM config is a LayerNorm one, so no hand-written kernel runs on it.

A train or serve step split over a mesh sets ``tp`` (``sharding.split``)
on the model, as on ``DenseLM``: each layer's weight shards gathered
along ``data`` where the layer runs, the embedding, ``ln_f`` and the
unembedding as the dense model splits them, and each block split along
the model axis where its weights are.  An mLSTM rank computes ``w_up``
on its columns of ``[xb | z]`` (column-parallel), gathers them along
``model`` and cuts what it computes with: its conv channels (the conv
state rests under ``act_mlp`` as the same shard), its heads' ``xb`` and
its ``z`` channels.  Where ``ssm_heads`` divides the model axis a rank's
heads are its conv channels, and it runs the recurrence, the group norm
and the gate on them; where it does not (``xlstm-1.3b``'s 4 heads on
16 ranks) it gathers the conv output and every rank computes every head
(the rules' fallback), the gated hidden state cut to its channels.
``w_if`` and ``w_down`` are row-parallel over ``mlp`` (f32 partials
summed over ``model``, cast once).  An sLSTM rank projects its heads
(``wx`` column-parallel), runs the time loop on them (``r`` is
block-diagonal by head: no collective inside the loop), gathers the
heads' output and runs the gated FFN column-, then row-parallel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, tree_map
from repro_torch.models.transformer import (remat_wrap, stack_defs,
                                            token_batch_table)

# ---------------------------------------------------------------------------
# small helpers shared with the Mamba2 port


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; torch's ``softplus`` returns x past 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """``q / sqrt(dk)`` in f32, as XLA compiles the reference's: the
    weakly typed scalar taken in q's dtype, the division a product with
    its f32 reciprocal, and (for bf16 q) the quotient left unrounded."""
    c = float(torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype))
    return q.float() * (1.0 / c)


def zeros_from(table: dict, device) -> dict:
    """Zero tensors of a table's shapes and dtypes (its leaves are all
    ``init="zeros"``)."""
    return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                          device=device), table)


def per_layer(t: torch.Tensor, lead: int) -> list:
    """The layer views of a tensor whose first ``lead`` axes are stacked
    layer axes, in row-major order."""
    return list(t.reshape((-1,) + t.shape[lead:]).unbind(0))


# ---------------------------------------------------------------------------
# mLSTM cell


def mlstm_recurrent(q, k, v, li, lf, state):
    """Step-by-step mLSTM (also the decode path).

    q, k: (b, h, s, dk); v: (b, h, s, dv); li, lf: (b, h, s) log input and
    forget gates.  state: (C (b, h, dv, dk), n (b, h, dk), m (b, h)).
    Returns (h (b, h, s, dv), state)."""
    qs = scale_q(q).to(q.dtype)         # a scan input: rounded
    C, n, m = state
    vf = v.float()
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = qs[:, :, t], k[:, :, t], vf[:, :, t]
        lit, lft = li[:, :, t], lf[:, :, t]
        m_new = torch.maximum(lft + m, lit)
        i_p = torch.exp(lit - m_new)[..., None]
        f_p = torch.exp(lft + m - m_new)[..., None]
        C = f_p[..., None] * C + i_p[..., None] * (vt[..., :, None] *
                                                   kt[..., None, :])
        n = f_p * n + i_p * kt
        num = (C @ qt.float()[..., None])[..., 0]                # bhv
        den = torch.maximum((n * qt).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_chunkwise(q, k, v, li, lf, state, chunk: int):
    """Exact chunkwise-parallel mLSTM (stabilized); shapes as
    ``mlstm_recurrent``.  A ragged tail (s % chunk) runs through the
    recurrence."""
    b, h, s, dk = q.shape
    if s % chunk:
        cut = (s // chunk) * chunk
        if cut == 0:
            return mlstm_recurrent(q, k, v, li, lf, state)
        y0, state = mlstm_chunkwise(q[:, :, :cut], k[:, :, :cut],
                                    v[:, :, :cut], li[:, :, :cut],
                                    lf[:, :, :cut], state, chunk)
        y1, state = mlstm_recurrent(q[:, :, cut:], k[:, :, cut:],
                                    v[:, :, cut:], li[:, :, cut:],
                                    lf[:, :, cut:], state)
        return torch.cat([y0, y1], dim=2), state
    qs = scale_q(q)
    kf, vf = k.float(), v.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    C, n, m_prev = state
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi, lii, lfi = qs[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            li[:, :, sl], lf[:, :, sl]
        a = torch.cumsum(lfi, dim=-1)                            # (b,h,Q)
        D = a[..., :, None] - a[..., None, :] + lii[..., None, :]
        D = torch.where(tri, D, torch.full_like(D, -math.inf))
        m_intra = D.amax(dim=-1)
        m_inter = m_prev[..., None] + a
        m_t = torch.maximum(m_intra, m_inter)                    # (b,h,Q)
        W = torch.exp(D - m_t[..., None])
        Wqk = W * (qi @ ki.transpose(-1, -2))                    # (b,h,Q,Q)
        inter = torch.exp(m_inter - m_t)
        num = Wqk @ vi + inter[..., None] * (qi @ C.transpose(-1, -2))
        den_i = Wqk.sum(-1) + inter * (qi @ n[..., None])[..., 0]
        den = torch.maximum(den_i.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        m_new = m_t[..., -1]
        decay = torch.exp(a[..., -1:] - a + lii - m_new[..., None])
        carry = torch.exp(m_prev + a[..., -1] - m_new)
        C = (decay[..., None] * vi).transpose(-1, -2) @ ki + \
            carry[..., None, None] * C
        n = (decay[..., None, :] @ ki)[..., 0, :] + carry[..., None] * n
        m_prev = m_new
    return torch.cat(hs, dim=2), (C, n, m_prev)


def mlstm_zero_state(b, h, dk, dv, device=None):
    return (torch.zeros((b, h, dv, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), -1e30, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# sLSTM cell (scalar memory, recurrent gates)


def slstm_scan(gates_x, R, state):
    """gates_x: (b, s, 4, h, dh) pre-activations from the input path.
    R: (4, h, dh, dh) recurrent per-head gate weights.  state: (c, n,
    hid, m), each (b, h, dh) but m (b, h).  Returns (hs (b, s, h, dh),
    state)."""
    Rf = R.float()
    c, n, hid, m = state
    hs = []
    for t in range(gates_x.shape[1]):
        gx = gates_x[:, t].float()                               # (b,4,h,dh)
        rec = torch.einsum("ghde,bhd->gbhe", Rf, hid)
        gi, gf, gz, go = (gx[:, i] + rec[i] for i in range(4))
        m_dim = m[..., None]
        lf = -softplus(-gf)                                      # log sigmoid
        m_new = torch.maximum(lf + m_dim, gi)
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(lf + m_dim - m_new)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        hid = o * c / torch.clamp(n, min=1.0)
        m = m_new.amax(dim=-1)
        hs.append(hid)
    return torch.stack(hs, dim=1), (c, n, hid, m)


def slstm_zero_state(b, h, dh, device=None):
    z = torch.zeros((b, h, dh), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(),
            torch.full((b, h), -1e30, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# causal depthwise conv (width w) with streaming state


def causal_conv(x, w, state=None):
    """x: (b, s, d); w: (width, d).  state: (b, width - 1, d), the trailing
    inputs.  Returns (y, new_state).  The products are summed in x's
    dtype, one rounding a term, as the reference's Python ``sum``."""
    width, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)
    y = xp[:, 0:s] * w[width - 1]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[width - 1 - i]
    return y, xp[:, -(width - 1):, :]


# ---------------------------------------------------------------------------
# Blocks


def mlstm_block_defs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.ssm_heads
    dqk, dv = cfg.ssm_head_dim, di // h
    return {
        "ln": L.norm_defs(d, cfg.norm),
        "w_up": ParamDef((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamDef((cfg.conv_width, di), ("conv", "mlp")),
        # block-diagonal per-head projections: each head projects its own
        # di/h slice
        "wq": ParamDef((h, dv, dqk), ("heads", "head_dim", None)),
        "wk": ParamDef((h, dv, dqk), ("heads", "head_dim", None)),
        "wv": ParamDef((h, dv, dv), ("heads", "head_dim", None)),
        "w_if": ParamDef((di, 2, h), ("mlp", None, "heads"), init="zeros"),
        "b_if": ParamDef((2, h), (None, "heads"), init="zeros"),
        "gn": ParamDef((h, dv), ("heads", "head_dim"), init="ones"),
        "w_down": ParamDef((di, d), ("mlp", "embed")),
    }


def slstm_block_defs(cfg) -> dict:
    d = cfg.d_model
    h = cfg.ssm_heads
    dh = d // h
    ff = int(d * 4 / 3 / 64 + 1) * 64
    return {
        "ln": L.norm_defs(d, cfg.norm),
        "wx": ParamDef((d, 4, h, dh), ("embed", None, "heads", "head_dim")),
        "r": ParamDef((4, h, dh, dh), (None, "heads", "head_dim", None),
                      init="normal", scale=0.05),
        "gn": ParamDef((h, dh), ("heads", "head_dim"), init="ones"),
        "ln_ffn": L.norm_defs(d, cfg.norm),
        "ffn_wi": ParamDef((d, ff), ("embed", "mlp")),
        "ffn_wg": ParamDef((d, ff), ("embed", "mlp")),
        "ffn_wo": ParamDef((ff, d), ("mlp", "embed")),
    }


def _groupnorm(x, scale):
    """x: (b, s, h, dv), normalized per head (population variance) in
    f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + 1e-6) * scale.float()


def mlstm_block_apply(p, x, cfg, mode, cache, chunk, tp=None):
    """One mLSTM block on x (b, s, d): (x + block(x), new cache).
    ``cache``: {"C", "n", "m", "conv"} of this layer, or None (the zero
    state, m = -1e30); ``mode="decode"`` steps the recurrence, any other
    mode runs the chunkwise form.  With ``tp`` and ``mlp`` split over the
    model axis, this rank's part (see the module's docstring)."""
    if tp is not None and \
            p["w_up"].shape[-1] < 2 * cfg.ssm_expand * x.shape[-1]:
        return _mlstm_split(p, x, cfg, mode, cache, chunk, tp)
    b, s, d = x.shape
    h = cfg.ssm_heads
    di = cfg.ssm_expand * d
    dv = di // h
    xin = L.apply_norm(p["ln"], x, cfg.norm)
    up = torch.einsum("bsd,de->bse", xin, p["w_up"])
    xb, z = up.split(di, dim=-1)
    xc, new_conv = causal_conv(xb, p["conv_w"],
                               cache["conv"] if cache else None)
    xc = L.silu(xc)
    gates = torch.einsum("bsd,dgh->bsgh", xc, p["w_if"]) + p["b_if"].float()
    hidden, state = _mlstm_heads(p, xc, xb, gates, cfg, mode, cache, chunk)
    out = (hidden * L.silu(z.float())).to(x.dtype)
    y = torch.einsum("bse,ed->bsd", out, p["w_down"])
    return x + y, dict(state, conv=new_conv)


def _mlstm_heads(p, xc, xb, gates, cfg, mode, cache, chunk):
    """The mLSTM cell over the heads of ``p`` (every head, or a rank's):
    xc, xb (b, s, heads * dv) their channels, ``gates`` (b, s, 2, heads)
    f32.  Returns (the group-normed hidden state (b, s, heads * dv) f32,
    {"C", "n", "m"})."""
    b, s = xc.shape[:2]
    h, dv = p["wq"].shape[0], p["wq"].shape[1]
    xch = xc.reshape(b, s, h, dv)   # per-head slices (block-diagonal proj)
    xbh = xb.reshape(b, s, h, dv)
    q = torch.einsum("bshc,hck->bhsk", xch, p["wq"])
    k = torch.einsum("bshc,hck->bhsk", xch, p["wk"])
    v = torch.einsum("bshc,hck->bhsk", xbh, p["wv"])
    li = gates[:, :, 0].transpose(1, 2).float()                  # (b,h,s)
    lf = -softplus(-gates[:, :, 1]).transpose(1, 2).float()
    if cache is not None:
        state = (cache["C"], cache["n"], cache["m"])
    else:
        state = mlstm_zero_state(b, h, cfg.ssm_head_dim, dv, xc.device)
    if mode == "decode":
        hidden, state = mlstm_recurrent(q, k, v, li, lf, state)
    else:
        hidden, state = mlstm_chunkwise(q, k, v, li, lf, state,
                                        min(chunk, s))
    hidden = _groupnorm(hidden.transpose(1, 2), p["gn"]).reshape(
        b, s, h * dv)
    return hidden, {"C": state[0], "n": state[1], "m": state[2]}


def _mlstm_split(p, x, cfg, mode, cache, chunk, tp):
    """``mlstm_block_apply`` on a split step: ``w_up`` column-parallel,
    its columns gathered along ``model`` and cut to the rank's conv
    channels, heads and ``z`` channels; the conv on its channels; the
    cell on its heads (every head where ``ssm_heads`` does not divide the
    model axis: the conv output gathered, the hidden state cut to the
    rank's channels); ``w_if`` and ``w_down`` row-parallel."""
    dt = x.dtype
    d = x.shape[-1]
    h = cfg.ssm_heads
    di = cfg.ssm_expand * d
    dv = di // h
    m0, m1 = tp.own(p["conv_w"].shape[-1], di)        # the rank's channels
    if p["w_if"].shape[0] != m1 - m0 or p["w_down"].shape[0] != m1 - m0:
        raise NotImplementedError("an mLSTM whose mlp products split "
                                  "unlike its conv")
    h0, h1 = tp.own(p["wq"].shape[0], h)              # the rank's heads
    heads = h1 - h0 < h
    if heads and (h0 * dv, h1 * dv) != (m0, m1):
        raise NotImplementedError("an mLSTM rank's heads off its channels")
    xin = L.apply_norm(p["ln"], x, cfg.norm)
    up = tp.gather_out(L.split_product(tp, "bsd,de->bse", xin, p["w_up"]),
                       -1)
    xb_own, z = tp.cut(up, -1, [(m0, m1), (di + m0, di + m1)])
    xc, new_conv = causal_conv(xb_own, p["conv_w"],
                               cache["conv"] if cache else None)
    xc = L.silu(xc)
    gates = L.split_rows(tp, "bsd,dgh->bsgh", xc, p["w_if"], dt)
    if heads:
        gates = tp.cut(gates, -1, [(h0, h1)])[0]
        hidden, state = _mlstm_heads(p, xc, xb_own, gates +
                                     p["b_if"].float(), cfg, mode, cache,
                                     chunk)
    else:
        hidden, state = _mlstm_heads(p, tp.gather_out(xc, -1), up[..., :di],
                                     gates + p["b_if"].float(), cfg, mode,
                                     cache, chunk)
        hidden = tp.cut(hidden, -1, [(m0, m1)])[0]
    out = (hidden * L.silu(z.float())).to(dt)
    y = L.split_rows(tp, "bse,ed->bsd", out, p["w_down"], dt)
    return x + y, dict(state, conv=new_conv)


def slstm_block_apply(p, x, cfg, mode, cache, tp=None):
    """One sLSTM block (the recurrence, then a gated FFN) on x (b, s, d):
    (x out, new cache).  ``cache``: {"c", "n", "h", "m"} of this layer, or
    None (the zero state, m = -1e30).  With ``tp``, the rank's heads
    (where ``ssm_heads`` divides the model axis; every head otherwise)
    and FFN columns."""
    b, s, d = x.shape
    dt = x.dtype
    h, dh = p["wx"].shape[2], d // cfg.ssm_heads       # heads held
    heads = tp is not None and h < cfg.ssm_heads
    xin = L.apply_norm(p["ln"], x, cfg.norm)
    eq = "bsd,dghe->bsghe"
    gx = L.split_product(tp, eq, xin, p["wx"]) if heads \
        else torch.einsum(eq, xin, p["wx"])                      # (b,s,4,h,dh)
    state = (cache["c"], cache["n"], cache["h"], cache["m"]) if cache \
        else slstm_zero_state(b, h, dh, x.device)
    hs, state = slstm_scan(gx, p["r"], state)
    hs = _groupnorm(hs, p["gn"]).reshape(b, s, h * dh).to(dt)
    if heads:
        hs = tp.gather_out(hs, -1)
    # XLA hands the FFN's norm the unrounded f32 sum of the residual add
    x, hin = L.add_norm(p["ln_ffn"], x, hs, cfg.norm, norm_of_rounded=False)
    ff = int(d * 4 / 3 / 64 + 1) * 64
    if tp is not None and p["ffn_wi"].shape[-1] < ff:
        f = L.silu(L.split_product(tp, "bsd,df->bsf", hin, p["ffn_wg"])) * \
            L.split_product(tp, "bsd,df->bsf", hin, p["ffn_wi"])
        y = L.split_rows(tp, "bsf,fd->bsd", f, p["ffn_wo"], dt)
    else:
        f = L.silu(torch.einsum("bsd,df->bsf", hin, p["ffn_wg"])) * \
            torch.einsum("bsd,df->bsf", hin, p["ffn_wi"])
        y = torch.einsum("bsf,fd->bsd", f, p["ffn_wo"])
    new_cache = {"c": state[0], "n": state[1], "h": state[2], "m": state[3]}
    return x + y, new_cache


# ---------------------------------------------------------------------------


class RecurrentLM:
    """What the xLSTM and Zamba2 models share: the config, the training
    forward's remat policy, the per-layer views of a params tree (built
    once per tree, ``_views``), token batches, ``ln_f`` and the
    unembedding, and the loss of ``full_forward``'s logits."""

    def __init__(self, cfg, remat: str = "dots"):
        self.cfg = cfg
        self.remat = remat
        self._views = (None, None)   # (params, their per-layer views)
        # the split of a mesh train or serve step while it runs, else None
        self.tp = None

    def batch_table(self, shape: ShapeConfig) -> dict:
        return token_batch_table(shape)

    def _used(self, tree, *path):
        """Weights at params ``path`` as a layer uses them: as they are,
        or in a split step gathered along ``data`` (``Split.use``)."""
        return tree if self.tp is None else self.tp.use(tree, path)

    def _table(self, params, *names) -> dict:
        e = params["embed"]
        return {k: self._used(e[k], "embed", k) for k in names if k in e}

    def _embed(self, params, tokens):
        return L.embed(self._table(params, "embedding", "pos_embedding"),
                       tokens, self.cfg, tp=self.tp)

    def _logits(self, params, x):
        h = L.apply_norm(self._used(params["ln_f"], "ln_f"), x,
                         self.cfg.norm)
        return L.unembed(self._table(params, "embedding" if
                                     self.cfg.tie_embeddings else "unembed"),
                         h, self.cfg, tp=self.tp)

    def loss(self, leaves, batch, weight=None):
        """Mean next-token cross entropy over ``train_leaves``; a split
        step's ``weight`` (this rank's share of the tokens) scales it."""
        logits, _ = self.full_forward(leaves, batch)
        split = self.tp is not None and \
            logits.shape[-1] < self.cfg.vocab_size
        loss = L.softmax_xent(logits, batch["labels"],
                              batch.get("loss_mask"),
                              tp=self.tp if split else None)
        if weight is not None:
            loss = loss * weight
        return loss, {"loss": loss}


class XLSTM(RecurrentLM):
    """``num_layers`` blocks in groups of ``slstm_every``: (k - 1) mLSTM
    blocks, then one sLSTM block.  The mLSTM weights and cache carry two
    stacked axes (groups, m_per), the sLSTM's one (groups)."""

    def _layout(self):
        cfg = self.cfg
        k = cfg.slstm_every
        assert cfg.num_layers % k == 0
        return cfg.num_layers // k, k - 1    # groups, mLSTM per group

    # ---- tables ----
    def param_table(self) -> dict:
        cfg = self.cfg
        groups, m_per = self._layout()
        return {
            "embed": L.embed_defs(cfg),
            "mlstm": stack_defs(stack_defs(mlstm_block_defs(cfg), m_per),
                                groups),
            "slstm": stack_defs(slstm_block_defs(cfg), groups),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm),
        }

    def cache_table(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        groups, m_per = self._layout()
        h = cfg.ssm_heads
        di = cfg.ssm_expand * cfg.d_model
        dv, dk, dh = di // h, cfg.ssm_head_dim, cfg.d_model // h
        f32 = torch.float32

        def m_def(shape, axes, dtype=f32):
            return ParamDef((groups, m_per) + shape,
                            ("layers", "layers") + axes, dtype, "zeros")

        def s_def(shape, axes):
            return ParamDef((groups,) + shape, ("layers",) + axes, f32,
                            "zeros")

        return {
            "mlstm": {
                "C": m_def((batch, h, dv, dk),
                           ("act_batch", "act_heads", None, None)),
                "n": m_def((batch, h, dk), ("act_batch", "act_heads", None)),
                "m": m_def((batch, h), ("act_batch", "act_heads")),
                "conv": m_def((batch, cfg.conv_width - 1, di),
                              ("act_batch", None, "act_mlp"),
                              cfg.activation_dtype),
            },
            "slstm": {
                "c": s_def((batch, h, dh), ("act_batch", "act_heads", None)),
                "n": s_def((batch, h, dh), ("act_batch", "act_heads", None)),
                "h": s_def((batch, h, dh), ("act_batch", "act_heads", None)),
                "m": s_def((batch, h), ("act_batch", "act_heads")),
            },
            "index": ParamDef((), (), torch.int32, "zeros"),
        }

    # ---- per-layer weights ----
    def layer_params(self, params) -> tuple[list, list]:
        """(mLSTM layer trees in (group, layer) order, sLSTM group trees):
        views of the stacked weights, built once per params tree."""
        if self._views[0] is not params:
            groups, m_per = self._layout()
            mlstm = [tree_map(lambda t: per_layer(t, 2)[i], params["mlstm"])
                     for i in range(groups * m_per)]
            slstm = [tree_map(lambda t: t[g], params["slstm"])
                     for g in range(groups)]
            self._views = (params, (mlstm, slstm))
        return self._views[1]

    def train_leaves(self, params) -> dict:
        """The weights as autograd leaves sharing their storage: each
        stacked weight as a list of per-layer trees (the mLSTM's in
        (group, layer) order), the rest as they are."""
        def leaf(t):
            return t.detach().requires_grad_()
        groups, m_per = self._layout()
        return {
            "embed": tree_map(leaf, params["embed"]),
            "mlstm": [tree_map(lambda t: leaf(per_layer(t, 2)[i]),
                               params["mlstm"])
                      for i in range(groups * m_per)],
            "slstm": [tree_map(lambda t: leaf(t[g]), params["slstm"])
                      for g in range(groups)],
            "ln_f": tree_map(leaf, params["ln_f"]),
        }

    # ---- backbone ----
    def backbone(self, mlstm_p, slstm_p, x, mode, cache=None):
        """The blocks over x.  ``cache`` (prefill and decode) is written in
        place, layer by layer; without one (the training forward) each
        mLSTM starts from zeros and each sLSTM from its zero state
        (m = -1e30), each block under the remat policy."""
        cfg, tp = self.cfg, self.tp
        groups, m_per = self._layout()
        chunk = cfg.ssm_chunk
        if cache is None:
            b = x.shape[0]

            def m_fn(p_, y_):
                p_ = self._used(p_, "mlstm")
                zero = self._zero_mlstm(p_, b, y_.device)
                return mlstm_block_apply(p_, y_, cfg, mode, zero, chunk,
                                         tp)[0]

            def s_fn(p_, y_):
                return slstm_block_apply(self._used(p_, "slstm"), y_, cfg,
                                         mode, None, tp)[0]
            m_fn, s_fn = remat_wrap(m_fn, self.remat), \
                remat_wrap(s_fn, self.remat)
            for g in range(groups):
                for j in range(m_per):
                    x = m_fn(mlstm_p[g * m_per + j], x)
                x = s_fn(slstm_p[g], x)
            return x
        mc, sc = cache["mlstm"], cache["slstm"]
        for g in range(groups):
            for j in range(m_per):
                c = {k: v[g, j] for k, v in mc.items()}
                x, nc = mlstm_block_apply(
                    self._used(mlstm_p[g * m_per + j], "mlstm"), x, cfg,
                    mode, c, chunk, tp)
                for k, v in nc.items():
                    c[k].copy_(v)
            c = {k: v[g] for k, v in sc.items()}
            x, nc = slstm_block_apply(self._used(slstm_p[g], "slstm"), x,
                                      cfg, mode, c, tp)
            for k, v in nc.items():
                c[k].copy_(v)
        return x

    def _zero_mlstm(self, p, b: int, device) -> dict:
        """One mLSTM layer's zero state, of the heads and conv channels
        the layer's weights ``p`` hold (a split rank's shard of them)."""
        h, dv = p["wq"].shape[0], p["wq"].shape[1]
        f32 = torch.float32
        return {"C": torch.zeros((b, h, dv, self.cfg.ssm_head_dim),
                                 dtype=f32, device=device),
                "n": torch.zeros((b, h, self.cfg.ssm_head_dim), dtype=f32,
                                 device=device),
                "m": torch.zeros((b, h), dtype=f32, device=device),
                "conv": torch.zeros((b, self.cfg.conv_width - 1,
                                     p["conv_w"].shape[-1]),
                                    dtype=self.cfg.activation_dtype,
                                    device=device)}

    # ---- entry points ----
    def full_forward(self, leaves, batch):
        """The training forward over ``train_leaves``: (logits, None)."""
        x = self._embed(leaves, batch["tokens"])
        x = self.backbone(leaves["mlstm"], leaves["slstm"], x, "full")
        return self._logits(leaves, x), None

    def prefill(self, params, batch):
        """Whole-prompt forward: last-position logits and a fresh cache
        (zeros of the layers' shapes, a split rank's shard of the heads
        and conv channels, filled in place), its 0-d index on the host."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        mlstm, slstm = self.layer_params(params)
        groups, m_per = self._layout()
        lead = {"mlstm": (groups, m_per), "slstm": (groups,)}
        zero = {"mlstm": self._zero_mlstm(mlstm[0], b, x.device),
                "slstm": dict(zip("cnhm", slstm_zero_state(
                    b, slstm[0]["wx"].shape[2],
                    self.cfg.d_model // self.cfg.ssm_heads, x.device)))}
        cache = {k: {n: torch.zeros(lead[k] + tuple(t.shape), dtype=t.dtype,
                                    device=x.device)
                     for n, t in v.items()} for k, v in zero.items()}
        cache["index"] = torch.tensor(s, dtype=torch.int32)
        x = self.backbone(mlstm, slstm, x, "prefill", cache)
        return self._logits(params, x[:, -1:].contiguous()), cache

    def decode_step(self, params, cache, tokens):
        """One token a row over ``cache`` (written in place): the logits
        and the cache, its index advanced."""
        x = self._embed(params, tokens)
        x = self.backbone(*self.layer_params(params), x, "decode", cache)
        return self._logits(params, x), dict(cache,
                                             index=cache["index"] +
                                             tokens.shape[1])
