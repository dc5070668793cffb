"""Mamba2 (SSD) blocks and the Zamba2-style hybrid backbone, arch
``zamba2-7b`` (port of ``repro/models/mamba.py``).

Zamba2 is a stack of Mamba2 blocks with one **shared** transformer block
(attention + MLP, one set of weights) applied after every
``shared_attn_period`` Mamba layers, each application with a KV cache of
its own.  Training and prefill run the chunkwise SSD algorithm (a loop
over chunks, quadratic only within one); decode runs the O(1)-state
recurrence.  The shared attention takes ``cfg.window`` (sliding-window
attention, ``layers.attention``).

The reference's three- and four-operand einsums run here as pairwise
products: no (b, h, i, j, p) intermediate is built (at full width that
would be 1.9 GB a request and chunk).  Every RMSNorm — each Mamba2
block's input norm and its gated norm over d_inner, the shared block's
two and ``ln_f`` — runs on the hand-written kernel on the card; the SSD
scans are plain PyTorch on every device, as the reference computes them
outside any Pallas kernel.

A train or serve step split over a mesh sets ``tp`` (``sharding.split``)
on the model.  A Mamba2 rank computes ``w_in`` on its columns of ``[z |
x | B | C | dt]`` (its contiguous shard is not its heads' columns),
gathers them along ``model`` and cuts its heads' ``z``, ``x`` and ``dt``
and the whole ``B`` and ``C``; the conv runs on its contiguous shard of
``[x | B | C]``'s channels (the conv state rests under ``act_mlp`` as the
same shard), its output gathered and cut the same way; the SSD scan runs
on its heads (``A_log``, ``D``, ``dt_bias`` and the state split by
heads).  The gated RMSNorm spans all of d_inner: the rank's gated rows
are gathered along ``model``, the kernel normalizes whole rows (at a
unit scale: ``gn`` stays split), and the rank keeps its channels, scaled
by its shard of ``gn``, for ``w_out``, row-parallel.  The shared block
runs split as the dense block does; its weights are gathered along
``data`` once a step and kept for every application, so autograd sums
their gradient over the applications and reduces it once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, tree_map
from repro_torch.models.ssm import (RecurrentLM, causal_conv, per_layer,
                                    softplus)
from repro_torch.models.transformer import remat_wrap, stack_defs

# ---------------------------------------------------------------------------
# SSD (state-space duality) core, chunkwise


def _segsum(x):
    """x: (..., q).  Returns (..., q, q) with S[i, j] = sum_{j<t<=i} x_t
    (i >= j), -inf above the diagonal."""
    q = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(tri, s, torch.full_like(s, -math.inf))


def ssd_chunkwise(x, dt, A, B, C, D, state, chunk: int):
    """Chunkwise SSD.

    x: (b, l, h, p) inputs per head; dt: (b, l, h) positive step sizes;
    A: (h,) negative decay rates; B, C: (b, l, n), shared across heads;
    D: (h,) skip connection; state: (b, h, p, n) or None.  Returns
    (y (b, l, h, p), final state).  A ragged tail runs through the
    recurrence."""
    b, l, h, p = x.shape
    if l % chunk:
        cut = (l // chunk) * chunk
        if cut == 0:
            return ssd_recurrent_ref(x, dt, A, B, C, D, state)
        y0, state = ssd_chunkwise(x[:, :cut], dt[:, :cut], A, B[:, :cut],
                                  C[:, :cut], D, state, chunk)
        y1, state = ssd_recurrent_ref(x[:, cut:], dt[:, cut:], A,
                                      B[:, cut:], C[:, cut:], D, state)
        return torch.cat([y0, y1], dim=1), state
    if state is None:
        state = x.new_zeros((b, h, p, B.shape[-1]), dtype=torch.float32)
    dA = dt * A                                                   # (b,l,h)
    S, ys = state, []
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        xi, dti, Bi, Ci = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        dAi = dA[:, sl].transpose(1, 2)                           # (b,h,q)
        a = torch.cumsum(dAi, dim=-1)
        Lmat = torch.exp(_segsum(dAi))                            # (b,h,q,q)
        CB = Ci @ Bi.transpose(1, 2)                              # (b,q,q)
        xdt = (xi * dti[..., None]).transpose(1, 2)               # (b,h,q,p)
        y_diag = (CB[:, None] * Lmat) @ xdt                       # (b,h,i,p)
        # the incoming state's contribution
        y_off = (Ci[:, None] @ S.transpose(-1, -2)) * \
            torch.exp(a)[..., None]                               # (b,h,i,p)
        ys.append((y_diag + y_off).transpose(1, 2))
        # the state at the chunk's end: decay from each position on
        decay_out = torch.exp(a[..., -1:] - a)                    # (b,h,q)
        S = torch.exp(a[..., -1])[..., None, None] * S + \
            (xdt * decay_out[..., None]).transpose(-1, -2) @ Bi[:, None]
    y = torch.cat(ys, dim=1)
    return y + x * D[:, None], S


def ssd_decode(x, dt, A, B, C, D, state):
    """One step of the recurrence.  x: (b, 1, h, p); B, C: (b, 1, n);
    state (b, h, p, n)."""
    dA = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    dBx = (dt[:, 0, :, None] * x[:, 0])[..., None] * B[:, 0, None, None, :]
    state = dA * state + dBx
    y = (state @ C[:, 0, None, :, None])[..., 0][:, None]         # (b,1,h,p)
    return y + x * D[:, None], state


def ssd_recurrent_ref(x, dt, A, B, C, D, state):
    """Step by step (the oracle of the tests, and a ragged tail)."""
    b, l, h, p = x.shape
    if state is None:
        state = x.new_zeros((b, h, p, B.shape[-1]), dtype=torch.float32)
    ys = []
    for t in range(l):
        y, state = ssd_decode(x[:, t:t + 1], dt[:, t:t + 1], A,
                              B[:, t:t + 1], C[:, t:t + 1], D, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


# ---------------------------------------------------------------------------
# Mamba2 block


def mamba_block_defs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h, n = cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * n
    return {
        "ln": L.norm_defs(d, cfg.norm),
        "w_in": ParamDef((d, 2 * di + 2 * n + h), ("embed", "mlp")),
        "conv_w": ParamDef((cfg.conv_width, conv_dim), ("conv", "mlp")),
        "A_log": ParamDef((h,), ("heads",), torch.float32, "zeros"),
        "D": ParamDef((h,), ("heads",), torch.float32, "ones"),
        "dt_bias": ParamDef((h,), ("heads",), torch.float32, "zeros"),
        "gn": ParamDef((di,), ("mlp",), init="ones"),
        "w_out": ParamDef((di, d), ("mlp", "embed")),
    }


def mamba_block_apply(p, x, cfg, mode, cache, chunk, tp=None):
    """One Mamba2 block on x (b, s, d): (x + block(x), new cache).
    ``cache``: {"ssm", "conv"} of this layer, or None (zeros); a one-token
    decode steps the recurrence, anything else runs the chunkwise form.
    The gated RMSNorm, ``norm(y * silu(z))`` over d_inner, is the kernel
    on the card.  With ``tp`` and ``mlp`` split over the model axis, this
    rank's part (see the module's docstring)."""
    if tp is not None and p["gn"].shape[0] < cfg.ssm_expand * x.shape[-1]:
        return _mamba_split(p, x, cfg, mode, cache, chunk, tp)
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    h, n = cfg.ssm_heads, cfg.ssm_state
    hp = di // h
    xin = L.apply_norm(p["ln"], x, cfg.norm)
    zxbcdt = torch.einsum("bsd,de->bse", xin, p["w_in"])
    z, xbc, dt_pre = zxbcdt.split([di, di + 2 * n, h], dim=-1)
    xbc, new_conv = causal_conv(xbc, p["conv_w"],
                                cache["conv"] if cache else None)
    xbc = L.silu(xbc)
    xs, B, C = xbc.split([di, n, n], dim=-1)
    xs = xs.reshape(b, s, h, hp)
    dt = softplus(dt_pre.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_state = _ssd(xs.float(), dt, A, B.float(), C.float(), p["D"],
                        cache["ssm"] if cache else None, mode, chunk)
    y = y.reshape(b, s, di)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = L.rmsnorm((y * L.silu(z.float())).to(x.dtype), p["gn"])
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    return x + out, {"ssm": new_state, "conv": new_conv}


def _ssd(xs, dt, A, B, C, D, state, mode, chunk):
    """The SSD scan of a block's heads: one decode step or chunkwise."""
    if mode == "decode" and xs.shape[1] == 1:
        return ssd_decode(xs, dt, A, B, C, D, state)
    return ssd_chunkwise(xs, dt, A, B, C, D, state, min(chunk, xs.shape[1]))


def _mamba_split(p, x, cfg, mode, cache, chunk, tp):
    """``mamba_block_apply`` on a split step (the module's docstring):
    ``w_in`` on the rank's shard (column-parallel where it is split),
    gathered and cut; the conv on the rank's channels, gathered and cut;
    the scan on its heads (every head where ``ssm_heads`` does not divide
    the model axis); the gated norm on whole rows; ``w_out``
    row-parallel.  A piece every rank computes alike is sliced; a piece
    only this rank computes with is ``cut`` (its gradient summed over the
    model axis)."""
    b, s, d = x.shape
    dt_ = x.dtype
    di = cfg.ssm_expand * d
    h, n = cfg.ssm_heads, cfg.ssm_state
    hp, cd, E = di // h, di + 2 * n, 2 * di + 2 * n + h
    h0, h1 = tp.own(p["A_log"].shape[0], h)            # the rank's heads
    c0, c1 = tp.own(p["conv_w"].shape[-1], cd)         # its conv channels
    m0, m1 = tp.own(p["gn"].shape[0], di)              # its d_inner columns
    heads = h1 - h0 < h
    xin = L.apply_norm(p["ln"], x, cfg.norm)
    if p["w_in"].shape[-1] < E:
        zx = tp.gather_out(L.split_product(tp, "bsd,de->bse", xin,
                                           p["w_in"]), -1)
    else:
        zx = torch.einsum("bsd,de->bse", xin, p["w_in"])
    z = (h0 * hp, h1 * hp)
    dts = (2 * di + 2 * n + h0, 2 * di + 2 * n + h1)
    conv = (di + c0, di + c1)
    if heads and c1 - c0 < cd:
        z, xbc, dt_pre = tp.cut(zx, -1, [z, conv, dts])
    elif heads:
        (z, dt_pre), xbc = tp.cut(zx, -1, [z, dts]), zx.narrow(-1, *conv)
    elif c1 - c0 < cd:
        xbc = tp.cut(zx, -1, [conv])[0]
        z, dt_pre = zx[..., :di], zx[..., 2 * di + 2 * n:]
    else:
        raise NotImplementedError("a Mamba2 block whose mlp products split "
                                  "but not its conv or heads")
    xbc, new_conv = causal_conv(xbc, p["conv_w"],
                                cache["conv"] if cache else None)
    xbc = L.silu(xbc)
    if c1 - c0 < cd:
        xbc = tp.gather_out(xbc, -1)
    # in f32, as the scan reads them: the ranks' partial gradients of the
    # shared B and C are summed in f32 and rounded once, as one device
    # sums its heads'
    xbc = xbc.float()
    if heads:
        xs, bc = tp.cut(xbc, -1, [(h0 * hp, h1 * hp), (di, cd)])
    else:
        xs, bc = xbc[..., :di], xbc[..., di:]
    B, C = bc.split(n, dim=-1)
    dt = softplus(dt_pre.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    state = cache["ssm"] if cache else None
    # a state that keeps every head (its rules keep them whole, as the
    # sequence-parallel rules do) beside the rank's heads: it reads its
    # heads' and hands back every head's, gathered along the model axis
    whole = heads and state is not None and state.shape[1] == h
    y, new_state = _ssd(xs.reshape(b, s, h1 - h0, hp), dt, A, B, C, p["D"],
                        state[:, h0:h1] if whole else state, mode, chunk)
    if whole:
        new_state = tp.gather_out(new_state.contiguous(), 1)
    y = (y.reshape(b, s, (h1 - h0) * hp) * L.silu(z.float())).to(dt_)
    if heads:
        y = tp.gather_out(y, -1)
    # the kernel normalizes whole rows at a unit scale; the rank keeps its
    # columns and scales them by its shard of gn
    unit = torch.ones(di, dtype=p["gn"].dtype, device=y.device)
    y = tp.cut(L.rmsnorm(y, unit), -1, [(m0, m1)])[0] * p["gn"]
    out = L.split_rows(tp, "bse,ed->bsd", y, p["w_out"], dt_)
    return x + out, {"ssm": new_state, "conv": new_conv}


# ---------------------------------------------------------------------------
# Zamba2 hybrid


class ZambaHybrid(RecurrentLM):
    """``num_layers`` Mamba2 blocks; one SHARED attention + MLP block
    applied after every ``shared_attn_period``-th Mamba layer (the
    ``segs`` full segments), then the ``rem`` tail layers.  The Mamba
    weights and cache carry two stacked axes (segs, per), the tail's one;
    the shared block's weights are one copy, its KV cache one per
    application (segs, b, len, K, dh)."""

    def _layout(self):
        cfg = self.cfg
        per = cfg.shared_attn_period
        segs = cfg.num_layers // per
        return per, segs, cfg.num_layers - segs * per

    # ---- tables ----
    def shared_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln1": L.norm_defs(cfg.d_model, cfg.norm),
                "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg.d_model, cfg.norm),
                "mlp": L.mlp_defs(cfg)}

    def param_table(self) -> dict:
        cfg = self.cfg
        per, segs, rem = self._layout()
        t = {
            "embed": L.embed_defs(cfg),
            "mamba": stack_defs(stack_defs(mamba_block_defs(cfg), per), segs),
            "shared": self.shared_block_defs(),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm),
        }
        if rem:
            t["mamba_tail"] = stack_defs(mamba_block_defs(cfg), rem)
        return t

    def cache_table(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        per, segs, rem = self._layout()
        di = cfg.ssm_expand * cfg.d_model
        h, n = cfg.ssm_heads, cfg.ssm_state
        hp = di // h
        conv_dim = di + 2 * n
        kv_len = min(max_len, cfg.window) if cfg.window else max_len

        def m_def(lead, shape, axes, dtype=torch.float32):
            return ParamDef(lead + shape, ("layers",) * len(lead) + axes,
                            dtype, "zeros")

        def kv():
            return m_def((segs,), (batch, kv_len, cfg.num_kv_heads,
                                   cfg.head_dim),
                         ("act_batch", "act_seq", "act_kv_heads", None),
                         cfg.activation_dtype)

        def mamba(lead):
            return {"ssm": m_def(lead, (batch, h, hp, n),
                                 ("act_batch", "act_heads", None, None)),
                    "conv": m_def(lead, (batch, cfg.conv_width - 1, conv_dim),
                                  ("act_batch", None, "act_mlp"),
                                  cfg.activation_dtype)}

        t = {"mamba": mamba((segs, per)),
             # one KV cache per application of the shared block
             "shared_kv": {"k": kv(), "v": kv()},
             "index": ParamDef((), (), torch.int32, "zeros")}
        if rem:
            t["mamba_tail"] = mamba((rem,))
        return t

    # ---- per-layer weights ----
    def _split(self, params, each):
        """{"mamba": per-layer trees in (segment, layer) order, "tail":
        per-layer trees, "shared", "embed", "ln_f"}, each stacked weight's
        layers passed through ``each``."""
        per, segs, rem = self._layout()
        out = {k: params[k] for k in ("embed", "shared", "ln_f")}
        out["mamba"] = [tree_map(lambda t: each(per_layer(t, 2)[i]),
                                 params["mamba"]) for i in range(segs * per)]
        out["tail"] = [tree_map(lambda t: each(t[i]), params["mamba_tail"])
                       for i in range(rem)]
        return out

    def layer_params(self, params) -> dict:
        """Views of the stacked weights, built once per params tree."""
        if self._views[0] is not params:
            self._views = (params, self._split(params, lambda t: t))
        return self._views[1]

    def train_leaves(self, params) -> dict:
        """The weights as autograd leaves sharing their storage: each
        stacked weight as a list of per-layer trees (the Mamba layers in
        (segment, layer) order; ``mamba_tail`` only with a tail), the
        shared block and the rest as they are (the shared block's
        gradient sums over its applications)."""
        def leaf(t):
            return t.detach().requires_grad_()
        parts = self._split(params, leaf)
        out = {k: tree_map(leaf, parts[k]) for k in ("embed", "shared",
                                                    "ln_f")}
        out["mamba"] = parts["mamba"]
        if parts["tail"]:
            out["mamba_tail"] = parts["tail"]
        return out

    # ---- backbone ----
    def shared_block_apply(self, p, x, positions, mode, kv_cache):
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm)
        attn_out, new_kv = L.attention(p["attn"], h, cfg,
                                       positions=positions, mode=mode,
                                       cache=kv_cache,
                                       window=cfg.window or None,
                                       tp=self.tp)
        # XLA hands the norm the unrounded f32 sum of the residual add,
        # as in the dense block
        x, h = L.add_norm(p["ln2"], x, attn_out, cfg.norm,
                          norm_of_rounded=False)
        return x + L.mlp(p["mlp"], h, cfg, self.tp), new_kv

    def _zero_mamba(self, p, lead: tuple, b: int, device) -> dict:
        """Zeros of a Mamba layer's state (a ``lead`` of stacked layers):
        the heads and conv channels the layer's weights ``p`` hold (a
        split rank's shard of them)."""
        cfg = self.cfg
        hp = cfg.ssm_expand * cfg.d_model // cfg.ssm_heads
        return {"ssm": torch.zeros(lead + (b, p["A_log"].shape[0], hp,
                                           cfg.ssm_state),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros(lead + (b, cfg.conv_width - 1,
                                            p["conv_w"].shape[-1]),
                                    dtype=cfg.activation_dtype,
                                    device=device)}

    def backbone(self, lp, x, positions, mode, cache=None):
        """The blocks over x.  Prefill (``cache=None``) returns a fresh
        cache: the Mamba states in zeros, filled in place, and each shared
        application's K/V of the prompt, (segs, b, s, K, dh).  Decode
        writes ``cache`` in place.  The training forward (mode ``full``)
        keeps no cache and runs each Mamba block under the remat policy.
        On a split step each Mamba layer's weights are gathered along
        ``data`` for the layer, the shared block's once for every
        application."""
        cfg, tp = self.cfg, self.tp
        per, segs, rem = self._layout()
        chunk = cfg.ssm_chunk
        shared = self._used(lp["shared"], "shared")
        if mode == "full":
            def m_fn(p_, y_, path):
                p_ = self._used(p_, path)
                zero = self._zero_mamba(p_, (), y_.shape[0], y_.device)
                return mamba_block_apply(p_, y_, cfg, mode, zero, chunk,
                                         tp)[0]
            m_fn = remat_wrap(m_fn, self.remat)
            for s_ in range(segs):
                for j in range(per):
                    x = m_fn(lp["mamba"][s_ * per + j], x, "mamba")
                x, _ = self.shared_block_apply(shared, x, positions, mode,
                                               None)
            for p_ in lp["tail"]:
                x = m_fn(p_, x, "mamba_tail")
            return x, None
        fresh = cache is None
        if fresh:
            b = x.shape[0]
            cache = {"mamba": self._zero_mamba(lp["mamba"][0], (segs, per),
                                               b, x.device),
                     "index": torch.tensor(0, dtype=torch.int32)}
            if rem:
                cache["mamba_tail"] = self._zero_mamba(lp["tail"][0], (rem,),
                                                       b, x.device)
            ks, vs = [], []

        def mamba(p_, path, x, c):
            x, nc = mamba_block_apply(self._used(p_, path), x, cfg, mode, c,
                                      chunk, tp)
            for k, v in nc.items():
                c[k].copy_(v)
            return x

        mc = cache["mamba"]
        for s_ in range(segs):
            for j in range(per):
                x = mamba(lp["mamba"][s_ * per + j], "mamba", x,
                          {k: v[s_, j] for k, v in mc.items()})
            kv = None if fresh else {
                "k": cache["shared_kv"]["k"][s_],
                "v": cache["shared_kv"]["v"][s_],
                "index": cache["index"], "layout": "contiguous",
                "seq_split": cache.get("seq_split")}
            x, new_kv = self.shared_block_apply(shared, x, positions, mode,
                                                kv)
            if fresh:
                ks.append(new_kv["k"])
                vs.append(new_kv["v"])
        for i, p_ in enumerate(lp["tail"]):
            x = mamba(p_, "mamba_tail", x,
                      {k: v[i] for k, v in cache["mamba_tail"].items()})
        if fresh:
            cache["shared_kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        cache["index"] = cache["index"] + x.shape[1]
        return x, cache

    # ---- entry points ----
    def full_forward(self, leaves, batch):
        """The training forward over ``train_leaves``: (logits, None)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(leaves, tokens)
        lp = dict(leaves, tail=leaves.get("mamba_tail", []))
        x, _ = self.backbone(lp, x, positions, "full")
        return self._logits(leaves, x), None

    def prefill(self, params, batch):
        """Whole-prompt forward: last-position logits and a fresh cache,
        its 0-d index (s) on the host."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(params, tokens)
        x, cache = self.backbone(self.layer_params(params), x, positions,
                                 "prefill")
        return self._logits(params, x[:, -1:].contiguous()), cache

    def decode_step(self, params, cache, tokens):
        """s tokens a row over ``cache`` (written in place; its shared K/V
        grown for them): the logits and the cache, its index advanced."""
        b, s = tokens.shape
        at = int(cache["index"])
        positions = torch.arange(at, at + s,
                                 device=tokens.device).expand(b, s)
        x = self._embed(params, tokens)
        x, cache = self.backbone(self.layer_params(params), x, positions,
                                 "decode", dict(cache))
        return self._logits(params, x), cache
