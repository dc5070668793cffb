"""Whisper-style encoder-decoder, arch ``whisper-tiny`` (port of
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (b, s, d_model).  The encoder adds f32
sinusoidal positions, cast to the frames' dtype, and runs pre-norm
blocks of non-causal self-attention and MLP, then ``enc_ln_f``.  The
decoder is causal, with learned positions, and each of its blocks
cross-attends the encoder's output between its self-attention and its
MLP.  A prefill caches each decoder layer's self K/V and cross K/V (of
the encoder's length, computed once); the legacy serve path grows the
self K/V for the tokens to come (``launch/serve.py`` ``grow_kv``), and
every decode step reads the cross K/V as they are.

Cross-attention is one function on every path (``layers.attention``
with ``kv_source``): the cached cross K/V include the ``bk`` and ``bv``
biases, and a decode step's cross query includes ``bq``.  The reference
leaves them out there (its prefill's ``xk`` and ``xv`` and its decode
step's cross query are bare projections), so once the biases are
nonzero, after one training step, its decode departs from its own
teacher-forced forward.  Under the reference's zero biases both compute
the same values.

The weights carry a leading ``layers`` axis per stack (``enc_blocks``,
``dec_blocks``); a Python loop over per-layer views takes the place of
``lax.scan``.  Each block's residual stream is rounded to bf16 at its
end (the scan's carry), and a norm that reads a residual sum inside a
block reads the unrounded f32 sum where XLA hands it so (``add_norm``).
A LayerNorm config: no hand-written kernel runs on it.

A train or serve step split over a mesh sets ``tp`` (``sharding.split``)
on the model, as on ``DenseLM``: each block's weight shards gathered
along ``data`` inside the block (the remat recompute gathers them
again), the encoder's and the decoder's self-attention and the
cross-attention by heads, the MLP by ``mlp``, the tied embedding and
unembedding by vocabulary, the loss reduced over the model axis where
the logits are split; a decode reads its shard of the self and cross
K/V where they rest (a cache split along its sequence says so by its
``seq_split`` flag: the cross K/V's shards are gathered a layer at a
time).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, tree_map
from repro_torch.models.transformer import remat_wrap, stack_defs


class EncDecLM:
    """Encoder over frames, causal decoder with cross-attention."""

    def __init__(self, cfg, remat: str = "dots"):
        self.cfg = cfg
        self.remat = remat
        self._enc_cfg = cfg.replace(causal=False)    # non-causal encoder
        self._views = (None, None)   # (params, their per-layer views)
        # the split of a mesh train or serve step while it runs, else None
        self.tp = None

    def _used(self, tree, *path):
        """Weights at params ``path`` as a layer uses them: as they are,
        or in a split step gathered along ``data`` (``Split.use``)."""
        return tree if self.tp is None else self.tp.use(tree, path)

    def _table(self, params, *names) -> dict:
        e = params["embed"]
        return {k: self._used(e[k], "embed", k) for k in names if k in e}

    # ---- tables ----
    def enc_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln1": L.norm_defs(cfg.d_model, cfg.norm),
                "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg.d_model, cfg.norm),
                "mlp": L.mlp_defs(cfg)}

    def dec_block_defs(self) -> dict:
        d = self.enc_block_defs()
        d["ln_x"] = L.norm_defs(self.cfg.d_model, self.cfg.norm)
        d["xattn"] = L.attention_defs(self.cfg)
        return d

    def param_table(self) -> dict:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "enc_blocks": stack_defs(self.enc_block_defs(),
                                     cfg.num_encoder_layers),
            "enc_ln_f": L.norm_defs(cfg.d_model, cfg.norm),
            "dec_blocks": stack_defs(self.dec_block_defs(), cfg.num_layers),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm),
        }

    def batch_table(self, shape: ShapeConfig) -> dict:
        """The reference's inputs, in its order (the synthetic source draws
        the leaves in this order): frames of the prompt's length, then
        the tokens (and labels to train on); a decode step's token (the
        cross K/V are in the cache)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        tok = ParamDef((b, s), ("act_batch", "act_seq"), torch.int32,
                       "zeros")
        if shape.kind == "decode":
            return {"tokens": ParamDef((b, 1), ("act_batch", None),
                                       torch.int32, "zeros")}
        base = {"frames": ParamDef((b, s, cfg.d_model),
                                   ("act_batch", "act_seq", "act_embed"),
                                   cfg.activation_dtype, "zeros"),
                "tokens": tok}
        if shape.kind == "train":
            base["labels"] = tok
        return base

    def cache_table(self, batch: int, max_len: int) -> dict:
        """Self and cross K/V, (layers, b, max_len, K, dh) each (the cross
        K/V's length is the encoder's; a dry run takes max_len for both),
        and the 0-d index."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        ax = ("layers", "act_batch", "act_seq", "act_kv_heads", None)

        def d():
            return ParamDef(kv, ax, cfg.activation_dtype, "zeros")
        return {"k": d(), "v": d(), "xk": d(), "xv": d(),
                "index": ParamDef((), (), torch.int32, "zeros")}

    # ---- per-layer weights ----
    def layer_params(self, params) -> tuple[list, list]:
        """(encoder layer trees, decoder layer trees): views of the stacked
        weights, built once per params tree."""
        if self._views[0] is not params:
            cfg = self.cfg
            self._views = (params, (
                [tree_map(lambda t: t[i], params["enc_blocks"])
                 for i in range(cfg.num_encoder_layers)],
                [tree_map(lambda t: t[i], params["dec_blocks"])
                 for i in range(cfg.num_layers)]))
        return self._views[1]

    def train_leaves(self, params) -> dict:
        """The weights as autograd leaves sharing their storage, each
        stacked weight as a list of per-layer trees."""
        def leaf(t):
            return t.detach().requires_grad_()
        cfg = self.cfg
        out = {k: tree_map(leaf, params[k])
               for k in ("embed", "enc_ln_f", "ln_f")}
        for k, n in (("enc_blocks", cfg.num_encoder_layers),
                     ("dec_blocks", cfg.num_layers)):
            out[k] = [tree_map(lambda t: leaf(t[i]), params[k])
                      for i in range(n)]
        return out

    # ---- encoder ----
    def enc_block_apply(self, p, y):
        cfg, tp = self.cfg, self.tp
        p = self._used(p, "enc_blocks")
        b, s = y.shape[:2]
        h = L.apply_norm(p["ln1"], y, cfg.norm)
        attn_out, _ = L.attention(
            p["attn"], h, self._enc_cfg,
            positions=torch.zeros((b, s), dtype=torch.int32,
                                  device=y.device), mode="full", tp=tp)
        # XLA hands the norm the unrounded f32 residual sum
        y, h = L.add_norm(p["ln2"], y, attn_out, cfg.norm,
                          norm_of_rounded=False)
        return y + L.mlp(p["mlp"], h, cfg, tp)

    def encode(self, layers, ln_f, frames, block=None):
        """The encoder's output over ``frames`` (b, s, d): the frames plus
        their sinusoidal positions, the blocks (each through ``block``,
        a remat-wrapped ``enc_block_apply`` in training), ``enc_ln_f``."""
        cfg = self.cfg
        s = frames.shape[1]
        pe = L.sinusoidal_positions(s, cfg.d_model, frames.device)
        x = frames + pe.to(frames.dtype)
        block = block or self.enc_block_apply
        for lp in layers:
            x = block(lp, x)
        return L.apply_norm(self._used(ln_f, "enc_ln_f"), x, cfg.norm)

    # ---- decoder ----
    def dec_block_apply(self, p, x, enc_out, positions, mode, cache):
        """One decoder block: causal self-attention (``mode`` full, prefill
        or decode over ``cache``'s self K/V), cross-attention onto
        ``enc_out`` (decode: onto ``cache``'s cross K/V), the MLP.
        Returns (x, the prefill's fresh {"k", "v", "xk", "xv"} or None).
        A cache split along its sequence (``seq_split``) gathers each
        cross K/V's shards for the layer."""
        cfg, tp = self.cfg, self.tp
        p = self._used(p, "dec_blocks")
        h = L.apply_norm(p["ln1"], x, cfg.norm)
        self_cache = None if cache is None else {
            k: cache.get(k) for k in ("k", "v", "index", "layout",
                                      "seq_split")}
        attn_out, new_self = L.attention(p["attn"], h, cfg,
                                         positions=positions, mode=mode,
                                         cache=self_cache, tp=tp)
        x, h = L.add_norm(p["ln_x"], x, attn_out, cfg.norm,
                          norm_of_rounded=False)
        source = enc_out
        if mode == "decode":
            source = (cache["xk"], cache["xv"])
            if cache.get("seq_split"):
                source = tuple(tp.gather_seq(t) for t in source)
        xo, new_cross = L.attention(
            p["xattn"], h, cfg, positions=positions,
            mode="prefill" if mode == "prefill" else "full",
            kv_source=source, tp=tp)
        x, h = L.add_norm(p["ln2"], x, xo, cfg.norm, norm_of_rounded=False)
        x = x + L.mlp(p["mlp"], h, cfg, tp)
        if mode != "prefill":
            return x, None
        return x, {"k": new_self["k"], "v": new_self["v"],
                   "xk": new_cross["k"], "xv": new_cross["v"]}

    def _embed(self, params, tokens, positions):
        return L.embed(self._table(params, "embedding", "pos_embedding"),
                       tokens, self.cfg, positions, tp=self.tp)

    def _logits(self, params, x):
        """The logits of the stream (on a split step this rank's
        vocabulary columns, where the tied table is split by them)."""
        h = L.apply_norm(self._used(params["ln_f"], "ln_f"), x,
                         self.cfg.norm)
        return L.unembed(self._table(params, "embedding"), h, self.cfg,
                         tp=self.tp)

    def _positions(self, tokens, start: int = 0):
        b, s = tokens.shape
        return torch.arange(start, start + s,
                            device=tokens.device).expand(b, s)

    # ---- entry points ----
    def full_forward(self, leaves, batch):
        """The training forward over ``train_leaves``: the logits of every
        position (and None: no aux loss), each block under the remat
        policy."""
        tokens = batch["tokens"]
        enc_out = self.encode(leaves["enc_blocks"], leaves["enc_ln_f"],
                              batch["frames"],
                              remat_wrap(self.enc_block_apply, self.remat))
        positions = self._positions(tokens)
        x = self._embed(leaves, tokens, positions)

        def dec(p, y, e):
            return self.dec_block_apply(p, y, e, positions, "full", None)[0]
        dec = remat_wrap(dec, self.remat)
        for lp in leaves["dec_blocks"]:
            x = dec(lp, x, enc_out)
        return self._logits(leaves, x), None

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

    def prefill(self, params, batch):
        """Frames and prompt at once: the last position's logits and a
        fresh contiguous cache, its 0-d index (the prompt's length) on the
        host.  The frames and the prompt may differ in length."""
        tokens = batch["tokens"]
        enc_layers, dec_layers = self.layer_params(params)
        enc_out = self.encode(enc_layers, params["enc_ln_f"],
                              batch["frames"])
        positions = self._positions(tokens)
        x = self._embed(params, tokens, positions)
        fresh = []
        for lp in dec_layers:
            x, nc = self.dec_block_apply(lp, x, enc_out, positions,
                                         "prefill", None)
            fresh.append(nc)
        cache = {k: torch.stack([c[k] for c in fresh])
                 for k in ("k", "v", "xk", "xv")}
        cache.update(index=torch.tensor(tokens.shape[1], dtype=torch.int32),
                     layout="contiguous")
        return self._logits(params, x[:, -1:].contiguous()), cache

    def decode_step(self, params, cache, tokens):
        """s tokens a row, the whole batch at the cache's 0-d index: each
        layer's self K/V written in place at it (the cache grown for them
        beforehand), the cross K/V read as they are.  Returns the logits
        and the cache, its index advanced."""
        if cache["index"].dim() != 0:
            raise ValueError("the enc-dec model decodes the whole batch at "
                             "one length (a 0-d index)")
        at = int(cache["index"])
        positions = self._positions(tokens, at)
        x = self._embed(params, tokens, positions)
        for i, lp in enumerate(self.layer_params(params)[1]):
            layer_cache = {k: cache[k][i] for k in ("k", "v", "xk", "xv")}
            layer_cache.update(index=cache["index"], layout=cache["layout"],
                               seq_split=cache.get("seq_split"))
            x, _ = self.dec_block_apply(lp, x, None, positions, "decode",
                                        layer_cache)
        return self._logits(params, x), dict(
            cache, index=cache["index"] + tokens.shape[1])
