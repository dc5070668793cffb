"""Decoder-only transformer LM, dense family, and the model of each
family (port of ``repro/models/transformer.py``).

The parameter table is the reference's: per-block weights carry a
leading ``layers`` axis.  A Python loop over per-layer views of those
stacked tensors takes the place of ``lax.scan``; each layer's pool slice
``cache["k"][i]`` is a view, so the in-place K/V writes of the decode and
chunk modes land in the pool's own storage.

Each residual add runs fused into the norm that reads its sum
(``layers.add_norm``, one kernel on the card): the attention's add into
the block's second norm, and the MLP's add into the next block's first
norm, or into ``ln_f`` after the last block.  So a block hands on its
stream and its MLP output unsummed, and the layer loops carry the pair.

Training (``loss``) runs the ``full`` forward over ``train_leaves``: one
autograd leaf per weight and per layer of a stacked weight, each sharing
its storage with the stacked tensor, so each layer has its own ``.grad``
and an in-place update of a leaf is an update of the stacked weight that
serving and checkpoints read.  Each block runs under the remat policy
(``remat_wrap``).  In a train step split over a mesh, ``tp`` is the
step's ``sharding.split.Split``: the leaves are the rank's shards, each
gathered along ``data`` where its layer (or the embedding, or the head)
uses it, inside the block so that the remat recompute gathers it again,
and the products run split along the model axis (``layers``).

Decode takes a pool's slot-wise cache (a ``(slots,)`` index) or, on the
legacy fixed-batch serve path, the cache ``prefill`` returns: the whole
batch at one length, a 0-d index kept on the host.

A serve step split over a mesh sets ``tp`` the same way (a
``sharding.split.ServeSplit``) for ``prefill``, ``chunk_prefill`` and
``decode_step``: each layer's weight shards are gathered along ``data``
for that layer alone, the products split along the model axis, the
logits this rank's vocabulary columns (the step gathers them), and the
cache read where it rests (a cache split along its sequence says so by
its ``seq_split`` flag).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, _map_table, tree_map


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the output of every matrix product without batch dimensions
    (the projections: ``einsum`` runs them as a bmm of batch 1), recompute
    the rest: JAX's ``dots_with_no_batch_dims_saveable``."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_wrap(fn, policy: str):
    """``fn`` under a remat policy: ``none`` keeps every activation its
    backward needs, ``full`` keeps only its inputs and recomputes the rest
    in the backward, ``dots`` keeps the projections' outputs and
    recomputes the norms, elementwise chains and attention scores."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_save_dots)
    raise ValueError(policy)


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a 'layers' dimension to every ParamDef in a tree."""
    return _map_table(
        defs,
        lambda d: dataclasses.replace(
            d, shape=(n,) + d.shape, logical_axes=("layers",) + d.logical_axes),
    )


def token_batch_table(shape: ShapeConfig) -> dict:
    """Declarative inputs of a shape: tokens (and labels to train on); a
    decode step's single token."""
    b, s = shape.global_batch, shape.seq_len
    tok = ParamDef((b, s), ("act_batch", "act_seq"), torch.int32, "zeros")
    if shape.kind == "train":
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        return {"tokens": tok}
    return {"tokens": ParamDef((b, 1), ("act_batch", None), torch.int32,
                               "zeros")}


class DenseLM:
    """Llama-style decoder: RMSNorm, RoPE GQA attention, gated SiLU MLP."""

    def __init__(self, cfg: ModelConfig, remat: str = "dots"):
        self.cfg = cfg
        self.remat = remat
        self._views = (None, [])    # (blocks dict, its per-layer views)
        # the split of a mesh train step while it runs (``Split``), else
        # None
        self.tp = None

    # ---- tables ----
    def block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln1": L.norm_defs(cfg.d_model, cfg.norm),
                "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg.d_model, cfg.norm),
                "mlp": self.mlp_defs()}

    def mlp_defs(self) -> dict:
        return L.mlp_defs(self.cfg)

    def param_table(self) -> dict:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "blocks": stack_defs(self.block_defs(), cfg.num_layers),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm),
        }

    def batch_table(self, shape: ShapeConfig) -> dict:
        return token_batch_table(shape)

    def cache_table(self, batch: int, max_len: int) -> dict:
        """The whole-batch K/V cache a prefill returns, declared (the
        sharding rules read its logical axes)."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        ax = ("layers", "act_batch", "act_seq", "act_kv_heads", None)
        return {"k": ParamDef(kv, ax, cfg.activation_dtype, "zeros"),
                "v": ParamDef(kv, ax, cfg.activation_dtype, "zeros"),
                "index": ParamDef((), (), torch.int32, "zeros")}

    # ---- block ----
    def block_apply(self, p, x, delta, positions, mode, cache):
        """One block on the residual stream ``x + delta``, ``delta`` the
        previous block's MLP output not yet added (None before the first
        block).  Returns ``(x, mlp_out, new_cache)``: the stream after the
        attention's add and this block's MLP output, whose sum the next
        norm takes (``ln_f``, in ``logits_from``, after the last block)."""
        cfg = self.cfg
        x, h = L.add_norm(p["ln1"], x, delta, cfg.norm)
        attn_out, new_cache = L.attention(p["attn"], h, cfg,
                                          positions=positions, mode=mode,
                                          cache=cache, tp=self.tp)
        # XLA evaluates the reference's bf16 residual add in f32 and hands
        # the unrounded sum to the next norm (excess precision), while the
        # residual stream itself is rounded; both are mirrored here
        x, h = L.add_norm(p["ln2"], x, attn_out, cfg.norm,
                          norm_of_rounded=False)
        return x, self.mlp_apply(p["mlp"], h), new_cache

    def mlp_apply(self, p, h):
        return L.mlp(p, h, self.cfg, self.tp)

    def layer_params(self, params) -> list[dict]:
        """Per-layer views of the stacked block weights, built once per
        params tree (a decode tick would otherwise re-slice every tensor
        of every layer)."""
        blocks = params["blocks"]
        if self._views[0] is not blocks:
            self._views = (blocks, [tree_map(lambda t: t[i], blocks)
                                    for i in range(self.cfg.num_layers)])
        return self._views[1]

    def train_leaves(self, params) -> dict:
        """The weights as autograd leaves: each tensor detached (sharing its
        storage) and set to require grad, the stacked block weights as a
        list of per-layer trees of such leaves.  Built anew for each step,
        never from ``layer_params``' views (made under no_grad by serving,
        they would carry no gradient)."""
        def leaf(t):
            return t.detach().requires_grad_()
        return {k: [tree_map(lambda t: leaf(t[i]), v)
                    for i in range(self.cfg.num_layers)]
                if k == "blocks" else tree_map(leaf, v)
                for k, v in params.items()}

    def _full_block(self, p, x, delta, positions):
        """One block of the training forward: (stream, mlp_out, aux)."""
        x, out, _ = self.block_apply(self._used(p, "blocks"), x, delta,
                                     positions, "full", None)
        return x, out, None

    def _used(self, tree, *path):
        """Weights at params ``path`` as a layer uses them: as they are,
        or in a split step gathered along ``data`` (``Split.use``)."""
        return tree if self.tp is None else self.tp.use(tree, path)

    def _table(self, params, *names) -> dict:
        """The embedding weights ``names`` (those present), as used."""
        e = params["embed"]
        return {k: self._used(e[k], "embed", k) for k in names if k in e}

    def full_forward(self, leaves, batch):
        """The training forward of ``batch`` over ``train_leaves``: logits
        (b, s, vocab) of the positions the loss reads (``loss_from``) and
        the per-layer aux losses summed in f32 (None for a dense model),
        each block under the remat policy."""
        x = self.embed_inputs(leaves, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        delta = None
        block = remat_wrap(self._full_block, self.remat)
        aux_sum = None
        for lp in leaves["blocks"]:
            x, delta, aux = block(lp, x, delta, positions)
            if aux is not None:
                aux_sum = (torch.zeros((), dtype=torch.float32,
                                       device=x.device)
                           if aux_sum is None else aux_sum) + aux
        pick = slice(self.loss_from, s)
        return self.logits_from(leaves, *_at(pick, x, delta)), aux_sum

    def loss(self, leaves, batch, weight=None):
        """Mean next-token cross entropy of ``batch`` (tokens, labels and an
        optional loss_mask) over ``train_leaves``: (loss, metrics).  A
        mesh step's ``weight`` (this rank's share of the microbatch's
        tokens) scales it."""
        logits, _ = self.full_forward(leaves, batch)
        loss = self.xent(logits, batch)
        if weight is not None:
            loss = loss * weight
        return loss, {"loss": loss}

    def xent(self, logits, batch):
        """The cross entropy of ``logits`` (over the vocabulary, or on a
        split step this rank's columns of it) against the batch's
        labels."""
        split = self.tp is not None and \
            logits.shape[-1] < self.cfg.vocab_size
        return L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"),
                              tp=self.tp if split else None)

    # ---- entry points ----
    # the first position the loss reads (a VLM's patches come before it)
    loss_from = 0

    def embed_inputs(self, params, batch):
        """The residual stream's input: the tokens' embeddings."""
        return self.embed_tokens(params, batch["tokens"])

    def embed_tokens(self, params, tokens):
        return L.embed(self._table(params, "embedding", "pos_embedding"),
                       tokens, self.cfg, tp=self.tp)

    def logits_from(self, params, x, delta=None):
        """Logits of the stream ``x + delta`` (the last block's pair)."""
        _, h = L.add_norm(self._used(params["ln_f"], "ln_f"), x, delta,
                          self.cfg.norm)
        return L.unembed(self._table(params, "embedding" if
                                     self.cfg.tie_embeddings else "unembed"),
                         h, self.cfg, tp=self.tp)

    def prefill(self, params, batch):
        """Whole-prompt forward: returns last-position logits and a fresh
        contiguous (layers, b, s, K, dh) cache whose 0-d index (s, on the
        host) is the whole batch's length.  ``batch["last"]`` picks the
        true final position of a right-padded prompt."""
        x = self.embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        delta = None
        ks, vs = [], []
        for lp in self.layer_params(params):
            x, delta, nc = self.block_apply(self._used(lp, "blocks"), x,
                                            delta, positions, "prefill",
                                            None)
            ks.append(nc["k"])
            vs.append(nc["v"])
        last = batch.get("last")
        pick = slice(s - 1, s) if last is None else slice(last, last + 1)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "index": torch.tensor(s, dtype=torch.int32),
                 "layout": "contiguous"}
        return self.logits_from(params, *_at(pick, x, delta)), cache

    def chunk_prefill(self, params, cache, tokens, slot: int, offset: int,
                      n_valid: int, kv_bound: int,
                      pages_row: torch.Tensor | None = None):
        """One prompt chunk of one request, written straight into the pool.

        tokens: (1, c) — a bucketed chunk padded past ``n_valid``; global
        positions are ``[offset, offset + c)``.  ``cache`` is the pool's,
        its ``layout`` saying which: a page pool, with ``pages_row`` the
        slot's (max_pages,) page-table row, or a contiguous slot pool.
        ``kv_bound``
        (>= offset + c) caps the KV prefix the chunk reads back.  Returns
        the logits at the chunk's last valid position and the pool cache,
        whose K/V were written in place and whose index for ``slot`` is
        now ``offset + n_valid``.
        """
        layout = cache["layout"]
        if (layout == "paged") != (pages_row is not None):
            raise ValueError(f"a {layout} pool's chunk takes "
                             f"{'a' if layout == 'paged' else 'no'} page-"
                             f"table row")
        b, c = tokens.shape
        positions = offset + torch.arange(c, device=tokens.device).expand(b, c)
        x, delta = self.embed_tokens(params, tokens), None
        for i, lp in enumerate(self.layer_params(params)):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                           "layout": layout, "slot": slot, "offset": offset,
                           "kv_bound": int(kv_bound), "pages_row": pages_row,
                           "seq_split": cache.get("seq_split")}
            x, delta, _ = self.block_apply(self._used(lp, "blocks"), x,
                                           delta, positions, "chunk",
                                           layer_cache)
        pick = slice(n_valid - 1, n_valid)
        logits = self.logits_from(params, x[:, pick], delta[:, pick])
        cache["index"][slot] = offset + n_valid
        return logits, cache

    def decode_step(self, params, cache, tokens):
        """s tokens per slot (one, or a verify burst) through the pool:
        ``cache`` holds the (layers, ...) K/V, the (slots,) index and the
        pool's ``layout``, plus for a paged pool the (slots, max_pages)
        page table and ``use_kernel``, which selects the CUDA paged-decode
        kernel over the gather path for single tokens.  A 0-d index (a
        contiguous cache from ``prefill``, its sequence axis padded) is the
        whole batch's length: every row writes and attends at it."""
        b, s = tokens.shape
        idx = cache["index"]
        if idx.dim() == 0:
            at = int(idx)
            positions = torch.arange(at, at + s,
                                     device=tokens.device).expand(b, s)
        else:
            positions = idx[:, None] + torch.arange(
                s, device=idx.device)[None, :]
        x, delta = self.embed_tokens(params, tokens), None
        paged = {"pages": cache["pages"],
                 "use_kernel": cache.get("use_kernel", False)} \
            if cache["layout"] == "paged" else {}
        for i, lp in enumerate(self.layer_params(params)):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                           "index": idx, "layout": cache["layout"],
                           "seq_split": cache.get("seq_split"), **paged}
            x, delta, _ = self.block_apply(self._used(lp, "blocks"), x,
                                           delta, positions, "decode",
                                           layer_cache)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + s,
                     "layout": cache["layout"], **paged}
        return self.logits_from(params, x, delta), new_cache


def _at(pick: slice, *ts):
    """The positions ``pick`` of each (b, s, d) tensor, contiguous (the
    RMSNorm kernel reads whole rows)."""
    return tuple(t[:, pick].contiguous() for t in ts)


def model_for(cfg: ModelConfig, remat: str = "dots"):
    """The model of ``cfg.family`` (dense, MoE, VLM, xLSTM, the Zamba2
    hybrid, enc-dec); ``remat`` is the training forward's policy."""
    if cfg.family == "dense":
        return DenseLM(cfg, remat=remat)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg, remat=remat)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM(cfg, remat=remat)
    if cfg.family == "ssm_xlstm":
        from repro_torch.models.ssm import XLSTM
        return XLSTM(cfg, remat=remat)
    if cfg.family == "hybrid_mamba":
        from repro_torch.models.mamba import ZambaHybrid
        return ZambaHybrid(cfg, remat=remat)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, remat=remat)
    raise NotImplementedError(f"no model for family {cfg.family!r}")
