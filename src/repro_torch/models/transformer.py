"""Decoder-only transformer LM, dense family (port of
``repro/models/transformer.py``).

The parameter table is the reference's: per-block weights carry a
leading ``layers`` axis.  A Python loop over per-layer views of those
stacked tensors takes the place of ``lax.scan``; each layer's pool slice
``cache["k"][i]`` is a view, so the in-place K/V writes of the decode and
chunk modes land in the pool's own storage.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import _map_table


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a 'layers' dimension to every ParamDef in a tree."""
    return _map_table(
        defs,
        lambda d: dataclasses.replace(
            d, shape=(n,) + d.shape, logical_axes=("layers",) + d.logical_axes),
    )


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DenseLM:
    """Llama-style decoder: RMSNorm, RoPE GQA attention, gated SiLU MLP."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._views = (None, [])    # (blocks dict, its per-layer views)

    # ---- tables ----
    def block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln1": L.norm_defs(cfg.d_model, cfg.norm),
                "attn": L.attention_defs(cfg),
                "ln2": L.norm_defs(cfg.d_model, cfg.norm),
                "mlp": L.mlp_defs(cfg)}

    def param_table(self) -> dict:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "blocks": stack_defs(self.block_defs(), cfg.num_layers),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm),
        }

    # ---- block ----
    def block_apply(self, p, x, positions, mode, cache):
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm)
        attn_out, new_cache = L.attention(p["attn"], h, cfg,
                                          positions=positions, mode=mode,
                                          cache=cache)
        # XLA evaluates the reference's bf16 residual add in f32 and hands
        # the unrounded sum to the next norm (excess precision), while the
        # residual stream itself is rounded; both are mirrored here
        x_mid = x.float() + attn_out.float()
        h = L.apply_norm(p["ln2"], x_mid, cfg.norm, out_dtype=x.dtype)
        x = x_mid.to(x.dtype) + L.mlp(p["mlp"], h, cfg)
        return x, new_cache

    def layer_params(self, params) -> list[dict]:
        """Per-layer views of the stacked block weights, built once per
        params tree (a decode tick would otherwise re-slice every tensor
        of every layer)."""
        blocks = params["blocks"]
        if self._views[0] is not blocks:
            self._views = (blocks, [_index_tree(blocks, i)
                                    for i in range(self.cfg.num_layers)])
        return self._views[1]

    # ---- entry points ----
    def logits_from(self, params, x):
        x = L.apply_norm(params["ln_f"], x, self.cfg.norm)
        return L.unembed(params["embed"], x, self.cfg)

    def prefill(self, params, batch):
        """Whole-prompt forward: returns last-position logits and a fresh
        (layers, b, s, K, dh) cache.  ``batch["last"]`` picks the true final
        position of a right-padded prompt."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = L.embed(params["embed"], tokens, self.cfg)
        ks, vs = [], []
        for lp in self.layer_params(params):
            x, nc = self.block_apply(lp, x, positions, "prefill", None)
            ks.append(nc["k"])
            vs.append(nc["v"])
        last = batch.get("last")
        x_last = x[:, -1:] if last is None else x[:, last:last + 1]
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "index": torch.tensor(s, dtype=torch.int32)}
        return self.logits_from(params, x_last), cache

    def chunk_prefill(self, params, cache, tokens, slot: int, offset: int,
                      n_valid: int, kv_bound: int, pages_row: torch.Tensor):
        """One prompt chunk of one request, written straight into the page
        pool.

        tokens: (1, c) — a bucketed chunk padded past ``n_valid``; global
        positions are ``[offset, offset + c)``.  ``pages_row`` is the
        slot's (max_pages,) page-table row; ``kv_bound`` (>= offset + c)
        caps the KV prefix the chunk reads back.  Returns the logits at
        the chunk's last valid position and the pool cache, whose K/V
        were written in place and whose index for ``slot`` is now
        ``offset + n_valid``.
        """
        b, c = tokens.shape
        positions = offset + torch.arange(c, device=tokens.device).expand(b, c)
        x = L.embed(params["embed"], tokens, self.cfg)
        for i, lp in enumerate(self.layer_params(params)):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                           "offset": offset, "kv_bound": int(kv_bound),
                           "pages_row": pages_row}
            x, _ = self.block_apply(lp, x, positions, "chunk", layer_cache)
        logits = self.logits_from(params, x[:, n_valid - 1:n_valid])
        cache["index"][slot] = offset + n_valid
        return logits, cache

    def decode_step(self, params, cache, tokens):
        """One token per slot through the paged pool: ``cache`` holds the
        (layers, num_pages, page_size, K, dh) pool, the (slots,) index and
        the (slots, max_pages) page table; ``use_kernel`` selects the CUDA
        paged-decode kernel over the gather path."""
        b, s = tokens.shape
        idx = cache["index"]
        positions = idx[:, None] + torch.arange(s, device=idx.device)[None, :]
        x = L.embed(params["embed"], tokens, self.cfg)
        for i, lp in enumerate(self.layer_params(params)):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                           "index": idx, "pages": cache["pages"],
                           "use_kernel": cache.get("use_kernel", False)}
            x, _ = self.block_apply(lp, x, positions, "decode", layer_cache)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + s,
                     "pages": cache["pages"]}
        return self.logits_from(params, x), new_cache


def model_for(cfg: ModelConfig) -> DenseLM:
    """The model of ``cfg.family`` (dense only so far)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP slices D, F)")
    return DenseLM(cfg)
