"""Step builders for serving (port of the serve builders of
``repro/training/steps.py``).

Each builder closes over the model and returns a plain function of
``params`` and the step's inputs that runs without autograd.  The decode,
verify and chunk steps write K/V in place into the pool tensors they are
given and return the same tensors (the reference donates them instead).
Each comes for the contiguous slot pool and for the paged pool
(``_paged``); a pool's cache names its layout, and a step given another
layout's cache raises.
"""

from __future__ import annotations

import torch


def _of_layout(cache: dict, layout: str) -> dict:
    """``cache`` stamped with the step's ``layout``: a pool's cache names
    its own, which must agree; a bare dict of tensors takes the step's."""
    if cache.get("layout", layout) != layout:
        raise ValueError(f"a {layout} step was given a {cache['layout']} "
                         f"pool's cache")
    return dict(cache, layout=layout)


def build_prefill_step(model):
    """Whole-prompt prefill: (params, {"tokens", "last"?}) -> (logits, cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def build_prefill_chunk_step(model):
    """Chunked prefill straight into a contiguous KV pool: ``cache`` holds
    K/V ``(layers, num_slots, max_len, kv_heads, head_dim)`` and the
    per-slot index; the chunk's K/V land at ``[slot, offset:offset+c)``
    and the chunk attends over the slot's first ``kv_bound`` positions."""
    @torch.no_grad()
    def chunk_step(params, cache, tokens, slot, offset, n_valid, kv_bound):
        return model.chunk_prefill(params, _of_layout(cache, "contiguous"),
                                   tokens, slot, offset, n_valid, kv_bound)
    return chunk_step


def build_prefill_chunk_step_paged(model):
    """Chunked prefill straight into a paged KV pool.

    ``cache`` holds the page pool ``(layers, num_pages, page_size,
    kv_heads, head_dim)`` and the per-slot index; ``pages_row`` is the
    slot's ``(max_pages,)`` page-table row: chunk token at global
    position j lands in page ``pages_row[j // page_size]`` at offset
    ``j % page_size`` — its final resting place, one write.  Pages must
    be reserved by the pool before the call; rows past the reserved
    region (bucket padding) fall into the junk page 0.
    """
    @torch.no_grad()
    def chunk_step(params, cache, tokens, slot, offset, n_valid, kv_bound,
                   pages_row):
        return model.chunk_prefill(params, _of_layout(cache, "paged"),
                                   tokens, slot, offset, n_valid, kv_bound,
                                   pages_row)
    return chunk_step


def build_decode_step_slots(model):
    """Slot-wise decode over a contiguous KV pool.  Inactive slots ride
    through the step (each writes only its own row, at its own stale
    index) but their lengths do not advance."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, active):
        cache = _of_layout(cache, "contiguous")
        logits, new_cache = model.decode_step(params, cache, tokens)
        new_index = torch.where(active.bool(), new_cache["index"],
                                cache["index"])
        return logits, dict(cache, index=new_index)
    return decode_step


def build_decode_step_slots_paged(model, use_kernel: bool = False):
    """Slot-wise decode over a paged KV pool.

    ``active`` flags the slots holding a live request; the
    ``(num_slots, max_pages)`` int32 page table arrives each step.
    Inactive rows (freed slots, or slots mid-prefill whose index is
    stale) must not write through their page table — with a shared
    prefix a stale write would land in a page others attend — so their
    rows divert to the reserved junk page 0, and their lengths do not
    advance.  ``use_kernel=True`` attends through the CUDA paged-decode
    kernel (its plain version for CPU tensors) instead of the gather
    path.
    """
    @torch.no_grad()
    def decode_step(params, cache, tokens, active, pages):
        cache = _of_layout(cache, "paged")
        keep = active.bool()
        safe_pages = torch.where(keep[:, None], pages, torch.zeros_like(pages))
        dcache = dict(cache, pages=safe_pages, use_kernel=use_kernel)
        logits, new_cache = model.decode_step(params, dcache, tokens)
        new_index = torch.where(keep, new_cache["index"], cache["index"])
        return logits, dict(cache, index=new_index)
    return decode_step


def build_verify_step_slots(model):
    """Speculative verify step over a contiguous KV pool: ``tokens`` is
    ``(num_slots, k+1)`` — each row's pending token and its k drafts —
    and the step returns logits at every position ``(num_slots, k+1,
    vocab)``.  Positions past a slot's max_len are dropped; a rejected
    draft's KV is overwritten before any causal mask admits it.  The
    returned index is the one given: how many positions became tokens is
    the host's decision (``pool.sync_index``)."""
    @torch.no_grad()
    def verify_step(params, cache, tokens, active):
        cache = _of_layout(cache, "contiguous")
        logits, _ = model.decode_step(params, cache, tokens)
        return logits, cache
    return verify_step


def build_verify_step_slots_paged(model):
    """Speculative verify step over a paged KV pool: as
    ``build_verify_step_slots`` plus the page table; inactive rows divert
    to the junk page 0 as in ``build_decode_step_slots_paged``, and each
    position's page lookup keeps the junk-page ok-guard, so a burst past
    a slot's page run never writes into a live page.  The burst always
    reads through the gather path (the paged-decode kernel takes single
    tokens)."""
    @torch.no_grad()
    def verify_step(params, cache, tokens, active, pages):
        cache = _of_layout(cache, "paged")
        keep = active.bool()
        safe_pages = torch.where(keep[:, None], pages, torch.zeros_like(pages))
        logits, _ = model.decode_step(params, dict(cache, pages=safe_pages),
                                      tokens)
        return logits, cache
    return verify_step
