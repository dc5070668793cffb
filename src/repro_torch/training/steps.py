"""Step builders for serving (port of the serve builders of
``repro/training/steps.py``).

Each builder closes over the model and returns a plain function of
``params`` and the step's inputs that runs without autograd.  The paged
decode and chunk steps write K/V in place into the pool tensors they are
given and return the same tensors (the reference donates them instead).
"""

from __future__ import annotations

import torch


def build_prefill_step(model):
    """Whole-prompt prefill: (params, {"tokens", "last"?}) -> (logits, cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


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
        return model.chunk_prefill(params, cache, tokens, slot, offset,
                                   n_valid, kv_bound, pages_row)
    return chunk_step


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
        keep = active.bool()
        safe_pages = torch.where(keep[:, None], pages, torch.zeros_like(pages))
        dcache = dict(cache, pages=safe_pages, use_kernel=use_kernel)
        logits, new_cache = model.decode_step(params, dcache, tokens)
        new_index = torch.where(keep, new_cache["index"], cache["index"])
        return logits, {"k": new_cache["k"], "v": new_cache["v"],
                        "index": new_index}
    return decode_step
