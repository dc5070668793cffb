"""Step builders: train (gradient accumulation, error-feedback int8
compression, the schedule, the update), prefill, chunk, decode and
verify (port of ``repro/training/steps.py``).

``build_train_step`` takes each microbatch's gradients with autograd
over the model's per-layer leaves (``DenseLM.train_leaves``) and updates
the state in place: parameters, moments, error feedback and step.

The serve builders close over the model and return a plain function of
``params`` and the step's inputs that runs without autograd.  The decode,
verify and chunk steps write K/V in place into the pool tensors they are
given and return the same tensors (the reference donates them instead).
Each comes for the contiguous slot pool and for the paged pool
(``_paged``); a pool's cache names its layout, and a step given another
layout's cache raises.  ``build_decode_step`` is the legacy fixed-batch
path's: the whole batch at one length, over a prefill's cache.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.plan import DeploymentPlan
from repro_torch.models.params import (ParamDef, _map_table, leaf_items,
                                      tree_map)
from repro_torch.optim.adamw import layers_of
from repro_torch.optim.schedule import warmup_cosine


def _accum_dtype(plan: DeploymentPlan) -> torch.dtype:
    return torch.bfloat16 if plan.grad_accum_dtype == "bfloat16" \
        else torch.float32


def _ef_int8(g: torch.Tensor, err: torch.Tensor,
             amax: torch.Tensor | None = None):
    """Error-feedback int8 quantization of a gradient contribution (it
    models a compressed cross-replica reduction): returns (the
    dequantized f32 gradient, the new error).  ``amax`` is the whole
    leaf's max |g + err| when g is one slice of it."""
    x = g.float() + err
    if amax is None:
        amax = x.abs().amax()
    scale = amax.clamp_min(1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    deq = q * scale
    return deq, x - deq


def _ef_compress(grads, ef):
    """``_ef_int8`` over every leaf, a stacked one layer by layer with its
    whole-leaf amax; ``ef`` (the tree of errors) is updated in place.
    Returns the gradients dequantized, each leaf as it came (a tensor or a
    per-layer list)."""
    if isinstance(grads, dict):
        return {k: _ef_compress(v, ef[k]) for k, v in grads.items()}
    if not isinstance(grads, list):
        deq, new = _ef_int8(grads, ef)
        ef.copy_(new)
        return deq
    ef = layers_of(ef, tuple(grads[0].shape))
    amax = torch.stack([(g.float() + ef[i]).abs().amax()
                        for i, g in enumerate(grads)]).amax()
    out = []
    for i, g in enumerate(grads):
        deq, new = _ef_int8(g, ef[i], amax)
        ef[i].copy_(new)
        out.append(deq)
    return out


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of one batch: autograd over the model's
    per-layer leaves; grads has the tree of ``params``, a stacked leaf's
    gradient as a list of per-layer tensors in the parameter's dtype."""
    leaves = model.train_leaves(params)
    loss, metrics = model.loss(leaves, batch)
    loss.backward()
    # a stacked leaf's per-layer trees -> one tree of per-layer lists
    grads = {k: tree_map(lambda *ls: list(map(_grad, ls)), *v)
             if isinstance(v, list) else tree_map(_grad, v)
             for k, v in leaves.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def build_train_step(model, opt, plan: DeploymentPlan,
                     peak_lr: float = 3e-4, warmup_steps: int = 100,
                     total_steps: int = 10_000):
    """Returns train_step(state, batch) -> (state, metrics), which updates
    ``state = {"params", "opt", "ef" (optional), "step"}`` in place.

    ``plan.microbatches`` > 1 splits the batch into that many equal
    microbatches along its first axis and accumulates their gradients in
    ``plan.grad_accum_dtype`` from zeros, then takes their mean in f32;
    the loss is the f32 mean of theirs.  ``ef_int8`` compression, the
    warm-up cosine learning rate at ``state["step"]`` and the optimizer's
    update follow, as in the reference."""
    M = plan.microbatches
    use_ef = plan.grad_compression == "ef_int8"
    acc_dt = _accum_dtype(plan)

    def train_step(state, batch):
        params = state["params"]
        if M == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % M:
                raise ValueError(f"batch {b} does not split into {M} "
                                 f"microbatches")
            n = b // M
            acc, lsum = None, None
            for i in range(M):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, mb)
                if acc is None:
                    acc = tree_map(lambda t: torch.zeros(
                        t.shape, dtype=acc_dt, device=t.device), g)
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                tree_map(lambda a, t: a.add_(t.to(a.dtype)), acc, g)
                lsum = lsum + l
            grads = tree_map(lambda t: (t / M).float(), acc)
            loss = lsum / M
            metrics = {"loss": loss}
        if use_ef:
            grads = _ef_compress(grads, state["ef"])
        lr = warmup_cosine(state["step"], peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        _, _, opt_metrics = opt.update(grads, state["opt"], params, lr)
        state["step"] = state["step"] + 1
        return state, dict(metrics, lr=lr, **opt_metrics)

    return train_step


def init_train_state(model, opt, params, plan: DeploymentPlan) -> dict:
    """{"params", "opt", "step"} (+ "ef", f32 zeros, under ef_int8), on
    the parameters' device."""
    dev = leaf_items(params)[0][1].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if plan.grad_compression == "ef_int8":
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def train_state_table(model, opt, plan: DeploymentPlan) -> dict:
    """Declarative (ParamDef) state table — dry-run path, no allocation."""
    ptable = model.param_table()
    t = {"params": ptable, "opt": opt.state_table(ptable),
         "step": ParamDef((), (), torch.int32, "zeros")}
    if plan.grad_compression == "ef_int8":
        t["ef"] = _map_table(ptable, lambda d: dataclasses.replace(
            d, dtype=torch.float32, init="zeros"))
    return t


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


def build_decode_step(model):
    """Whole-batch decode, the legacy fixed-batch serve path's step:
    ``cache`` is a prefill's contiguous cache, its sequence axis padded
    for the tokens to come and its 0-d index the whole batch's length;
    each row's token is written at that index in place.  Returns the
    logits and the cache with the index advanced."""
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        if cache["index"].dim() != 0:
            raise ValueError("the whole-batch step takes a 0-d index; a "
                             "pool's slot-wise cache goes to "
                             "build_decode_step_slots")
        return model.decode_step(params, _of_layout(cache, "contiguous"),
                                 tokens)
    return decode_step


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
