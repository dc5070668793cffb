"""Paged KV cache pool — the serving stack's memory layer (port of the
paged half of ``repro/serving/pool.py``).

KV storage is a pool of fixed-size pages on the device plus a per-slot
page-table indirection on the host:

    k, v      : (layers, num_pages, page_size, kv_heads, head_dim)
    index     : (num_slots,) int32 — tokens written per slot
    page_table: (num_slots, max_pages) int32 — host-side, shipped to the
                decode step each iteration

A request holds only ``ceil(len / page_size)`` pages.  Page 0 is a
reserved junk page: inactive slots (zeroed page-table rows) scatter their
dead writes there and nothing reads it through a live page table.  Pages
grow on demand during decode (``prepare_decode``); when the pool is out
of pages the scheduler preempts a request and resumes it later.  Pages
are refcounted (``page_refs``); the slot and page allocators are
deterministic LIFO free lists, so every allocation matches the
reference's.  The contiguous layout comes in a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.target import resolve_device


class PoolExhausted(RuntimeError):
    """alloc() on a pool with no free slots / no free pages."""


class _FreeList:
    """Deterministic LIFO free list with an O(1) boolean free-mask.

    ``pop()`` hands out the lowest index first on a fresh pool; a freed
    index is the next one reissued.
    """

    def __init__(self, n: int, start: int = 0):
        self._items = list(range(n - 1 + start, start - 1, -1))
        self._mask = np.zeros((n + start,), bool)
        self._mask[start:] = True

    def __len__(self) -> int:
        return len(self._items)

    def pop(self) -> int:
        idx = self._items.pop()
        self._mask[idx] = False
        return idx

    def push(self, idx: int) -> None:
        if self._mask[idx]:
            raise ValueError(f"index {idx} is already free")
        self._mask[idx] = True
        self._items.append(idx)

    def is_free(self, idx: int) -> bool:
        return bool(self._mask[idx])


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to ``device`` (a copy, never a view: the host
    keeps mutating its page table and token buffers)."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


class PagedKVCachePool:
    """Page-table KV pool: slots hold page lists, not max_len reservations.

    ``num_pages`` counts the whole pool *including* the reserved junk page
    0, so ``num_pages - 1`` pages are allocatable.  A slot may hold at most
    ``max_pages = ceil(max_len / page_size)`` pages.  The storage lives on
    the GPU (``device=None``; raises without one) unless the caller passes
    ``device="cpu"``.
    """

    layout = "paged"

    def __init__(self, model, num_slots: int, max_len: int,
                 page_size: int = 16, num_pages: int = 0,
                 device: torch.device | str | None = None):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe") or cfg.window:
            raise NotImplementedError(
                f"the paged pool serves full-attention dense/moe families, "
                f"not {cfg.family!r} (window={cfg.window})")
        if num_slots < 1 or max_len < 1 or page_size < 1:
            raise ValueError((num_slots, max_len, page_size))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages = math.ceil(max_len / page_size)
        # default: worst case (every slot at max_len) + the junk page
        self.num_pages = num_pages or num_slots * self.max_pages + 1
        if self.num_pages < 2:
            raise ValueError(f"num_pages {self.num_pages} < 2 "
                             f"(page 0 is reserved)")
        kv_shape = (cfg.num_layers, self.num_pages, page_size,
                    cfg.num_kv_heads, cfg.head_dim)
        self.cache = {
            "k": torch.zeros(kv_shape, dtype=cfg.activation_dtype,
                             device=self.device),
            "v": torch.zeros(kv_shape, dtype=cfg.activation_dtype,
                             device=self.device),
            "index": torch.zeros((num_slots,), dtype=torch.int32,
                                 device=self.device)}
        self.page_table = np.zeros((num_slots, self.max_pages), np.int32)
        self._pages_held = np.zeros((num_slots,), np.int64)
        self._free = _FreeList(num_slots)
        self._free_pages = _FreeList(self.num_pages - 1, start=1)
        self.lengths = np.zeros((num_slots,), np.int64)  # host mirror
        self.page_refs = np.zeros((self.num_pages,), np.int32)

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def can_admit(self, prompt_len: int, active_slots=()) -> bool:
        """Admission needs a slot, pages for the prompt, and headroom for
        the in-flight requests about to cross a page boundary (reserving
        those avoids admit/preempt ping-pong under pressure)."""
        if self.num_free == 0 or prompt_len > self.max_len:
            return False
        imminent = sum(
            1 for s in active_slots
            if self.lengths[s] >= self._pages_held[s] * self.page_size)
        return self.free_pages >= self.pages_for(prompt_len) + imminent

    def can_ever_serve(self, n_tokens: int) -> bool:
        """Whether a request resident at `n_tokens` could ever fit an
        otherwise-empty pool (needs its pages all at once)."""
        return n_tokens <= self.max_len and \
            self.pages_for(n_tokens) <= self.num_pages - 1

    # -- slot / page lifecycle ---------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_slots} KV slots are in flight")
        return self._free.pop()

    def free(self, slot: int) -> None:
        """Release `slot` and drop one reference on each of its pages."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if self._free.is_free(slot):
            raise ValueError(f"slot {slot} is already free")
        for i in range(int(self._pages_held[slot])):
            self.release_page(int(self.page_table[slot, i]))
        self.page_table[slot] = 0       # dead writes land in junk page 0
        self._pages_held[slot] = 0
        self.lengths[slot] = 0
        self._free.push(slot)

    def release_page(self, page: int) -> None:
        """Drop one reference on `page`; free it at refcount zero."""
        self.page_refs[page] -= 1
        if self.page_refs[page] == 0:
            self._free_pages.push(page)
        elif self.page_refs[page] < 0:
            raise ValueError(f"page {page} released below zero references")

    def _grow(self, slot: int) -> bool:
        """Append one page to `slot`; False when the pool is starved."""
        held = int(self._pages_held[slot])
        if held >= self.max_pages:
            raise PoolExhausted(
                f"slot {slot} already holds max_pages={self.max_pages}")
        if not self._free_pages:
            return False
        page = self._free_pages.pop()
        self.page_refs[page] = 1
        self.page_table[slot, held] = page
        self._pages_held[slot] = held + 1
        return True

    # -- cache plumbing ----------------------------------------------------
    def reserve_prefix(self, slot: int, n_tokens: int) -> None:
        """Grow `slot` to hold an `n_tokens` prompt before chunked prefill
        writes into it (all pages up front)."""
        if n_tokens > self.max_len:
            raise ValueError(
                f"prefix of {n_tokens} tokens > pool max_len {self.max_len}")
        need = self.pages_for(n_tokens)
        if need - int(self._pages_held[slot]) > self.free_pages:
            raise PoolExhausted(
                f"prefix of {n_tokens} tokens needs {need} pages, "
                f"{self.free_pages} free")
        for _ in range(need - int(self._pages_held[slot])):
            self._grow(slot)

    def chunk_extras(self, slot: int) -> tuple:
        """The slot's page-table row — the chunk step scatters through it."""
        return (to_device(self.page_table[slot], self.device),)

    @property
    def kv_bound_cap(self) -> int:
        return self.max_pages * self.page_size

    def adopt(self, new_cache: dict) -> None:
        """Take the cache a chunk step returned (its own tensors, written
        in place)."""
        self.cache = new_cache

    def set_length(self, slot: int, n_tokens: int) -> None:
        self.lengths[slot] = n_tokens

    def prepare_decode(self, active_slots) -> list:
        """Grow every active slot whose next token crosses into a fresh
        page; returns the slots the pool could not serve (page-starved),
        in the order they were visited."""
        starved = []
        for slot in active_slots:
            if self.lengths[slot] >= self._pages_held[slot] * self.page_size:
                if not self._grow(slot):
                    starved.append(slot)
        return starved

    def decode_extras(self) -> tuple:
        return (to_device(self.page_table, self.device),)

    def update(self, new_cache: dict, active_slots=()) -> None:
        """Take the cache a decode step returned; the length mirror
        advances only for the slots that were active this step."""
        self.cache = new_cache
        for slot in active_slots:
            self.lengths[slot] += 1
