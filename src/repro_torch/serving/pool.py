"""KV cache pools — the serving stack's memory layer, in two layouts
(port of ``repro/serving/pool.py``).

``KVCachePool`` (contiguous) holds one ``max_len`` row per slot:

    k, v : (layers, num_slots, max_len, kv_heads, head_dim)
    index: (num_slots,) int32 — tokens written per slot

Every admitted request pins ``max_len`` positions for its whole life.
``PagedKVCachePool`` breaks that reservation: KV storage is a pool of
fixed-size pages on the device plus a per-slot page-table indirection on
the host:

    k, v      : (layers, num_pages, page_size, kv_heads, head_dim)
    index     : (num_slots,) int32 — tokens written per slot
    page_table: (num_slots, max_pages) int32 — host-side, shipped to the
                decode step each iteration

A request holds only ``ceil(len / page_size)`` pages.  Page 0 is a
reserved junk page: inactive slots (zeroed page-table rows) scatter their
dead writes there and nothing reads it through a live page table.  Pages
grow on demand during decode (``prepare_decode``); when the pool is out
of pages the scheduler preempts a request and resumes it later.  Pages
are refcounted (``page_refs``): normally a page has one owner, but an
attached shared-prefix cache (``serving/prefix_cache.PrefixCache``) lets
several requests — and the cache itself — reference one page, and
``free`` then only decrements; a page rejoins the free list at refcount
zero, so a preempted sharer never frees a page another request reads.
Cache-only pages (``page_cached`` at refcount 1, counted in
``reclaimable_pages``) count as free for admission and the router's load
signal, and a starved free list reclaims them (LRU) before anyone is
preempted.  The slot and page allocators are deterministic LIFO free
lists, so every allocation matches the reference's.  Both pools take
speculative verify bursts (``grow_for_burst``, ``sync_index``).

Each pool's cache dict carries its ``layout`` ("contiguous" or
"paged"): the steps and the model read the layout from there, so the
pool is the one place that decides how K/V are addressed.

On a mesh of ranks a pool's K/V rest as DTensors under specs, each rank
allocating its shard alone: a contiguous pool's under the cache table's
(rows along ``data``; KV heads, or the sequence where the KV heads do
not divide it, along ``model``), a paged pool's under ``paged_specs``
(whole along ``data``; KV heads along ``model`` where they divide it).
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


def _check_servable(cfg) -> None:
    if cfg.family not in ("dense", "moe") or cfg.window:
        raise NotImplementedError(
            f"KV pools serve full-attention dense/moe families, not "
            f"{cfg.family!r} (window={cfg.window})")


def _kv_cache(cfg, layout: str, rows: int, cols: int, num_slots: int,
              device, mesh=None, specs=None) -> dict:
    """Zeroed K/V storage ``(layers, rows, cols, kv_heads, head_dim)``, the
    per-slot index, and the pool's layout.  On a mesh of ranks the K/V
    rest under ``specs`` (``sharding.rules.zeros_at_rest``)."""
    shape = (cfg.num_layers, rows, cols, cfg.num_kv_heads, cfg.head_dim)

    def zeros(name):
        if specs is None:
            return torch.zeros(shape, dtype=cfg.activation_dtype,
                               device=device)
        from repro_torch.sharding.rules import zeros_at_rest
        return zeros_at_rest(shape, cfg.activation_dtype, specs[name], mesh,
                             device)
    return {"k": zeros("k"), "v": zeros("v"),
            "index": torch.zeros((num_slots,), dtype=torch.int32,
                                 device=device),
            "layout": layout}


def paged_specs(model, num_pages: int, page_size: int, mesh, rules) -> dict:
    """The specs a paged pool's K/V rest under on ``mesh``: whole along
    every axis but the KV heads, which follow ``act_kv_heads``'s rule
    (``model``, where it divides them; else whole)."""
    from repro_torch.models.params import ParamDef, partition_specs
    cfg = model.cfg
    d = ParamDef((cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                  cfg.head_dim), ("layers", None, None, "act_kv_heads", None),
                 cfg.activation_dtype, "zeros")
    return partition_specs({"k": d, "v": d}, mesh, rules)


class _LengthMirror:
    """What both pools share: the host mirror of each slot's KV length
    (``lengths``), the device cache whose ``index`` it uploads, and the
    attached shared-prefix cache (None: none; paged pools only)."""

    prefix_cache = None

    def sync_index(self) -> None:
        """Upload the host length mirror as the device index (a verify
        step leaves the index as it was: acceptance is the host's)."""
        self.cache = dict(self.cache, index=to_device(
            self.lengths.astype(np.int32), self.device))

    def update(self, new_cache: dict, active_slots=()) -> None:
        """Take the cache a decode step returned; the length mirror
        advances only for the slots that were active this step."""
        self.cache = new_cache
        for slot in active_slots:
            self.lengths[slot] += 1


class KVCachePool(_LengthMirror):
    """Fixed-capacity contiguous slot pool: one ``max_len`` row of K/V per
    slot.  The storage lives on the GPU (``device=None``; raises without
    one) unless the caller passes ``device="cpu"``.  On a mesh of ranks
    (``mesh``, and ``specs`` the cache table's) the K/V rest as DTensors
    under their specs, each rank allocating its shard alone."""

    layout = "contiguous"

    def __init__(self, model, num_slots: int, max_len: int,
                 device: torch.device | str | None = None, mesh=None,
                 specs=None):
        cfg = model.cfg
        _check_servable(cfg)
        if num_slots < 1 or max_len < 1:
            raise ValueError((num_slots, max_len))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache = _kv_cache(cfg, self.layout, num_slots, max_len,
                               num_slots, self.device, mesh, specs)
        self._free = _FreeList(num_slots)
        self.lengths = np.zeros((num_slots,), np.int64)  # host mirror

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def free_tokens(self) -> int:
        """Admittable KV tokens left (free worst-case slots) — the load
        signal a router's least-loaded policy balances."""
        return self.num_free * self.max_len

    def can_admit(self, prompt_len: int, active_slots=(),
                  hit=None) -> bool:
        """A contiguous slot IS the worst-case reservation: one free slot
        admits any prompt that fits max_len (``hit``, a prefix-cache
        probe, applies to paged pools only)."""
        return self.num_free > 0 and prompt_len <= self.max_len

    def can_ever_serve(self, n_tokens: int) -> bool:
        return n_tokens <= self.max_len

    # -- slot lifecycle ----------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_slots} KV slots are in flight")
        return self._free.pop()

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if self._free.is_free(slot):
            raise ValueError(f"slot {slot} is already free")
        self.lengths[slot] = 0
        self._free.push(slot)

    # -- cache plumbing ----------------------------------------------------
    def reserve_prefix(self, slot: int, n_tokens: int) -> None:
        """A slot IS the reservation: bounds-check only."""
        if n_tokens > self.max_len:
            raise ValueError(
                f"prefix of {n_tokens} tokens > pool max_len {self.max_len}")

    def chunk_extras(self, slot: int) -> tuple:
        return ()

    @property
    def kv_bound_cap(self) -> int:
        return self.max_len

    def adopt(self, new_cache: dict) -> None:
        self.cache = new_cache

    def set_length(self, slot: int, n_tokens: int) -> None:
        self.lengths[slot] = n_tokens

    def prepare_decode(self, active_slots) -> list:
        """Contiguous slots never grow: nothing can starve."""
        return []

    def decode_extras(self) -> tuple:
        return ()

    def grow_for_burst(self, slot: int, want_tokens: int) -> int:
        """KV positions backed for a verify burst from the slot's length:
        its headroom below max_len."""
        return max(int(min(want_tokens, self.max_len - self.lengths[slot])),
                   0)


class PagedKVCachePool(_LengthMirror):
    """Page-table KV pool: slots hold page lists, not max_len reservations.

    ``num_pages`` counts the whole pool *including* the reserved junk page
    0, so ``num_pages - 1`` pages are allocatable.  A slot may hold at most
    ``max_pages = ceil(max_len / page_size)`` pages.  The storage lives on
    the GPU (``device=None``; raises without one) unless the caller passes
    ``device="cpu"``.  On a mesh of ranks (``mesh``, and ``specs``
    ``paged_specs``') the K/V rest as DTensors under their specs.
    """

    layout = "paged"

    def __init__(self, model, num_slots: int, max_len: int,
                 page_size: int = 16, num_pages: int = 0,
                 device: torch.device | str | None = None, mesh=None,
                 specs=None):
        cfg = model.cfg
        _check_servable(cfg)
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
        self.cache = _kv_cache(cfg, self.layout, self.num_pages, page_size,
                               num_slots, self.device, mesh, specs)
        self.page_table = np.zeros((num_slots, self.max_pages), np.int32)
        self._pages_held = np.zeros((num_slots,), np.int64)
        self._free = _FreeList(num_slots)
        self._free_pages = _FreeList(self.num_pages - 1, start=1)
        self.lengths = np.zeros((num_slots,), np.int64)  # host mirror
        # owners per page: the allocating request, each prefix-cache
        # sharer and the cache cell itself hold one reference each.
        # page_cached flags cache-pinned pages; _cache_only counts those
        # no request shares (refcount exactly 1), kept on the 1 <-> 2
        # refcount transitions so admission never scans the cache
        self.page_refs = np.zeros((self.num_pages,), np.int32)
        self.page_cached = np.zeros((self.num_pages,), bool)
        self._cache_only = 0

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def reclaimable_pages(self) -> int:
        """Pages the attached prefix cache could hand back on demand
        (cache-pinned, shared with no live request): a running count."""
        return self._cache_only

    @property
    def free_tokens(self) -> int:
        """Admittable KV tokens left: free and reclaimable pages' worth,
        0 without a free page-table row.  A page shared by several
        requests is simply not free, so it is never counted twice."""
        if not self.num_free:
            return 0
        return (self.free_pages + self.reclaimable_pages) * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def can_admit(self, prompt_len: int, active_slots=(),
                  hit=None) -> bool:
        """Admission needs a slot, pages for the prompt, and headroom for
        the in-flight requests about to cross a page boundary (reserving
        those avoids admit/preempt ping-pong under pressure).

        With a prefix-cache ``hit`` only the cold suffix needs pages, and
        the hit's cache-only pages leave the spendable headroom (attaching
        pins them: counted as reclaimable too, they would be promised
        twice)."""
        if self.num_free == 0 or prompt_len > self.max_len:
            return False
        imminent = sum(
            1 for s in active_slots
            if self.lengths[s] >= self._pages_held[s] * self.page_size)
        need = self.pages_for(prompt_len)
        avail = self.free_pages + self.reclaimable_pages
        if hit is not None and hit.pages:
            need -= len(hit.pages)
            avail -= hit.pinned
        return avail >= need + imminent

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
        if self.prefix_cache is not None:
            # shared pages may just have become cache-only: keep the
            # cache inside its pin budget
            self.prefix_cache.enforce_budget()

    def release_page(self, page: int) -> None:
        """Drop one reference on `page`; free it at refcount zero.  A
        cache-pinned page whose last request reference just left becomes
        reclaimable (the cache's own reference keeps it resident)."""
        self.page_refs[page] -= 1
        if self.page_refs[page] == 0:
            self._free_pages.push(page)
        elif self.page_refs[page] < 0:
            raise ValueError(f"page {page} released below zero references")
        elif self.page_refs[page] == 1 and self.page_cached[page]:
            self._cache_only += 1

    def pin_page(self, page: int) -> None:
        """The prefix cache takes its reference on `page` (cell insert);
        the inserting request still holds it, so it is shared."""
        self.page_refs[page] += 1
        self.page_cached[page] = True

    def unpin_page(self, page: int) -> None:
        """The prefix cache drops its reference on `page` (cell evict)."""
        if self.page_refs[page] == 1:
            self._cache_only -= 1
        self.page_cached[page] = False
        self.release_page(page)

    def adopt_run(self, slot: int, pages) -> None:
        """Install a shared page run as the head of `slot`'s page table
        (prefix-cache hit), one reference per page.  The slot must hold
        nothing yet; ``reserve_prefix`` then adds the cold suffix's own
        pages."""
        if self._pages_held[slot]:
            raise ValueError(
                f"slot {slot} already holds {self._pages_held[slot]} pages; "
                f"a shared run must be adopted first")
        for i, page in enumerate(pages):
            if self.page_refs[page] == 1 and self.page_cached[page]:
                self._cache_only -= 1   # cache-only -> shared again
            self.page_refs[page] += 1
            self.page_table[slot, i] = page
        self._pages_held[slot] = len(pages)

    def _take_page(self, slot: int, held: int) -> None:
        """Pop a free page into `slot`'s table at position `held`."""
        page = self._free_pages.pop()
        self.page_refs[page] = 1
        self.page_cached[page] = False
        self.page_table[slot, held] = page
        self._pages_held[slot] = held + 1

    def _grow(self, slot: int) -> bool:
        """Append one page to `slot`; False when the pool is starved.  A
        starved free list reclaims LRU cache-only prefix pages first: the
        cache gives way before any request is preempted."""
        held = int(self._pages_held[slot])
        if held >= self.max_pages:
            raise PoolExhausted(
                f"slot {slot} already holds max_pages={self.max_pages}")
        if not self._free_pages and self.prefix_cache is not None:
            self.prefix_cache.reclaim(1)
        if not self._free_pages:
            return False
        self._take_page(slot, held)
        return True

    # -- cache plumbing ----------------------------------------------------
    def reserve_prefix(self, slot: int, n_tokens: int) -> None:
        """Grow `slot` to hold an `n_tokens` prompt before chunked prefill
        writes into it (all pages up front)."""
        if n_tokens > self.max_len:
            raise ValueError(
                f"prefix of {n_tokens} tokens > pool max_len {self.max_len}")
        need = self.pages_for(n_tokens)
        if need - int(self._pages_held[slot]) > \
                self.free_pages + self.reclaimable_pages:
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

    def grow_for_burst(self, slot: int, want_tokens: int) -> int:
        """Back up to ``want_tokens`` KV positions past ``slot``'s length
        for a verify burst, with genuinely free pages only (a burst is a
        bonus, never a reservation: it changes no admission or eviction).
        Returns how many positions are backed (>= 1 after
        ``prepare_decode``); verify writes past them divert to the junk
        page 0 and the scheduler caps acceptance at the backed count."""
        target = min(int(self.lengths[slot]) + want_tokens, self.max_len)
        while int(self._pages_held[slot]) * self.page_size < target:
            held = int(self._pages_held[slot])
            if held >= self.max_pages or not self._free_pages:
                break
            self._take_page(slot, held)
        backed = int(self._pages_held[slot]) * self.page_size \
            - int(self.lengths[slot])
        return max(min(backed, want_tokens,
                       self.max_len - int(self.lengths[slot])), 0)
