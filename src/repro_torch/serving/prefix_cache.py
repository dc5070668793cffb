"""Shared-prefix KV page cache — refcounted page-run reuse for paged pools
(port of ``repro/serving/prefix_cache.py``).

Serving traffic repeats: shared-prefix prompts (system preambles,
few-shot headers, templated documents) would re-ingest identical KV on
every admission.  This is a per-replica map from a prompt-prefix key to
a **refcounted run of pages** already resident in a ``PagedKVCachePool``,
so a hit turns re-prefill of the shared prefix into page-table pointer
copies — no chunk steps and no KV writes for it — and only the cold
suffix runs through the ``PrefillManager``.

Keying
------
One cell per *full page* of a prompt, keyed by the cumulative token
bytes up to that page boundary (``prefix_key(prompt, (i+1) * page_size)``
— the bytes ``prefix_affinity`` routing hashes, so routing and caching
cannot drift apart).  A probe walks page keys from the front and returns
the longest run of consecutively cached pages, capped at
``(len(prompt) - 1) // page_size`` so at least one suffix token goes
through prefill (the final chunk's logits seed the first token).

Why whole pages are safe to share
---------------------------------
KV at position ``j`` depends only on tokens ``[0, j]`` (causal masking
at every layer), and a page wholly covered by a prompt is never written
again: suffix chunks write at positions ``>= done`` and decode at
``index >= prompt_len``.  The paged decode step diverts inactive slots'
page-table rows to the junk page 0 (``training/steps.py``), so a stale
index never writes into a page another request reads.

Refcount lifecycle
------------------
``pool.page_refs`` counts owners per page: the allocating request, each
later sharer (+1 on ``attach``) and the cache itself (+1 on ``insert``).
``pool.free(slot)`` decrements; a page returns to the free list only at
refcount zero.  Under page pressure the pool reclaims here first
(``reclaim``: LRU by probe/insert stamp, deepest page first within a
chain, and only at refcount 1) before anyone is preempted.
``max_pages`` caps the pages pinned *only* by the cache.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np


def prefix_key(prompt, n_tokens: int | None = None) -> bytes:
    """Canonical prompt-prefix key: the first ``n_tokens`` token ids as
    little-endian int32 bytes (the whole prompt when ``None``) — the one
    keying both ``prefix_affinity`` routing and the cache use."""
    arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
    if n_tokens is not None:
        arr = arr[:n_tokens]
    return arr.tobytes()


@dataclasses.dataclass
class PrefixHit:
    """A probe result: the longest cached page run for a prompt.

    ``pinned`` counts hit pages held *only* by the cache — attaching turns
    them from reclaimable into shared, which admission must not count as
    spendable headroom too."""
    n_tokens: int = 0
    pages: list = dataclasses.field(default_factory=list)
    pinned: int = 0

    def __bool__(self) -> bool:
        return bool(self.pages)


@dataclasses.dataclass
class _Cell:
    page: int                     # pool page id this cell pins
    depth: int                    # page index within its prompt chain
    stamp: int                    # LRU clock at last probe-hit / insert


class PrefixCache:
    """Prefix -> page-run cache over one ``PagedKVCachePool``.

    Construction attaches the cache to the pool (``pool.prefix_cache``),
    which is how the scheduler, the prefill manager and the pool's own
    allocator find it.  The cache refers back to the pool weakly: the two
    would otherwise form a cycle, and a pool the caller dropped would keep
    its device memory (2 GB a replica at full width) until the cyclic
    garbage collector ran.
    """

    def __init__(self, pool, max_pages: int = 0):
        if getattr(pool, "layout", None) != "paged":
            raise ValueError(
                "PrefixCache needs a paged pool (page-run sharing has no "
                f"meaning for layout {getattr(pool, 'layout', None)!r})")
        if max_pages < 0:
            raise ValueError(f"max_pages {max_pages} < 0")
        self.pool = weakref.proxy(pool)
        self.page_size = pool.page_size
        self.max_pages = max_pages    # cap on cache-only (refcount-1) pages
        self._cells: dict[bytes, _Cell] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0         # prefill tokens skipped via hits
        self.inserts = 0
        self.evictions = 0
        # telemetry hook, bound by the scheduler (bind_tracer); None = off
        self.tracer = None
        self.vclock = None
        self.replica_id = 0
        pool.prefix_cache = self

    def bind_tracer(self, tracer, vclock=None, replica_id: int = 0) -> None:
        """Attach the serving tracer so reclaims show up as ring events.
        The scheduler calls this at reset; a None tracer unbinds."""
        self.tracer = tracer
        self.vclock = vclock
        self.replica_id = int(replica_id)

    def __len__(self) -> int:
        return len(self._cells)

    # -- probing -------------------------------------------------------------
    def probe(self, prompt) -> PrefixHit:
        """Longest cached page run for ``prompt`` (read-only: no refcount,
        counter or LRU change — safe to call from every replica's
        ``can_admit``)."""
        prompt = np.asarray(prompt, np.int32)
        limit = (len(prompt) - 1) // self.page_size   # >= 1 cold token
        pages = []
        for i in range(limit):
            cell = self._cells.get(prefix_key(prompt, (i + 1) * self.page_size))
            if cell is None:
                break
            pages.append(cell.page)
        pinned = sum(1 for p in pages if self.pool.page_refs[p] == 1)
        return PrefixHit(n_tokens=len(pages) * self.page_size,
                         pages=pages, pinned=pinned)

    # -- request lifecycle ---------------------------------------------------
    def attach(self, slot: int, prompt, hit: PrefixHit | None = None) -> int:
        """Install ``hit``'s page run (probed fresh when not given) as the
        head of ``slot``'s page table, a reference on every shared page;
        returns the cached token count (0 on a miss).  Runs before
        ``reserve_prefix`` adds the cold pages."""
        if hit is None:
            hit = self.probe(prompt)
        self._tick += 1
        if not hit:
            self.misses += 1
            return 0
        self.hits += 1
        self.tokens_saved += hit.n_tokens
        prompt = np.asarray(prompt, np.int32)
        for i in range(len(hit.pages)):   # touch for LRU recency
            self._cells[prefix_key(prompt, (i + 1) * self.page_size)] \
                .stamp = self._tick
        # the run's references pass to the slot's page-table row, which the
        # caller's free(slot) releases; the slot-level dataflow cannot see
        # that hand-off
        # easeylint: allow[refcount-pairing]
        self.pool.adopt_run(slot, hit.pages)
        return hit.n_tokens

    def insert(self, prompt, slot: int) -> int:
        """Register every page of ``slot``'s run that the prompt covers
        whole (a page holding positions past the prompt still takes
        decode writes).  Called when the prompt's final chunk lands.
        Returns the pages newly pinned."""
        prompt = np.asarray(prompt, np.int32)
        self._tick += 1
        fresh = 0
        for i in range(len(prompt) // self.page_size):
            key = prefix_key(prompt, (i + 1) * self.page_size)
            cell = self._cells.get(key)
            if cell is not None:          # already cached (perhaps by a
                cell.stamp = self._tick   # concurrent miss): just touch
                continue
            page = int(self.pool.page_table[slot, i])
            self.pool.pin_page(page)
            self._cells[key] = _Cell(page=page, depth=i, stamp=self._tick)
            fresh += 1
        self.inserts += 1
        self.enforce_budget()
        return fresh

    def enforce_budget(self) -> None:
        """LRU back under the pin cap; called after every insert and every
        ``pool.free`` — the two moments pages can become cache-only."""
        if not self.max_pages:
            return
        over = self.reclaimable_pages - self.max_pages
        if over > 0:
            self.reclaim(over)

    # -- page-pressure eviction ----------------------------------------------
    @property
    def reclaimable_pages(self) -> int:
        """Cells whose page no live request shares (refcount exactly 1);
        the pool keeps the count on refcount transitions."""
        return self.pool.reclaimable_pages

    def reclaim(self, n_pages: int) -> int:
        """Evict LRU cells until ``n_pages`` pages went back to the free
        list (or nothing evictable remains).  Never evicts a cell whose
        page a request still references; within one stamp (a chain
        inserted together) the deepest page goes first, so surviving
        chains stay reachable from the front."""
        freed = 0
        refs = self.pool.page_refs
        while freed < n_pages:
            victim = None
            for key, cell in self._cells.items():
                if refs[cell.page] != 1:
                    continue
                if victim is None or \
                        (cell.stamp, -cell.depth, key) < \
                        (victim[1].stamp, -victim[1].depth, victim[0]):
                    victim = (key, cell)
            if victim is None:
                break
            del self._cells[victim[0]]
            self.pool.unpin_page(victim[1].page)
            self.evictions += 1
            freed += 1
        if freed and self.tracer is not None:
            self.tracer.instant(
                "prefix_reclaim",
                self.vclock.t if self.vclock is not None else 0,
                replica=self.replica_id, pages=freed,
                asked=n_pages, cells_left=len(self._cells))
        return freed
