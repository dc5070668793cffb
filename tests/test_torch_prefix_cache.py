"""The port's shared-prefix KV page cache against the JAX reference's, on
the CPU.

* Page accounting: each case of the reference's own
  ``tests/test_serving_prefix_cache.py`` (refcounts through insert,
  free, attach and reclaim; a preempted sharer leaving the other's pages
  alone; LRU order and shared-page protection; the pin budget; reclaim
  before admission fails; admission reserving the cold suffix only) runs
  step for step on both packages' pools, and every observation — page
  ids, refcounts, free counts, probe results, counters — must be equal.
* Serving: cached and cold greedy streams are identical across chunk
  sizes x shared-prefix depths x traces, under preemption and through a
  prefix-affinity fleet, and equal to the reference's streams on the
  reference's weights.
* ``BENCH_serving.json``'s ``sharedprefix_router_cold`` and
  ``sharedprefix_router_cached`` cells: the port's deterministic keys
  equal the file's, and its streams the reference's run on the same
  trace.
"""

import gc
import json
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro_torch.core.target as port_target
from repro.configs import get_config as ref_config
from repro.core.tuning import kv_bytes_per_token, param_count_estimate
from repro.models.transformer import model_for as ref_model_for
from repro.serving import PrefixCache as RefCache
from repro.serving import ReplicaRouter as RefRouter
from repro.serving import ServeEngine as RefEngine
from repro.serving import prefix_key as ref_prefix_key
from repro.serving import sharedprefix_trace as ref_sharedprefix
from repro.serving.pool import PagedKVCachePool as RefPool
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.serving import (KVCachePool, PagedKVCachePool, PrefixCache,
                                 ReplicaRouter, ServeEngine, Tracer,
                                 prefix_key, sharedprefix_trace)

ARCH = "deepseek-7b-smoke"
TIGHT = "bench:serve-tight"
BENCH = json.loads((Path(__file__).resolve().parents[1] /
                    "BENCH_serving.json").read_text())["cells"]
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the smoke model's steps
    are thousands of tiny ops, and with the suite's workers sharing the
    cores, OpenMP's barriers across threads cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Page accounting, both packages step for step

class _Pkg:
    """One package's pool and cache classes over its own smoke model."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            self.model = model_for(get_config(ARCH))
            self.Pool = lambda *a, **k: PagedKVCachePool(
                self.model, *a, device="cpu", **k)
            self.Cache = PrefixCache
        else:
            self.model = ref_model_for(ref_config(ARCH), remat="none")
            self.Pool = lambda *a, **k: RefPool(self.model, *a, **k)
            self.Cache = RefCache


@pytest.fixture(scope="module")
def pkgs():
    return _Pkg("ref"), _Pkg("port")


def _prompt(n, start=1):
    return np.arange(start, start + n, dtype=np.int32)


def _refs(pool, pages):
    return [int(pool.page_refs[p]) for p in pages]


def _brute_reclaimable(cache):
    """O(cells) ground truth for the pool's O(1) cache-only counter."""
    refs = cache.pool.page_refs
    return sum(1 for c in cache._cells.values() if refs[c.page] == 1)


def _refcount_lifecycle(k):
    pool = k.Pool(num_slots=3, max_len=64, page_size=8, num_pages=16)
    cache = k.Cache(pool, max_pages=8)
    prompt = _prompt(20)                       # 3 pages, 2 fully covered
    out = []
    s0 = pool.alloc()
    pool.reserve_prefix(s0, len(prompt))
    run = [int(pool.page_table[s0, i]) for i in range(2)]
    partial = int(pool.page_table[s0, 2])
    assert cache.insert(prompt, s0) == 2       # the partial page is mutable
    assert _refs(pool, run) == [2, 2] and _refs(pool, [partial]) == [1]
    out.append((run, partial, pool.free_pages))
    free_before = pool.free_pages
    pool.free(s0)
    assert pool.free_pages == free_before + 1  # only the partial page freed
    assert _refs(pool, run) == [1, 1]
    assert cache.reclaimable_pages == _brute_reclaimable(cache) == 2
    hit = cache.probe(prompt)
    assert hit.n_tokens == 16 and hit.pages == run and hit.pinned == 2
    s1 = pool.alloc()
    assert cache.attach(s1, prompt) == 16
    pool.reserve_prefix(s1, len(prompt))
    assert [int(pool.page_table[s1, i]) for i in range(2)] == run
    assert _refs(pool, run) == [2, 2]
    assert cache.reclaimable_pages == _brute_reclaimable(cache) == 0
    out.append((pool.page_table.tolist(), pool.free_pages))
    pool.free(s1)
    assert _refs(pool, run) == [1, 1]
    assert cache.reclaim(2) == 2
    assert cache.reclaimable_pages == _brute_reclaimable(cache) == 0
    assert _refs(pool, run) == [0, 0]
    assert cache.probe(prompt).n_tokens == 0
    out.append((cache.hits, cache.misses, cache.tokens_saved,
                cache.evictions, pool.free_pages, pool.page_refs.tolist()))
    return out


def _preempted_sharer(k):
    pool = k.Pool(num_slots=3, max_len=64, page_size=8, num_pages=16)
    cache = k.Cache(pool)
    prompt_a = np.concatenate([_prompt(16), _prompt(5, start=100)])
    prompt_b = np.concatenate([_prompt(16), _prompt(7, start=200)])
    s0 = pool.alloc()
    pool.reserve_prefix(s0, len(prompt_a))
    cache.insert(prompt_a, s0)
    run = [int(pool.page_table[s0, i]) for i in range(2)]
    s1 = pool.alloc()
    cache.attach(s1, prompt_b)                 # shares both head pages
    pool.reserve_prefix(s1, len(prompt_b))
    assert _refs(pool, run) == [3, 3]
    out = [pool.page_table.tolist()]
    pool.free(s1)                              # the "preempted" sharer
    assert _refs(pool, run) == [2, 2]
    assert [int(pool.page_table[s0, i]) for i in range(2)] == run
    assert not pool._free_pages.is_free(run[0])
    assert not pool._free_pages.is_free(run[1])
    assert cache.reclaim(2) == 0               # the survivor still reads it
    pool.free(s0)
    cache.reclaim(2)
    assert _refs(pool, run) == [0, 0]
    with pytest.raises(ValueError, match="below zero"):
        pool.release_page(run[0])
    out.append((pool.free_pages, cache.evictions))
    return out


def _lru_order(k):
    pool = k.Pool(num_slots=4, max_len=64, page_size=8, num_pages=20)
    cache = k.Cache(pool)
    pa = np.concatenate([_prompt(16), _prompt(1, start=500)])
    pb = np.concatenate([_prompt(16, start=300), _prompt(1, start=600)])
    runs = []
    for p in (pa, pb):
        s = pool.alloc()
        pool.reserve_prefix(s, len(p))
        cache.insert(p, s)
        runs.append([int(pool.page_table[s, i]) for i in range(2)])
        pool.free(s)
    sc = pool.alloc()                          # touching A: B is the LRU
    cache.attach(sc, pa)
    pool.reserve_prefix(sc, len(pa))
    pool.free(sc)
    assert cache.reclaim(2) == 2
    assert cache.probe(pb).n_tokens == 0
    assert cache.probe(pa).n_tokens == 16
    sd = pool.alloc()                          # a live sharer pins A
    cache.attach(sd, pa)
    pool.reserve_prefix(sd, len(pa))
    assert cache.reclaimable_pages == 0
    assert cache.reclaim(4) == 0
    assert cache.probe(pa).pages == runs[0] != runs[1]
    return [runs, pool.page_table.tolist(), pool.free_pages]


def _pin_budget(k):
    pool = k.Pool(num_slots=4, max_len=64, page_size=8, num_pages=24)
    cache = k.Cache(pool, max_pages=2)
    out = []
    for start in (1, 300, 700):
        p = np.concatenate([_prompt(16, start=start), _prompt(1, start=900)])
        s = pool.alloc()
        pool.reserve_prefix(s, len(p))
        cache.insert(p, s)
        pool.free(s)
        out.append((cache.reclaimable_pages, cache.evictions, len(cache),
                    pool.free_pages))
    assert cache.reclaimable_pages <= 2 and cache.evictions >= 2
    return out


def _reclaim_before_admission_fails(k):
    pool = k.Pool(num_slots=2, max_len=32, page_size=8, num_pages=4)
    cache = k.Cache(pool)
    pa = _prompt(17)                           # 3 pages, 2 cached
    s0 = pool.alloc()
    pool.reserve_prefix(s0, len(pa))
    cache.insert(pa, s0)
    pool.free(s0)
    assert pool.free_pages == 1                # 2 pinned by the cache
    assert pool.free_tokens == 3 * 8           # reclaimable counts as free
    pb = _prompt(17, start=400)                # no hit, needs all 3 pages
    assert pool.can_admit(len(pb), hit=cache.probe(pb))
    s1 = pool.alloc()
    pool.reserve_prefix(s1, len(pb))           # grows via LRU reclaim
    assert pool._pages_held[s1] == 3
    assert cache.probe(pa).n_tokens == 0       # the cache gave way
    return [pool.page_table.tolist(), cache.evictions]


def _admission_reserves_cold_suffix(k):
    pool = k.Pool(num_slots=2, max_len=32, page_size=8, num_pages=4)
    cache = k.Cache(pool)
    pa = _prompt(17)
    s0 = pool.alloc()
    pool.reserve_prefix(s0, len(pa))
    cache.insert(pa, s0)
    pool.free(s0)                              # 1 free + 2 cache-pinned
    hit = cache.probe(pa)
    assert hit.pinned == 2
    assert pool.can_admit(len(pa), hit=hit)    # 1 cold page, 1 free
    s1 = pool.alloc()
    assert cache.attach(s1, pa) == 16
    pool.reserve_prefix(s1, len(pa))
    assert pool.free_pages == 0
    assert not pool.can_admit(len(pa), hit=None)
    return [pool.page_table.tolist(), pool.free_tokens]


@pytest.mark.parametrize("case", [
    _refcount_lifecycle, _preempted_sharer, _lru_order, _pin_budget,
    _reclaim_before_admission_fails, _admission_reserves_cold_suffix],
    ids=lambda f: f.__name__.strip("_"))
def test_page_accounting_matches_reference(pkgs, case):
    ref, port = pkgs
    assert case(port) == case(ref)


def test_cached_pool_is_freed_with_its_last_reference(pkgs):
    """A pool and its cache must not form a reference cycle: the pool's
    device memory goes with its last reference, not at the next cyclic
    garbage collection (the router builds fresh pools every run)."""
    _, port = pkgs
    gc.disable()
    try:
        pool = PagedKVCachePool(port.model, 2, 32, device="cpu")
        cache = PrefixCache(pool)
        alive = weakref.ref(pool)
        del pool
        assert alive() is None
        with pytest.raises(ReferenceError):
            cache.reclaim(1)
    finally:
        gc.enable()


def test_prefix_key_equals_the_reference():
    rng = np.random.RandomState(4)
    for _ in range(20):
        p = rng.randint(1, 1000, size=(rng.randint(1, 40),))
        for n in (None, 1, 8, 16, 64):
            assert prefix_key(p, n) == ref_prefix_key(p, n)
    assert prefix_key(_prompt(20, 5), 8) == _prompt(20, 5)[:8].tobytes()


def test_prefix_cache_requires_paged_layout(pkgs):
    _, port = pkgs
    with pytest.raises(ValueError, match="paged"):
        PrefixCache(KVCachePool(port.model, 2, 32, device="cpu"))
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(arch=ARCH, num_slots=2, max_len=32, log=quiet,
                    kv_layout="contiguous", prefix_cache=True, device="cpu")
    eng = ServeEngine(arch=ARCH, num_slots=2, max_len=32, log=quiet,
                      kv_layout="contiguous", device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.make_pool(prefix_cache=True)
    cache = PrefixCache(PagedKVCachePool(port.model, 2, 32, device="cpu"))
    tracer = Tracer()
    cache.bind_tracer(tracer, replica_id=2)
    assert (cache.tracer, cache.replica_id) == (tracer, 2)
    cache.bind_tracer(None)
    assert cache.tracer is None


# ---------------------------------------------------------------------------
# Serving: cached == cold, and equal to the reference


@pytest.fixture(scope="module")
def engines():
    """(reference, port) paged smoke engines of 6 slots x 64 on the
    reference's weights, roomy and with scarce pages (8 x 13)."""
    out = {}
    for name, kw in (("roomy", {}), ("scarce", dict(page_size=8,
                                                     num_pages=13))):
        ref = RefEngine(arch=ARCH, num_slots=6, max_len=64, seed=0,
                        kv_layout="paged", log=quiet, **kw)
        port = ServeEngine(arch=ARCH, num_slots=6, max_len=64, seed=0,
                           log=quiet, device="cpu", **kw)
        port.params = params_from_jax(jax.tree.map(np.asarray, ref.params))
        out[name] = (ref, port)
    return out


def _tokens(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _prefix_counts(s):
    return (s.prefix_hits, s.prefix_misses, s.prefill_tokens_saved,
            s.prefill_tokens, s.prefill_chunks, s.decode_steps,
            s.preemptions, s.mean_ttft_steps)


def test_cached_matches_cold_and_the_reference(engines):
    ref, port = engines["roomy"]
    reqs = sharedprefix_trace(12, 256, seed=0)
    cold = port.run(reqs, prefix_cache=False)
    hot = port.run(reqs, prefix_cache=True)
    assert _tokens(hot) == _tokens(cold)
    assert hot.prefix_hits > 0 and hot.prefill_tokens_saved > 0
    assert hot.prefill_tokens + hot.prefill_tokens_saved == \
        cold.prefill_tokens
    assert hot.prefill_chunks < cold.prefill_chunks
    want = ref.run(ref_sharedprefix(12, 256, seed=0), prefix_cache=True)
    assert _tokens(hot) == _tokens(want)
    assert _prefix_counts(hot) == _prefix_counts(want)
    assert hot.prefix_evictions == want.prefix_evictions
    again = port.run(reqs, prefix_cache=True)
    assert _tokens(again) == _tokens(hot)
    assert _prefix_counts(again) == _prefix_counts(hot)


@pytest.mark.parametrize("chunk", [0, 4, 8, 16])
@pytest.mark.parametrize("head_len,trace_seed", [(16, 3), (32, 11),
                                                 (32, 25)])
def test_cached_equivalence_sweep(engines, chunk, head_len, trace_seed):
    """Any chunk size (0 = blocking) x shared-prefix depth x trace gives
    the same streams with the cache on or off."""
    _, port = engines["roomy"]
    reqs = sharedprefix_trace(8, 256, head_len=head_len, seed=trace_seed)
    cold = port.run(reqs, prefill_chunk=chunk, prefix_cache=False)
    hot = port.run(reqs, prefill_chunk=chunk, prefix_cache=True)
    assert _tokens(hot) == _tokens(cold)


def test_preemption_with_sharing_matches_roomy_and_reference(engines):
    """Scarce pages and sharing: preempting a sharer must not corrupt the
    run others read — the streams equal a roomy cache-off run, and the
    counts equal the reference's on the same pool."""
    ref, scarce = engines["scarce"]
    _, roomy = engines["roomy"]
    reqs = sharedprefix_trace(10, 256, head_len=16, max_new=24, seed=3)
    base = roomy.run(reqs, prefix_cache=False)
    got = scarce.run(reqs, prefill_chunk=8, prefix_cache=True)
    assert got.preemptions > 0
    assert _tokens(got) == _tokens(base)
    want = ref.run(ref_sharedprefix(10, 256, head_len=16, max_new=24,
                                    seed=3), prefill_chunk=8,
                   prefix_cache=True)
    assert _prefix_counts(got) == _prefix_counts(want)
    assert [r.preemptions for r in got.results] == \
        [r.preemptions for r in want.results]


def test_router_per_replica_caches_compose(engines):
    _, port = engines["roomy"]
    router = ReplicaRouter([port] * 3, policy="prefix_affinity", log=quiet)
    reqs = sharedprefix_trace(30, 256, seed=5)
    cold = router.run(reqs)
    hot = router.run(reqs, prefix_cache=True)
    assert _tokens(hot) == _tokens(cold)
    assert hot.prefill_tokens_saved > 0
    assert hot.prefill_tokens + hot.prefill_tokens_saved == \
        cold.prefill_tokens


def test_mixed_fleet_caches_paged_replicas_only(engines):
    """A paged + contiguous fleet takes the per-run cache override on its
    paged replica only, and its streams do not change."""
    _, port = engines["roomy"]
    cont = ServeEngine(arch=ARCH, num_slots=2, max_len=64, seed=0,
                       kv_layout="contiguous", log=quiet, device="cpu")
    cont.params = port.params
    router = ReplicaRouter([port, cont], policy="prefix_affinity", log=quiet)
    reqs = sharedprefix_trace(8, 256, seed=7)
    cold = router.run(reqs)
    hot = router.run(reqs, prefix_cache=True)
    assert _tokens(hot) == _tokens(cold)
    assert hot.replica_stats[1].prefix_hits == \
        hot.replica_stats[1].prefix_misses == 0
    mixed = ReplicaRouter.build(arch=ARCH, replicas=2,
                                kv_layout="paged,contiguous", num_slots=2,
                                max_len=64, prefix_cache=True, log=quiet,
                                device="cpu")
    assert mixed.engines[0].prefix_cache
    assert not mixed.engines[1].prefix_cache


# ---------------------------------------------------------------------------
# BENCH_serving.json's shared-prefix cells


def _tight_spec(module):
    """The serving benchmark's budget target (``bench:serve-tight``)."""
    cfg = ref_config(ARCH)
    hbm = (2 * param_count_estimate(cfg) +
           3.5 * kv_bytes_per_token(cfg) * 128) / 0.85
    return module.TargetSpec(
        name=TIGHT, chip="cpu", mesh_shape=(1,), mesh_axes=("data",),
        peak_flops=5e10, hbm_bw=2e10, hbm_bytes=hbm, ici_bw=1e9,
        scheduler="local", kernels="reference")


def _num(x):
    return None if x != x else round(x, 4)


def test_sharedprefix_cells_match_bench_and_reference():
    for module in (ref_target, port_target):
        if TIGHT not in module.TARGETS:
            module.register(_tight_spec(module))
    ref = RefEngine(arch=ARCH, target=TIGHT, num_slots=8, max_len=128,
                    seed=0, kv_layout="paged", log=quiet)
    port = ServeEngine(arch=ARCH, target=TIGHT, num_slots=8, max_len=128,
                       seed=0, log=quiet, device="cpu")
    port.params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    router = ReplicaRouter([port] * 3, policy="prefix_affinity", log=quiet)
    ref_router = RefRouter([ref] * 3, policy="prefix_affinity", log=quiet)
    for name, cached in (("sharedprefix_router_cold", False),
                         ("sharedprefix_router_cached", True)):
        s = router.run(sharedprefix_trace(36, 256, seed=0),
                       prefix_cache=cached)
        rounds = max(max(x.decode_steps for x in s.replica_stats), 1)
        got = {"tokens_per_step": round(s.generated_tokens / rounds, 4),
               "mean_ttft_steps": _num(s.mean_ttft_steps),
               "prefill_tokens": s.prefill_tokens,
               "prefill_tokens_saved": s.prefill_tokens_saved,
               "prefix_hits": s.prefix_hits,
               "prefix_misses": s.prefix_misses,
               "prefix_hit_rate": _num(s.prefix_hit_rate),
               "generated_tokens": s.generated_tokens,
               "decode_steps": rounds, "replicas": len(s.replica_stats),
               "load_imbalance": _num(s.imbalance)}
        # every key but tokens_per_s (wall clock) and the route policy
        want = {k: v for k, v in BENCH[name].items()
                if k not in ("tokens_per_s", "route_policy")}
        assert got == want, name
        w = ref_router.run(ref_sharedprefix(36, 256, seed=0),
                           prefix_cache=cached)
        assert _tokens(s) == _tokens(w)
        assert s.replica_of == w.replica_of
