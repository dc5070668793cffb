"""The port's keyed sampler, speculative decoding and contiguous KV layout
against the JAX reference, on the CPU.

* The sampler's draws equal the reference's ``make_sampler(0)`` exactly
  over fixed logits, for every temperature / top-k / top-p style and a
  sweep of (request id, step) keys.  The port computes JAX's threefry
  bits with the counter layout of ``jax_threefry_partitionable=True``,
  the default of the JAX these tests run against; the test asserts that
  flag, so that another JAX fails loudly instead of silently.
* The engine reproduces ``BENCH_serving.json``'s deterministic keys:
  ``contiguous_static`` (93 decode steps) and ``contiguous_continuous``
  (63) under the serving benchmark's tight target, and ``paged_spec_off``
  (141) / ``paged_spec_on`` (82) on ``picolm-4-smoke`` — greedy streams
  equal to the reference's run side by side on the same weights, and
  spec-on streams equal to spec-off.  The spec cells of that file were
  made with weights drawn by JAX with ``jax_threefry_partitionable``
  off (the CI pin, JAX 0.4.37); under the installed default the same
  seed draws other weights, on which both packages accept more drafts
  (51 decode steps).  Both weight sets are cases here.
* Sampled traces with and without preemption give the reference's
  streams when the port's scheduler and sampler drive the reference's
  model steps, and one stream set through the port's whole stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro_torch.core.target as port_target
from repro.configs import get_config as ref_config
from repro.core.tuning import kv_bytes_per_token, param_count_estimate
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.serving import ServeEngine as RefEngine
from repro.serving import repetitive_trace as ref_repetitive
from repro.serving import zipf_trace as ref_zipf
from repro.serving.pool import KVCachePool as RefContiguousPool
from repro.serving.pool import PagedKVCachePool as RefPagedPool
from repro.serving.sampling import make_sampler as ref_make_sampler
from repro.serving.spec import NGramDrafter as RefDrafter
from repro.training.steps import (
    build_decode_step_slots as ref_decode_builder,
    build_verify_step_slots as ref_verify_builder,
    build_verify_step_slots_paged as ref_verify_paged_builder)
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.serving import Scheduler, ServeEngine, zipf_trace
from repro_torch.serving.pool import KVCachePool, PagedKVCachePool
from repro_torch.serving.sampling import (K_CAP, effective_top_k, fold_in,
                                          gumbel, make_sampler)
from repro_torch.serving.spec import NGramDrafter
from repro_torch.serving.trace import repetitive_trace
from repro_torch.training.steps import (build_decode_step_slots,
                                        build_verify_step_slots,
                                        build_verify_step_slots_paged)

ARCH, SPEC_ARCH = "deepseek-7b-smoke", "picolm-4-smoke"
TIGHT = "bench:serve-tight"
quiet = lambda *a, **k: None  # noqa: E731
# the JAX threefry counter layout the sampler's bits were written for
PARTITIONABLE = True


def _tight_spec(module):
    """The serving benchmark's budget target: ~3.5 contiguous slots x 128
    of KV on top of the weights (benchmarks/serving_throughput.py)."""
    cfg = ref_config(ARCH)
    param_bytes = 2 * param_count_estimate(cfg)
    kv_budget = 3.5 * kv_bytes_per_token(cfg) * 128
    return module.TargetSpec(
        name=TIGHT, chip="cpu", mesh_shape=(1,), mesh_axes=("data",),
        peak_flops=5e10, hbm_bw=2e10,
        hbm_bytes=(param_bytes + kv_budget) / 0.85, ici_bw=1e9,
        scheduler="local", kernels="reference")


@pytest.fixture(scope="module", autouse=True)
def tight_target():
    for module in (ref_target, port_target):
        if TIGHT not in module.TARGETS:
            module.register(_tight_spec(module))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread while this module runs: the smoke model's steps
    are thousands of tiny ops, and with the suite's workers sharing the
    cores, OpenMP's barriers across threads cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(partitionable=PARTITIONABLE, **kw):
    """(reference engine, port engine) on the reference's weights, drawn
    with the given threefry counter layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        ref = RefEngine(seed=0, log=quiet, **kw)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    port = ServeEngine(seed=0, log=quiet, device="cpu", **kw)
    port.params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    return ref, port


def _streams(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _spec_counts(stats):
    return (stats.decode_steps, stats.generated_tokens,
            stats.spec_verify_steps, stats.spec_drafted_tokens,
            stats.spec_accepted_tokens, stats.accepted_per_verify,
            stats.mean_ttft_steps, stats.preemptions)


# ---------------------------------------------------------------------------
# the sampler


def test_jax_draws_with_the_counter_layout_the_port_mirrors():
    assert jax.config.jax_threefry_partitionable is PARTITIONABLE


def test_fold_in_and_gumbel_bits_match_jax():
    rids = np.array([0, 1, 7, 2**31 - 1], np.int64)
    steps = np.array([0, 5, 3, 2**31 - 1], np.int64)
    zero = torch.zeros(4, dtype=torch.int64)
    key = fold_in(fold_in((zero, zero + 3), torch.from_numpy(rids)),
                  torch.from_numpy(steps))
    noise = gumbel(key, 300)
    for i, (rid, step) in enumerate(zip(rids, steps)):
        jkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(3), int(rid)), int(step))
        assert [int(key[0][i]), int(key[1][i])] == \
            np.asarray(jax.random.key_data(jkey)).tolist()
        want = np.asarray(jax.random.gumbel(jkey, (300,), jnp.float32))
        # the bits are exact; XLA's log and torch's may round apart by
        # one f32 step
        np.testing.assert_allclose(noise[i].numpy(), want, rtol=3e-7,
                                   atol=3e-7)


@pytest.mark.parametrize("vocab", [256, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sampler_draws_equal_reference(vocab, temperature):
    """Every (top_k, top_p) style over 64 (rid, step) keys on fixed logits:
    the draws are equal.  No draw here meets a tie of gumbel + logits
    within one f32 step, so nothing is exempted."""
    rng = np.random.RandomState(vocab)
    rows = 64
    logits = (3 * rng.standard_normal((rows, vocab))).astype(np.float32)
    logits[5, :2] = logits[5].max() + 1.0           # a tie for the argmax
    rids = (np.arange(rows) % 9).astype(np.int32)
    steps = ((np.arange(rows) * 5) % 13).astype(np.int32)
    ref_sample, port_sample = ref_make_sampler(0), make_sampler(0)
    drawn = 0
    for top_k in (0, 1, 16, 64):
        for top_p in (1.0, 0.9, 0.5):
            cols = [np.full((rows,), temperature, np.float32),
                    np.full((rows,), top_k, np.int32),
                    np.full((rows,), top_p, np.float32), rids, steps]
            want = np.asarray(ref_sample(jnp.asarray(logits),
                                         *map(jnp.asarray, cols)))
            got = port_sample(torch.from_numpy(logits),
                              *map(torch.from_numpy, cols)).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"top_k {top_k}, top_p "
                                                  f"{top_p}")
            drawn += int((got != logits.argmax(-1)).sum())
    assert (drawn > 0) == (temperature > 0)


def test_effective_top_k_and_cap():
    assert K_CAP == 64
    assert [effective_top_k(k, 4) for k in (0, 1, 3, 16)] == [0, 1, 3, 4]
    assert effective_top_k(100, 1000) == 64


# ---------------------------------------------------------------------------
# the drafter and the pools' burst accounting


def test_ngram_drafter_equals_reference():
    rng = np.random.RandomState(0)
    for _ in range(50):
        hist = rng.randint(0, 4, size=rng.randint(1, 30)).tolist()
        a, b = NGramDrafter(), RefDrafter()
        assert a.draft(hist, 4) == b.draft(hist, 4)
        assert (a.ngram_hits, a.fallbacks) == (b.ngram_hits, b.fallbacks)
    assert NGramDrafter().draft([], 3) == [0, 0, 0]


def test_grow_for_burst_and_sync_index_match_reference():
    cfg = get_config(ARCH)
    port_model, ref_model = model_for(cfg), ref_model_for(ref_config(ARCH))
    pools = [(PagedKVCachePool(port_model, 3, 40, page_size=8, num_pages=8,
                               device="cpu"),
              RefPagedPool(ref_model, 3, 40, page_size=8, num_pages=8)),
             (KVCachePool(port_model, 3, 40, device="cpu"),
              RefContiguousPool(ref_model, 3, 40))]
    for port, ref in pools:
        got, want = [], []
        for pool, out in ((port, got), (ref, want)):
            for n in (13, 30, 5):
                slot = pool.alloc()
                pool.reserve_prefix(slot, n)
                pool.set_length(slot, n)
            out.extend(pool.grow_for_burst(s, 9) for s in (0, 1, 2, 0))
            pool.sync_index()
            out.append(np.asarray(pool.cache["index"]).tolist())
            if pool.layout == "paged":
                out.append(np.asarray(pool.page_table).tolist())
        assert got == want, port.layout


# ---------------------------------------------------------------------------
# the verify and contiguous steps, teacher-forced


@pytest.fixture(scope="module")
def model_pair():
    rm = ref_model_for(ref_config(ARCH), remat="none")
    rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
    pm = model_for(get_config(ARCH))
    return rm, rp, pm, params_from_jax(jax.tree.map(np.asarray, rp))


def _close(got, want, what):
    """Within two bf16 rounding steps of the largest entry
    (tests/test_torch_model.py's agreement)."""
    want = np.asarray(want, np.float32)
    step = 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=step,
                               atol=step * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_and_decode_steps_match_reference(model_pair, layout):
    """A pool whose K/V come from the reference (random, shared bit for
    bit), three slots at different lengths (slot 2 inactive), then a
    verify burst of 5 and two decode ticks through both packages' steps:
    logits of the live slots agree, indices agree, and the burst's
    positions past max_len are dropped (contiguous) or sent to the junk
    page (paged)."""
    rm, rp, pm, pp = model_pair
    cfg = pm.cfg
    L, Kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.RandomState(1)
    lens = np.array([21, 30, 9], np.int32)
    active = np.array([1, 1, 0], np.int32)
    if layout == "paged":
        psize, max_pages, n_pages = 8, 4, 14
        shape = (L, n_pages, psize, Kh, dh)
        table = np.zeros((3, max_pages), np.int32)
        table[0, :4] = [3, 7, 1, 12]
        table[1, :4] = [2, 9, 4, 11]       # slot 1 full: burst past 32
        table[2, :2] = [5, 6]
        extra = (table,)
        ref_verify = ref_verify_paged_builder(rm)
        port_verify = build_verify_step_slots_paged(pm)
    else:
        shape = (L, 3, 32, Kh, dh)
        extra = ()
        ref_verify, port_verify = ref_verify_builder(rm), \
            build_verify_step_slots(pm)
    kv = (0.5 * rng.standard_normal((2,) + shape)).astype(jnp.bfloat16)
    rcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
              "index": jnp.asarray(lens)}
    pcache = params_from_jax(jax.tree.map(np.asarray, rcache))
    burst = rng.randint(1, 255, (3, 5)).astype(np.int32)
    rl, rcache = jax.jit(ref_verify)(rp, rcache, jnp.asarray(burst),
                                     jnp.asarray(active), *extra)
    pl, pcache = port_verify(pp, pcache, torch.from_numpy(burst),
                             torch.from_numpy(active),
                             *map(torch.from_numpy, extra))
    live = active == 1
    _close(pl[live], np.asarray(rl, np.float32)[live], f"{layout} verify")
    assert pcache["index"].tolist() == np.asarray(rcache["index"]).tolist()
    # every page but the junk page 0, which several rows may write at once
    first = 1 if layout == "paged" else 0
    _close(pcache["k"][:, first:], np.asarray(rcache["k"], np.float32)[:, first:],
           f"{layout} pool K after the burst")
    if layout == "contiguous":
        step = build_decode_step_slots(pm)
        rstep = jax.jit(ref_decode_builder(rm))
        for t in range(2):
            toks = rng.randint(1, 255, (3, 1)).astype(np.int32)
            rl, rcache = rstep(rp, rcache, jnp.asarray(toks),
                               jnp.asarray(active))
            pl, pcache = step(pp, pcache, torch.from_numpy(toks),
                              torch.from_numpy(active))
            _close(pl[live], np.asarray(rl, np.float32)[live],
                   f"contiguous decode tick {t}")
            assert pcache["index"].tolist() == \
                np.asarray(rcache["index"]).tolist()


# ---------------------------------------------------------------------------
# the engine against BENCH_serving.json and the reference


@pytest.fixture(scope="module")
def contiguous():
    return _pair(arch=ARCH, target=TIGHT, num_slots=8, max_len=128,
                 kv_layout="contiguous")


@pytest.mark.parametrize("policy,steps,tps,ttft", [
    ("static", 93, 2.086, 37.0), ("continuous", 63, 3.0794, 26.8333)])
def test_contiguous_cells_match_bench_and_reference(contiguous, policy, steps,
                                                    tps, ttft):
    ref, port = contiguous
    assert (port.num_slots, port.kv_kernel) == (ref.num_slots, "gather") \
        == (3, "gather")
    args = dict(n=12, vocab_size=256, max_prompt=48, max_new=32, alpha=1.3,
                seed=0)
    want = ref.run(ref_zipf(**args), policy=policy, prefill_chunk=0)
    got = port.run(zipf_trace(**args), policy=policy, prefill_chunk=0)
    assert _streams(got) == _streams(want)
    assert (got.decode_steps, got.generated_tokens, got.peak_active,
            got.occupancy, got.mean_ttft_steps, got.peak_resident_tokens) == \
        (want.decode_steps, want.generated_tokens, want.peak_active,
         want.occupancy, want.mean_ttft_steps, want.peak_resident_tokens)
    # BENCH_serving.json's contiguous_{static,continuous} cells
    assert got.decode_steps == steps
    assert round(got.generated_tokens / got.decode_steps, 4) == tps
    assert round(got.mean_ttft_steps, 4) == ttft


def test_contiguous_streams_equal_paged(contiguous):
    _, port = contiguous
    paged = ServeEngine(arch=ARCH, target=TIGHT, num_slots=8, max_len=128,
                        seed=0, log=quiet, device="cpu")
    paged.params = port.params
    trace = zipf_trace(12, 256, max_prompt=48, max_new=32, seed=0)
    assert _streams(port.run(trace)) == _streams(paged.run(trace))


@pytest.mark.parametrize("partitionable,on_steps", [(False, 82),
                                                     (True, 51)])
def test_spec_cells_match_bench_and_reference(partitionable, on_steps):
    """``paged_spec_off`` / ``paged_spec_on``: 12 repetitive requests x 48
    tokens on picolm-4-smoke, 4 slots x 128, blocking prefill, spec_k 4.
    With the CI pin's weights (partitionable off) the counts are
    BENCH_serving.json's: 141 and 82 decode steps, 304 verify events,
    260 accepted drafts."""
    ref, port = _pair(partitionable, arch=SPEC_ARCH, target="local:cpu",
                      num_slots=4, max_len=128, kv_layout="paged")
    runs = {}
    for k in (0, 4):
        want = ref.run(ref_repetitive(12, 4, seed=0), spec_k=k,
                       prefill_chunk=0)
        got = port.run(repetitive_trace(12, 4, seed=0), spec_k=k,
                       prefill_chunk=0)
        assert _streams(got) == _streams(want)
        assert _spec_counts(got) == _spec_counts(want)
        runs[k] = got
    assert _streams(runs[4]) == _streams(runs[0])
    assert (runs[0].decode_steps, runs[4].decode_steps) == (141, on_steps)
    assert runs[0].generated_tokens == runs[4].generated_tokens == 576
    if not partitionable:
        assert (runs[4].spec_verify_steps, runs[4].spec_drafted_tokens,
                runs[4].spec_accepted_tokens) == (304, 1216, 260)
        assert round(runs[4].accepted_per_verify, 4) == 1.8553


def test_contiguous_spec_and_chunked_prefill_match_reference():
    """Spec on the contiguous layout with chunked prefill: the streams and
    counts of the reference, spec-on equal to spec-off."""
    ref, port = _pair(arch=SPEC_ARCH, target="local:cpu", num_slots=4,
                      max_len=64, kv_layout="contiguous")
    streams = []
    for k in (0, 3):
        want = ref.run(ref_repetitive(6, 4, max_new=40, seed=1), spec_k=k,
                       prefill_chunk=4)
        got = port.run(repetitive_trace(6, 4, max_new=40, seed=1), spec_k=k,
                       prefill_chunk=4)
        assert _streams(got) == _streams(want)
        assert _spec_counts(got) == _spec_counts(want)
        streams.append(_streams(got))
    assert streams[0] == streams[1]


SAMPLED = dict(temperature=0.7, top_k=16, top_p=0.9)
SCARCE = dict(num_slots=4, max_len=64, page_size=8, num_pages=13)
ROOMY = dict(num_slots=4, max_len=64)


class _ReferenceSteps:
    """The reference engine's jitted steps behind the port scheduler's
    calling convention (torch tensors in, torch logits out), so that the
    port's scheduler, sampler and drafter run on the reference's own
    model numerics."""

    def __init__(self, engine):
        self.engine = engine

    @staticmethod
    def _j(x):
        return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x

    def _cache(self, cache):
        return {k: self._j(v) for k, v in cache.items()}

    @staticmethod
    def _t(logits):
        return torch.from_numpy(np.asarray(logits, np.float32))

    def decode_fn(self, cache, tokens, active, *extras):
        logits, new = self.engine.decode_fn(
            self._cache(cache), self._j(tokens), self._j(active),
            *map(self._j, extras))
        return self._t(logits), new

    def verify_fn(self, cache, tokens, active, *extras):
        logits, new = self.engine.verify_fn(
            self._cache(cache), self._j(tokens), self._j(active),
            *map(self._j, extras))
        return self._t(logits), new

    def chunk_fn(self, cache, tokens, slot, offset, n_valid, kv_bound,
                 *extras):
        logits, new = self.engine.chunk_fn(
            self._cache(cache), self._j(tokens), jnp.int32(slot),
            jnp.int32(offset), jnp.int32(n_valid), kv_bound,
            *map(self._j, extras))
        return self._t(logits), new


@pytest.mark.parametrize("pool", ["scarce", "roomy"])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_sampled_streams_match_reference_with_and_without_preemption(
        pool, spec_k):
    """A sampled trace (temperature 0.7, top-k 16, top-p 0.9) on a pool so
    short of pages that it preempts, and on a roomy one, with and without
    spec.  The port's scheduler, sampler and drafter, driving the
    reference's model steps, give the reference engine's streams and
    counts exactly.  The port's whole stack gives one stream set in all
    four runs.  (The port's own model rounds a few bf16 values apart
    from XLA's — see tests/test_torch_model.py — and a sampled draw can
    follow such a difference where a greedy pick does not.)"""
    kw = SCARCE if pool == "scarce" else ROOMY
    ref, port = _pair(arch=ARCH, target="local:cpu", kv_layout="paged", **kw)
    args = dict(n=12, vocab_size=256, max_prompt=24, max_new=32, seed=3)
    want = ref.run(ref_zipf(**args, **SAMPLED), spec_k=spec_k)
    steps = _ReferenceSteps(ref)
    sched_pool = PagedKVCachePool(port.model, ref.num_slots, ref.max_len,
                                  page_size=ref.page_size,
                                  num_pages=ref.num_pages, device="cpu")
    sched_pool.cache = ref.make_pool().cache
    sched = Scheduler(sched_pool, steps.decode_fn, steps.chunk_fn,
                      sampler=make_sampler(0), prefill_chunk=ref.prefill_chunk,
                      prefill_chunk_unit=ref.chunk_unit,
                      verify_fn=steps.verify_fn if spec_k else None,
                      spec_k=spec_k, vocab_size=256)
    got = sched.run(zipf_trace(**args, **SAMPLED))
    assert _streams(got) == _streams(want)
    assert _spec_counts(got) == _spec_counts(want)
    assert (got.preemptions > 0) == (pool == "scarce")
    assert got.effective_top_k == want.effective_top_k == \
        {i: 16 for i in range(12)}
    # the port's whole stack: preemption and speculation change nothing
    own = port.run(zipf_trace(**args, **SAMPLED), spec_k=spec_k)
    assert own.preemptions == got.preemptions
    baseline = ServeEngine(arch=ARCH, seed=0, log=quiet, device="cpu",
                           **ROOMY)
    baseline.params = port.params
    assert _streams(own) == \
        _streams(baseline.run(zipf_trace(**args, **SAMPLED), spec_k=0))
    assert _streams(own) != _streams(port.run(zipf_trace(**args),
                                              spec_k=spec_k))


def test_spec_rejects_without_verify_and_validates_top_k():
    port = ServeEngine(arch=ARCH, num_slots=2, max_len=32, seed=0, log=quiet,
                       device="cpu")
    pool = port.make_pool()
    with pytest.raises(ValueError, match="verify_fn"):
        Scheduler(pool, port.decode_fn, port.chunk_fn, spec_k=2)
    req = zipf_trace(1, 256, seed=0)[0]
    with pytest.raises(ValueError, match="top_k"):
        port.run([dataclasses.replace(req, top_k=K_CAP + 1)])
