"""The port's ReplicaRouter against the JAX reference's, on the CPU.

Both fleets serve the same traces on the same weights (the reference's,
crossed bit for bit).  Routing decisions, reroutes, SLO rejections,
autoscale events and every scheduling count are host-side integers and
must be equal; greedy streams must be identical.

* Policies (``tests/test_serving_router.py``): round-robin order and its
  skipping of full replicas, least-loaded by free tokens (contiguous and
  paged), prefix affinity stable under the replica count and equal to the
  reference's rendezvous hash, rerouting on solo starvation, N = 1 equal
  to the bare engine, a mixed-layout fleet equal to one engine, and the
  conservation of requests.
* Open loop (``tests/test_serving_openloop.py``): open-loop streams equal
  the closed replay, SLO reject partitions the trace with the
  reference's reasons, autoscaling conserves requests with the
  reference's events, and ``to_metrics()`` has the reference's keys.
* ``BENCH_serving.json``'s ``router_least_loaded_x3``,
  ``longprompt_router_blocking`` / ``_chunked`` and
  ``openloop_poisson_fixed`` / ``_autoscale`` cells: every key but the
  wall-clock ``tokens_per_s`` equals the file's, and the streams equal
  the reference's run on the same trace.  ``prefill_compiles`` counts
  the reference's jit compiles: distinct (chunk bucket, kv bound) pairs
  per replica, which the port's ``ServeStats.prefill_buckets`` counts
  the same way (it has no compiles), so the key is compared.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro.serving as ref_serving
import repro_torch.core.target as port_target
import repro_torch.serving as port_serving
from repro.configs import get_config as ref_config
from repro.core.tuning import kv_bytes_per_token, param_count_estimate
from repro_torch.models.params import params_from_jax
from repro_torch.serving import (AutoscalePolicy, PoolExhausted,
                                 ReplicaRouter, Request, ServeEngine,
                                 prefix_replica, replay_peak_replicas,
                                 with_arrivals, zipf_trace)
from repro_torch.serving.telemetry import ROUTER_SCHEMA, Tracer

ARCH = "deepseek-7b-smoke"
SLOTS, MAX_LEN = 4, 64
TIGHT = "bench:serve-tight"
BENCH = json.loads((Path(__file__).resolve().parents[1] /
                    "BENCH_serving.json").read_text())["cells"]
quiet = lambda *a, **k: None  # noqa: E731

_PAIRS: dict = {}
_PARAMS: list = []


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the smoke model's steps
    are thousands of tiny ops, and with the suite's workers sharing the
    cores, OpenMP's barriers across threads cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(layout="contiguous", page_size=0, num_pages=0, slots=SLOTS,
         max_len=MAX_LEN, target="local:cpu", eos_id=None):
    """(reference engine, port engine) of one configuration, the port on
    the reference's weights; shared across tests by configuration."""
    key = (layout, page_size, num_pages, slots, max_len, target, eos_id)
    if key not in _PAIRS:
        kw = dict(arch=ARCH, target=target, num_slots=slots, max_len=max_len,
                  seed=0, kv_layout=layout, page_size=page_size,
                  num_pages=num_pages, eos_id=eos_id, log=quiet)
        ref = ref_serving.ServeEngine(**kw)
        if not _PARAMS:
            _PARAMS.append(params_from_jax(jax.tree.map(np.asarray,
                                                        ref.params)))
        port = ServeEngine(device="cpu", **kw)
        port.params = _PARAMS[0]
        _PAIRS[key] = (ref, port)
    return _PAIRS[key]


def routers(engines, policy="least_loaded"):
    """(reference router, port router) over the pairs' engines."""
    return (ref_serving.ReplicaRouter([e[0] for e in engines], policy=policy,
                                      log=quiet),
            ReplicaRouter([e[1] for e in engines], policy=policy, log=quiet))


def _tokens(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _counts(stats):
    """Every deterministic figure of a router drain."""
    return {"replica_of": stats.replica_of, "reroutes": stats.reroutes,
            "peak_in_flight": stats.peak_in_flight,
            "total_vsteps": stats.total_vsteps,
            "peak_replicas": stats.peak_replicas,
            "rejected": [(r.rid, r.reason, r.v_reject,
                          r.predicted_ttft_steps) for r in stats.rejected],
            "events": [dataclasses.astuple(e)
                       for e in stats.autoscale_events],
            "preemptions": [r.preemptions for r in stats.results],
            "vsteps": [(r.v_submit, r.v_first, r.v_done)
                       for r in stats.results],
            "replicas": [(s.decode_steps, s.generated_tokens,
                          s.peak_resident_tokens, s.preemptions,
                          s.prefill_chunks, s.prefill_tokens,
                          s.overlap_steps, s.occupancy)
                         for s in stats.replica_stats]}


def both(engines, trace_fn, policy="least_loaded", **run):
    """Run ``trace_fn(package)``'s trace through both fleets; assert equal
    streams and counts; return the port's stats."""
    ref_router, port_router = routers(engines, policy)
    want = ref_router.run(trace_fn(ref_serving), **run)
    got = port_router.run(trace_fn(port_serving), **run)
    assert _tokens(got) == _tokens(want)
    assert _counts(got) == _counts(want)
    return got


# ---------------------------------------------------------------------------
# Construction and validation


def test_router_validates_fleet_and_policy():
    _, e = pair()
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([], log=quiet)
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter([e], policy="fastest", log=quiet)
    other = ServeEngine(arch="picolm-4-smoke", num_slots=2, max_len=64,
                        seed=0, log=quiet, device="cpu")
    with pytest.raises(ValueError, match="one architecture"):
        ReplicaRouter([e, other], log=quiet)
    short = ServeEngine(arch=ARCH, num_slots=2, max_len=32, seed=0,
                        log=quiet, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ReplicaRouter([e, short], log=quiet)
    with pytest.raises(ValueError, match="eos_id"):
        ReplicaRouter([e, pair(slots=2, eos_id=-1)[1]], log=quiet)
    reseeded = ServeEngine(arch=ARCH, num_slots=2, max_len=64, seed=1,
                           log=quiet, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        ReplicaRouter([e, reseeded], log=quiet)
    tracer = Tracer()
    empty = ReplicaRouter([e], log=quiet).run([], tracer=tracer)
    assert (empty.results, tracer.spans, tracer.total_events) == ([], [], 0)
    with pytest.raises(ValueError, match="admission"):
        ReplicaRouter([e], log=quiet).run([], admission="drop")


def test_router_rejects_request_no_replica_can_ever_serve():
    _, e = pair()
    too_long = [Request(rid=0, prompt=np.ones((MAX_LEN + 1,), np.int32),
                        max_new_tokens=4)]
    with pytest.raises(ValueError, match="any replica"):
        ReplicaRouter([e, e], policy="round_robin", log=quiet).run(too_long)
    _, scarce = pair("paged", page_size=8, num_pages=3, slots=2)
    fat = [Request(rid=0, prompt=np.ones((16,), np.int32),
                   max_new_tokens=40)]
    with pytest.raises(PoolExhausted, match="no replica"):
        ReplicaRouter([scarce, scarce], log=quiet).run(fat)


# ---------------------------------------------------------------------------
# Policies


def test_round_robin_assignment_matches_reference():
    e = pair()
    a = both([e] * 3, lambda m: m.uniform_trace(6, 256, prompt_len=8,
                                                max_new=4, seed=2),
             "round_robin")
    assert a.replica_of == {i: i % 3 for i in range(6)}


def test_round_robin_skips_full_replicas():
    small = pair(slots=1)
    a = both([small] * 2, lambda m: m.uniform_trace(4, 256, prompt_len=8,
                                                    max_new=12, seed=2),
             "round_robin")
    assert sorted(a.replica_of) == [0, 1, 2, 3] and a.peak_in_flight == 2


def test_least_loaded_picks_most_free_tokens():
    one, four = pair(slots=1), pair(slots=4)
    a = both([one, one, four], lambda m: m.uniform_trace(
        3, 256, prompt_len=8, max_new=4, seed=0))
    assert set(a.replica_of.values()) == {2}


def test_least_loaded_balances_paged_fleet_by_free_pages():
    big = pair("paged", page_size=8, num_pages=13)
    small = pair("paged", page_size=8, num_pages=5)
    a = both([small, big], lambda m: m.uniform_trace(1, 256, prompt_len=8,
                                                     max_new=4, seed=1))
    assert a.replica_of[0] == 1


def test_prefix_replica_equals_reference_and_is_stable():
    rng = np.random.RandomState(7)
    for _ in range(60):
        p = rng.randint(1, 1000, size=(rng.randint(1, 24),))
        for n in (1, 2, 3, 4, 7):
            for plen in (4, 8):
                assert prefix_replica(p, n, plen) == \
                    ref_serving.prefix_replica(p, n, plen)
        r3, r4 = prefix_replica(p, 3), prefix_replica(p, 4)
        assert r4 == r3 or r4 == 3
    base = np.arange(1, 9, dtype=np.int32)
    a = np.concatenate([base, np.full((6,), 101, np.int32)])
    b = np.concatenate([base, np.full((12,), 907, np.int32)])
    assert prefix_replica(a, 5) == prefix_replica(b, 5)
    with pytest.raises(ValueError):
        prefix_replica(a, 0)


def test_prefix_affinity_routes_shared_prefixes_together():
    e = pair()
    base = np.arange(1, 9, dtype=np.int32)

    def trace(m):
        return [m.Request(rid=i, prompt=np.concatenate(
                    [base, np.full((i + 1,), 50 + i, np.int32)]),
                          max_new_tokens=4) for i in range(4)]
    a = both([e] * 3, trace, "prefix_affinity")
    assert set(a.replica_of.values()) == {prefix_replica(base, 3)}


# ---------------------------------------------------------------------------
# Overflow and re-route


def test_starved_request_reroutes_like_the_reference():
    scarce = pair("paged", page_size=8, num_pages=3, slots=2, eos_id=-1)
    roomy = pair(slots=2, eos_id=-1)

    def trace(m):
        return [m.Request(rid=0, prompt=np.arange(1, 17, dtype=np.int32),
                          max_new_tokens=40)]
    a = both([scarce, roomy], trace, "round_robin")
    assert a.reroutes >= 1 and a.replica_of == {0: 1}
    assert _tokens(a) == _tokens(roomy[1].run(trace(
        port_serving)))
    with pytest.raises(PoolExhausted, match="mid-decode"):
        scarce[1].run(trace(port_serving))
    with pytest.raises(PoolExhausted, match="no longer fit"):
        ReplicaRouter([scarce[1]], log=quiet).run(trace(
            port_serving))


# ---------------------------------------------------------------------------
# Equivalence


def test_single_replica_router_token_identical_to_bare_engine():
    e = pair()
    reqs = zipf_trace(12, 256, max_prompt=24, max_new=16, seed=3)
    a = both([e], lambda m: m.zipf_trace(12, 256, max_prompt=24, max_new=16,
                                         seed=3))
    ref = e[1].run(reqs)
    assert _tokens(a) == _tokens(ref)
    assert a.replica_stats[0].decode_steps == ref.decode_steps
    assert [r.preemptions for r in a.results] == \
        [r.preemptions for r in ref.results]
    assert a.replica_of == {r.rid: 0 for r in ref.results}


def test_mixed_layout_fleet_token_identical_to_single_engine():
    ec, ep = pair(), pair("paged", page_size=16)
    a = both([ep, ec], lambda m: m.zipf_trace(10, 256, max_prompt=16,
                                              max_new=12, seed=5))
    assert _tokens(a) == _tokens(ec[1].run(zipf_trace(
        10, 256, max_prompt=16, max_new=12, seed=5)))
    assert len(a.replica_of) == 10


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity"])
@pytest.mark.parametrize("seed,n", [(0, 10), (11, 7), (29, 9)])
def test_router_conserves_requests_across_preemptions(policy, seed, n):
    scarce, roomy = pair("paged", page_size=8, num_pages=13), pair()
    stats = both([scarce, roomy], lambda m: m.zipf_trace(
        n, 256, max_prompt=16, max_new=12, seed=seed), policy)
    assert [r.rid for r in stats.results] == list(range(n))
    per = [[r.rid for r in s.results] for s in stats.replica_stats]
    assert sorted(r for rids in per for r in rids) == list(range(n))


# ---------------------------------------------------------------------------
# Open loop, SLO admission and autoscaling (3 contiguous slots x 64)


def _otrace(m, n, mode="poisson", gap=4.0, seed=7):
    return m.with_arrivals(m.zipf_trace(n, 256, max_prompt=24, max_new=6,
                                        alpha=1.3, seed=0),
                           mode, mean_gap=gap, seed=seed)


def test_open_loop_streams_match_closed_replay():
    _, e = pair(slots=3)
    open_reqs = with_arrivals(zipf_trace(6, 256, max_prompt=24, max_new=6),
                              "poisson", mean_gap=5.0, seed=3)
    closed = [dataclasses.replace(r, arrival_vstep=0) for r in open_reqs]
    s_open, s_closed = e.run(open_reqs), e.run(closed)
    assert _tokens(s_open) == _tokens(s_closed)
    assert s_open.total_vsteps >= s_closed.total_vsteps


def test_router_open_loop_with_slo_and_autoscale_matches_reference():
    e = pair(slots=3)
    kw = dict(slo_ttft_steps=20, slo_e2e_steps=120, admission="reject",
              autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3))
    a = both([e] * 3, lambda m: _otrace(m, 10), **kw)
    b = both([e] * 3, lambda m: _otrace(m, 10), **kw)
    assert _counts(a) == _counts(b) and _tokens(a) == _tokens(b)


def test_slo_reject_partitions_and_explains():
    e = pair(slots=3)
    stats = both([e] * 2, lambda m: _otrace(m, 9, gap=1.0, seed=2),
                 slo_ttft_steps=3, admission="reject")
    done = {r.rid for r in stats.results}
    shed = {r.rid for r in stats.rejected}
    assert shed and done | shed == set(range(9)) and not done & shed
    for rej in stats.rejected:
        assert "slo_ttft" in rej.reason and rej.predicted_ttft_steps > 3
    full = both([e] * 2, lambda m: _otrace(m, 9, gap=1.0, seed=2),
                slo_ttft_steps=3, admission="queue")
    assert {r.rid for r in full.results} == set(range(9))
    assert not full.rejected
    with pytest.raises(ValueError, match="needs"):
        ReplicaRouter([e[1]] * 2, log=quiet).run(
            zipf_trace(2, 256), admission="reject")


def test_autoscale_drain_conserves_requests():
    e = pair(slots=3)
    stats = both([e] * 3, lambda m: _otrace(m, 14, "bursty", 3.0, 4),
                 slo_ttft_steps=12,
                 autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3,
                                           drain_idle_rounds=4))
    assert sorted(stats.replica_of) == list(range(14))
    assert stats.autoscale_grows > 0 and stats.peak_replicas > 1
    assert replay_peak_replicas(stats.autoscale_events, 1) == \
        stats.peak_replicas
    with pytest.raises(ValueError, match="continuous"):
        ReplicaRouter([e[1]] * 3, log=quiet).run(
            zipf_trace(2, 256), policy="static",
            autoscale=AutoscalePolicy())
    with pytest.raises(ValueError, match="min_replicas"):
        ReplicaRouter([e[1]] * 2, log=quiet).run(
            zipf_trace(2, 256), autoscale=AutoscalePolicy(min_replicas=3))


def test_autoscale_beats_fixed_and_metrics_keys_match_reference():
    e = pair(slots=3)
    slo = dict(slo_ttft_steps=20, slo_e2e_steps=120)
    fixed = both([e], lambda m: _otrace(m, 12, gap=6.0, seed=3), **slo)
    auto = both([e] * 3, lambda m: _otrace(m, 12, gap=6.0, seed=3),
                autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3),
                **slo)
    assert _tokens(fixed) == _tokens(auto)
    assert auto.p99_ttft_steps < fixed.p99_ttft_steps
    assert auto.goodput_tokens >= fixed.goodput_tokens
    want = ref_serving.ReplicaRouter([e[0]] * 3, log=quiet).run(
        _otrace(ref_serving, 12, gap=6.0, seed=3),
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3), **slo)
    got, ref_m = auto.to_metrics(), want.to_metrics()
    assert list(got) == list(ref_m)
    assert list(got) == [s.key for s in ROUTER_SCHEMA
                         if "{i}" not in s.key] + [
        s.key.replace("{i}", str(i)) for i in range(3)
        for s in ROUTER_SCHEMA if "{i}" in s.key]
    for key, value in ref_m.items():
        if key not in ("router_wall_s", "router_tokens_per_s"):
            assert got[key] == value or (got[key] != got[key] and
                                         value != value), key


# ---------------------------------------------------------------------------
# BENCH_serving.json's router, long-prompt and open-loop cells


def _tight_spec(module):
    """The serving benchmark's budget target (``bench:serve-tight``)."""
    cfg = ref_config(ARCH)
    hbm = (2 * param_count_estimate(cfg) +
           3.5 * kv_bytes_per_token(cfg) * 128) / 0.85
    return module.TargetSpec(
        name=TIGHT, chip="cpu", mesh_shape=(1,), mesh_axes=("data",),
        peak_flops=5e10, hbm_bw=2e10, hbm_bytes=hbm, ici_bw=1e9,
        scheduler="local", kernels="reference")


@pytest.fixture(scope="module")
def tight():
    for module in (ref_target, port_target):
        if TIGHT not in module.TARGETS:
            module.register(_tight_spec(module))
    e = pair(slots=8, max_len=128, target=TIGHT)
    assert e[1].num_slots == 3 and e[1].prefill_chunk == 8
    return e


def _num(x):
    return None if x != x else round(x, 4)


def _rounds(stats):
    return max(max(s.decode_steps for s in stats.replica_stats), 1)


def _bench_keys(name, **skip):
    return {k: v for k, v in BENCH[name].items()
            if k not in ("tokens_per_s", *skip)}


def _zipf(m):
    return m.zipf_trace(12, 256, max_prompt=48, max_new=32, alpha=1.3,
                        seed=0)


def test_router_least_loaded_x3_cell(tight):
    s = both([tight] * 3, _zipf, prefill_chunk=0)
    single = tight[1].run(_zipf(port_serving),
                          prefill_chunk=0)
    got = {"tokens_per_step": round(s.generated_tokens / _rounds(s), 4),
           "replicas": 3, "route_policy": "least_loaded",
           "generated_tokens": s.generated_tokens,
           "decode_steps": _rounds(s), "peak_in_flight": s.peak_in_flight,
           "in_flight_vs_single": round(
               s.peak_in_flight / max(single.peak_active, 1), 2),
           "load_imbalance": _num(s.imbalance), "reroutes": s.reroutes}
    assert got == _bench_keys("router_least_loaded_x3")
    assert _tokens(s) == _tokens(single)


@pytest.mark.parametrize("name,chunk", [("longprompt_router_blocking", 0),
                                        ("longprompt_router_chunked", None)])
def test_longprompt_cells(tight, name, chunk):
    s = both([tight] * 3, lambda m: m.longprompt_trace(
        12, 256, max_prompt=128, max_new=8, seed=0), prefill_chunk=chunk)
    got = {"tokens_per_step": round(s.generated_tokens / _rounds(s), 4),
           "mean_ttft_steps": round(s.mean_ttft_steps, 4),
           "prefill_chunk": 0 if chunk == 0 else tight[1].prefill_chunk,
           "prefill_chunks": s.prefill_chunks,
           "prefill_compiles": max(x.prefill_buckets
                                   for x in s.replica_stats),
           "prefill_queue_peak": max(x.prefill_queue_peak
                                     for x in s.replica_stats),
           "overlap_steps": s.overlap_steps,
           "generated_tokens": s.generated_tokens,
           "decode_steps": _rounds(s), "replicas": 3,
           "reroutes": s.reroutes}
    assert got == _bench_keys(name)


@pytest.mark.parametrize("name,fleet,auto", [
    ("openloop_poisson_fixed", 1, False),
    ("openloop_poisson_autoscale", 3, True)])
def test_openloop_cells(tight, name, fleet, auto):
    kw = dict(prefill_chunk=0, slo_ttft_steps=20, slo_e2e_steps=120)
    if auto:
        kw["autoscale"] = AutoscalePolicy(min_replicas=1, max_replicas=3)
    s = both([tight] * fleet, lambda m: m.with_arrivals(
        _zipf(m), "poisson", mean_gap=6.0, seed=3), **kw)
    m = s.to_metrics()
    got = {"arrivals": "poisson", "arrival_gap": 6.0, "arrival_seed": 3,
           "slo_ttft_steps": 20, "slo_e2e_steps": 120,
           "p50_ttft_steps": _num(s.p50_ttft_steps),
           "p99_ttft_steps": _num(s.p99_ttft_steps),
           "p50_e2e_steps": _num(s.p50_e2e_steps),
           "p99_e2e_steps": _num(s.p99_e2e_steps),
           "goodput_tokens": s.goodput_tokens,
           "generated_tokens": s.generated_tokens,
           "total_vsteps": s.total_vsteps,
           "peak_replicas": m["router_peak_replicas"],
           "autoscale_grows": m["router_autoscale_grows"],
           "autoscale_drains": m["router_autoscale_drains"],
           "replicas": fleet}
    assert got == _bench_keys(name)
