"""The port's serving telemetry against the JAX reference's, on the CPU.

* The metric schemas, the registry's rules and the Prometheus text are
  the reference's: the same keys, kinds and help in the same order, the
  same text for the same snapshot (an equality, no tolerance).
* Spans and ring events of a traced drain equal the reference's on the
  same weights (the reference's, crossed bit for bit): one engine on
  ``BENCH_serving.json``'s trace, and the reference's own
  ``_full_fleet_run`` recipe (``tests/test_serving_telemetry.py``: three
  ``picolm-4-smoke`` spec replicas under page pressure, chunked prefill,
  the prefix cache, Poisson arrivals, SLO admission, autoscaling).  The
  Chrome-trace files of the two packages are equal byte for byte.
* That recipe grows the fleet to 2 replicas in both packages on this
  JAX, so its trace names processes {0, 1}; the reference test's literal
  {0, 1, 2} depends on how far the fleet grows.  A denser arrival
  process (mean gap 1.0) grows it to 3 in both, and its trace names
  {0, 1, 2}.
* Tracing on and off give identical streams and metrics, apart from the
  two wall-clock keys.
* ``BENCH_serving.json``'s ``telemetry_overhead`` cell: every key but
  the wall-clock ``tokens_per_s`` equals the file's, and the streams equal
  the untraced ``paged_continuous`` run's.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro.serving as R
import repro.serving.telemetry as ref_tel
import repro_torch.core.target as port_target
import repro_torch.serving as P
from repro.configs import get_config as ref_config
from repro.core.tuning import kv_bytes_per_token, param_count_estimate
from repro_torch.models.params import params_from_jax
from repro_torch.serving import telemetry as tel

BENCH = json.loads((Path(__file__).resolve().parents[1] /
                    "BENCH_serving.json").read_text())["cells"]
TIGHT = "bench:serve-tight"
WALL = ("serve_wall_s", "serve_tokens_per_s", "router_wall_s",
        "router_tokens_per_s")
quiet = lambda *a, **k: None  # noqa: E731
PKGS = {"ref": R, "port": P}

_PAIRS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the smoke steps are many
    tiny ops, and the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tight_spec(module):
    """The serving benchmark's budget target (``benchmarks/
    serving_throughput.py``)."""
    cfg = ref_config("deepseek-7b-smoke")
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


def pair(name):
    """(reference engine, port engine) on the reference's weights."""
    if name not in _PAIRS:
        if name == "fleet":
            kw = dict(arch="picolm-4-smoke", target="local:cpu",
                      num_slots=3, max_len=64, kv_layout="paged",
                      page_size=8, num_pages=5, spec_k=2)
        else:
            kw = dict(arch="deepseek-7b-smoke", target=TIGHT, num_slots=8,
                      max_len=128, kv_layout="paged")
        ref = R.ServeEngine(seed=0, log=quiet, **kw)
        port = P.ServeEngine(seed=0, log=quiet, device="cpu", **kw)
        port.params = params_from_jax(jax.tree.map(np.asarray, ref.params))
        _PAIRS[name] = (ref, port)
    return _PAIRS[name]


def _tokens(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _no_wall(metrics):
    return {k: v for k, v in metrics.items() if k not in WALL}


def _same_numbers(a: dict, b: dict) -> bool:
    """Equal key lists and values, NaN equal to NaN."""
    return list(a) == list(b) and all(
        a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]) for k in a)


def _spans(tracer):
    return [dataclasses.astuple(s) for s in tracer.spans]


def _events(tracer):
    return [dataclasses.astuple(e) for e in tracer.events]


def fleet_run(m, engine, tracer=None, mean_gap=2.0):
    """The reference's ``_full_fleet_run`` on package ``m``; ``mean_gap``
    1.0 is the denser arrival process that grows the fleet to 3."""
    reqs = m.sharedprefix_trace(10, engine.cfg.vocab_size, n_heads=2,
                                head_len=8, max_suffix=10, max_new=10,
                                seed=3)
    reqs = m.poisson_arrivals(reqs, mean_gap=mean_gap, seed=7)
    router = m.ReplicaRouter([engine] * 3, log=quiet)
    return router.run(reqs, policy="continuous", prefill_chunk=8,
                      prefix_cache=True, slo_ttft_steps=30,
                      slo_e2e_steps=200, admission="reject",
                      autoscale=m.AutoscalePolicy(min_replicas=1,
                                                  max_replicas=3),
                      tracer=tracer)


def bench_trace(m):
    return m.zipf_trace(12, 256, max_prompt=48, max_new=32, alpha=1.3,
                        seed=0)


# ---------------------------------------------------------------------------
# Schemas, registry, Prometheus text


def _spec_rows(schema):
    return [(s.key, s.kind, s.help) for s in schema]


@pytest.mark.parametrize("name", ["SERVE_SCHEMA", "ROUTER_SCHEMA"])
def test_schemas_equal_the_reference(name):
    assert _spec_rows(getattr(tel, name)) == \
        _spec_rows(getattr(ref_tel, name))


def test_phases_and_event_kinds_equal_the_reference():
    assert (tel.PHASES, tel.EVENT_KINDS) == \
        (ref_tel.PHASES, ref_tel.EVENT_KINDS)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_registry_rules(pkg):
    """The reference's registry cases, run on both packages."""
    m = PKGS[pkg]
    reg = m.MetricsRegistry((m.MetricSpec("a_total", "counter", "a"),
                             m.MetricSpec("b_now", "gauge", "b")))
    reg.set("a_total", 3)
    with pytest.raises(KeyError):
        reg.set("not_declared", 1)
    with pytest.raises(ValueError, match="b_now"):
        reg.snapshot()
    reg.set("b_now", 0.5)
    assert reg.snapshot() == {"a_total": 3, "b_now": 0.5}
    with pytest.raises(ValueError):
        reg.declare(m.MetricSpec("a_total", "counter", "dup"))
    with pytest.raises(ValueError):
        reg.declare(m.MetricSpec("bad key!", "gauge", ""))
    with pytest.raises(ValueError):
        m.MetricSpec("x", "summary", "")
    hist = m.MetricsRegistry()
    hist.declare(m.MetricSpec("hits_total", "counter", ""))
    hist.declare(m.MetricSpec("lat_steps", "histogram", ""), buckets=(1, 4))
    hist.inc("hits_total")
    hist.inc("hits_total", 2)
    with pytest.raises(ValueError):
        hist.observe("hits_total", 1)
    with pytest.raises(ValueError):
        hist.set("lat_steps", 1)
    for v in (1, 2, 3, 99):
        hist.observe("lat_steps", v)
    assert hist.snapshot() == {"hits_total": 3, "lat_steps_count": 4,
                               "lat_steps_sum": 105.0, "lat_steps_le_1": 1,
                               "lat_steps_le_4": 2}
    routers = m.MetricsRegistry(m.ROUTER_SCHEMA)
    for i in (0, 1, 7):
        routers.set(f"replica{i}_generated_tokens", i)
    assert routers.spec_for("replica7_occupancy").kind == "gauge"
    with pytest.raises(KeyError):
        routers.spec_for("replicaX_generated_tokens")


def test_prometheus_text_equals_the_reference():
    metrics = {"x_total": 4, "y_now": float("nan"), "z_free": 1.5,
               "w_flag": True, "v_int_float": 3.0}
    schema = (("x_total", "counter", "things done"), ("y_now", "gauge", ""))
    want = ref_tel.prometheus_text(
        metrics, [ref_tel.MetricSpec(*s) for s in schema])
    got = tel.prometheus_text(metrics, [tel.MetricSpec(*s) for s in schema])
    assert got == want
    assert "y_now NaN" in got.splitlines()


# ---------------------------------------------------------------------------
# Tracer semantics


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tracer_spans_ring_and_metrics(pkg):
    m = PKGS[pkg]
    tr = m.Tracer(ring_capacity=4)
    tr.begin("queued", 1, 0)
    assert tr.end_any(("resume", "queued"), 1, 3)
    assert not tr.end("decode", 9, 4)
    assert tr.unmatched_ends == 1
    tr.begin("decode", 2, 1, slot=0)
    tr.begin("decode", 2, 5, slot=0)     # re-begin closes the open one
    first, second = tr.spans_of("decode")
    assert first.v_end == 5 and second.v_start == 5
    tr.span("spec_verify", 2, 5, 6, k=2)
    assert tr.close(9) == 1 and second.v_end == 9
    for v in range(10):
        tr.instant("preempt", v, rid=v)
    assert (tr.total_events, len(tr.events), tr.dropped_events) == (10, 4, 6)
    assert [e.vstep for e in tr.events_of("preempt")] == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        m.Tracer(ring_capacity=0)
    snap = tr.metrics().snapshot(require_complete=False)
    assert snap["trace_spans_total"] == 4
    assert snap["trace_decode_spans"] == 2
    assert snap["trace_span_vsteps_sum"] == 3.0 + 4 + 4 + 1


def test_tracer_metrics_equal_the_reference():
    trs = {}
    for pkg, m in PKGS.items():
        tr = trs[pkg] = m.Tracer(ring_capacity=3)
        tr.span("prefill_chunk", 1, 0, 1, index=0)
        tr.begin("decode", 1, 1, slot=2)
        tr.instant("reroute", 3, replica=1, rid=1)
        tr.end("decode", 1, 9, tokens=4)
        for v in range(4):
            tr.instant("reject", v + 4, rid=v)
    got, want = trs["port"].metrics(), trs["ref"].metrics()
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    assert tel.chrome_trace(trs["port"]) == ref_tel.chrome_trace(trs["ref"])


def test_json_sanitize_equals_the_reference():
    obj = {"a": float("nan"), "b": [1.0, float("inf"), (2, -float("inf"))],
           "c": {"d": 3}}
    assert tel.json_sanitize(obj) == ref_tel.json_sanitize(obj) == \
        {"a": None, "b": [1.0, None, [2, None]], "c": {"d": 3}}


# ---------------------------------------------------------------------------
# Traced drains against the reference


def test_engine_spans_and_events_equal_the_reference():
    """BENCH_serving.json's trace on the paged engine, chunked prefill
    (spans per chunk), traced in both packages."""
    ref, port = pair("bench")
    trs = {"ref": R.Tracer(), "port": P.Tracer()}
    want = ref.run(bench_trace(R), tracer=trs["ref"])
    got = port.run(bench_trace(P), tracer=trs["port"])
    assert _tokens(got) == _tokens(want)
    assert _spans(trs["port"]) == _spans(trs["ref"])
    assert _events(trs["port"]) == _events(trs["ref"])
    assert {s.phase for s in trs["port"].spans} == \
        {"queued", "prefill_chunk", "decode"}
    assert _same_numbers(_no_wall(got.to_metrics()),
                         _no_wall(want.to_metrics()))


@pytest.mark.parametrize("mean_gap", [2.0, 1.0])
def test_fleet_trace_bytes_equal_the_reference(tmp_path, mean_gap):
    ref, port = pair("fleet")
    trs = {"ref": R.Tracer(), "port": P.Tracer()}
    want = fleet_run(R, ref, trs["ref"], mean_gap)
    got = fleet_run(P, port, trs["port"], mean_gap)
    assert _tokens(got) == _tokens(want)
    assert _spans(trs["port"]) == _spans(trs["ref"])
    assert _events(trs["port"]) == _events(trs["ref"])
    assert (trs["port"].total_events, trs["port"].unmatched_ends) == \
        (trs["ref"].total_events, trs["ref"].unmatched_ends)
    paths = {k: tmp_path / f"{k}.json" for k in trs}
    ref_tel.write_chrome_trace(trs["ref"], paths["ref"])
    trace = tel.write_chrome_trace(trs["port"], paths["port"])
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    # the properties the reference's Chrome-trace test asserts
    data = json.loads(paths["port"].read_text())
    assert data == trace
    by_ph: dict = {}
    for ev in data["traceEvents"]:
        by_ph.setdefault(ev["ph"], []).append(ev)
    assert set(tel.PHASES) <= {ev["name"] for ev in by_ph["X"]}
    inst = [ev for ev in by_ph["i"] if ev["name"].startswith("autoscale_")]
    assert inst and all(ev["s"] == "p" for ev in inst)
    pids = {ev["pid"] for ev in by_ph["M"] if ev["name"] == "process_name"}
    served = {s.replica for s in trs["port"].spans if s.phase == "decode"}
    assert pids == set(range(got.peak_replicas)) == served
    assert pids == ({0, 1} if mean_gap == 2.0 else {0, 1, 2})
    threads = {ev["args"]["name"] for ev in by_ph["M"]
               if ev["name"] == "thread_name"}
    assert threads >= {"queue", "slot 0"}
    assert all(isinstance(ev["ts"], int) for ev in data["traceEvents"]
               if "ts" in ev)
    ts = [ev["ts"] for ev in by_ph["X"]]
    assert ts == sorted(ts)
    assert trs["port"]._open == {}
    assert {e.kind for e in trs["port"].events} <= set(tel.EVENT_KINDS)


def test_fleet_tracing_on_equals_off_and_serializes_identically(tmp_path):
    _, port = pair("fleet")
    off = fleet_run(P, port)
    tr1, tr2 = P.Tracer(), P.Tracer()
    on = fleet_run(P, port, tr1)
    fleet_run(P, port, tr2)
    assert _tokens(on) == _tokens(off)
    assert on.total_vsteps == off.total_vsteps
    assert on.autoscale_events == off.autoscale_events
    assert _same_numbers(_no_wall(on.to_metrics()), _no_wall(off.to_metrics()))
    assert list(on.to_metrics()) == [
        s.key for s in tel.ROUTER_SCHEMA if "{i}" not in s.key] + [
        s.key.replace("{i}", str(i)) for i in range(3)
        for s in tel.ROUTER_SCHEMA if "{i}" in s.key]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    tel.write_chrome_trace(tr1, a)
    tel.write_chrome_trace(tr2, b)
    assert a.read_bytes() == b.read_bytes()
    assert P.replay_peak_replicas(on.autoscale_events, 1) == on.peak_replicas


def test_serve_stats_to_metrics_equals_the_reference():
    ref, port = pair("bench")
    want = ref.run(bench_trace(R), prefill_chunk=0).to_metrics()
    got = port.run(bench_trace(P), prefill_chunk=0).to_metrics()
    assert list(got) == [s.key for s in tel.SERVE_SCHEMA]
    assert _same_numbers(_no_wall(got), _no_wall(want))
    assert tel.prometheus_text(_no_wall(got), tel.SERVE_SCHEMA) == \
        ref_tel.prometheus_text(_no_wall(want), ref_tel.SERVE_SCHEMA)


# ---------------------------------------------------------------------------
# BENCH_serving.json's telemetry_overhead cell


def test_telemetry_overhead_cell_matches_bench():
    """The cell's recipe (``benchmarks/serving_throughput.py``): the
    paged_continuous drain, blocking prefill, re-run with a Tracer."""
    _, port = pair("bench")
    plain = port.run(bench_trace(P), policy="continuous", prefill_chunk=0)
    tr = P.Tracer()
    stats = port.run(bench_trace(P), policy="continuous", prefill_chunk=0,
                     tracer=tr)
    cell = {"tokens_per_step": round(
                stats.generated_tokens / max(stats.decode_steps, 1), 4),
            "decode_steps": stats.decode_steps,
            "generated_tokens": stats.generated_tokens,
            "trace_spans": len(tr.spans),
            "ring_events": tr.total_events,
            "mean_ttft_steps": round(stats.mean_ttft_steps, 4)}
    want = {k: v for k, v in BENCH["telemetry_overhead"].items()
            if k != "tokens_per_s"}
    assert cell == want
    assert _tokens(stats) == _tokens(plain)
    assert _same_numbers(_no_wall(stats.to_metrics()),
                         _no_wall(plain.to_metrics()))
