"""The port's request traces, arrival presets and the small host-side
helpers the router needs, against the JAX reference on the CPU.

Every trace draws from ``np.random.RandomState(seed)``, so both packages
must build the same requests, field for field (rid, prompt,
``max_new_tokens``, ``arrival_vstep`` and the sampling fields), for every
trace and arrival preset and several seeds.  The TTFT napkin, the
trace-repetitiveness measure and ``rebalance_batch_size`` are integer
host math and must agree exactly too.
"""

import dataclasses

import numpy as np
import pytest

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.core.tuning import ttft_napkin_steps as ref_napkin
from repro.runtime.elastic import rebalance_batch_size as ref_rebalance
from repro_torch.core.tuning import ttft_napkin_steps
from repro_torch.runtime.elastic import rebalance_batch_size

SEEDS = (0, 3, 17)
SAMPLED = dict(temperature=0.7, top_k=16, top_p=0.9)
# (trace, keyword arguments): each trace at its defaults and at the
# serving benchmark's settings, greedy and sampled
TRACES = [
    ("zipf_trace", dict(max_prompt=48, max_new=32, alpha=1.3)),
    ("zipf_trace", dict(SAMPLED)),
    ("longprompt_trace", {}),
    ("longprompt_trace", dict(max_prompt=128, max_new=8, **SAMPLED)),
    ("sharedprefix_trace", {}),
    ("sharedprefix_trace", dict(n_heads=4, head_len=256, max_suffix=64,
                                max_new=16)),
    ("uniform_trace", dict(prompt_len=8, max_new=4, **SAMPLED)),
    ("repetitive_trace", {}),
]
ARRIVALS = [("closed", {}), ("poisson", dict(mean_gap=6.0)),
            ("poisson", dict(mean_gap=1.0)),
            ("bursty", dict(mean_gap=3.0)),
            ("bursty", dict(mean_gap=6.0, burst=4.0, period=6.0))]


def _fields(reqs):
    return [(r.rid, np.asarray(r.prompt).dtype.str,
             np.asarray(r.prompt).tolist(), r.max_new_tokens,
             r.arrival_vstep, r.temperature, r.top_k, r.top_p)
            for r in reqs]


def _both(name, n, vocab, seed, **kw):
    return (getattr(ref_serving, name)(n, vocab, seed=seed, **kw),
            getattr(port_serving, name)(n, vocab, seed=seed, **kw))


@pytest.mark.parametrize("name,kw", TRACES)
@pytest.mark.parametrize("seed", SEEDS)
def test_traces_equal_the_reference(name, kw, seed):
    want, got = _both(name, 24, 256, seed, **kw)
    assert _fields(got) == _fields(want)
    assert all(isinstance(r, port_serving.Request) for r in got)
    assert port_serving.trace_repetitiveness(got) == \
        ref_serving.trace_repetitiveness(want)


@pytest.mark.parametrize("mode,kw", ARRIVALS)
@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_presets_equal_the_reference(mode, kw, seed):
    want, got = _both("zipf_trace", 14, 256, 0, max_prompt=24, max_new=6)
    want = ref_serving.with_arrivals(want, mode, seed=seed, **kw)
    got = port_serving.with_arrivals(got, mode, seed=seed, **kw)
    assert _fields(got) == _fields(want)
    stamps = [r.arrival_vstep for r in got]
    assert stamps == sorted(stamps)
    if mode != "closed":
        assert stamps[-1] > 0
        direct = getattr(port_serving, f"{mode}_arrivals")(
            port_serving.zipf_trace(14, 256, max_prompt=24, max_new=6),
            seed=seed, **kw)
        assert [r.arrival_vstep for r in direct] == stamps


def test_arrival_modes_and_their_errors():
    assert port_serving.ARRIVAL_MODES == ref_serving.ARRIVAL_MODES
    reqs = port_serving.zipf_trace(2, 256)
    with pytest.raises(ValueError, match="burst"):
        port_serving.bursty_arrivals(reqs, burst=0.5)
    with pytest.raises(ValueError, match="arrival mode"):
        port_serving.with_arrivals(reqs, "uniform")
    opened = port_serving.with_arrivals(reqs, "poisson", mean_gap=3.0,
                                        seed=2)
    assert all(r.arrival_vstep == 0 for r in
               port_serving.with_arrivals(opened, "closed"))


def test_sharedprefix_trace_clusters_heads():
    a = port_serving.sharedprefix_trace(16, 1000, seed=2)
    heads = [tuple(r.prompt[:32]) for r in a]
    assert len(set(heads)) <= 4
    top = max(set(heads), key=heads.count)
    assert heads.count(top) >= len(a) // 2
    assert all(len(r.prompt) > 32 for r in a)


@pytest.mark.parametrize("prompt", [np.full(4, 7), np.full(12, 7),
                                    np.arange(16), np.resize([3, 1, 4], 20)])
def test_trace_repetitiveness_equals_the_reference(prompt):
    reqs = [port_serving.Request(rid=0, prompt=prompt.astype(np.int32))]
    refs = [ref_serving.Request(rid=0, prompt=prompt.astype(np.int32))]
    assert port_serving.trace_repetitiveness(reqs) == \
        ref_serving.trace_repetitiveness(refs)


@pytest.mark.parametrize("args", [(64, 16), (1, 16), (64, 16, 3, 2),
                                  (0, 8, 0, 0), (300, 128, 7, 11)])
def test_ttft_napkin_equals_the_reference(args):
    assert ttft_napkin_steps(*args) == ref_napkin(*args)


@pytest.mark.parametrize("batch,old,new,shrink", [
    (24, 3, 2, False), (24, 1, 3, True), (24, 3, 1, True), (8, 2, 3, True),
    (9, 3, 3, False)])
def test_rebalance_batch_size_equals_the_reference(batch, old, new, shrink):
    assert rebalance_batch_size(batch, old, new, allow_shrink=shrink) == \
        ref_rebalance(batch, old, new, allow_shrink=shrink)


def test_rebalance_batch_size_errors():
    with pytest.raises(ValueError, match="positive"):
        rebalance_batch_size(8, 2, 0)
    with pytest.raises(ValueError, match="allow_shrink"):
        rebalance_batch_size(8, 2, 3)


def test_request_fields_are_the_reference_fields():
    assert [f.name for f in dataclasses.fields(port_serving.Request)] == \
        [f.name for f in dataclasses.fields(ref_serving.Request)]
