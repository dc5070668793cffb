"""The benchmark's generator and arithmetic on hand-made inputs."""

import math

import numpy as np
import pytest

from portbench import counts, generator

MIX_OPEN = {"loop": "open", "rate_per_s": 4.0, "warm_s": 2.0,
            "trace_seed": 7,
            "prompt": {"median": 100, "sigma": 0.5, "min": 20, "max": 300},
            "output": {"median": 10, "sigma": 0.7, "min": 2, "max": 40}}
MIX_CLOSED = {"loop": "closed", "clients_per_slot": 1.5, "trace_seed": 8,
              "prompt": MIX_OPEN["prompt"], "output": MIX_OPEN["output"]}


def _open(seed, mix=MIX_OPEN, seconds=10.0):
    return generator.open_loop(mix, seed, seconds, 1000)


def _closed(seed, n=40):
    gen = generator.ClosedLoop(MIX_CLOSED, seed, 1000, 4)
    return [gen.next() for _ in range(n)]


@pytest.mark.parametrize("make", [_open, _closed])
def test_generator_repeats_from_a_seed(make):
    a, b = make(2**31 + 17), make(2**31 + 17)
    assert [(s.rid, s.max_new_tokens, s.due_s) for s in a] == \
        [(s.rid, s.max_new_tokens, s.due_s) for s in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("make", [_open, _closed])
def test_generator_differs_across_seeds(make):
    # the trace is the mix's: a seed draws the token ids alone
    a, b = make(3), make(4)
    assert [(len(s.prompt), s.max_new_tokens, s.due_s) for s in a] == \
        [(len(s.prompt), s.max_new_tokens, s.due_s) for s in b]
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])


def test_open_loop_arrivals_are_poisson():
    mix = dict(MIX_OPEN, warm_s=0.0)
    due = np.array([s.due_s for s in _open(1, mix, seconds=500.0)])
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / 4.0, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.08)
    # counts a second: as spread as they are many (not smoothed)
    counts_ = np.bincount(due[due < 1000].astype(int))
    assert counts_.var() / counts_.mean() == pytest.approx(1.0, abs=0.2)


def test_open_loop_replays_one_trace_at_any_rate():
    a, b = _open(5), _open(5, dict(MIX_OPEN, rate_per_s=8.0))
    n = len(a)
    assert n == math.ceil(4.0 * (2.0 + 20.0))
    assert [len(s.prompt) for s in a] == [len(s.prompt) for s in b[:n]]
    assert [s.max_new_tokens for s in a] == \
        [s.max_new_tokens for s in b[:n]]
    assert [s.due_s + 2.0 for s in a] == pytest.approx(
        [2 * (s.due_s + 2.0) for s in b[:n]])
    assert a[0].due_s == pytest.approx(-MIX_OPEN["warm_s"])
    assert all(x.due_s <= y.due_s for x, y in zip(a, a[1:]))


def test_lengths_are_clipped_lognormal():
    rng = np.random.default_rng(0)
    d = {"median": 100, "sigma": 0.5, "min": 60, "max": 150}
    x = generator.lengths(d, 4001, rng)
    assert x.min() == 60 and x.max() == 150
    assert abs(np.median(x) - 100) <= 3
    assert (x == 60).mean() == pytest.approx(0.154, abs=0.02)


def test_closed_loop_first_wave_is_the_same_work_every_seed():
    a, b = _closed(9), _closed(10)
    assert [len(s.prompt) for s in a] == [len(s.prompt) for s in b]
    assert [s.max_new_tokens for s in a] == [s.max_new_tokens for s in b]
    tr = generator.trace(MIX_CLOSED)
    # the wave stands for requests under way: a share of its output left
    assert all(1 <= s.max_new_tokens <= o
               for s, o in zip(a[:4], tr.outputs[:4]))
    assert [s.max_new_tokens for s in a[4:8]] == list(tr.outputs[4:8])
    assert generator.ClosedLoop(MIX_CLOSED, 9, 1000, 4).clients == 6


def test_percentile_and_rate():
    assert counts.percentile([], 90) is None
    assert counts.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10.0
    assert counts.percentile([5.0], 90) == 5.0
    assert counts.rate(300, 2.0) == 150.0
    assert counts.rate(1, 0.0) is None


def test_union_length():
    assert counts.union_length([]) == 0
    assert counts.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert counts.union_length([(3, 4), (0, 10)]) == 10


M = {"layers": 2, "d_model": 8, "heads": 4, "kv_heads": 2, "head_dim": 2,
     "d_ff": 16, "vocab": 10}


def test_k1_bytes_and_bound():
    # 2 slots holding 10 + 6 keys: K and V rows of 2 kv heads x 2 dims in
    # bf16, q and out of 4 heads x 2 dims, lengths and page entries
    b = counts.k1_bytes(M, 2, 16)
    assert b == 16 * 2 * 2 * 2 * 2 + 2 * 2 * 4 * 2 * 2 + 4 * (2 + 1)
    assert counts.k1_flops(M, 16) == 4 * 4 * 2 * 16
    assert counts.k1_bound_s(M, 2, 16) == b / counts.HBM_BYTES_PER_S


def test_model_flops():
    dense = counts.dense_flops_per_token(M)
    # per layer: q, k, v, o products and the gated MLP; then the head
    assert dense == 2 * (2 * (8 * 8 * 2 + 8 * 8 + 3 * 8 * 16) + 8 * 10)
    moe = dict(M, experts=4, top_k=2)
    assert counts.dense_flops_per_token(moe) == 2 * (
        2 * (8 * 8 * 2 + 8 * 8 + 2 * 3 * 8 * 16 + 8 * 4) + 8 * 10)
    # three prompt tokens at offset 2 read 3, 4 and 5 keys
    assert counts.prefill_flops(M, 2, 3) == \
        3 * dense + counts.attention_flops(M, 12)
    assert counts.attention_flops(M, 1) == 4 * 2 * 4 * 2
    assert counts.decode_flops(M, 2, 9) == \
        2 * dense + counts.attention_flops(M, 9)
