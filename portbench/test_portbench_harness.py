"""The harness on the CPU at the port's smoke sizes: its scheduler loop,
its files found by name, the check against faults planted under the
timed path, and the lower-precision control."""

import json
import time

import pytest
import torch

from portbench import control, harness, judge, report, smoke

# an open loop's window holds a burst or a lull of the mix's trace: long
# enough for some tens of finished requests on a loaded CPU
SECONDS = {"closed": 0.6, "open": 1.5}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("root"))


def _seconds(cell):
    return SECONDS[cell.mix["loop"]]


def _measure(root, name, seed=11, trace=False, wrap=None, control=False):
    cell = smoke.cell(root, name)
    return report.measure(cell, seed, _seconds(cell), trace, "cpu",
                          time.perf_counter(), wrap=wrap, log=lambda s: None,
                          control=control)


@pytest.mark.parametrize("name", sorted(smoke.CELLS))
def test_smoke_cell_runs_through_the_scheduler_loop(root, name):
    result, lines = _measure(root, name)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    m = result["metrics"]
    assert m["setup_s"]["value"] > 0
    if name.endswith(".batch"):
        assert m["tokens_per_s"]["value"] > 0
    else:
        assert m["ttft_p90_ms"]["value"] > 0 and m["itl_p90_ms"]["value"] > 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["compared_tokens"]["value"] >= 20
    assert lines[-1].startswith("check unanswered: 0")
    json.dumps(result)


def test_traced_smoke_run_reads_per_layer_metrics(root):
    result, _ = _measure(root, "granite-smoke.batch", trace=True)
    m = result["metrics"]
    assert 0 < m["slot_occupancy.batch"]["value"] <= 100
    assert 0 < m["mfu.batch"]["value"] < 100
    # CUDA events and the profiler are the card's: nothing to read here
    assert "k1_roofline.batch" not in m and "decode_tick_ms.batch" not in m


def test_traced_open_loop_smoke_run_reads_its_metrics(root):
    result, _ = _measure(root, "stablelm-smoke.longdoc", trace=True)
    m = result["metrics"]
    assert m["arrival_lateness_p90_ms.longdoc"]["value"] >= 0
    assert m["queue_wait_p90_ms.longdoc"]["value"] >= 0
    # CUDA events are the card's: nothing to read here
    assert "chunk_step_ms.longdoc" not in m


def test_a_config_mix_and_metric_are_found_by_their_files(tmp_path):
    root = smoke.make_root(tmp_path)
    pb = root / "portbench"
    cfg = dict(smoke.CONFIGS["stablelm-smoke"])
    smoke.write(pb / "configs" / "stablelm-smoke-b.json", cfg)
    smoke.write(pb / "traffic" / "slow-smoke.json",
                dict(smoke.MIXES["longdoc-smoke"], rate_per_s=6.0))
    smoke.write(pb / "limits" / "stablelm-smoke-b.slow.json",
                smoke.LIMITS["stablelm-smoke.longdoc"])
    (pb / "metrics" / "chunks_run.py").write_text(
        "def read(rec):\n    return float(len(rec.chunks))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stablelm-smoke-b", "source": "smoke",
                             "file": "portbench/configs/stablelm-smoke-b.json",
                             "reduced": [], "why": "smoke"})
    bench["workloads"].append({"name": "stablelm-smoke-b.slow",
                               "config": "stablelm-smoke-b",
                               "traffic": "slow-smoke", "chips": 1,
                               "why": "smoke"})
    bench["per_layer"].append({"name": "chunks_run.slow", "unit": "chunks",
                               "better": "lower", "source": "program_counter",
                               "layer": "prefill", "moves": "ttft_p90_ms",
                               "workloads": ["stablelm-smoke-b.slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = smoke.cell(root, "stablelm-smoke-b.slow")
    assert cell.mix["rate_per_s"] == 6.0
    result, lines = report.measure(cell, 5, _seconds(cell), True, "cpu",
                                   time.perf_counter(), log=lambda s: None)
    assert result["correct"], lines
    assert result["metrics"]["chunks_run.slow"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", sorted(smoke.CELLS))
def test_a_fault_under_the_timed_path_is_not_correct(root, name, fault):
    result, lines = _measure(root, name, wrap=control.FAULTS[fault])
    assert not result["correct"], lines
    c = result["checks"]["max_logit_gap"]
    assert c["value"] > c["limit"]


def test_fp8_control_fails_the_dense_smoke_limit(root):
    cell = smoke.cell(root, "stablelm-smoke.longdoc")
    limit = cell.limits["mean_logit_gap"]
    for seed in (11, 12, 13):
        rec, *_ = harness.run(cell, seed, _seconds(cell), False, "cpu",
                              time.perf_counter(), log=lambda s: None)
        v = judge.check(rec, cell.model, seed, "cpu", control=True)
        assert v["gap"] <= cell.limits["max_logit_gap"], v
        assert v["gap_mean"] <= limit < v["control_gap_mean"], v


@pytest.mark.parametrize("name", sorted(smoke.CELLS))
def test_the_control_through_the_checks_is_not_correct(root, name):
    result, lines = _measure(root, name, seed=12, control=True)
    assert result["correct"], lines
    ctl = result["control"]
    assert not ctl["correct"], ctl
    assert ctl["checks"]["mean_logit_gap"]["value"] > \
        ctl["checks"]["mean_logit_gap"]["limit"]
    assert list(result)[-1] == "checks"
