"""A checkout-shaped directory for runs of the harness on the CPU at the
port's smoke sizes: ``BENCHMARK.json`` naming two smoke cells, and the
benchmark's configurations, mixes, limits and metric readers beside
smoke ones of their own.  Used by the tests in this folder.

    from portbench import smoke, report
    cell = smoke.cell(smoke.make_root(tmp_path), "granite-smoke.batch")
    result, lines = report.measure(cell, 7, 1.0, False, "cpu", t0)
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent

CONFIGS = {
    "granite-smoke": {
        "arch": "granite-moe-3b-a800m-smoke",
        "model": {"family": "moe", "layers": 2, "d_model": 64, "heads": 4,
                  "kv_heads": 2, "head_dim": 64, "d_ff": 64, "vocab": 256,
                  "norm": "rmsnorm", "norm_eps": 1e-6, "rope_fraction": 1.0,
                  "rope_theta": 10000.0, "experts": 4, "top_k": 2,
                  "capacity_factor": 1.25, "dtype": "bfloat16"},
        "engine": {"num_slots": 4, "max_len": 96, "prefill_chunk": None}},
    "stablelm-smoke": {
        "arch": "stablelm-1.6b-smoke",
        "model": {"family": "dense", "layers": 2, "d_model": 64, "heads": 4,
                  "kv_heads": 4, "head_dim": 64, "d_ff": 128, "vocab": 256,
                  "norm": "layernorm", "norm_eps": 1e-5,
                  "rope_fraction": 0.25, "rope_theta": 10000.0,
                  "dtype": "bfloat16"},
        "engine": {"num_slots": 4, "max_len": 96, "prefill_chunk": 32}},
}

MIXES = {
    "batch-smoke": {
        "loop": "closed", "clients_per_slot": 2, "trace_seed": 101,
        "prompt": {"median": 16, "sigma": 0.6, "min": 8, "max": 40},
        "output": {"median": 12, "sigma": 0.6, "min": 4, "max": 40}},
    "longdoc-smoke": {
        "loop": "open", "rate_per_s": 15.0, "warm_s": 0.3, "trace_seed": 102,
        "prompt": {"median": 40, "sigma": 0.5, "min": 20, "max": 70},
        "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16}},
}

CELLS = {"granite-smoke.batch": ("granite-smoke", "batch-smoke"),
         "stablelm-smoke.longdoc": ("stablelm-smoke", "longdoc-smoke")}

# set from CPU readings of seeds 1-6 and 11-13 (one thread): the dense
# smoke model served 0 to 0.016 below the reference's best (0 to 0.00035
# in the mean), its fp8 control 0.087 to 0.202 (0.0029 to 0.0112 in the
# mean), a decode tick that leaves the cache unchanged 0.748 to 0.826;
# the MoE smoke model (2 of 4 experts, so a routing flip moves half a
# layer's output) served up to 0.462 at most and 0.0023 in the mean, its
# control 0.0066 to 0.0223 in the mean, the faults 1.847 to 5.798 at most
LIMITS = {"granite-smoke.batch": {"max_logit_gap": 1.0,
                                  "mean_logit_gap": 0.003,
                                  "min_compared_tokens": 20},
          "stablelm-smoke.longdoc": {"max_logit_gap": 0.06,
                                     "mean_logit_gap": 0.002,
                                     "min_compared_tokens": 20}}


# the open loop's metrics, which no cell of BENCHMARK.json reports yet:
# the smoke cells read them all the same
_LONGDOC = {"unit": "ms", "better": "lower", "moves": "ttft_p90_ms"}
OPEN_LOOP_METRICS = {
    "end_to_end": [{"name": n, "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}
                   for n in ("ttft_p90_ms", "itl_p90_ms")],
    "per_layer": [
        dict(_LONGDOC, name="arrival_lateness_p90_ms.longdoc",
             source="host_clock", layer="client"),
        dict(_LONGDOC, name="queue_wait_p90_ms.longdoc",
             source="program_span", layer="scheduler and engine"),
        dict(_LONGDOC, name="chunk_step_ms.longdoc", source="device_trace",
             layer="prefill")]}


def make_root(tmp: Path) -> Path:
    """A directory holding BENCHMARK.json with the smoke cells, and under
    ``portbench/`` the benchmark's own data and readers plus the smoke
    files."""
    tmp = Path(tmp)
    pb = tmp / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / sub, pb / sub)
    bench = harness.load_json(HERE.parent / "BENCHMARK.json")
    bench["configs"] = [{"name": n, "source": "smoke", "reduced": [],
                         "file": f"portbench/configs/{n}.json", "why": "smoke"}
                        for n in CONFIGS]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": mix,
                           "chips": 1, "why": "smoke"}
                          for c, (cfg, mix) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for key, extra in OPEN_LOOP_METRICS.items():
        names = {m["name"] for m in bench[key]}
        bench[key] += [m for m in extra if m["name"] not in names]
    write(tmp / "BENCHMARK.json", bench)
    for n, c in CONFIGS.items():
        write(pb / "configs" / f"{n}.json", c)
    for n, mix in MIXES.items():
        write(pb / "traffic" / f"{n}.json", mix)
    for c in CELLS:
        write(pb / "limits" / f"{c}.json", LIMITS[c])
    return tmp


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def cell(root: Path, name: str) -> harness.Cell:
    return harness.load_cell(root, name)
