"""From a run's record to the result line: the end-to-end metrics (taken
by the benchmark on the host clock), the per-layer metrics (each read by
its own reader in ``portbench/metrics/``), the device, and the check.
"""

from __future__ import annotations

import math
import sys

import torch

from portbench import counts, harness, judge

TOP = 10


def tokens_per_s(rec) -> float | None:
    """Output tokens made in the window, over its length."""
    n = sum(1 for r in rec.reqs.values() for t in r.times
            if rec.in_window(t))
    return counts.rate(n, rec.window_s)


def ttft_p90_ms(rec) -> float | None:
    """From each due time in the window to the request's first token."""
    return counts.percentile([(r.first - r.due) * 1e3
                              for r in rec.due_in_window()
                              if not math.isnan(r.first)], 90)


def itl_p90_ms(rec) -> float | None:
    """Every gap between consecutive output tokens that ends in the
    window."""
    return counts.percentile([(b - a) * 1e3 for r in rec.reqs.values()
                              for a, b in zip(r.times, r.times[1:])
                              if rec.in_window(b)], 90)


# the numbers of the check a cell's limits file may name, and their keys
# in ``judge.check``'s verdict
GAPS = {"max_logit_gap": "gap", "mean_logit_gap": "gap_mean"}

END_TO_END = {"tokens_per_s": tokens_per_s, "ttft_p90_ms": ttft_p90_ms,
              "itl_p90_ms": itl_p90_ms}


def unanswered(rec) -> int:
    """Requests due in an open loop's window with no first token."""
    if rec.loop != "open":
        return 0
    return sum(1 for r in rec.due_in_window() if math.isnan(r.first))


def judged(cell, verdict: dict, missing: int, prefix: str = ""):
    """(correct, checks): ``verdict``'s numbers (``judge.check``'s, or
    with ``prefix`` "control_" its control's) each beside the cell's
    limit, and whether every one keeps it."""
    checks = {}
    for name, key in GAPS.items():
        if name in cell.limits:
            checks[name] = {"value": verdict.get(prefix + key),
                            "limit": cell.limits[name], "at": "most"}
    checks["compared_tokens"] = {"value": verdict["tokens"],
                                 "limit": cell.limits["min_compared_tokens"],
                                 "at": "least"}
    checks["unanswered"] = {"value": missing, "limit": 0, "at": "most"}
    at = {k: c.pop("at") for k, c in checks.items()}
    correct = all(c["value"] is not None and (
        c["value"] <= c["limit"] if at[k] == "most"
        else c["value"] >= c["limit"]) for k, c in checks.items())
    return bool(correct), checks


def measure(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, wrap=None, log=None, control: bool = False):
    """One run of ``cell``: (result, the check's lines).  With
    ``control`` the result also holds the lower-precision control's
    verdict under the same limits (``"control"``)."""
    log = log or (lambda s: print(s, file=sys.stderr))
    rec, plan, setup_s, peak = harness.run(cell, seed, seconds, trace,
                                           device, t_start, wrap, log)
    metrics = {}
    if trace:
        for m in cell.per_layer():
            v = harness.reader(cell.root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            v = setup_s if m["name"] == "setup_s" else \
                END_TO_END[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda"
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
    due = rec.due_in_window()
    missing = unanswered(rec)
    log(f"[portbench] window {rec.window_s:.3f} s, {len(due)} requests "
        f"due, {sum(1 for r in rec.reqs.values() if r.tokens and rec.in_window(r.done))} "
        f"finished, {len(rec.ticks)} ticks and {len(rec.chunks)} chunks "
        f"in the run; setup {setup_s:.3f} s")
    try:
        verdict = judge.check(rec, cell.model, seed, device, control=control)
    except ValueError as e:             # the steps' groups do not tile
        log(f"[portbench] check failed: {e}")
        verdict = {"tokens": 0}
    log(f"[portbench] check: {verdict}")
    correct, checks = judged(cell, verdict, missing)
    result = {"correct": bool(correct), "attempted": len(due),
              "failed": missing, "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        p = rec.profile
        result["breakdown"] = {
            "device_ops": sorted(([k[:96], v] for k, v in
                                  p["kernel_s"].items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in p["gaps_s"].items()),
                                key=lambda kv: -kv[1])[:TOP]}
    if control:
        ok, ctl = judged(cell, verdict, missing, "control_")
        result["control"] = {"correct": ok, "checks": ctl}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return result, lines
