"""The knee of an open-loop cell, on the card: its mix run at each of a
few fixed rates, in one process.

    python3 portbench/sweep.py --workload <cell> --rates 1,2,3 --seconds 20

For each rate one line: the time to first token (median and 90th
percentile), the mean of the window's first and second halves (a
backlog that grows shows as a second half far above the first), the
queue left at the close, and requests completed a second.  The highest
rate without a growing backlog is the knee; a cell's mix runs at about
four fifths of it.  The benchmark's runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, _setup_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    _setup_env()
    import numpy as np
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("[sweep] needs a CUDA device", file=sys.stderr)
        return 3
    base = harness.load_cell(ROOT, args.workload)
    for r in (float(x) for x in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.mix["rate_per_s"] = r
        rec, *_ = harness.run(cell, args.seed, args.seconds, False, "cuda",
                              time.perf_counter(), log=lambda s: None,
                              grace_s=0.0)
        due = sorted(rec.due_in_window(), key=lambda q: q.due)
        ttft = [(q.first - q.due) * 1e3 for q in due
                if not math.isnan(q.first)]
        half = len(ttft) // 2
        done = sum(1 for q in rec.reqs.values()
                   if q.tokens and rec.in_window(q.done))
        out = {"rate": r, "due": len(due), "answered": len(ttft),
               "ttft_p50_ms": float(np.percentile(ttft, 50)) if ttft else None,
               "ttft_p90_ms": float(np.percentile(ttft, 90)) if ttft else None,
               "first_half_ms": float(np.mean(ttft[:half])) if half else None,
               "second_half_ms": float(np.mean(ttft[half:])) if half else None,
               "queued_at_close": sum(
                   1 for q in rec.reqs.values() if q.release <= rec.t_close
                   and not q.admit <= rec.t_close),
               "completed_per_s": done / rec.window_s,
               "card": torch.cuda.get_device_name()}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
