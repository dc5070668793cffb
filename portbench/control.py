"""The readings the check's limits are set from, on the card, and the
check's verdict on the lower-precision control and on faults planted
under the timed path, over many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 11,12,13 [--fault token|state] --seconds 10

Each seed is a run of the cell through ``report.measure``, as
``run.py`` makes it, with a window of ``--seconds`` at the cell's own
load.  On the control seeds the same run also judges, under the same
limits, what the reference computed in float8 would have chosen at the
same positions (``"control"``).  ``--fault`` plants a fault under the
timed path.  One JSON line a seed on standard output, with each verdict
and the numbers beside their limits.  The benchmark's runs do not run
this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, _setup_env  # noqa: E402


def altered_token(decode_fn, chunk_fn):
    """Every fifth decode tick, each row's best token replaced by
    another, where the step produces it."""
    n = [0]

    def decode(cache, tokens, active, *extras):
        logits, new = decode_fn(cache, tokens, active, *extras)
        n[0] += 1
        if n[0] % 5 == 0:
            logits = logits.clone()
            wrong = (logits.argmax(-1) + 97) % logits.shape[-1]
            logits.scatter_(-1, wrong[..., None], 1e4)
        return logits, new
    return decode, chunk_fn


def state_unchanged(decode_fn, chunk_fn):
    """The decode tick leaves the pool's keys and values as they were."""
    def decode(cache, tokens, active, *extras):
        k, v = cache["k"].clone(), cache["v"].clone()
        out = decode_fn(cache, tokens, active, *extras)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        return out
    return decode, chunk_fn


FAULTS = {"token": altered_token, "state": state_unchanged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant a fault under the timed path: token, every "
                         "fifth decode tick serves another token than its "
                         "best; state, the decode tick leaves the cache "
                         "unchanged")
    args = ap.parse_args(argv)
    _setup_env()
    import torch

    from portbench import harness, report
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(ROOT, args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = report.measure(
            cell, seed, args.seconds, False, "cuda", time.perf_counter(),
            wrap=FAULTS.get(args.fault), control=seed in ctl)
        out = {"seed": seed, "fault": args.fault,
               "correct": result["correct"], "checks": result["checks"],
               "control": result.get("control"),
               "metrics": result["metrics"],
               "memory_peak_bytes": result["device"]["memory_peak_bytes"],
               "card": result["device"]["kind"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
