"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell names a configuration and a
traffic mix in ``BENCHMARK.json``; the run builds the serving engine of
``repro_torch`` (from ``src/``) on one CUDA device with weights drawn
from the seed, brings it to the mix's steady state, measures for
``--seconds``, checks a sample of what it served against the plain
reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
(CUDA events around the steps, ``torch.profiler`` over a few steady
steps).  The numbers the check compared, each beside its limit, are the
last lines on standard error and the last key of the line.

Without a CUDA device it prints no result and exits non-zero; so it
does where ``jax``, ``jaxlib``, ``flax`` or the JAX package are loaded
once the window has closed.  Build and kernel caches stay inside the
checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def _setup_env() -> None:
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    sys.path.append(str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    import torch

    from portbench import harness, report
    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, lines = report.measure(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", T_START)
    bad = banned_modules()
    if bad:
        print(f"[portbench] loaded after the window: {bad}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
