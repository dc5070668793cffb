"""The paper's own use case (§4 + Listing 1.5): LULESH deployed via EASEY
(port of ``examples/lulesh_easey.py``).

    PYTHONPATH=src python -m repro_torch.examples.lulesh_easey [--device cpu]

Reproduces Table 1 in miniature: the Sedov solver run natively (a direct
``lulesh.run``) vs through the complete EASEY pipeline, FOM + delta
printed per cube size.  On the card both run the fused stencil kernel
(the target's ``plan.kernels``); with ``--device cpu`` both run its plain
version.  The generated SLURM batch file — what would be submitted on a
real cluster — is printed for one job.  Without a GPU it raises unless
given ``--device cpu``.
"""

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core.appspec import AppSpec
from repro_torch.core.jobspec import lulesh_example, parse_jobspec
from repro_torch.core.target import default_target, get_target, resolve_device
from repro_torch.core.workflow import run_easey
from repro_torch.models import lulesh

GRIDS = [(8, 40), (13, 20), (16, 12)]


def _timed(fn, device: torch.device):
    """(fn's result, host seconds it took), the device drained before and
    after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def native_fom(grid, iters, device, use_kernel):
    cfg = lulesh.LuleshConfig(grid=grid, iters=iters)
    lulesh.run(lulesh.init_state(cfg, device), cfg, 2, use_kernel=use_kernel)
    state = lulesh.init_state(cfg, device)
    _, seconds = _timed(lambda: lulesh.run(state, cfg, iters,
                                           use_kernel=use_kernel), device)
    return lulesh.fom(grid ** 3, iters, seconds)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "stencil's plain version on the CPU)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    target = default_target(device)
    use_kernel = get_target(target).kernels == "cuda"

    storage = tempfile.mkdtemp(prefix="easey_lulesh_")
    print(f"{'p':>4} {'zones':>8} {'FOM native':>14} {'FOM easey':>14} {'delta':>8}")
    rows = []
    for grid, iters in GRIDS:
        nat = native_fom(grid, iters, device, use_kernel)
        spec = parse_jobspec(lulesh_example())
        spec.executions[0].command = (
            f"ch-run -b ./data:/data lulesh.dash -- "
            f"/built/lulesh.dash -i {iters} -s {grid}")
        app = AppSpec(arch="lulesh-dash", shape="train_4k",
                      run=f"lulesh -i {iters} -s {grid}")
        # two runs: first pays the build, second is steady state (as Table 1)
        run_easey(app, target, spec, storage=storage)
        mw, jid, _ = run_easey(app, target, spec, storage=storage)
        eas = mw.scheduler.result(jid)[0]["fom"]
        rows.append((grid, nat, eas))
        print(f"{grid:>4} {grid**3:>8} {nat:>14,.0f} {eas:>14,.0f} "
              f"{(eas - nat) / nat * 100:>+7.2f}%")

    # show the batch file EASEY synthesized (paper Alg. 1 line 'create batch_file')
    batch = sorted(Path(storage, "cluster").glob("*/batch.sh"))[-1]
    print(f"\n--- generated {batch} ---")
    print(batch.read_text())
    return rows, batch


if __name__ == "__main__":
    main()
