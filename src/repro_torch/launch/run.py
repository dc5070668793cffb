"""Command dispatcher for EASEY execution specs, port of
``repro/launch/run.py`` (paper §3: execution commands are 'bash (serial)
or mpi-based'; ours are train/serve/lulesh).

``lulesh`` runs where the build's plan says: on the device of the build's
target, through the hand-written stencil kernel when the plan's kernels
are ``"cuda"`` and through the plain step otherwise.  Without a build
result it runs on the card with the kernel, or on the CPU with the plain
step when asked (``device="cpu"``).
"""

from __future__ import annotations

import shlex
import time
from pathlib import Path

import torch

from repro_torch.core.target import (default_target, device_for, get_target,
                                     resolve_device)


def run_command(command: str, job=None, workdir: Path | None = None,
                spec=None, build_result=None, device=None):
    log = job.log if job is not None else print
    argv = shlex.split(command)
    # strip ch-run wrappers if a paper-style command was given
    if argv and argv[0] == "ch-run":
        # ch-run -b src:dst image -- cmd args...
        if "--" in argv:
            argv = argv[argv.index("--") + 1:]
    name = Path(argv[0]).name if argv else ""

    if name.startswith("train"):
        raise NotImplementedError("the train command is not ported yet "
                                  "(ROADMAP slice E)")
    if name.startswith("serve"):
        raise NotImplementedError("the serve command is not ported yet "
                                  "(ROADMAP slice A, left-out item 8: "
                                  "launch/serve.py)")
    if "lulesh" in name:
        return _lulesh(_parse_kw(argv[1:]), log, build_result, device)
    raise ValueError(f"unknown EASEY command: {command!r}")


def _lulesh(kw: dict, log, build_result, device) -> dict:
    from repro_torch.models import lulesh
    if build_result is not None:
        run_on = device_for(build_result.target)
        if device is not None and torch.device(device) != run_on:
            raise ValueError(f"device {device!r} but the build is for "
                             f"{build_result.target.name} ({run_on})")
        kernels = build_result.plan.kernels
    else:
        run_on = resolve_device(device)
        kernels = get_target(default_target(run_on)).kernels
    iters = int(kw.get("i", kw.get("iters", 10)))
    size = int(kw.get("s", kw.get("size", 16)))
    cfg = lulesh.LuleshConfig(grid=size, iters=iters)
    state = lulesh.init_state(cfg, run_on)
    state, dt = _timed(lambda: lulesh.run(state, cfg, iters,
                                          use_kernel=kernels == "cuda"),
                       run_on)
    f = lulesh.fom(size ** 3, iters, dt)
    log(f"[lulesh] grid={size}^3 iters={iters} device={run_on} "
        f"kernels={kernels} time={dt:.3f}s FOM={f:,.0f}")
    return {"fom": f, "seconds": dt, "grid": size, "iters": iters,
            "device": str(run_on), "kernels": kernels, "state": state}


def _timed(fn, device: torch.device):
    """(fn's result, host seconds it took), the device drained before and
    after, so the time is the work's and not only its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _parse_kw(argv: list[str]) -> dict:
    kw, i = {}, 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key = a[2:]
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                kw[key] = argv[i + 1]
                i += 2
            else:
                kw[key] = "true"
                i += 1
        elif a.startswith("-") and len(a) == 2:
            kw[a[1:]] = argv[i + 1] if i + 1 < len(argv) else "true"
            i += 2
        else:
            i += 1
    return kw

