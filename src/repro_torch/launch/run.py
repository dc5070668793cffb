"""Command dispatcher for EASEY execution specs, port of
``repro/launch/run.py`` (paper §3: execution commands are 'bash (serial)
or mpi-based'; ours are train/serve/lulesh).

The commands run where the build's plan says: on the device of the
build's target, through its hand-written kernels when the plan's kernels
are ``"cuda"`` and through the plain versions otherwise.

* ``train ...`` (``launch/train.train_main``, the reference's keywords)
  trains on the build target's device under the target's tuner plan,
  checkpointing into the job's working directory (``ckpt/``) unless
  ``--ckpt-dir`` names another.

* ``serve ...`` (``launch/serve.serve_main``, the reference's keywords
  plus ``--trace-out`` / ``--metrics-out`` / ``--prom-out``) serves on
  the build target's device with
  the target's tuner plan; the paged layout decodes through the
  paged-decode kernel under a ``"cuda"`` plan and through the gather
  path under a ``"reference"`` one (no local-kernel directive).
  Relative ``--trace-out`` / ``--metrics-out`` / ``--prom-out`` paths
  land in the job's working directory.
* ``lulesh ...`` runs the Sedov step, through the stencil kernel under a
  ``"cuda"`` plan.

Without a build result a command runs on the card with the kernels, or
on the CPU with the plain versions when asked (``device="cpu"``).
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
        return _train(_parse_kw(argv[1:]), log, workdir, build_result,
                      device)
    if name.startswith("serve"):
        return _serve(_parse_kw(argv[1:]), log, workdir, build_result,
                      device)
    if "lulesh" in name:
        return _lulesh(_parse_kw(argv[1:]), log, build_result, device)
    raise ValueError(f"unknown EASEY command: {command!r}")


def _placement(build_result, device) -> tuple[torch.device, str, str]:
    """(device, target name, kernels) a command runs with: the build's
    target and plan, or the device's own target without a build."""
    if build_result is not None:
        run_on = device_for(build_result.target)
        if device is not None and torch.device(device) != run_on:
            raise ValueError(f"device {device!r} but the build is for "
                             f"{build_result.target.name} ({run_on})")
        return run_on, build_result.target.name, build_result.plan.kernels
    run_on = resolve_device(device)
    target = default_target(run_on)
    return run_on, target, get_target(target).kernels


def _train(kw: dict, log, workdir, build_result, device) -> dict:
    from repro_torch.launch.train import train_main
    run_on, target, _ = _placement(build_result, device)
    ckpt = kw.get("ckpt-dir")
    if ckpt is None and workdir is not None:
        ckpt = str(Path(workdir) / "ckpt")
    return train_main(
        arch=kw.get("arch", _arch_from(build_result, "deepseek-7b-smoke")),
        steps=int(kw.get("steps", 10)),
        seq_len=int(kw.get("seq-len", 64)),
        global_batch=int(kw.get("global-batch", 4)),
        ckpt_dir=ckpt, ckpt_every=int(kw.get("ckpt-every", 5)),
        target=target, log=log, device=run_on)


def _serve(kw: dict, log, workdir, build_result, device) -> dict:
    from repro_torch.launch.serve import serve_main
    run_on, target, kernels = _placement(build_result, device)
    kv_layout = kw.get("kv-layout", "contiguous")
    # the plan names the paged decode attention (a contiguous pool has none)
    kv_kernel = "auto" if "paged" not in kv_layout else \
        "cuda" if kernels == "cuda" else "gather"

    def out_path(key):
        path = kw.get(key)
        if path is None or workdir is None:
            return path
        return str(Path(workdir) / path)

    return serve_main(
        arch=kw.get("arch", _arch_from(build_result, "deepseek-7b-smoke")),
        batch=int(kw.get("batch", 4)),
        prefill_len=int(kw.get("prefill", 64)),
        decode_tokens=int(kw.get("decode", 8)),
        target=target, mode=kw.get("mode", "continuous"),
        requests=int(kw.get("requests", 0)),
        max_len=int(kw.get("max-len", 0)),
        kv_layout=kv_layout,
        page_size=int(kw.get("page-size", 0)),
        temperature=float(kw.get("temperature", 0.0)),
        top_k=int(kw.get("top-k", 0)),
        replicas=int(kw.get("replicas", 1)),
        route_policy=kw.get("route-policy", "least_loaded"),
        prefix_cache=str(kw.get("prefix-cache", "")).lower()
        in ("true", "1", "yes"),
        kv_kernel=kv_kernel, trace=kw.get("trace", "uniform"),
        trace_out=out_path("trace-out"),
        metrics_out=out_path("metrics-out"),
        prom_out=out_path("prom-out"),
        log=log, device=run_on)


def _arch_from(build_result, default: str) -> str:
    if build_result is not None:
        return build_result.appspec.arch
    return default


def _lulesh(kw: dict, log, build_result, device) -> dict:
    from repro_torch.models import lulesh
    run_on, _, kernels = _placement(build_result, device)
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

