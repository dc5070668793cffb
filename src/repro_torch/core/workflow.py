"""End-to-end EASEY workflow (paper Fig. 2) + the `easey` CLI, port of
``repro/core/workflow.py``.

    user --Appfile+JobSpec--> CLIENT (build -> package)
         --package--> MIDDLEWARE (stage, batch, submit) --> jobID
         --poll--> pending/running/finished + logs --> stage-out

`run_easey` wires BuildService -> write_package -> Middleware.submit with a
runner that executes the app's RUN command through the launch layer.  The
target picks the device: ``nvidia:h100`` runs on the card with the
hand-written kernels, ``local:cpu`` on the CPU with the plain versions.

    python -m repro_torch.core.workflow run Appfile --target nvidia:h100 \\
        --config job.json
"""

from __future__ import annotations

import argparse
import functools
import tempfile
from pathlib import Path

from repro_torch.core.appspec import AppSpec, parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobspec import JobSpec, parse_jobspec
from repro_torch.core.middleware import Middleware
from repro_torch.core.package import write_package
from repro_torch.core.target import get_target


def default_runner(job, workdir: Path, spec: JobSpec, build_result=None):
    """Execute the JobSpec's execution commands via the launch layer, on
    the build's target when given its result."""
    from repro_torch.launch.run import run_command  # late import: launch -> core
    results = []
    for ex in spec.executions:
        job.log(f"$ {ex.command}")
        results.append(run_command(ex.command, job=job, workdir=workdir,
                                   spec=spec, build_result=build_result))
    return results


def run_easey(appspec: AppSpec, target_name: str, jobspec: JobSpec,
              storage: str | Path | None = None, execute: bool = True,
              overrides: dict | None = None):
    """build -> package -> stage -> submit -> wait. Returns (middleware,
    job_id, build_result)."""
    storage = Path(storage) if storage else Path(tempfile.mkdtemp(prefix="easey_"))
    target = get_target(target_name)
    svc = BuildService()
    result = svc.build(appspec, target, overrides=overrides, lower=True)
    pkg = write_package(result, storage / "packages")

    mw = Middleware(storage / "cluster")
    # the runner executes the built step on the build's target
    runner = functools.partial(default_runner, build_result=result) \
        if execute else None
    job_id = mw.submit(pkg, jobspec, runner=runner,
                       scheduler_dialect=target.scheduler
                       if target.scheduler != "local" else "slurm")
    return mw, job_id, result


def _cli():
    p = argparse.ArgumentParser(prog="easey")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an Appfile for a target "
                                     "(paper: easey build Dockerfile --target ...)")
    b.add_argument("appfile")
    b.add_argument("--target", required=True)
    b.add_argument("--out", default="./packages")

    s = sub.add_parser("submit", help="submit a package with a job config")
    s.add_argument("package")
    s.add_argument("--config", required=True)
    s.add_argument("--storage", default="./easey_cluster")

    r = sub.add_parser("run", help="build + submit + execute in one step")
    r.add_argument("appfile")
    r.add_argument("--target", required=True)
    r.add_argument("--config", required=True)

    args = p.parse_args()
    if args.cmd == "build":
        spec = parse_appfile(Path(args.appfile).read_text())
        res = BuildService().build(spec, args.target)
        pkg = write_package(res, args.out)
        print(f"built {pkg}")
        print(res.plan.report())
    elif args.cmd == "submit":
        spec = parse_jobspec(Path(args.config).read_text())
        mw = Middleware(args.storage)
        job_id = mw.submit(args.package, spec)
        print(f"jobID={job_id} state={mw.status(job_id).value}")
    elif args.cmd == "run":
        app = parse_appfile(Path(args.appfile).read_text())
        spec = parse_jobspec(Path(args.config).read_text())
        mw, job_id, _ = run_easey(app, args.target, spec)
        out, err = mw.logs(job_id)
        print(f"jobID={job_id} state={mw.status(job_id).value}")
        print(out)
        if err:
            print("STDERR:", err)


if __name__ == "__main__":
    _cli()
