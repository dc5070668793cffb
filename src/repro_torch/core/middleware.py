"""EASEY Middleware (§2.2) — Algorithm 1, line for line (host code, copied
from ``repro/core/middleware.py``).

    Require: Charliecloud tar-ball            -> .easey.tar package
    Require: EASEY configuration file         -> JobSpec (4-part JSON)
    Require: User credentials                 -> public-key stub
      Move tar-ball to cluster storage
      Extract tar-ball and create execution environment
      if data in configuration then mkdir data_folder
      while input in configuration do transfer input[source] to data_folder
      create batch_file
      for each deployment: parse to SLURM or PBS command in batch_file
      while execution in configuration do add command to batch_file
      submit batch_file to local scheduler and return jobID to EASEY

The batch file is really synthesized (core/batch.py); execution in this
container goes through the LocalScheduler with the same state machine and
monitoring interface the paper describes.
"""

from __future__ import annotations

import shutil
import urllib.parse
from pathlib import Path
from typing import Callable

from repro_torch.core.batch import make_batch
from repro_torch.core.jobs import Job, JobState, LocalScheduler
from repro_torch.core.jobspec import DataItem, JobSpec
from repro_torch.core.package import extract_package


class StageError(RuntimeError):
    pass


def _transfer(item: DataItem, dest: Path, direction: str = "in"):
    """Data service (§3): https/scp/ftp handled; gridftp next release.
    In this offline container all protocols resolve to local file copies;
    the handler validates the URL shape exactly as the real mover would."""
    src = item.source if direction == "in" else item.destination
    proto = item.protocol
    if proto in ("https", "scp", "ftp"):
        parsed = urllib.parse.urlparse(src if "://" in src else f"{proto}://{src}")
        if not parsed.path:
            raise StageError(f"malformed {proto} url: {src}")
        local = Path(parsed.path)
    elif proto == "file":
        local = Path(src)
    else:
        raise StageError(f"unsupported protocol {proto}")
    if direction == "in":
        if not local.exists():
            raise StageError(f"input not found: {local}")
        shutil.copy2(local, dest / local.name)
        return dest / local.name
    dest.mkdir(parents=True, exist_ok=True)
    return local


class Middleware:
    """Connects the EASEY client's package to the cluster scheduler."""

    def __init__(self, cluster_storage: str | Path,
                 scheduler: LocalScheduler | None = None):
        self.storage = Path(cluster_storage)
        self.storage.mkdir(parents=True, exist_ok=True)
        self.scheduler = scheduler or LocalScheduler()

    def submit(self, package_path: str | Path, spec: JobSpec,
               runner: Callable[[Job, Path, JobSpec], object] | None = None,
               scheduler_dialect: str = "slurm") -> str:
        """Algorithm 1. Returns the local jobID."""
        spec.ensure_id()
        workdir = self.storage / spec.job_id
        workdir.mkdir(parents=True, exist_ok=True)

        # 1. move tar-ball to cluster storage
        staged_pkg = workdir / Path(package_path).name
        shutil.copy2(package_path, staged_pkg)

        # 2. extract tar-ball, create execution environment
        env_dir = workdir / "env"
        manifest = extract_package(staged_pkg, env_dir)

        # 3-4. data folder + stage-in
        data_dir = workdir / "data"
        if spec.has_data:
            data_dir.mkdir(exist_ok=True)
            for item in spec.inputs:
                _transfer(item, data_dir, "in")

        # 5-7. synthesize the batch file
        batch = make_batch(spec, scheduler_dialect, workdir=str(workdir))
        (workdir / "batch.sh").write_text(batch)

        # 8. submit to the local scheduler -> jobID
        def job_fn(job: Job):
            job.log(f"EASEY job {spec.job_id} ({manifest['arch']} x "
                    f"{manifest['shape']} on {manifest['target']})")
            job.log(f"batch file: {workdir / 'batch.sh'}")
            if runner is None:
                job.log("no runner bound (dry deployment) — batch file only")
                return {"manifest": manifest, "batch": str(workdir / "batch.sh")}
            out = runner(job, workdir, spec)
            job.log("execution finished")
            return out

        job_id = self.scheduler.submit(job_fn, name=spec.name)
        # keep the paper's ID visible
        self.scheduler.jobs[job_id].log(f"scheduler jobID={job_id}")
        return job_id

    # -- monitoring (paper: status + stdout/stderr at intermediate state) --
    def status(self, job_id: str) -> JobState:
        return self.scheduler.status(job_id)

    def logs(self, job_id: str) -> tuple[str, str]:
        return self.scheduler.logs(job_id)

    def stage_out(self, job_id: str, spec: JobSpec):
        """'After the job ended EASEY will transfer output files if
        specified.'"""
        workdir = self.storage / spec.job_id
        out_paths = []
        for item in spec.outputs:
            dest = _transfer(item, workdir, "out")
            produced = workdir / "data"
            if produced.exists():
                for f in produced.iterdir():
                    shutil.copy2(f, dest / f.name if dest.is_dir() else dest)
            out_paths.append(dest)
        return out_paths
