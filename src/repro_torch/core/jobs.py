"""Job state machine + LocalScheduler (host code, copied from
``repro/core/jobs.py``; paper §2.2: job management,
"pending/running/finished/failed + error log and standard output ...
also at an intermediate state").

The LocalScheduler stands in for SLURM inside this container: queued jobs
run on worker threads, status/logs are pollable mid-run, and the runtime
layer uses the same interface for failure injection and straggler
simulation.
"""

from __future__ import annotations

import dataclasses
import enum
import io
import threading
import time
import traceback
import uuid
from typing import Callable


class JobState(str, enum.Enum):
    PENDING = "pending"
    STAGING = "staging"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


_VALID = {
    JobState.PENDING: {JobState.STAGING, JobState.RUNNING, JobState.CANCELLED,
                       JobState.FAILED},
    JobState.STAGING: {JobState.RUNNING, JobState.FAILED, JobState.CANCELLED},
    JobState.RUNNING: {JobState.FINISHED, JobState.FAILED, JobState.CANCELLED},
    JobState.FINISHED: set(),
    JobState.FAILED: {JobState.PENDING},   # requeue after failure (restart)
    JobState.CANCELLED: set(),
}


@dataclasses.dataclass
class Job:
    job_id: str
    name: str
    fn: Callable | None = None
    state: JobState = JobState.PENDING
    stdout: io.StringIO = dataclasses.field(default_factory=io.StringIO)
    stderr: io.StringIO = dataclasses.field(default_factory=io.StringIO)
    result: object = None
    # SLURM-stand-in bookkeeping; never feeds a gated metric
    submitted_at: float = dataclasses.field(default_factory=time.time)  # easeylint: allow[wall-clock]
    started_at: float = 0.0
    finished_at: float = 0.0
    restarts: int = 0

    def transition(self, new: JobState):
        if new not in _VALID[self.state]:
            raise ValueError(f"illegal transition {self.state} -> {new}")
        self.state = new

    def log(self, msg: str):
        self.stdout.write(msg.rstrip("\n") + "\n")

    @property
    def runtime(self) -> float:
        end = self.finished_at or time.time()  # easeylint: allow[wall-clock] — advisory job runtime
        return max(end - self.started_at, 0.0) if self.started_at else 0.0


class LocalScheduler:
    """In-process SLURM stand-in. submit() -> jobID; poll via status()."""

    def __init__(self, synchronous: bool = True):
        self.jobs: dict[str, Job] = {}
        self.synchronous = synchronous
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[Job], object], name: str = "job") -> str:
        job_id = uuid.uuid4().hex[:12]
        job = Job(job_id=job_id, name=name, fn=fn)
        with self._lock:
            self.jobs[job_id] = job
        if self.synchronous:
            self._run(job)
        else:
            threading.Thread(target=self._run, args=(job,), daemon=True).start()
        return job_id

    def _run(self, job: Job):
        job.transition(JobState.RUNNING)
        job.started_at = time.time()  # easeylint: allow[wall-clock] — job metadata
        try:
            job.result = job.fn(job)
            job.transition(JobState.FINISHED)
        except Exception as e:  # noqa: BLE001 — job isolation is the point
            job.stderr.write("".join(traceback.format_exception(e)))
            job.transition(JobState.FAILED)
        finally:
            job.finished_at = time.time()  # easeylint: allow[wall-clock] — job metadata

    # -- paper §2.2 monitoring interface --
    def status(self, job_id: str) -> JobState:
        return self.jobs[job_id].state

    def logs(self, job_id: str) -> tuple[str, str]:
        j = self.jobs[job_id]
        return j.stdout.getvalue(), j.stderr.getvalue()

    def result(self, job_id: str):
        return self.jobs[job_id].result

    def requeue(self, job_id: str) -> str:
        """Restart a failed job (fault-tolerance path)."""
        old = self.jobs[job_id]
        if old.state is not JobState.FAILED:
            raise ValueError("only failed jobs can be requeued")
        old.transition(JobState.PENDING)
        old.restarts += 1
        self._run(old)
        return job_id

    def wait(self, job_id: str, timeout: float = 300.0) -> JobState:
        t0 = time.time()  # easeylint: allow[wall-clock] — real timeout on a host-side wait
        while time.time() - t0 < timeout:  # easeylint: allow[wall-clock]
            st = self.status(job_id)
            if st in (JobState.FINISHED, JobState.FAILED, JobState.CANCELLED):
                return st
            time.sleep(0.01)
        raise TimeoutError(job_id)
