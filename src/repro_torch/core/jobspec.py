"""The paper's four-part JSON job configuration (§3, Listings 1.1–1.5);
host code, copied from ``repro/core/jobspec.py``.

    {"job": {"name", "id", "mail"},
     "data": {"input": [{source, protocol, user, auth}],
              "output": [{destination, protocol, user, auth}],
              "mount": {"container-path"}},
     "deployment": {"nodes", "ram", "cores-per-task", "tasks-per-node",
                    "clocktime"},
     "execution": [{"serial": {"command"}} |
                   {"mpi": {"command", "mpi-tasks"}}]}

Faithfully parsed/validated here; the deployment extension adds an
optional "easey" block (arch/shape/target) so the same file drives both the
paper's LULESH-style jobs and LM deployments.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any

PROTOCOLS = ("https", "scp", "ftp", "gridftp", "file")


@dataclasses.dataclass
class DataItem:
    source: str = ""
    destination: str = ""
    protocol: str = "file"
    user: str = ""
    auth: str = "publickey"

    def validate(self):
        if self.protocol not in PROTOCOLS:
            raise ValueError(f"unsupported protocol {self.protocol!r}")
        if self.protocol == "gridftp":
            raise NotImplementedError(
                "gridftp is planned for the next release (paper §3)")


@dataclasses.dataclass
class Deployment:
    nodes: int = 1
    ram: str = ""
    cores_per_task: int = 1
    tasks_per_node: int = 1
    clocktime: str = "01:00:00"


@dataclasses.dataclass
class Execution:
    kind: str = "serial"            # serial | mpi
    command: str = ""
    mpi_tasks: int = 0


@dataclasses.dataclass
class JobSpec:
    name: str
    job_id: str = ""
    mail: str = ""
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    mount: str = "/data"
    deployment: Deployment = dataclasses.field(default_factory=Deployment)
    executions: list = dataclasses.field(default_factory=list)
    easey: dict = dataclasses.field(default_factory=dict)

    def ensure_id(self) -> str:
        """'a hash which is determined by the system at the moment of
        submission' (paper §3)."""
        if not self.job_id:
            # submission-moment entropy is the paper's spec — hash input,
            # never a metric
            payload = f"{self.name}:{time.time_ns()}"  # easeylint: allow[wall-clock]
            self.job_id = hashlib.sha256(payload.encode()).hexdigest()[:12]
        return self.job_id

    @property
    def has_data(self) -> bool:
        return bool(self.inputs or self.outputs)


def parse_jobspec(text_or_dict: str | dict) -> JobSpec:
    d = json.loads(text_or_dict) if isinstance(text_or_dict, str) else text_or_dict
    if "job" not in d:
        raise ValueError("missing required 'job' section")
    job = d["job"]
    spec = JobSpec(name=job.get("name", "easey-job"),
                   job_id=job.get("id", ""), mail=job.get("mail", ""))

    data = d.get("data", {})
    for item in data.get("input", []):
        di = DataItem(source=item.get("source", ""),
                      protocol=item.get("protocol", "file"),
                      user=item.get("user", ""), auth=item.get("auth", "publickey"))
        di.validate()
        spec.inputs.append(di)
    for item in data.get("output", []):
        do = DataItem(destination=item.get("destination", ""),
                      protocol=item.get("protocol", "file"),
                      user=item.get("user", ""), auth=item.get("auth", "publickey"))
        do.validate()
        spec.outputs.append(do)
    if "mount" in data:
        spec.mount = data["mount"].get("container-path", "/data")

    dep = d.get("deployment", {})
    spec.deployment = Deployment(
        nodes=int(dep.get("nodes", 1)), ram=str(dep.get("ram", "")),
        cores_per_task=int(dep.get("cores-per-task", 1)),
        tasks_per_node=int(dep.get("tasks-per-node", 1)),
        clocktime=str(dep.get("clocktime", "01:00:00")))

    for entry in d.get("execution", []):
        if "serial" in entry:
            spec.executions.append(Execution("serial", entry["serial"]["command"]))
        elif "mpi" in entry:
            spec.executions.append(Execution(
                "mpi", entry["mpi"]["command"],
                int(entry["mpi"].get("mpi-tasks", 1))))
        else:
            raise ValueError(f"execution entries must be serial|mpi: {entry}")

    spec.easey = d.get("easey", {})
    return spec


def lulesh_example() -> dict:
    """The paper's Listing 1.5 (LULESH:DASH on SuperMUC-NG), verbatim-shaped."""
    return {
        "job": {"name": "lulesh_dash", "mail": "hoeb@mnm-team.org"},
        "data": {},
        "deployment": {"nodes": 46, "tasks-per-node": 48,
                       "clocktime": "06:00:00"},
        "execution": [{
            "mpi": {
                "command": "ch-run -b ./data:/data lulesh.dash -- "
                           "/built/lulesh.dash -i 1000 -s 13",
                "mpi-tasks": 2197}}],
    }
