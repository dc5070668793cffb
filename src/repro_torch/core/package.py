"""Package — the `ch-builder2tar` analogue (§2.1), port of
``repro/core/package.py``.

A deployable EASEY artifact is a tarball:

    manifest.json        app hash, arch, shape, target, step name, timings
    plan.json            the DeploymentPlan (tuning decisions)
    tuning_report.txt    human-readable report
    Appfile              the portable spec that produced the build
    program.json.gz      the program the target runs

The reference stores its lowered StableHLO module there; PyTorch has no
lowered program, so the port stores the build's program description
(``build.program_description``): the step, the sha256 of each kernel
source it launches, the ``nvcc`` flags and ``sm_90a``, or ``"reference"``
for the plain PyTorch step.  The manifest keeps its hash, and extraction
refuses a package whose program does not match it.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import tarfile
import time
from pathlib import Path

from repro_torch.core.build import BuildResult

PROGRAM = "program.json.gz"


def write_package(result: BuildResult, out_dir: str | Path) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    app = result.appspec
    name = f"{app.arch}__{app.shape}__{result.target.name.replace(':', '_')}"
    path = out_dir / f"{name}.easey.tar"

    # mtime=0: the same program gives the same bytes
    program_gz = gzip.compress(
        json.dumps(result.program, indent=2, sort_keys=True).encode(), mtime=0)
    manifest = {
        "app_hash": app.content_hash(),
        "arch": app.arch,
        "shape": app.shape,
        "target": result.target.name,
        "step": result.step_name,
        "built_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "timings": result.timings,
        "program_sha256": hashlib.sha256(program_gz).hexdigest(),
        "mesh": {"shape": list(result.target.mesh_shape),
                 "axes": list(result.target.mesh_axes)},
    }

    def add(tar, arcname: str, data: bytes):
        info = tarfile.TarInfo(arcname)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    with tarfile.open(path, "w") as tar:
        add(tar, "manifest.json", json.dumps(manifest, indent=2).encode())
        add(tar, "plan.json", result.plan.to_json().encode())
        add(tar, "tuning_report.txt", result.plan.report().encode())
        add(tar, "Appfile", app.to_appfile().encode())
        add(tar, PROGRAM, program_gz)
    return path


def read_manifest(path: str | Path) -> dict:
    with tarfile.open(path) as tar:
        return json.loads(tar.extractfile("manifest.json").read())


def read_program(workdir: str | Path) -> dict:
    """The program description of an extracted package."""
    return json.loads(gzip.decompress((Path(workdir) / PROGRAM).read_bytes()))


def extract_package(path: str | Path, workdir: str | Path) -> dict:
    """Algorithm 1: 'Extract tar-ball and create execution environment'."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path) as tar:
        tar.extractall(workdir, filter="data")
    manifest = json.loads((workdir / "manifest.json").read_text())
    # integrity check against the manifest hash
    program_gz = (workdir / PROGRAM).read_bytes()
    if hashlib.sha256(program_gz).hexdigest() != manifest["program_sha256"]:
        raise ValueError("package integrity check failed (program hash "
                         "mismatch)")
    return manifest
