"""Batch-file synthesis for SLURM and PBS (paper §2.2, Algorithm 1:
"create batch_file; for each deployment parse to SLURM or PBS command").

Pure text generation, copied from ``repro/core/batch.py`` and held
byte-equal to it (tests/test_torch_easey.py).  GPU clusters sit behind
the same schedulers; the LocalScheduler executes the equivalent
in-process.
"""

from __future__ import annotations

from repro_torch.core.jobspec import JobSpec


def slurm_batch(spec: JobSpec, workdir: str = "$EASEY_WORKDIR") -> str:
    d = spec.deployment
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={spec.name}",
        f"#SBATCH --nodes={d.nodes}",
        f"#SBATCH --ntasks-per-node={d.tasks_per_node}",
        f"#SBATCH --cpus-per-task={d.cores_per_task}",
        f"#SBATCH --time={d.clocktime}",
    ]
    if d.ram:
        lines.append(f"#SBATCH --mem={d.ram}")
    if spec.mail:
        lines += [f"#SBATCH --mail-user={spec.mail}",
                  "#SBATCH --mail-type=END,FAIL"]
    lines += ["", f"cd {workdir}"]
    if spec.has_data:
        lines.append("mkdir -p data")
    for ex in spec.executions:
        if ex.kind == "mpi":
            lines.append(f"srun --ntasks={ex.mpi_tasks} {ex.command}")
        else:
            lines.append(ex.command)
    return "\n".join(lines) + "\n"


def pbs_batch(spec: JobSpec, workdir: str = "$EASEY_WORKDIR") -> str:
    d = spec.deployment
    lines = [
        "#!/bin/bash",
        f"#PBS -N {spec.name}",
        f"#PBS -l nodes={d.nodes}:ppn={d.tasks_per_node}",
        f"#PBS -l walltime={d.clocktime}",
    ]
    if d.ram:
        lines.append(f"#PBS -l mem={d.ram}")
    if spec.mail:
        lines += [f"#PBS -M {spec.mail}", "#PBS -m ae"]
    lines += ["", f"cd {workdir}"]
    if spec.has_data:
        lines.append("mkdir -p data")
    for ex in spec.executions:
        if ex.kind == "mpi":
            lines.append(f"mpirun -np {ex.mpi_tasks} {ex.command}")
        else:
            lines.append(ex.command)
    return "\n".join(lines) + "\n"


def make_batch(spec: JobSpec, scheduler: str, workdir: str = "$EASEY_WORKDIR") -> str:
    if scheduler == "slurm":
        return slurm_batch(spec, workdir)
    if scheduler == "pbs":
        return pbs_batch(spec, workdir)
    if scheduler == "local":
        return "\n".join(["#!/bin/bash"] + [e.command for e in spec.executions]) + "\n"
    raise ValueError(f"unsupported scheduler {scheduler!r} "
                     "(paper: 'other scheduler are not supported so far')")
