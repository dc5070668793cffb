"""The port's EASEY deployment layers (``repro_torch.core``,
``repro_torch.launch``) against the JAX reference's, on the CPU.

Host-side text and plans must be exactly equal: Appfile parsing, content
hashes, batch files (the goldens of ``tests/test_batch_golden.py``), the
stencil plan and its report.  The LULESH app then goes the whole way —
build, package, stage, submit, run — on ``local:cpu``, and its final
state equals a direct ``lulesh.run``.  The ``nvidia:h100`` path builds
the CUDA kernel and runs only on the card (``cuda``-marked case here,
``chip_smoke.py`` there).
"""

import dataclasses
import io
import json
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest
import torch

from repro.configs.base import ARCHS as REF_ARCHS
from repro.core import appspec as ref_appspec
from repro.core import batch as ref_batch
from repro.core import jobspec as ref_jobspec
from repro.core.build import BuildService as RefBuildService
from repro_torch.configs.base import ARCHS
from repro_torch.core import appspec, batch, jobspec
from repro_torch.core.build import BuildService, BuildResult
from repro_torch.core.jobs import Job, JobState, LocalScheduler
from repro_torch.core.middleware import Middleware
from repro_torch.core.package import (extract_package, read_manifest,
                                      read_program, write_package)
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.workflow import run_easey
from repro_torch.kernels import _build
from repro_torch.kernels.sedov_stencil import sedov_step_cuda
from repro_torch.launch.run import run_command
from repro_torch.models import lulesh
from test_batch_golden import GOLDEN_PBS, GOLDEN_SLURM

REPO = Path(__file__).resolve().parents[1]
PAPER_CMD = "ch-run -b ./data:/data lulesh.dash -- /built/lulesh.dash"

APPFILES = [
    "FROM arch:lulesh-dash\nSHAPE train_4k\n###include_local_kernels###\n"
    "###include_local_collectives###\nRUN lulesh -i 1000 -s 13\n",
    "FROM arch:deepseek-7b\nSHAPE decode_32k\n###includelocalmpi###\n"
    "SET num_layers=4\nSET notes=short run\nRUN serve --batch 2\n",
    "# a comment\n\nFROM arch:lulesh-dash-smoke\nSHAPE train_4k\n",
]


class _Job:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


def _lulesh_spec(module, iters, size, **job):
    d = module.lulesh_example()
    d["job"].update(job)
    d["execution"][0]["mpi"]["command"] = f"{PAPER_CMD} -i {iters} -s {size}"
    return module.parse_jobspec(d)


def _app(iters=3, size=8):
    return appspec.AppSpec(arch="lulesh-dash", shape="train_4k",
                           run=f"lulesh -i {iters} -s {size}")


# ---------------------------------------------------------------- Appfile

@pytest.mark.parametrize("text", APPFILES)
def test_appfile_parse_and_hash_equal_reference(text):
    got, want = appspec.parse_appfile(text), ref_appspec.parse_appfile(text)
    assert (got.arch, got.shape, got.run, got.directives, got.overrides) == \
        (want.arch, want.shape, want.run, want.directives, want.overrides)
    assert got.to_appfile() == want.to_appfile()
    assert got.content_hash() == want.content_hash()
    again = appspec.parse_appfile(got.to_appfile())
    assert again.content_hash() == got.content_hash()


@pytest.mark.parametrize("text,match", [
    ("FROM arch:lulesh-dash\nSHAPE train_4k\n###bogus###\n",
     "unknown directive"),
    ("FROM image:lulesh\nSHAPE train_4k\n", "FROM must reference"),
    ("FROM arch:lulesh-dash\nSHAPE grid13\n", "unknown shape"),
    ("FROM arch:lulesh-dash\n", "must contain"),
    ("FROM arch:lulesh-dash\nSHAPE train_4k\nCOPY a b\n", "unparseable"),
])
def test_appfile_rejects_like_reference(text, match):
    for module in (appspec, ref_appspec):
        with pytest.raises(ValueError, match=match):
            module.parse_appfile(text)


def test_programmatic_appspec_defaults_equal_reference():
    got = appspec.AppSpec("lulesh-dash", "train_4k")
    want = ref_appspec.AppSpec("lulesh-dash", "train_4k")
    assert got.content_hash() == want.content_hash()
    assert appspec.KNOWN_DIRECTIVES == ref_appspec.KNOWN_DIRECTIVES
    assert got.model_config.family == "stencil"


# ------------------------------------------------------ JobSpec and batch

def test_listing_1_5_parses_like_reference():
    got = jobspec.parse_jobspec(jobspec.lulesh_example())
    want = ref_jobspec.parse_jobspec(ref_jobspec.lulesh_example())
    assert jobspec.lulesh_example() == ref_jobspec.lulesh_example()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.executions[0].mpi_tasks == 2197


def test_jobspec_id_and_gridftp_like_reference():
    spec = jobspec.parse_jobspec({"job": {"name": "j"}})
    jid = spec.ensure_id()
    assert len(jid) == 12 and spec.ensure_id() == jid
    with pytest.raises(NotImplementedError, match="next release"):
        jobspec.parse_jobspec({"job": {"name": "x"}, "data": {"input": [
            {"source": "gsiftp://x/y", "protocol": "gridftp"}]}})
    with pytest.raises(ValueError, match="missing required 'job'"):
        jobspec.parse_jobspec({})


def _rich_spec(module):
    """tests/test_batch_golden.py's spec, in either package."""
    return module.JobSpec(
        name="lulesh_dash", mail="hoeb@mnm-team.org",
        inputs=[module.DataItem(source="https://example.org/input.tar",
                                protocol="https")],
        deployment=module.Deployment(nodes=46, ram="90gb", cores_per_task=1,
                                     tasks_per_node=48, clocktime="06:00:00"),
        executions=[
            module.Execution("serial", "echo preparing"),
            module.Execution("mpi", f"{PAPER_CMD} -i 1000 -s 13", 2197)])


@pytest.mark.parametrize("dialect", ["slurm", "pbs", "local"])
@pytest.mark.parametrize("which", ["rich", "listing_1_5", "plain"])
def test_batch_text_byte_equal_reference(dialect, which):
    def spec(module):
        if which == "rich":
            return _rich_spec(module)
        if which == "listing_1_5":
            return module.parse_jobspec(module.lulesh_example())
        return module.parse_jobspec({"job": {"name": "tiny"},
                                     "execution": [{"serial": {
                                         "command": "./a.out"}}]})
    got = batch.make_batch(spec(jobspec), dialect, workdir="/scratch/j1")
    assert got == ref_batch.make_batch(spec(ref_jobspec), dialect,
                                       workdir="/scratch/j1")


def test_batch_goldens():
    assert batch.slurm_batch(_rich_spec(jobspec)) == GOLDEN_SLURM
    assert batch.pbs_batch(_rich_spec(jobspec)) == GOLDEN_PBS
    with pytest.raises(ValueError, match="not supported so far"):
        batch.make_batch(jobspec.parse_jobspec({"job": {"name": "x"}}), "lsf")


# ---------------------------------------------------------- job machine

def test_job_state_machine_and_requeue():
    j = Job("id", "n")
    j.transition(JobState.RUNNING)
    j.transition(JobState.FAILED)
    j.transition(JobState.PENDING)  # requeue allowed
    with pytest.raises(ValueError):
        Job("id2", "n").transition(JobState.FINISHED)
    sched, calls = LocalScheduler(), []

    def fn(job):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return 42
    jid = sched.submit(fn, "flaky")
    assert sched.status(jid) is JobState.FAILED
    assert "boom" in sched.logs(jid)[1]
    sched.requeue(jid)
    assert (sched.status(jid), sched.result(jid)) == (JobState.FINISHED, 42)
    assert sched.wait(jid, timeout=1.0) is JobState.FINISHED


# ------------------------------------------------------- build and plan

def test_stencil_plan_equals_reference():
    got = BuildService().build(_app(size=13), "local:cpu", lower=False).plan
    want = RefBuildService().build(
        ref_appspec.AppSpec("lulesh-dash", "train_4k",
                            run="lulesh -i 3 -s 13"),
        "local:cpu", lower=False).plan
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.shape == "grid13" and got.kernels == "reference"
    assert got.report() == want.report()


def test_plan_json_roundtrip():
    plan = BuildService().build(_app(), "nvidia:h100", lower=False).plan
    back = DeploymentPlan.from_json(plan.to_json())
    assert back == plan and back.mesh_shape == (1,)
    assert "EASEY tuning report" in back.report()
    assert "kernels         : cuda" in back.report()


def test_h100_build_describes_the_cuda_program():
    res = BuildService().build(_app(size=256), "nvidia:h100", lower=False)
    assert (res.plan.kernels, res.step_name, res.built) == \
        ("cuda", "sedov_step", {})
    prog = res.program
    assert prog["arch"] == "sm_90a" and set(prog["kernels"]) == \
        {"sedov_stencil"}
    k4 = prog["kernels"]["sedov_stencil"]
    assert k4["sha256"] == _build.source_sha256("sedov_stencil")
    assert (REPO / k4["source"]).exists()
    assert "-fmad=false" in k4["nvcc_flags"]
    assert "arch=compute_90a,code=sm_90a" in k4["nvcc_flags"]


def test_cpu_build_runs_the_plain_step():
    res = BuildService().build(_app(size=8), "local:cpu", lower=True)
    assert res.program == {"step": "sedov_step", "arch": "reference",
                           "kernels": {}}
    assert res.built == {}
    out = run_command(f"{PAPER_CMD} -i 1 -s 8", job=_Job(), build_result=res)
    assert (out["device"], out["kernels"]) == ("cpu", "reference")
    cfg = lulesh.LuleshConfig(grid=8)
    got = out["state"]
    want = lulesh.step(lulesh.init_state(cfg, "cpu"), cfg)
    for k in ("rho", "e", "v", "t"):
        assert torch.equal(got[k], want[k])


def test_skip_shapes_registered_like_reference():
    for arch in ("lulesh-dash", "lulesh-dash-smoke"):
        assert ARCHS[arch]["skip_shapes"] == REF_ARCHS[arch]["skip_shapes"]
        assert ARCHS[arch]["full"].family == "stencil"


def test_lm_build_gives_the_serve_plan_and_refuses_lowering():
    app = appspec.AppSpec("deepseek-7b", "decode_32k",
                          shape_overrides={"seq_len": 512,
                                           "global_batch": 8})
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert (res.plan.kernels, res.plan.serve_kv_kernel) == ("cuda", "cuda")
    assert (res.plan.serve_num_pages, res.plan.serve_page_size) == (257, 16)
    bare = dataclasses.replace(app, directives=())
    plan = BuildService().build(bare, "nvidia:h100", lower=False).plan
    assert plan.kernels == "reference"
    assert "local-kernel directive absent -> reference ops" in plan.notes
    # lowering the serving app: the decode step's kernels (K1, K2) on the
    # card, nothing to build on the CPU or without the directive
    assert set(res.program["kernels"]) == {"paged_attention", "rmsnorm"}
    assert res.step_name == "decode_step" and res.built == {}
    cpu = BuildService().build(app, "local:cpu", lower=True)
    assert (cpu.program["arch"], cpu.built) == ("reference", {})
    assert BuildService().build(bare, "nvidia:h100", lower=True).built == {}
    train = BuildService().build(appspec.AppSpec("deepseek-7b", "train_4k"),
                                 "nvidia:h100", lower=False)
    assert (train.step_name, list(train.program["kernels"])) == \
        ("train_step", ["rmsnorm"]) and train.built == {}


# --------------------------------------------------------------- package

def _package(tmp_path, target="local:cpu", size=8):
    res = BuildService().build(_app(size=size), target, lower=False)
    return res, write_package(res, tmp_path / "pkgs")


def test_package_members_and_manifest(tmp_path):
    res, pkg = _package(tmp_path, "nvidia:h100", 256)
    names = tarfile.open(pkg).getnames()
    assert set(names) == {"manifest.json", "plan.json", "tuning_report.txt",
                          "Appfile", "program.json.gz"}
    man = read_manifest(pkg)
    assert (man["arch"], man["shape"], man["target"], man["step"]) == \
        ("lulesh-dash", "train_4k", "nvidia:h100", "sedov_step")
    assert man["app_hash"] == res.appspec.content_hash()
    env = tmp_path / "env"
    assert extract_package(pkg, env)["program_sha256"] == \
        man["program_sha256"]
    assert read_program(env) == res.program
    assert DeploymentPlan.from_json((env / "plan.json").read_text()) == \
        res.plan
    assert appspec.parse_appfile((env / "Appfile").read_text()) \
        .content_hash() == res.appspec.content_hash()


def test_package_tamper_detected(tmp_path):
    _, pkg = _package(tmp_path)
    with tarfile.open(pkg) as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar}
    members["program.json.gz"] = b"corrupt"
    with tarfile.open(pkg, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="integrity"):
        extract_package(pkg, tmp_path / "env2")


# ------------------------------------------------------------ middleware

def test_algorithm1_data_staging(tmp_path):
    _, pkg = _package(tmp_path)
    src = tmp_path / "input.bin"
    src.write_bytes(b"data!")
    spec = jobspec.parse_jobspec({
        "job": {"name": "staged"},
        "data": {"input": [{"source": str(src), "protocol": "file"}],
                 "mount": {"container-path": "/data"}},
        "deployment": {"nodes": 1}, "execution": []})
    mw = Middleware(tmp_path / "cluster")
    jid = mw.submit(pkg, spec, runner=None)
    assert mw.status(jid) is JobState.FINISHED
    workdir = tmp_path / "cluster" / spec.job_id
    assert (workdir / "data" / "input.bin").read_bytes() == b"data!"
    assert "#SBATCH" in (workdir / "batch.sh").read_text()
    assert (workdir / "env" / "program.json.gz").exists()


def test_missing_input_fails_staging(tmp_path):
    _, pkg = _package(tmp_path)
    spec = jobspec.parse_jobspec({
        "job": {"name": "bad"},
        "data": {"input": [{"source": "/nonexistent", "protocol": "file"}]},
        "execution": []})
    with pytest.raises(Exception, match="input not found"):
        Middleware(tmp_path / "cluster").submit(pkg, spec)


# ----------------------------------------------------------- run_command

def test_run_lulesh_paper_command_on_cpu():
    """The exact command shape of the paper's Listing 1.5, with the
    reference's result keys (tests/test_system.py)."""
    job = _Job()
    out = run_command(f"{PAPER_CMD} -i 3 -s 8", job=job, device="cpu")
    assert out["iters"] == 3 and out["grid"] == 8
    assert out["fom"] > 0 and out["seconds"] > 0
    assert (out["device"], out["kernels"]) == ("cpu", "reference")
    assert any("[lulesh]" in ln for ln in job.lines)


def test_run_command_rejects_what_it_does_not_run(monkeypatch):
    with pytest.raises(ValueError, match="unknown EASEY command"):
        run_command("frobnicate --now", device="cpu")
    trained = run_command("train --steps 3 --seq-len 16", device="cpu")
    assert (trained["steps"], trained["device"]) == (3, "cpu")
    out = run_command("serve --arch deepseek-7b-smoke --batch 2 --prefill 8 "
                      "--decode 2", device="cpu")
    assert (out["requests"], out["device"]) == (2, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_command(f"{PAPER_CMD} -i 1 -s 4")


# ------------------------------------------------------------- run_easey

def test_run_easey_on_cpu_finishes(tmp_path):
    spec = _lulesh_spec(jobspec, 3, 8)
    mw, jid, res = run_easey(_app(3, 8), "local:cpu", spec,
                             storage=tmp_path)
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)[1]
    out = mw.scheduler.result(jid)[0]
    assert out["fom"] > 0 and (out["grid"], out["iters"]) == (8, 3)
    assert out["kernels"] == "reference"
    workdir = tmp_path / "cluster" / spec.job_id
    assert "srun --ntasks=2197" in (workdir / "batch.sh").read_text()
    assert list((tmp_path / "packages").glob("*.easey.tar"))
    assert "[lulesh] grid=8^3" in mw.logs(jid)[0]


def test_run_easey_state_equals_direct_run(tmp_path):
    mw, jid, _ = run_easey(_app(5, 12), "local:cpu",
                           _lulesh_spec(jobspec, 5, 12), storage=tmp_path)
    got = mw.scheduler.result(jid)[0]["state"]
    cfg = lulesh.LuleshConfig(grid=12)
    want = lulesh.run(lulesh.init_state(cfg, "cpu"), cfg, 5)
    for k in ("rho", "e", "v", "t"):
        assert torch.equal(got[k], want[k]), k


def test_failed_run_is_reported_failed(tmp_path):
    """A run that raises ends FAILED with its traceback, never FINISHED."""
    spec = jobspec.parse_jobspec({"job": {"name": "bad"}, "execution": [
        {"serial": {"command": "frobnicate --now"}}]})
    mw, jid, _ = run_easey(_app(), "local:cpu", spec, storage=tmp_path)
    assert mw.status(jid) is JobState.FAILED
    assert "unknown EASEY command" in mw.logs(jid)[1]


def test_easey_cli_build_and_run(tmp_path):
    app = tmp_path / "Appfile"
    app.write_text(_app(2, 6).to_appfile())
    cfg = tmp_path / "job.json"
    d = jobspec.lulesh_example()
    d["execution"][0]["mpi"]["command"] = f"{PAPER_CMD} -i 2 -s 6"
    cfg.write_text(json.dumps(d))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO / "src")}

    def easey(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.core.workflow", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
    out = easey("build", str(app), "--target", "local:cpu", "--out", "pk")
    assert out.returncode == 0, out.stderr
    assert "kernels         : reference" in out.stdout
    assert list((tmp_path / "pk").glob("*.easey.tar"))
    out = easey("run", str(app), "--target", "local:cpu", "--config",
                str(cfg))
    assert out.returncode == 0, out.stderr
    assert "state=finished" in out.stdout and "[lulesh] grid=6^3" in \
        out.stdout


@pytest.mark.cuda
def test_run_easey_on_h100_runs_the_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    before = sedov_step_cuda.launches
    mw, jid, res = run_easey(_app(4, 16), "nvidia:h100",
                             _lulesh_spec(jobspec, 4, 16), storage=tmp_path)
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)[1]
    assert isinstance(res, BuildResult) and "sedov_stencil" in res.built
    assert sedov_step_cuda.launches == before + 4
    assert mw.scheduler.result(jid)[0]["state"]["e"].is_cuda
