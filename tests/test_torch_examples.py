"""The port's example twins (``repro_torch.examples``) on the CPU, at smoke
sizes, with ``--device cpu``.

Each runs through its ``main``.  Where its output depends neither on the
clock nor on drawn weights it equals the reference's: the quickstart's
tuning report, the batch file LULESH's job generates (its storage path
and job id are the run's own), the training example's restarts.
Without a GPU and without ``--device cpu`` each one raises.
"""

import re

import pytest
import torch

from repro.configs import base as ref_base
from repro.core import appspec as ref_appspec
from repro.core import batch as ref_batch
from repro.core import jobspec as ref_jobspec
from repro.core.build import BuildService as RefBuildService
from repro.launch.train import train_main as ref_train_main
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.examples import (lulesh_easey, quickstart, serve_batch,
                                  train_100m)

EXAMPLES = {"quickstart": quickstart, "serve_batch": serve_batch,
            "train_100m": train_100m, "lulesh_easey": lulesh_easey}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # thousands of tiny ops: torch's default thread count only contends
    # with the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _registry():
    # train_100m registers its configs when run; the tests that follow in
    # this process compare the registry with the reference's
    saved = dict(ARCHS)
    yield
    ARCHS.clear()
    ARCHS.update(saved)


def test_quickstart_prints_the_reference_tuning_report(capsys):
    mw, job_id, build = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"jobID={job_id} state=finished" in out
    report = out.split("--- tuning report " + "-" * 43 + "\n")[1] \
        .split("\n--- job stdout")[0]
    app = ref_appspec.parse_appfile(quickstart.APPFILE)
    app.shape_overrides = {"seq_len": 64, "global_batch": 4}
    want = RefBuildService().build(app, "local:cpu", lower=False)
    assert report == build.plan.report() == want.plan.report()
    assert "[train] step 9 loss=" in out
    res = mw.scheduler.result(job_id)[0]
    assert res["steps"] == 10 and res["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["--prefill", "16", "--decode", "4"],
    ["--arch", "picolm-4-smoke", "--kv-layout", "paged", "--trace",
     "repetitive", "--decode", "12", "--spec-k", "4"],
])
def test_serve_batch_runs(argv, capsys):
    out = serve_batch.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "deepseek-7b-smoke"
    assert out["device"] == "cpu"
    assert re.fullmatch(rf"{arch}: [0-9.]+ decode tok/s \(batch=4\); first "
                        rf"tokens of request 0: \[[0-9, ]+\]",
                        lines[-1 - ("--spec-k" in argv)])
    if "--spec-k" in argv:
        assert out["spec_k"] == 4 and out["spec_verify_steps"] > 0
        assert lines[-1].startswith("speculative: k=4, ")


def test_train_100m_restores_the_step_25_checkpoint(monkeypatch, capsys,
                                                    tmp_path):
    """The smoke twin of the 100M config through an injected failure
    right after the step-25 checkpoint, its async write slowed down: the
    restart waits for it and restores it, and counts the reference's
    restarts."""
    write = checkpointer.Checkpointer._write

    def slow_write(self, step, snap):
        import time
        time.sleep(0.3)       # easeylint: allow[wall-clock] — a slow disk
        return write(self, step, snap)

    monkeypatch.setattr(checkpointer.Checkpointer, "_write", slow_write)
    monkeypatch.setattr(train_100m, "ARCH", "gpt2s-100m-smoke")
    argv = ["--steps", "26", "--fail-at", "25", "--seq-len", "16",
            "--global-batch", "2"]
    out = train_100m.main(argv + ["--device", "cpu"])
    log = capsys.readouterr().out
    assert "[FT] injected failure at step 25 -> restart #1 from step 25" \
        in log and "[train] restored checkpoint step 24" in log
    assert f"trained 26 steps ({out['restarts']} restarts" in log
    # the reference on the same config
    cfg = get_config("gpt2s-100m-smoke")
    fields = {f: getattr(cfg, f) for f in (
        "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
        "d_ff", "vocab_size", "activation", "norm", "pos")}
    small = ref_base.ModelConfig(name="gpt2s-100m-smoke", **fields)
    monkeypatch.setitem(ref_base.ARCHS, small.name,
                        {"full": small, "smoke": small, "skip_shapes": ()})
    want = ref_train_main(arch=small.name, steps=26, seq_len=16,
                          global_batch=2, ckpt_every=25, fail_at=(25,),
                          ckpt_dir=str(tmp_path / "ref"),
                          log=lambda *a, **k: None)
    assert (out["steps"], out["restarts"]) == (want["steps"],
                                               want["restarts"]) == (26, 1)


def test_lulesh_easey_generates_the_reference_batch_file(capsys):
    rows, batch = lulesh_easey.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [r[0] for r in rows] == [g for g, _ in lulesh_easey.GRIDS]
    assert all(nat > 0 and eas > 0 for _, nat, eas in rows)
    assert len(out) >= 4 and out[0].split() == ["p", "zones", "FOM",
                                                "native", "FOM", "easey",
                                                "delta"]
    text = batch.read_text()
    assert f"--- generated {batch} ---" in out
    iters, grid = map(int, re.search(r"-i (\d+) -s (\d+)", text).groups())
    assert (grid, iters) in lulesh_easey.GRIDS
    spec = ref_jobspec.parse_jobspec(ref_jobspec.lulesh_example())
    spec.executions[0].command = (
        f"ch-run -b ./data:/data lulesh.dash -- "
        f"/built/lulesh.dash -i {iters} -s {grid}")
    workdir = str(batch.parent)        # the storage path and the job id
    want = ref_batch.make_batch(spec, "slurm", workdir=workdir)
    assert text.replace(workdir, "<job>") == want.replace(workdir, "<job>")
    assert text == want


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_without_cuda_unless_asked_for_cpu(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name].main([])
