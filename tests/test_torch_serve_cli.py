"""The port's ``serve`` entry points against the JAX reference's, on the
CPU: ``launch/serve.serve_main`` (single engine and router fleet), the
``python -m repro_torch.launch.serve`` CLI, the ``serve`` branch of
``run_command`` and EASEY deployment of a serving Appfile.

The port's engines take the reference's weights (crossed bit for bit:
the port's ``init_params`` is replaced by the reference's draw for the
same seed), so every deterministic key the reference returns — counts,
virtual-step latencies, the first tokens (``sample``), the metrics
snapshot without its two wall-clock keys — must be equal, and the
Chrome-trace files byte-identical.  Wall-clock keys (``decode_s``,
``decode_tok_per_s``, ``latency_mean_s``) and the plan object are not
compared.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
from repro.configs import get_config as ref_config
from repro.launch.run import run_command as ref_run_command
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro_torch.core import jobspec
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobs import JobState
from repro_torch.core.workflow import run_easey
from repro_torch.kernels import _build
from repro_torch.launch import serve as port_serve
from repro_torch.launch.run import run_command
from repro_torch.models.params import params_from_jax
from repro_torch.serving import engine as port_engine

ARCH = "deepseek-7b-smoke"
WALL = {"decode_s", "decode_tok_per_s", "latency_mean_s", "plan"}
METRIC_WALL = {"serve_wall_s", "serve_tokens_per_s", "router_wall_s",
               "router_tokens_per_s"}
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS: dict = {}


@pytest.fixture(autouse=True)
def reference_weights(monkeypatch):
    """Every port engine built in a test draws the reference's weights:
    the reference model of the engine's arch, ``PRNGKey(seed)``."""
    real = port_engine.ServeEngine.__init__

    def init(self, arch="deepseek-7b-smoke", *a, seed=0, **kw):
        key = (arch, seed)
        if key not in _WEIGHTS:
            rm = ref_model_for(ref_config(arch), remat="none")
            _WEIGHTS[key] = params_from_jax(jax.tree.map(
                np.asarray, ref_init(rm.param_table(),
                                     jax.random.PRNGKey(seed))))
        monkeypatch.setattr(port_engine, "init_params",
                            lambda table, gen, device: _WEIGHTS[key])
        real(self, arch, *a, seed=seed, **kw)
    monkeypatch.setattr(port_engine.ServeEngine, "__init__", init)


def _same(got: dict, want: dict) -> None:
    """Every deterministic key of the reference's output, equal (NaN
    equal to NaN), and the metrics without their wall-clock keys."""
    for key, value in want.items():
        if key in WALL:
            continue
        if key == "metrics":
            g = {k: v for k, v in got[key].items() if k not in METRIC_WALL}
            w = {k: v for k, v in value.items() if k not in METRIC_WALL}
            assert list(g) == list(w)
            for k in w:
                assert g[k] == w[k] or (g[k] != g[k] and w[k] != w[k]), k
            continue
        assert got[key] == value or (got[key] != got[key] and
                                     value != value), key


def _paths(tmp_path, tag):
    return {k: str(tmp_path / f"{tag}_{k}") for k in
            ("trace_out", "metrics_out", "prom_out")}


def _strip_wall_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if not any(w in ln for w in METRIC_WALL)]


CASES = {
    "paged": dict(kv_layout="paged", trace="zipf", requests=5),
    "contiguous": dict(kv_layout="contiguous", requests=3),
    "sharedprefix_cache": dict(kv_layout="paged", trace="sharedprefix",
                               prefix_cache=True, requests=6,
                               prefill_len=16),
    "router_x2": dict(kv_layout="paged", replicas=2, requests=5),
    "router_autoscale": dict(kv_layout="paged", replicas=3, requests=8,
                             arrivals="poisson", arrival_gap=2.0,
                             slo_ttft=30, admission="reject", autoscale=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_main_returns_the_reference_keys(tmp_path, case):
    kw = dict(arch=ARCH, batch=2, prefill_len=8, decode_tokens=4,
              max_len=32, seed=0)
    kw.update(CASES[case])
    ref_paths, port_paths = _paths(tmp_path, "ref"), _paths(tmp_path, "port")
    want = ref_serve.serve_main(log=quiet, target="local:cpu", **kw,
                                **ref_paths)
    got = port_serve.serve_main(log=quiet, device="cpu", **kw, **port_paths)
    _same(got, want)
    assert Path(port_paths["trace_out"]).read_bytes() == \
        Path(ref_paths["trace_out"]).read_bytes()
    got_m = json.loads(Path(port_paths["metrics_out"]).read_text())
    want_m = json.loads(Path(ref_paths["metrics_out"]).read_text())
    assert {k: v for k, v in got_m.items() if k not in METRIC_WALL} == \
        {k: v for k, v in want_m.items() if k not in METRIC_WALL}
    assert _strip_wall_lines(Path(port_paths["prom_out"]).read_text()) == \
        _strip_wall_lines(Path(ref_paths["prom_out"]).read_text())


def test_run_command_serve_twin_of_the_system_test():
    """``tests/test_system.py::test_run_serve_command`` on the port, and
    its deterministic keys equal to the reference's run_command."""
    cmd = "serve --arch stablelm-1.6b-smoke --batch 2 --prefill 16 --decode 4"
    lines = []

    class Job:
        log = staticmethod(lines.append)
    out = run_command(cmd, job=Job(), device="cpu")
    assert out["decode_tokens"] == 4
    assert out["decode_tok_per_s"] > 0
    assert any("tok/s aggregate" in ln for ln in lines)
    _same(out, ref_run_command(cmd, job=type("J", (), {"log": quiet})()))


def test_main_writes_the_three_files(tmp_path):
    args = ["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prefill",
            "8", "--decode", "3", "--requests", "3", "--max-len", "32",
            "--kv-layout", "paged"]
    files = {k: tmp_path / f"{k}.out" for k in ("trace", "metrics", "prom")}
    for k, p in files.items():
        args += [f"--{k}-out", str(p)]
    out = port_serve.main(args)
    metrics = json.loads(files["metrics"].read_text())
    assert metrics["serve_requests_completed"] == 3
    assert metrics["serve_decode_steps"] == out["decode_steps"]
    assert "# TYPE serve_requests_completed counter" in \
        files["prom"].read_text()
    trace = json.loads(files["trace"].read_text())
    assert {ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "X"} \
        == {"queued", "prefill_chunk", "decode"}
    ref_serve.serve_main(arch=ARCH, batch=2, prefill_len=8, decode_tokens=3,
                         requests=3, max_len=32, kv_layout="paged",
                         target="local:cpu", log=quiet,
                         trace_out=str(tmp_path / "ref_trace"))
    assert files["trace"].read_bytes() == \
        (tmp_path / "ref_trace").read_bytes()


SERVE_APPFILE = ("FROM arch:deepseek-7b-smoke\nSHAPE decode_32k\n"
                 "###include_local_kernels###\n"
                 "RUN serve --kv-layout paged --batch 2 --max-len 64\n")


def test_run_easey_deploys_the_serving_app_on_cpu(tmp_path):
    app = parse_appfile(SERVE_APPFILE)
    cmd = ("serve --arch deepseek-7b-smoke --kv-layout paged --batch 2 "
           "--max-len 64 --requests 3 --prefill 16 --decode 4 "
           "--trace-out trace.json --metrics-out metrics.json "
           "--prom-out metrics.prom")
    spec = jobspec.parse_jobspec({"job": {"name": "serve"}, "execution": [
        {"serial": {"command": cmd}}]})
    mw, jid, res = run_easey(app, "local:cpu", spec, storage=tmp_path)
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)[1]
    assert (res.step_name, res.program["arch"], res.built) == \
        ("decode_step", "reference", {})
    out = mw.scheduler.result(jid)[0]
    assert (out["requests"], out["kv_kernel"], out["device"]) == \
        (3, "gather", "cpu")
    workdir = tmp_path / "cluster" / spec.job_id
    trace = json.loads((workdir / "trace.json").read_text())
    assert {ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "X"} \
        == {"queued", "prefill_chunk", "decode"}
    assert json.loads((workdir / "metrics.json").read_text())[
        "serve_requests_completed"] == 3
    assert (workdir / "metrics.prom").exists()
    # the same serve_main call, untraced, gives the same streams
    plain = port_serve.serve_main(arch=ARCH, batch=2, max_len=64,
                                  requests=3, prefill_len=16,
                                  decode_tokens=4, kv_layout="paged",
                                  log=quiet, device="cpu")
    assert [r.tokens for r in out["stats"].results] == \
        [r.tokens for r in plain["stats"].results]
    assert "[serve] paged:continuous" in mw.logs(jid)[0]


def test_serve_runs_where_the_build_says(tmp_path):
    app = parse_appfile(SERVE_APPFILE)
    res = BuildService().build(app, "local:cpu", lower=True)
    out = run_command("serve --kv-layout paged --batch 2 --max-len 64 "
                      "--requests 2 --prefill 8 --decode 2",
                      build_result=res)
    assert (out["arch"], out["device"]) == ("deepseek-7b-smoke", "cpu")
    with pytest.raises(ValueError, match="build is for"):
        run_command("serve --batch 2", build_result=res, device="cuda")


def test_serve_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.serve_main(arch=ARCH, batch=2, prefill_len=8,
                              decode_tokens=2, log=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_command("serve --batch 2 --prefill 8 --decode 2")
    with pytest.raises(SystemExit):
        port_serve.main(["--kv-kernel", "pallas"])


def test_legacy_families_and_router_only_flags_raise(monkeypatch):
    """The reference's message logic for a family the engine cannot serve
    (the enc-dec's smoke, served by the legacy fixed-batch path, which
    refuses the engine's trace and fleet flags) and for router-only flags
    on one engine."""
    from repro_torch.serving import ServeEngine
    kw = dict(arch="whisper-tiny-smoke", log=quiet, device="cpu")
    with pytest.raises(NotImplementedError, match="legacy static path"):
        ServeEngine(num_slots=2, max_len=32, **kw)
    with pytest.raises(NotImplementedError, match="legacy static path"):
        port_serve.serve_main(trace_out="x.json", **kw)
    with pytest.raises(NotImplementedError, match="--replicas"):
        port_serve.serve_main(replicas=2, **kw)
    out = port_serve.serve_main(batch=2, prefill_len=16, decode_tokens=3,
                                **kw)
    assert out["mode"] == "legacy-static"
    with pytest.raises(NotImplementedError, match="router path"):
        port_serve.serve_main(arch=ARCH, autoscale=1, log=quiet,
                              device="cpu")
    with pytest.raises(ValueError, match="trace"):
        port_serve.serve_main(arch=ARCH, trace="bogus", log=quiet,
                              device="cpu")


def test_build_raises_when_nvcc_fails(monkeypatch):
    """No fallback hides a kernel: a CUDA plan's build propagates the
    compiler's failure."""
    def broken(names):
        raise RuntimeError("nvcc failed for paged_attention")
    monkeypatch.setattr(_build, "build", broken)
    app = parse_appfile(SERVE_APPFILE.replace("-smoke", ""))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        BuildService().build(app, "nvidia:h100", lower=True)
    prefill = BuildService().build(
        parse_appfile(SERVE_APPFILE.replace("decode_32k", "prefill_32k")),
        "nvidia:h100", lower=False)
    assert (prefill.step_name, set(prefill.program["kernels"])) == \
        ("prefill_step", {"rmsnorm"})
    stablelm = BuildService().build(
        parse_appfile(SERVE_APPFILE.replace("deepseek-7b", "stablelm-1.6b")),
        "nvidia:h100", lower=False)
    assert set(stablelm.program["kernels"]) == {"paged_attention"}
