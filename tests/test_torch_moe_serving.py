"""The MoE family served through the port's entry points, against the JAX
reference on the CPU.

* ``ServeEngine`` on ``granite-moe-3b-a800m-smoke`` and
  ``dbrx-132b-smoke`` (3 slots x 48) on the trace of the reference's
  ``test_paged_matches_contiguous_moe_family`` and
  ``test_chunked_matches_blocking_moe_family`` (6 Zipf requests, prompts
  up to 16, 10 new tokens, seed 1): greedy streams identical to the
  reference engine's on the same weights, and the scheduling counts
  equal, paged (page 8) and contiguous, chunked (chunk 4) and blocking;
  and within the port, paged equals contiguous and chunked equals
  blocking, on the kernel dispatch (its plain version on the CPU).
* ``serve_main`` (one engine and a 2-replica router) and
  ``run_command("serve --arch granite-moe-3b-a800m-smoke ...")`` go
  through the engine and return the reference's deterministic keys.
* ``run_easey`` deploys a MoE serving Appfile on the CPU target.
* ``BuildService.build(lower=True)`` for ``nvidia:h100`` builds the
  paged-decode and RMSNorm kernels for granite and the paged-decode
  kernel only for dbrx (a LayerNorm config).
* A fleet mixing a dense and a MoE arch is refused.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch.run import run_command as ref_run_command
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.serving import ServeEngine as RefEngine
from repro.serving import zipf_trace as ref_zipf
from repro_torch.configs import get_config
from repro_torch.core import jobspec
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobs import JobState
from repro_torch.core.workflow import run_easey
from repro_torch.kernels import _build
from repro_torch.launch import serve as port_serve
from repro_torch.launch.run import run_command
from repro_torch.models.moe import MoELM
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.serving import ReplicaRouter, ServeEngine, zipf_trace
from repro_torch.serving import engine as port_engine

MOE_SMOKES = ("granite-moe-3b-a800m-smoke", "dbrx-132b-smoke")
TRACE = dict(n=6, vocab_size=256, max_prompt=16, max_new=10, seed=1)
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


def _ref_weights(arch, seed=0):
    """The reference model's weights for ``arch``, ``PRNGKey(seed)``, as
    port tensors."""
    key = (arch, seed)
    if key not in _WEIGHTS:
        rm = ref_model_for(ref_config(arch), remat="none")
        _WEIGHTS[key] = params_from_jax(jax.tree.map(
            np.asarray, ref_init(rm.param_table(), jax.random.PRNGKey(seed))))
    return _WEIGHTS[key]


@pytest.fixture(autouse=True)
def reference_weights(monkeypatch):
    """Every port engine built in a test draws the reference's weights."""
    real = port_engine.ServeEngine.__init__

    def init(self, arch="deepseek-7b-smoke", *a, seed=0, **kw):
        weights = _ref_weights(arch, seed)
        monkeypatch.setattr(port_engine, "init_params",
                            lambda table, gen, device: weights)
        real(self, arch, *a, seed=seed, **kw)
    monkeypatch.setattr(port_engine.ServeEngine, "__init__", init)


def _streams(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _counts(stats):
    return {"decode_steps": stats.decode_steps,
            "generated_tokens": stats.generated_tokens,
            "preemptions": stats.preemptions,
            "peak_active": stats.peak_active,
            "peak_resident_tokens": stats.peak_resident_tokens,
            "mean_ttft_steps": stats.mean_ttft_steps,
            "prefill_chunks": stats.prefill_chunks,
            "prefill_tokens": stats.prefill_tokens,
            "overlap_steps": stats.overlap_steps,
            "occupancy": stats.occupancy}


def _engine_kw(arch, layout):
    return dict(arch=arch, num_slots=3, max_len=48, seed=0, kv_layout=layout,
                page_size=8 if layout == "paged" else 0, log=quiet)


_REF_RUNS: dict = {}


def _ref_run(arch, layout, chunk):
    key = (arch, layout, chunk)
    if key not in _REF_RUNS:
        eng = RefEngine(**_engine_kw(arch, layout))
        _REF_RUNS[key] = eng.run(ref_zipf(**TRACE), prefill_chunk=chunk)
    return _REF_RUNS[key]


@pytest.mark.parametrize("chunk", [4, 0])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", MOE_SMOKES)
def test_moe_streams_and_counts_match_reference(arch, layout, chunk):
    want = _ref_run(arch, layout, chunk)
    eng = ServeEngine(device="cpu", **_engine_kw(arch, layout))
    assert isinstance(eng.model, MoELM)
    got = eng.run(zipf_trace(**TRACE), prefill_chunk=chunk)
    assert _streams(got) == _streams(want)
    assert _counts(got) == _counts(want)
    assert got.prefill_buckets == want.prefill_compiles


@pytest.mark.parametrize("arch", MOE_SMOKES)
def test_moe_family_paged_equals_contiguous_and_chunked_blocking(arch):
    """The reference's two MoE-family serving identities, on the port's
    kernel dispatch."""
    paged = ServeEngine(device="cpu", kv_kernel="cuda",
                        **_engine_kw(arch, "paged"))
    contiguous = ServeEngine(device="cpu", **_engine_kw(arch, "contiguous"))
    reqs = zipf_trace(**TRACE)
    assert _streams(paged.run(reqs)) == _streams(contiguous.run(reqs))
    assert _streams(contiguous.run(reqs, prefill_chunk=4)) == \
        _streams(contiguous.run(reqs, prefill_chunk=0))


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


@pytest.mark.parametrize("arch,replicas", [
    ("granite-moe-3b-a800m-smoke", 1), ("dbrx-132b-smoke", 1),
    ("granite-moe-3b-a800m-smoke", 2)])
def test_serve_main_serves_moe_through_the_engine(arch, replicas):
    kw = dict(arch=arch, batch=2, prefill_len=8, decode_tokens=4,
              max_len=32, seed=0, kv_layout="paged", requests=5,
              replicas=replicas)
    want = ref_serve.serve_main(log=quiet, target="local:cpu", **kw)
    got = port_serve.serve_main(log=quiet, device="cpu", **kw)
    _same(got, want)
    assert got["requests"] == 5 and got["kv_layout"] == "paged"


def test_run_command_serves_moe():
    cmd = ("serve --arch granite-moe-3b-a800m-smoke --batch 2 --prefill 16 "
           "--decode 4")
    out = run_command(cmd, device="cpu")
    assert out["decode_tokens"] == 4 and out["decode_steps"] > 0
    _same(out, ref_run_command(cmd, job=type("J", (), {"log": quiet})()))


def test_run_easey_deploys_a_moe_serving_appfile_on_cpu(tmp_path):
    app = parse_appfile("FROM arch:granite-moe-3b-a800m-smoke\n"
                        "SHAPE decode_32k\n###include_local_kernels###\n"
                        "RUN serve --kv-layout paged --batch 2 --max-len 64\n")
    cmd = ("serve --arch granite-moe-3b-a800m-smoke --kv-layout paged "
           "--batch 2 --max-len 64 --requests 3 --prefill 16 --decode 4 "
           "--metrics-out metrics.json")
    spec = jobspec.parse_jobspec({"job": {"name": "serve-moe"}, "execution": [
        {"serial": {"command": cmd}}]})
    mw, jid, res = run_easey(app, "local:cpu", spec, storage=tmp_path)
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)[1]
    assert (res.step_name, res.program["arch"], res.built) == \
        ("decode_step", "reference", {})
    out = mw.scheduler.result(jid)[0]
    assert (out["arch"], out["requests"], out["kv_kernel"]) == \
        ("granite-moe-3b-a800m-smoke", 3, "gather")
    assert all(len(r.tokens) == 4 for r in out["stats"].results)
    assert (tmp_path / "cluster" / spec.job_id / "metrics.json").exists()


@pytest.mark.parametrize("arch,decode,prefill", [
    ("granite-moe-3b-a800m", {"paged_attention", "rmsnorm"}, {"rmsnorm"}),
    ("dbrx-132b", {"paged_attention"}, set())])
def test_build_lists_the_kernels_of_a_served_moe(arch, decode, prefill,
                                                 monkeypatch):
    """The CUDA plan's build compiles what the step launches (recorded
    here: no nvcc on the CPU): K1 for decode, K2 for an RMSNorm config."""
    asked = []
    monkeypatch.setattr(_build, "build", lambda names: asked.append(
        tuple(names)) or {})
    for shape, want in (("decode_32k", decode), ("prefill_32k", prefill)):
        app = parse_appfile(f"FROM arch:{arch}\nSHAPE {shape}\n"
                            f"###include_local_kernels###\nRUN serve\n")
        res = BuildService().build(app, "nvidia:h100", lower=True)
        assert set(res.program["kernels"]) == want
        assert set(res.built) == want
        assert res.plan.serve_kv_kernel == "cuda"
    assert [set(a) for a in asked] == [s for s in (decode, prefill) if s]


def test_mixed_dense_and_moe_fleet_is_refused():
    dense = ServeEngine(arch="deepseek-7b-smoke", num_slots=2, max_len=32,
                        device="cpu", log=quiet)
    moe = ServeEngine(arch="granite-moe-3b-a800m-smoke", num_slots=2,
                      max_len=32, device="cpu", log=quiet)
    with pytest.raises(ValueError, match="one architecture"):
        ReplicaRouter([dense, moe], log=quiet)


def test_model_for_serves_moe_and_still_refuses_other_families():
    assert isinstance(model_for(get_config("granite-moe-3b-a800m")), MoELM)
    assert type(model_for(get_config("deepseek-7b"))).__name__ == "DenseLM"
    from repro_torch.models.encdec import EncDecLM
    assert isinstance(model_for(get_config("whisper-tiny")), EncDecLM)
    bogus = get_config("deepseek-7b-smoke").replace(family="bogus")
    with pytest.raises(NotImplementedError, match="family 'bogus'"):
        model_for(bogus)
