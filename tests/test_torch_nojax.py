"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run without a GPU unless asked for the CPU, and
``chip_smoke.py`` fails (printing no result) where it cannot run."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.target import default_target
from repro_torch.kernels import bench
from repro_torch.launch.train import train_main
from repro_torch.serving import PagedKVCachePool, ReplicaRouter, ServeEngine
from repro_torch.serving.pool import KVCachePool

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
OK_LINE = '"ok": true'


def _run(args, cwd, env_src=True):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd)}
    if env_src:
        env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_reference(tmp_path):
    code = ("import sys\n"
            "import repro_torch.serving.engine, repro_torch.kernels.ops\n"
            "import repro_torch.core.workflow, repro_torch.launch.run\n"
            "import repro_torch.models.lulesh, repro_torch.configs\n"
            "import repro_torch.kernels.sedov_stencil\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.bench, repro_torch.serving.sampling\n"
            "import repro_torch.serving.spec, repro_torch.serving.trace\n"
            "import repro_torch.configs.picolm\n"
            "import repro_torch.serving.router\n"
            "import repro_torch.serving.prefix_cache\n"
            "import repro_torch.runtime.elastic\n"
            "import repro_torch.serving.telemetry, repro_torch.launch.serve\n"
            "import repro_torch.configs.stablelm_1_6b\n"
            "import repro_torch.configs.mistral_large_123b\n"
            "import repro_torch.configs.nemotron_4_340b\n"
            "import repro_torch.models.moe\n"
            "import repro_torch.configs.granite_moe_3b_a800m\n"
            "import repro_torch.configs.dbrx_132b\n"
            "import repro_torch.optim, repro_torch.data.pipeline\n"
            "import repro_torch.checkpoint\n"
            "import repro_torch.runtime.fault_tolerance\n"
            "import repro_torch.launch.train, repro_torch.training.steps\n"
            "import repro_torch.models.vlm, repro_torch.configs.llava_next_34b\n"
            "import repro_torch.models.ssm, repro_torch.models.mamba\n"
            "import repro_torch.configs.xlstm_1_3b\n"
            "import repro_torch.configs.zamba2_7b\n"
            "import repro_torch.models.encdec\n"
            "import repro_torch.configs.whisper_tiny\n"
            "import repro_torch.analysis.flops\n"
            "import repro_torch.analysis.roofline\n"
            "import repro_torch.analysis.cost\n"
            "import repro_torch.sharding, repro_torch.launch.mesh\n"
            "import repro_torch.launch.dryrun\n"
            "import repro_torch.analysis.lint, repro_torch.analysis.lint.core\n"
            "import repro_torch.analysis.lint.__main__\n"
            "from repro_torch.analysis.lint.rules import (graph_purity,\n"
            "    keyed_rng, refcount, smem_budget, telemetry_guard,\n"
            "    wall_clock)\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.serve_batch\n"
            "import repro_torch.examples.train_100m\n"
            "import repro_torch.examples.lulesh_easey\n"
            "from repro_torch.sharding import (distribute, placements,\n"
            "    shard_constraint)\n"
            "from repro_torch.runtime.elastic import reshard_state\n"
            "from repro_torch.launch.mesh import (Mesh, degraded_mesh,\n"
            "    mesh_for_target)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'ml_dtypes' or "
            "m.startswith('ml_dtypes.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path} imports {name}"


def test_engine_without_cuda_raises_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine()
    eng = ServeEngine(device="cpu", log=lambda *a, **k: None)
    assert eng.params["ln_f"]["scale"].device.type == "cpu"
    assert (eng.plan.target, eng.kv_kernel) == ("local:cpu", "gather")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCachePool(eng.model, 2, 32)
    pool = PagedKVCachePool(eng.model, 2, 32, device="cpu")
    assert pool.cache["k"].device.type == "cpu"


def test_train_main_refuses_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(steps=1, log=lambda *a, **k: None)
    with pytest.raises(ValueError, match="runs on"):
        train_main(steps=1, target="nvidia:h100", device="cpu",
                   log=lambda *a, **k: None)
    out = train_main(steps=1, seq_len=8, global_batch=2, device="cpu",
                     log=lambda *a, **k: None)
    assert out["device"] == "cpu" and out["plan"].target == "local:cpu"
    assert out["state"]["params"]["ln_f"]["scale"].device.type == "cpu"


def test_router_and_prefix_cache_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRouter.build(replicas=2, num_slots=2, max_len=32,
                            prefix_cache=True, log=lambda *a, **k: None)
    fleet = ReplicaRouter.build(replicas=2, num_slots=2, max_len=32,
                                prefix_cache=True, log=lambda *a, **k: None,
                                device="cpu")
    pool = fleet.engines[0].make_pool()
    assert pool.cache["k"].device.type == "cpu"
    assert pool.prefix_cache is not None and pool.cache["layout"] == "paged"


def test_contiguous_pool_and_kernel_bench_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = ServeEngine(device="cpu", kv_layout="contiguous",
                      log=lambda *a, **k: None)
    assert (eng.kv_layout, eng.kv_kernel) == ("contiguous", "gather")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCachePool(eng.model, 2, 32)
    assert KVCachePool(eng.model, 2, 32, device="cpu").cache["k"].shape[1:3] \
        == (2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(lambda *row: None)


def test_device_picks_the_target_and_cuda_never_defaults_to_gather():
    assert default_target(torch.device("cuda")) == "nvidia:h100"
    assert default_target(torch.device("cpu")) == "local:cpu"
    # raises while planning, before anything is put on the card
    with pytest.raises(ValueError, match="kv_kernel='gather'"):
        ServeEngine(device="cuda", target="local:cpu")


@pytest.mark.cuda
def test_default_engine_on_cuda_runs_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    eng = ServeEngine(log=lambda *a, **k: None)
    assert eng.device.type == "cuda"
    assert (eng.plan.target, eng.kv_kernel) == ("nvidia:h100", "cuda")
    assert eng.make_pool().cache["k"].is_cuda


def test_chip_smoke_fails_without_cuda_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = _run([str(REPO / "chip_smoke.py")], tmp_path)
    assert out.returncode != 0 and OK_LINE not in out.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone / "chip_smoke.py")
    out = _run(["chip_smoke.py"], lone, env_src=False)
    assert out.returncode != 0 and OK_LINE not in out.stdout
