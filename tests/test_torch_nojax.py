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
from repro_torch.serving import PagedKVCachePool, ServeEngine

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
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
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
