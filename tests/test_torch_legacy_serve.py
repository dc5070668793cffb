"""The port's legacy fixed-batch serve path (``launch/serve.py``
``_legacy_serve_main``, ``training/steps.build_decode_step``) against the
JAX reference's on the CPU, on the reference's weights: the port's
``init_params`` is replaced by the reference's draw under
``PRNGKey(seed)``, crossed bit for bit with ``params_from_jax``, and
both packages draw the request from their ``SyntheticSource``.

* ``serve_main(arch="llava-next-34b-smoke", device="cpu")`` returns
  exactly the reference ``_legacy_serve_main``'s keys, every one that is
  not a timing equal (``sample`` included), and the whole greedy stream
  of every row equals the reference's, driven the same way.
* ``run_command("serve --arch llava-next-34b-smoke ...")`` and
  ``run_easey`` of a VLM serving Appfile to ``local:cpu`` give the
  reference's result.
* A VLM's build lists the RMSNorm kernel alone (the legacy path launches
  no paged-decode kernel); the enc-dec family serves and builds no
  kernel; a family that does not exist raises.
* The refusals: router-only and telemetry flags, a target on another
  device, no card without ``device="cpu"``.
* On the card (``cuda``): the smoke legacy serve, K2 counted on every
  norm, its tokens equal with the plain norm in K2's place.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.core.appspec import parse_appfile as ref_parse_appfile
from repro.core.jobspec import parse_jobspec as ref_parse_jobspec
from repro.core.workflow import run_easey as ref_run_easey
from repro.data.pipeline import SyntheticSource as RefSource
from repro.launch.run import run_command as ref_run_command
from repro.launch.serve import serve_main as ref_serve_main
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training import steps as ref_steps
from repro_torch.configs import get_config
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobs import JobState
from repro_torch.core.jobspec import parse_jobspec
from repro_torch.core.workflow import run_easey
from repro_torch.launch import serve as port_serve
from repro_torch.launch.run import run_command
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.training import steps as port_steps

SMOKE = "llava-next-34b-smoke"
TIMINGS = ("prefill_s", "decode_s", "decode_tok_per_s")
CASES = [(2, 32, 8, 0), (3, 40, 12, 1), (4, 24, 16, 0), (1, 17, 5, 2)]


def quiet(*a, **k):
    pass


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS: dict = {}


def _ref_params(arch, seed):
    if (arch, seed) not in _WEIGHTS:
        rm = ref_model_for(ref_config(arch), remat="none")
        _WEIGHTS[arch, seed] = ref_init(rm.param_table(),
                                        jax.random.PRNGKey(seed))
    return _WEIGHTS[arch, seed]


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's legacy path draws the reference's weights for the seed
    its generator was seeded with."""
    def draw(table, generator, device):
        arch = next(a for a in (SMOKE, "deepseek-7b-smoke")
                    if model_for(get_config(a)).param_table() == table)
        return params_from_jax(jax.tree.map(
            np.asarray, _ref_params(arch, generator.initial_seed())), device)
    monkeypatch.setattr(port_serve, "init_params", draw)


@pytest.fixture
def port_streams(monkeypatch):
    """Every token the port's legacy path generates, row by row: its
    whole-batch step wrapped to record the greedy tokens it is fed and
    the one its last logits pick."""
    runs = []
    make_step = port_steps.build_decode_step

    def recording(model):
        step = make_step(model)
        fed = []
        runs.append(fed)

        def decode(params, cache, tokens):
            logits, cache = step(params, cache, tokens)
            fed.append((tokens, logits[:, -1].argmax(-1)))
            return logits, cache
        return decode
    monkeypatch.setattr(port_steps, "build_decode_step", recording)

    def streams(i=-1):
        fed = runs[i]
        cols = [t[:, 0] for t, _ in fed] + [fed[-1][1]]
        return torch.stack(cols, dim=1).cpu().numpy()
    return streams


def _ref_streams(arch, batch, prefill_len, decode_tokens, seed):
    """The reference's legacy recipe driven step by step: every row's
    greedy tokens."""
    rm = ref_model_for(ref_config(arch), remat="none")
    params = _ref_params(arch, seed)
    req = RefSource(rm.cfg.vocab_size, seed).batch(
        rm.batch_table(RefShape("p", prefill_len, batch, "prefill")), 0)
    logits, cache = jax.jit(ref_steps.build_prefill_step(rm))(params, req)
    for key in ("k", "v"):
        c = cache[key]
        cache[key] = jax.numpy.pad(c, [(0, 0)] * 2 + [(0, decode_tokens)] +
                                   [(0, 0)] * (c.ndim - 3))
    decode = jax.jit(ref_steps.build_decode_step(rm))
    tok = jax.numpy.argmax(logits[:, -1], -1).astype(jax.numpy.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(decode_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = jax.numpy.argmax(logits[:, -1], -1).astype(
            jax.numpy.int32)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _same_result(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k in TIMINGS:
            assert got[k] >= 0, k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("batch,prefill_len,decode_tokens,seed", CASES)
def test_serve_main_matches_reference(batch, prefill_len, decode_tokens,
                                      seed, reference_weights,
                                      port_streams):
    kw = dict(arch=SMOKE, batch=batch, prefill_len=prefill_len,
              decode_tokens=decode_tokens, seed=seed, log=quiet)
    want = ref_serve_main(**kw)
    got = port_serve.serve_main(**kw, device="cpu")
    _same_result(got, want)
    assert got["mode"] == "legacy-static" and len(got["sample"]) == \
        min(8, decode_tokens)
    streams = port_streams()
    assert streams.shape == (batch, decode_tokens)
    np.testing.assert_array_equal(streams, _ref_streams(
        SMOKE, batch, prefill_len, decode_tokens, seed))


def test_run_command_matches_reference(reference_weights, port_streams):
    cmd = f"serve --arch {SMOKE} --batch 3 --prefill 36 --decode 10"
    want = ref_run_command(cmd)
    got = run_command(cmd, device="cpu")
    _same_result(got, want)
    np.testing.assert_array_equal(port_streams(),
                                  _ref_streams(SMOKE, 3, 36, 10, 0))


def test_cli_reaches_the_legacy_path(reference_weights):
    got = port_serve.main(["--device", "cpu", "--arch", SMOKE, "--batch",
                           "2", "--prefill", "32", "--decode", "6"])
    want = ref_serve_main(arch=SMOKE, batch=2, prefill_len=32,
                          decode_tokens=6, log=quiet)
    _same_result(got, want)


APPFILE = (f"FROM arch:{SMOKE}\nSHAPE decode_32k\n"
           f"###include_local_kernels###\n"
           f"RUN serve --batch 2 --prefill 32 --decode 6\n")


def test_run_easey_serves_a_vlm_appfile(tmp_path, reference_weights):
    spec = {"job": {"name": "serve-vlm"}, "execution": [
        {"serial": {"command": "serve --batch 2 --prefill 32 --decode 6"}}]}
    mw, jid, res = run_easey(parse_appfile(APPFILE), "local:cpu",
                             parse_jobspec(spec), storage=tmp_path / "port")
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)
    got = mw.scheduler.result(jid)[0]
    rmw, rjid, _ = ref_run_easey(ref_parse_appfile(APPFILE), "local:cpu",
                                 ref_parse_jobspec(spec),
                                 storage=tmp_path / "ref")
    _same_result(got, rmw.scheduler.result(rjid)[0])
    assert (res.step_name, res.program["arch"], res.built) == \
        ("decode_step", "reference", {})


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_vlm_build_lists_the_rmsnorm_kernel_alone(shape):
    """The legacy path decodes over a contiguous whole-batch cache: a VLM
    step launches K2 and never the paged-decode kernel."""
    app = parse_appfile(f"FROM arch:llava-next-34b\nSHAPE {shape}\n"
                        f"###include_local_kernels###\n")
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert list(res.program["kernels"]) == ["rmsnorm"]
    assert res.program["arch"] == "sm_90a" and res.built == {}
    dense = BuildService().build(parse_appfile(
        f"FROM arch:deepseek-7b\nSHAPE {shape}\n"
        f"###include_local_kernels###\n"), "nvidia:h100", lower=False)
    assert list(dense.program["kernels"]) == (
        ["paged_attention", "rmsnorm"] if shape == "decode_32k"
        else ["rmsnorm"])


def test_unported_families_still_raise(monkeypatch):
    """Every family of the reference is ported: the enc-dec's smoke
    serves through the legacy path and its build lists no kernel (a
    LayerNorm model there); only a family that does not exist raises."""
    out = port_serve.serve_main(arch="whisper-tiny-smoke", batch=2,
                                prefill_len=16, decode_tokens=3, log=quiet,
                                device="cpu")
    assert out["mode"] == "legacy-static" and len(out["sample"]) == 3
    app = parse_appfile("FROM arch:whisper-tiny-smoke\nSHAPE decode_32k\n"
                        "###include_local_kernels###\n")
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert list(res.program["kernels"]) == [] and res.built == {}
    from repro_torch.configs import ARCHS
    bogus = get_config(SMOKE).replace(name="bogus-smoke", family="bogus")
    monkeypatch.setitem(ARCHS, "bogus-smoke", {"full": bogus,
                                               "skip_shapes": ()})
    with pytest.raises(NotImplementedError, match="family 'bogus'"):
        port_serve.serve_main(arch="bogus-smoke", log=quiet, device="cpu")
    app = parse_appfile("FROM arch:bogus-smoke\nSHAPE decode_32k\n"
                        "###include_local_kernels###\n")
    with pytest.raises(NotImplementedError, match="family 'bogus'"):
        BuildService().build(app, "nvidia:h100", lower=False)


def test_the_engine_refuses_a_vlm_as_the_reference_does():
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.serving import ServeEngine
    for engine, kw in ((RefEngine, {}), (ServeEngine, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="legacy static path"):
            engine(arch=SMOKE, num_slots=2, max_len=32, log=quiet, **kw)


def test_legacy_refusals(monkeypatch):
    kw = dict(arch=SMOKE, batch=2, prefill_len=32, decode_tokens=4,
              log=quiet)
    with pytest.raises(NotImplementedError, match="legacy static path"):
        port_serve.serve_main(metrics_out="m.json", device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="--replicas"):
        port_serve.serve_main(replicas=2, device="cpu", **kw)
    with pytest.raises(ValueError, match="runs on cuda"):
        port_serve.serve_main(target="nvidia:h100", device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.serve_main(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_command(f"serve --arch {SMOKE} --batch 2 --prefill 32")


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_legacy_serve_on_the_card(cuda, port_streams, monkeypatch):
    """K2 on every norm (layer 0's first alone, then two fused a layer, per
    forward: the prefill and decode - 1 steps), and the same tokens with
    the plain norm in the kernel's place."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
    kw = dict(arch=SMOKE, batch=4, prefill_len=48, decode_tokens=12,
              log=quiet)
    rmsnorm_cuda.launches = add_rmsnorm_cuda.launches = 0
    got = port_serve.serve_main(**kw)
    L = get_config(SMOKE).num_layers
    assert (rmsnorm_cuda.launches, add_rmsnorm_cuda.launches) == \
        (12, 2 * L * 12)
    kernel = port_streams()
    monkeypatch.setattr(ops, "rmsnorm_cuda",
                        lambda x, w, *, eps=1e-6, out_dtype=None:
                        ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype))
    monkeypatch.setattr(ops, "add_rmsnorm_cuda",
                        lambda x, a, w, *, eps=1e-6, norm_of_rounded:
                        ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                            norm_of_rounded=norm_of_rounded))
    plain = port_serve.serve_main(**kw)
    assert plain["sample"] == got["sample"]
    np.testing.assert_array_equal(port_streams(), kernel)
