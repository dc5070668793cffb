"""The port's xLSTM family (``repro_torch/models/ssm.py``) and its config
against the JAX reference on the CPU, on the reference's weights
(``init_params`` under ``PRNGKey(0)``, crossed bit for bit with
``params_from_jax``) and on seeded numpy inputs.

* ``xlstm-1.3b`` and its smoke equal the reference's configs field for
  field; the full width is 1,845,084,496 parameters and its cache for
  one request 354 MB.
* The cells in f32 at the reference's rtol = atol = 2e-4
  (``tests/test_ssm_equivalence.py``): ``mlstm_recurrent``,
  ``mlstm_chunkwise`` (whole chunks and a ragged tail through the
  recurrence; and against the port's own recurrence), ``slstm_scan``
  from both zero states, ``_groupnorm``; ``causal_conv`` in bf16 bit for
  bit, with and without a state.
* The blocks in bf16 from the reference's zero cache: the states within
  2e-4, the block's output within one bf16 step of the largest entry.
* The smoke model: prefill and 6 whole-batch decode steps within two
  bf16 steps of the largest logit, prefill(s) + one step against
  prefill(s + 1) (``tests/test_models_decode.py``'s tolerance), the loss
  within rtol 1e-3.  The one source of difference left is the order of
  the f32 sums inside the chunkwise mLSTM (a few hidden elements
  cancelled by the group norm's mean round the other way; without the
  reference's q scaling, the product by the reciprocal of the
  bf16-rounded sqrt(dk), left unrounded, the logits sat 4 bf16 steps
  off).
* The sLSTM stabilizer: the training forward starts it from ``m =
  -1e30``, the prefill from the cache's zeros; the two give different
  outputs, each equal to the reference's on its own path.
* ``serve_main`` and ``run_command`` return the reference's result
  (``sample`` included) and every row's greedy stream; an xLSTM build
  lists no kernel; the engine refuses the family, as the reference's.
* Training: ``train_main`` for 3 steps within rtol 1e-3 of the
  reference's losses; remat ``none``, ``dots`` and ``full`` bitwise
  equal within the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.data.pipeline import SyntheticSource as RefSource
from repro.launch.run import run_command as ref_run_command
from repro.launch.serve import serve_main as ref_serve_main
from repro.launch.train import train_main as ref_train_main
from repro.models import ssm as R
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training import steps as ref_steps
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.tuning import param_count_estimate
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.run import run_command
from repro_torch.models import ssm as P
from repro_torch.models.params import params_from_jax, tree_map
from repro_torch.models.transformer import model_for
from repro_torch.training import steps as port_steps

ARCH, SMOKE = "xlstm-1.3b", "xlstm-1.3b-smoke"
BF16_STEP = 2.0 ** -7
TOL = 2e-4


def quiet(*a, **k):
    pass


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A reference array as a torch tensor of the same bits."""
    return params_from_jax(np.asarray(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def close(got, want, what="", steps=1.0):
    """Within ``steps`` x two bf16 steps of the largest entry."""
    want = _np(want)
    tol = BF16_STEP * steps
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def f32_close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL,
                               err_msg=what)


_MODELS: dict = {}


def models():
    """(reference model, its params, port model, the same params)."""
    if not _MODELS:
        rm = ref_model_for(ref_config(SMOKE), remat="none")
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        _MODELS["m"] = (rm, rp, model_for(get_config(SMOKE), remat="none"),
                        params_from_jax(jax.tree.map(np.asarray, rp)))
    return _MODELS["m"]


_JIT: dict = {}


def jitted(name, fn):
    """One jitted reference function per name for the module."""
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


# ---------------------------------------------------------------------------
# Config, sizes


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_config_equals_the_reference_field_for_field(arch):
    port, want = get_config(arch), ref_config(arch)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(want, f.name)
        if f.name.endswith("_dtype"):
            assert str(a).split(".")[-1] == np.dtype(b).name, f.name
        else:
            assert a == b, (arch, f.name)
    assert ARCHS[arch]["skip_shapes"] == REF_ARCHS[arch]["skip_shapes"]
    assert isinstance(model_for(port), P.XLSTM)


def test_full_width_parameters_and_cache():
    cfg = get_config(ARCH)
    assert param_count_estimate(cfg) == 1_845_084_496
    table = model_for(cfg).cache_table(1, 1024)
    nbytes = sum(np.prod(d.shape) * d.dtype.itemsize
                 for d in jax.tree.leaves(table, is_leaf=lambda d: hasattr(
                     d, "shape")))
    assert round(nbytes / 1e6) == 354
    rt = ref_model_for(ref_config(ARCH)).cache_table(1, 1024)
    assert jax.tree.map(lambda d: d.shape, table,
                        is_leaf=lambda d: hasattr(d, "shape")) == \
        jax.tree.map(lambda d: d.shape, rt,
                     is_leaf=lambda d: hasattr(d, "shape"))


# ---------------------------------------------------------------------------
# Cells, f32


def _mlstm_inputs(rng, b, h, s, dk, dv, dtype=np.float32):
    q, k = rng.randn(b, h, s, dk), rng.randn(b, h, s, dk)
    v = rng.randn(b, h, s, dv)
    li = rng.randn(b, h, s) * 2
    lf = -np.abs(rng.randn(b, h, s))
    return [np.asarray(a, dtype) for a in (q, k, v)] + \
        [np.asarray(a, np.float32) for a in (li, lf)]


def _state(rng, b, h, dk, dv, zero=False):
    if zero:
        return tuple(np.asarray(a) for a in R.mlstm_zero_state(b, h, dk, dv))
    return (rng.randn(b, h, dv, dk).astype(np.float32) * 0.1,
            rng.randn(b, h, dk).astype(np.float32) * 0.1,
            rng.randn(b, h).astype(np.float32))


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 2), h=st.integers(1, 3),
       s=st.sampled_from([5, 8, 12, 16, 19]), chunk=st.sampled_from([4, 8]),
       dk=st.sampled_from([4, 8]), dv=st.sampled_from([4, 8]),
       zero=st.booleans(), seed=st.integers(0, 2**31 - 2))
def test_mlstm_cells_match_reference(b, h, s, chunk, dk, dv, zero, seed):
    """Chunkwise (ragged tails included) and recurrent forms against the
    reference's, and the port's chunkwise against its own recurrence."""
    rng = np.random.RandomState(seed)
    args = _mlstm_inputs(rng, b, h, s, dk, dv)
    state = _state(rng, b, h, dk, dv, zero)
    t_args = [torch.from_numpy(a) for a in args]
    t_state = tuple(torch.from_numpy(np.array(a)) for a in state)
    want_c = R.mlstm_chunkwise(*map(jnp.asarray, args),
                               tuple(map(jnp.asarray, state)), chunk)
    want_r = R.mlstm_recurrent(*map(jnp.asarray, args),
                               tuple(map(jnp.asarray, state)))
    got_c = P.mlstm_chunkwise(*t_args, t_state, chunk)
    got_r = P.mlstm_recurrent(*t_args, t_state)
    for got, want in ((got_c, want_c), (got_r, want_r), (got_c, got_r)):
        f32_close(got[0], want[0], "hidden")
        for a, b_ in zip(got[1], want[1]):
            f32_close(a, b_, "state")


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 2), h=st.integers(1, 3), s=st.integers(1, 9),
       dh=st.sampled_from([4, 8]), zero=st.booleans(),
       seed=st.integers(0, 2**31 - 2))
def test_slstm_scan_matches_reference(b, h, s, dh, zero, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(b, s, 4, h, dh).astype(np.float32) * 2
    r = rng.randn(4, h, dh, dh).astype(np.float32) * 0.3
    if zero:    # the training forward's state, m = -1e30
        state = tuple(np.asarray(a) for a in R.slstm_zero_state(b, h, dh))
    else:       # the cache's zeros, as prefill starts
        state = tuple(np.zeros(x.shape, np.float32) for x in
                      R.slstm_zero_state(b, h, dh))
    want = R.slstm_scan(jnp.asarray(gx), jnp.asarray(r),
                        tuple(map(jnp.asarray, state)))
    got = P.slstm_scan(torch.from_numpy(gx), torch.from_numpy(r),
                       tuple(torch.from_numpy(np.array(a)) for a in state))
    f32_close(got[0], want[0], "hs")
    for a, b_ in zip(got[1], want[1]):
        f32_close(a, b_, "state")


def test_zero_states_keep_minus_1e30():
    for got, want in ((P.mlstm_zero_state(2, 3, 4, 5),
                       R.mlstm_zero_state(2, 3, 4, 5)),
                      (P.slstm_zero_state(2, 3, 4),
                       R.slstm_zero_state(2, 3, 4))):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert np.array_equal(_np(a), np.asarray(b))
    assert float(P.slstm_zero_state(1, 1, 1)[3]) == float(np.float32(-1e30))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bit_for_bit(with_state):
    """The four bf16 products summed one rounding a term, as the
    reference's Python ``sum`` compiles on XLA's CPU."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 7, 24) * 3, jnp.bfloat16)
    w = jnp.asarray(rng.randn(4, 24), jnp.bfloat16)
    state = jnp.asarray(rng.randn(2, 3, 24), jnp.bfloat16) if with_state \
        else None
    want = jitted(f"conv{with_state}", R.causal_conv)(x, w, state)
    got = P.causal_conv(_t(x), _t(w), None if state is None else _t(state))
    for a, b in zip(got, want):
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16))


def test_groupnorm_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 64).astype(np.float32) * 40 + 7
    scale = jnp.asarray(1 + 0.1 * rng.randn(3, 64), jnp.bfloat16)
    want = jitted("gn", R._groupnorm)(jnp.asarray(x), scale)
    f32_close(P._groupnorm(torch.from_numpy(x), _t(scale)), want)


def test_softplus_is_logaddexp():
    x = np.array([-100, -20.5, -1, 0, 1e-3, 3, 20.5, 30, 100], np.float32)
    np.testing.assert_allclose(
        P.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
        atol=1e-37)     # XLA flushes exp(-100)'s denormal to zero


# ---------------------------------------------------------------------------
# Blocks, bf16


def _block_inputs(b, s):
    rm, rp, _, _ = models()
    x = jnp.asarray(np.random.RandomState(5).randn(b, s, rm.cfg.d_model)
                    * 3, jnp.bfloat16)
    zeros = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                         rm.cache_table(b, 0),
                         is_leaf=lambda d: hasattr(d, "init"))
    return x, zeros


@pytest.mark.parametrize("mode,s", [("prefill", 21), ("decode", 1)])
def test_blocks_match_reference(mode, s):
    rm, rp, pm, pp = models()
    cfg = rm.cfg
    x, zeros = _block_inputs(2, s)
    mp = jax.tree.map(lambda t: t[1, 0], rp["mlstm"])
    sp = jax.tree.map(lambda t: t[1], rp["slstm"])
    rng = np.random.RandomState(6)
    mc = {k: jnp.asarray(rng.randn(*v.shape[2:]) * 0.3, v.dtype)
          for k, v in zeros["mlstm"].items()}
    mc["m"] = jnp.zeros_like(mc["m"])
    sc = {k: jnp.asarray(rng.randn(*v.shape[1:]) * 0.3, v.dtype)
          for k, v in zeros["slstm"].items()}
    want_m = jitted(f"m{mode}", lambda p, x, c: R.mlstm_block_apply(
        p, x, cfg, None, mode, c, cfg.ssm_chunk))(mp, x, mc)
    want_s = jitted(f"s{mode}", lambda p, x, c: R.slstm_block_apply(
        p, x, cfg, None, mode, c))(sp, x, sc)
    with torch.no_grad():
        got_m = P.mlstm_block_apply(tree_map(_t, mp), _t(x), pm.cfg, mode,
                                    tree_map(_t, mc), pm.cfg.ssm_chunk)
        got_s = P.slstm_block_apply(tree_map(_t, sp), _t(x), pm.cfg, mode,
                                    tree_map(_t, sc))
    for (gy, gc), (wy, wc) in ((got_m, want_m), (got_s, want_s)):
        assert gy.dtype == torch.bfloat16
        close(gy, wy, "block output", steps=0.5)
        for k in wc:
            if wc[k].dtype == jnp.bfloat16:
                assert np.array_equal(gc[k].view(torch.int16).numpy(),
                                      np.asarray(wc[k]).view(np.int16)), k
            else:
                f32_close(gc[k], wc[k], k)


def test_slstm_stabilizer_differs_between_loss_and_prefill():
    """The reference's training forward runs the sLSTM from
    ``slstm_zero_state`` (m = -1e30), its prefill from the cache table's
    zeros (m = 0): the first steps differ (``hid = o c / max(n, 1)``).
    The port keeps each path's state: each output equals the reference's
    on the same path, and the two paths differ by as much in the port as
    in the reference."""
    rm, rp, pm, pp = models()
    cfg = rm.cfg
    x, zeros = _block_inputs(2, 9)
    sp = jax.tree.map(lambda t: t[0], rp["slstm"])
    sc = jax.tree.map(lambda t: t[0], zeros["slstm"])
    fn = jitted("s_paths", lambda p, x, c: (
        R.slstm_block_apply(p, x, cfg, None, "full", None)[0],
        R.slstm_block_apply(p, x, cfg, None, "prefill", c)[0]))
    want_full, want_pre = fn(sp, x, sc)
    with torch.no_grad():
        got_full = P.slstm_block_apply(tree_map(_t, sp), _t(x), pm.cfg,
                                       "full", None)[0]
        got_pre = P.slstm_block_apply(tree_map(_t, sp), _t(x), pm.cfg,
                                      "prefill", tree_map(_t, sc))[0]
    close(got_full, want_full, "loss path", steps=0.5)
    close(got_pre, want_pre, "prefill path", steps=0.5)
    ref_gap = np.abs(_np(want_full) - _np(want_pre)).max()
    port_gap = np.abs(_np(got_full) - _np(got_pre)).max()
    assert ref_gap > 0.05 * np.abs(_np(want_full)).max()
    assert port_gap == pytest.approx(ref_gap, rel=0.05)
    # and the model's own paths take them: loss starts no cache, prefill
    # the table's zeros (m = 0)
    b = 2
    cache = P.zeros_from(pm.cache_table(b, 0), "cpu")
    assert float(cache["slstm"]["m"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The smoke model


@pytest.mark.parametrize("s,b", [(24, 2), (37, 3)])
def test_prefill_and_decode_match_reference(s, b):
    rm, rp, pm, pp = models()
    tok = RefSource(rm.cfg.vocab_size, s).batch(rm.batch_table(
        RefShape("p", s, b, "prefill")), 0)["tokens"]
    rl, rc = jitted(f"prefill{s}", lambda p, t: rm.prefill(
        p, {"tokens": t}, None))(rp, jnp.asarray(tok))
    with torch.no_grad():
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(tok)})
    close(pl, rl, "prefill logits")
    assert (pc["index"].dim(), int(pc["index"])) == (0, s)
    decode = port_steps.build_decode_step(pm)
    ref_decode = jitted("decode", ref_steps.build_decode_step(rm))
    toks = np.random.default_rng(s).integers(
        1, rm.cfg.vocab_size - 1, (6, b, 1)).astype(np.int32)
    for i in range(6):
        rl, rc = ref_decode(rp, rc, jnp.asarray(toks[i]))
        pl, pc = decode(pp, pc, torch.from_numpy(toks[i]))
        close(pl, rl, f"decode step {i}")
        assert int(pc["index"]) == int(rc["index"]) == s + i + 1
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(_np(pc["mlstm"][k]), _np(rc["mlstm"][k]),
                                   rtol=2e-2, atol=2e-2 * float(
                                       np.abs(_np(rc["mlstm"][k])).max()))


def test_prefill_plus_decode_matches_longer_prefill():
    """``tests/test_models_decode.py``'s property in the port: prefill of
    s then one decode step against prefill of s + 1 (5% of max |logit| +
    0.05, and the top token on half the rows)."""
    rm, _, pm, pp = models()
    s = 32
    tok = torch.from_numpy(RefSource(pm.cfg.vocab_size, 0).batch(
        rm.batch_table(RefShape("p", s + 1, 2, "prefill")), 0)["tokens"])
    with torch.no_grad():
        want, _ = pm.prefill(pp, {"tokens": tok})
        _, cache = pm.prefill(pp, {"tokens": tok[:, :-1]})
        got, _ = port_steps.build_decode_step(pm)(pp, cache, tok[:, -1:])
    a, b = _np(want[:, -1]), _np(got[:, -1])
    assert np.abs(a - b).max() < 0.05 * (np.abs(a).max() + 1)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5


def _train_batch(seed=0):
    rm = models()[0]
    from repro.data.pipeline import DataPipeline as RefPipeline
    rb = RefPipeline(rm, RefShape("t", 40, 4, "train"), seed=seed) \
        .batch_at(0)
    return rb, {k: _t(v) for k, v in rb.items()}


def test_loss_matches_reference():
    rm, rp, pm, pp = models()
    rb, pb = _train_batch()
    want, _ = jitted("loss", lambda p, b: rm.loss(p, b, None))(rp, rb)
    with torch.no_grad():
        got, _ = pm.loss(pm.train_leaves(pp), pb)
    assert float(got) == pytest.approx(float(want), rel=1e-3)


# ---------------------------------------------------------------------------
# Serving and the build


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's legacy path draws the reference's weights for the seed
    its generator was seeded with."""
    cache = {}

    def draw(table, generator, device):
        seed = generator.initial_seed()
        if seed not in cache:
            rm = ref_model_for(ref_config(SMOKE), remat="none")
            cache[seed] = ref_init(rm.param_table(), jax.random.PRNGKey(seed))
        return params_from_jax(jax.tree.map(np.asarray, cache[seed]), device)
    monkeypatch.setattr(port_serve, "init_params", draw)


@pytest.fixture
def port_streams(monkeypatch):
    """Every row's greedy tokens of the port's legacy path."""
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


def _ref_streams(batch, prefill_len, decode_tokens, seed):
    rm = ref_model_for(ref_config(SMOKE), remat="none")
    params = ref_init(rm.param_table(), jax.random.PRNGKey(seed))
    req = RefSource(rm.cfg.vocab_size, seed).batch(
        rm.batch_table(RefShape("p", prefill_len, batch, "prefill")), 0)
    logits, cache = jax.jit(ref_steps.build_prefill_step(rm))(params, req)
    decode = jitted("decode", ref_steps.build_decode_step(rm))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(decode_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _same_result(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ("prefill_s", "decode_s", "decode_tok_per_s"):
            assert got[k] >= 0, k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("batch,prefill_len,decode_tokens,seed",
                         [(2, 32, 8, 0), (3, 21, 6, 1)])
def test_serve_main_matches_reference(batch, prefill_len, decode_tokens,
                                      seed, reference_weights, port_streams):
    kw = dict(arch=SMOKE, batch=batch, prefill_len=prefill_len,
              decode_tokens=decode_tokens, seed=seed, log=quiet)
    want = ref_serve_main(**kw)
    got = port_serve.serve_main(**kw, device="cpu")
    _same_result(got, want)
    assert got["mode"] == "legacy-static"
    np.testing.assert_array_equal(port_streams(), _ref_streams(
        batch, prefill_len, decode_tokens, seed))


def test_run_command_matches_reference(reference_weights, port_streams):
    cmd = f"serve --arch {SMOKE} --batch 2 --prefill 24 --decode 6"
    _same_result(run_command(cmd, device="cpu"), ref_run_command(cmd))
    np.testing.assert_array_equal(port_streams(), _ref_streams(2, 24, 6, 0))


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_xlstm_build_lists_no_kernel(shape):
    """A LayerNorm family on the legacy path: nothing to build."""
    app = parse_appfile(f"FROM arch:{ARCH}\nSHAPE {shape}\n"
                        f"###include_local_kernels###\n")
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert res.program["kernels"] == {} and res.built == {}


def test_the_engine_refuses_xlstm_as_the_reference_does():
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.serving import ServeEngine
    for engine, kw in ((RefEngine, {}), (ServeEngine, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="legacy static path"):
            engine(arch=SMOKE, num_slots=2, max_len=32, log=quiet, **kw)


# ---------------------------------------------------------------------------
# Training


def test_train_main_matches_reference(monkeypatch):
    """``train_main`` for 3 steps on the reference's weights and batches:
    every loss within rtol 1e-3 (the reference's plan: ``adamw``,
    ``dots``)."""
    def draw(table, generator, device):
        return params_from_jax(jax.tree.map(np.asarray, models()[1]),
                               device)
    monkeypatch.setattr(port_train, "init_params", draw)
    kw = dict(arch=SMOKE, steps=3, seq_len=40, global_batch=4, log=quiet)
    want = ref_train_main(**kw)
    got = port_train.train_main(**kw, device="cpu")
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["plan"].remat_policy == "dots"
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-3)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)


def test_remat_policies_bitwise_equal():
    """Loss and every per-layer gradient equal bit for bit under remat
    ``none``, ``dots`` and ``full``; each stacked weight's gradient comes
    as one list entry per layer, (group, layer) order for the mLSTM's."""
    _, _, _, pp = models()
    _, pb = _train_batch(seed=2)
    out = {}
    for remat in ("none", "dots", "full"):
        m = model_for(get_config(SMOKE), remat=remat)
        loss, _, grads = port_steps.loss_and_grads(m, pp, pb)
        out[remat] = (loss, grads)
    groups, m_per = models()[2]._layout()
    assert len(out["none"][1]["mlstm"]["w_up"]) == groups * m_per
    assert len(out["none"][1]["slstm"]["wx"]) == groups
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        flat = jax.tree.leaves(out[remat][1])
        for a, b in zip(flat, jax.tree.leaves(out["none"][1])):
            assert torch.equal(a, b)
