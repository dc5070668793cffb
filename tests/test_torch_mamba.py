"""The port's Zamba2 hybrid (``repro_torch/models/mamba.py``), its
config and sliding-window attention (``models/layers.py``) against the
JAX reference on the CPU, on the reference's weights (``init_params``
under ``PRNGKey(0)``, crossed bit for bit with ``params_from_jax``) and
on seeded numpy inputs.

* ``zamba2-7b`` and its smoke equal the reference's configs field for
  field; the full width is 6,750,539,856 parameters and its cache for one
  request of 1,024 tokens 343 MB.
* The SSD core in f32 at the reference's rtol = atol = 2e-4
  (``tests/test_ssm_equivalence.py``): ``ssd_chunkwise`` (whole chunks
  and a ragged tail) and ``ssd_recurrent_ref`` against the reference's,
  the chunkwise form against the port's recurrence, and ``ssd_decode``
  continuing ``ssd_chunkwise``'s state; ``_segsum`` bit for bit.
* A Mamba2 block in bf16 (prefill from zeros, and a decode step from a
  state): the output bit for bit, the states within 2e-4.
* Sliding-window attention: ``_windowed_attention`` at s > window (one
  q-chunk, and three chunks of 1,024) and ``attention(..., window=)`` in
  prefill, within one bf16 step of the reference's; the ring-buffer
  decode of a cache no longer than the window, wrapping over the
  prompt's first positions as the reference does.
* The smoke model on XLA's CPU arithmetic: XLA runs a bf16 einsum as an
  f32 product of the exact bf16 values rounded once, where torch's bf16
  CPU product rounds otherwise in a few elements, and its rsqrt is not
  correctly rounded (``ROADMAP.md`` §3); the random-weight Mamba layers
  carry one such bf16 step to 1-10% of the logits.  The fixture
  ``xla_cpu`` gives the port XLA's products and rsqrt (as the VLM and
  MoE tests give it XLA's rsqrt; the card's products are the tensor
  cores' anyway), and then prefill and each decode step over the grown
  cache (``window=0``, and a window of 16 with prompts beyond it and
  within it), each from the reference's cache, are within one bf16 step
  of the largest logit (in practice equal), the new caches' K/V and
  conv states within one bf16 step and the SSD states within 2e-4
  (stepping from
  its own cache, the port's f32 SSD states, whose sums run in another
  order, part from the reference's by f32 ulps, which a random-weight
  decode step can carry to a flipped bf16 rounding: 1.9% of max |logit|
  at one step of one case); the loss within rtol 1e-3; per-leaf gradients (the shared
  block's summed over its applications) within the dense family's
  tolerances (``tests/test_torch_train.py``: relative L2 1e-1, the
  unembedding and ``ln_f`` 2e-2).
* The weights' seed: under the reference's init law (the fan-in taken
  from the stacked axis, 2 segments at smoke size, so the Mamba
  projections draw at std 0.7) the smoke model is chaotic.  Every block
  is bit for bit the reference's on the reference's own inputs, but the
  f32 sums of the SSD scans run in another order, and at seed 1's
  weights that f32 noise reaches 1.4-7.8% of max |logit| after a prefill
  of 16-37 tokens (seed 0's: 0-0.9%), enough to flip a greedy pick on a
  near tie.  The model and stream tests therefore run at seed 0, the
  entry points' default.
* The legacy path grows every nested K/V by the tokens it decodes
  (``grow_kv``): ``serve_main`` and ``run_command`` return the
  reference's keys, and every row's stream equals the reference model's
  driven with the same grown cache (the reference's own legacy path
  leaves the hybrid's nested K/V ungrown: its decode writes clamp onto
  the last prompt position); a decode write past an ungrown cache
  raises.  The build lists the RMSNorm kernel alone; the engine refuses
  the family and windows, as the reference's.
* Training: ``train_main`` for 3 steps within rtol 1e-3 of the
  reference's losses; remat ``none``, ``dots`` and ``full`` bitwise
  equal within the port.
* On the card (``cuda``): the smoke legacy serve with K2 on every norm
  (counted), its tokens equal with the plain norm in K2's place.
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
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import SyntheticSource as RefSource
from repro.launch.run import run_command as ref_run_command
from repro.launch.serve import serve_main as ref_serve_main
from repro.launch.train import train_main as ref_train_main
from repro.models import layers as RL
from repro.models import mamba as R
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training import steps as ref_steps
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.tuning import param_count_estimate
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.run import run_command
from repro_torch.models import layers as PL
from repro_torch.models import mamba as P
from repro_torch.models.params import params_from_jax, tree_map
from repro_torch.models.transformer import model_for
from repro_torch.training import steps as port_steps

ARCH, SMOKE = "zamba2-7b", "zamba2-7b-smoke"
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


@pytest.fixture
def xla_cpu(monkeypatch):
    """bf16 einsums, rsqrt and the RMSNorm's statistic as XLA's CPU
    computes them: a bf16 einsum is the f32 product of the exact bf16
    values, rounded once to bf16; rsqrt is XLA's own (not correctly
    rounded); the norm's ``rsqrt(mean(x^2) + eps)`` is XLA's, whose sum
    runs in another order than torch's."""
    plain = torch.einsum

    def einsum(eq, *ops):
        if any(o.dtype == torch.bfloat16 for o in ops):
            return plain(eq, *(o.float() for o in ops)).to(torch.bfloat16)
        return plain(eq, *ops)

    xla_rsqrt = jax.jit(jax.lax.rsqrt)

    def rsqrt(t):
        out = xla_rsqrt(t.detach().float().numpy())
        return torch.from_numpy(np.array(out)).to(t.dtype)

    stat = jax.jit(lambda x, eps: jax.lax.rsqrt(
        jnp.mean(x * x, axis=-1, keepdims=True) + eps))

    def rmsnorm_ref(x, w, *, eps=1e-6, out_dtype=None):
        xf = x.detach().float()
        r = torch.from_numpy(np.array(stat(xf.numpy(), eps)))
        return (xf * r * w.detach().float()).to(out_dtype or x.dtype)
    monkeypatch.setattr(torch, "einsum", einsum)
    monkeypatch.setattr(torch, "rsqrt", rsqrt)
    monkeypatch.setattr(kref, "rmsnorm_ref", rmsnorm_ref)


def _t(a) -> torch.Tensor:
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


def bits_equal(got, want, what=""):
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16)), what


_MODELS: dict = {}


def models(window=0):
    """(reference model, its params, port model, the same params) of the
    smoke config with ``window``."""
    if window not in _MODELS:
        rm = ref_model_for(ref_config(SMOKE).replace(window=window),
                           remat="none")
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        pm = model_for(get_config(SMOKE).replace(window=window),
                       remat="none")
        _MODELS[window] = (rm, rp, pm,
                           params_from_jax(jax.tree.map(np.asarray, rp)))
    return _MODELS[window]


_JIT: dict = {}


def jitted(name, fn):
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
    assert isinstance(model_for(port), P.ZambaHybrid)


def test_full_width_parameters_and_cache():
    cfg = get_config(ARCH)
    assert param_count_estimate(cfg) == 6_750_539_856
    model = model_for(cfg)
    assert model._layout() == (6, 13, 3)
    leaf = lambda d: hasattr(d, "shape")   # noqa: E731
    table = model.cache_table(1, 1024)
    nbytes = sum(np.prod(d.shape) * d.dtype.itemsize
                 for d in jax.tree.leaves(table, is_leaf=leaf))
    assert round(nbytes / 1e6) == 343
    rt = ref_model_for(ref_config(ARCH)).cache_table(1, 1024)
    assert jax.tree.map(lambda d: d.shape, table, is_leaf=leaf) == \
        jax.tree.map(lambda d: d.shape, rt, is_leaf=leaf)
    # f32 leaves stay f32 (A_log, D, dt_bias)
    pt = model.param_table()["mamba"]
    assert {k: pt[k].dtype for k in ("A_log", "D", "dt_bias")} == \
        dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)


# ---------------------------------------------------------------------------
# The SSD core, f32


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = (np.abs(rng.randn(b, s, h)) * 0.5 + 0.01).astype(np.float32)
    A = (-np.abs(rng.randn(h)) - 0.1).astype(np.float32)
    B = (rng.randn(b, s, n) * 0.5).astype(np.float32)
    C = (rng.randn(b, s, n) * 0.5).astype(np.float32)
    D = rng.randn(h).astype(np.float32)
    return x, dt, A, B, C, D


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 2), h=st.integers(1, 3),
       s=st.sampled_from([5, 8, 12, 16, 19]), chunk=st.sampled_from([4, 8]),
       p=st.sampled_from([4, 8]), n=st.sampled_from([4, 8]),
       with_state=st.booleans(), seed=st.integers(0, 2**31 - 2))
def test_ssd_matches_reference(b, h, s, chunk, p, n, with_state, seed):
    rng = np.random.RandomState(seed)
    args = _ssd_inputs(rng, b, s + 1, h, p, n)
    state = (rng.randn(b, h, p, n) * 0.3).astype(np.float32) if with_state \
        else None
    head = [a[:, :s] if a.ndim > 1 else a for a in args]
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want_c = R.ssd_chunkwise(*map(j, head), j(state), chunk)
    want_r = R.ssd_recurrent_ref(*map(j, head), j(state))
    got_c = P.ssd_chunkwise(*map(t, head), t(state), chunk)
    got_r = P.ssd_recurrent_ref(*map(t, head), t(state))
    for got, want in ((got_c, want_c), (got_r, want_r), (got_c, got_r)):
        f32_close(got[0], want[0], "y")
        f32_close(got[1], want[1], "state")
    # one more token: ssd_decode continues the chunkwise state
    last = [a[:, s:s + 1] if a.ndim > 1 else a for a in args]
    want_d = R.ssd_decode(*map(j, last), want_c[1])
    got_d = P.ssd_decode(*map(t, last), got_c[1])
    f32_close(got_d[0], want_d[0], "decode y")
    f32_close(got_d[1], want_d[1], "decode state")
    whole = R.ssd_recurrent_ref(*map(j, args), j(state))
    f32_close(got_d[0][:, 0], whole[0][:, s], "decode vs recurrence")


def test_segsum_bit_for_bit():
    x = np.random.RandomState(1).randn(2, 3, 9).astype(np.float32)
    want = np.asarray(jitted("segsum", R._segsum)(jnp.asarray(x)))
    got = P._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The Mamba2 block, bf16


@pytest.mark.parametrize("mode,s", [("prefill", 21), ("decode", 1)])
def test_mamba_block_matches_reference(mode, s):
    rm, rp, pm, pp = models()
    cfg = rm.cfg
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, s, cfg.d_model) * 3, jnp.bfloat16)
    mp = jax.tree.map(lambda t: t[1, 0], rp["mamba"])
    zeros = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                         rm.cache_table(2, 0)["mamba"],
                         is_leaf=lambda d: hasattr(d, "init"))
    cache = None if mode == "prefill" else {
        k: jnp.asarray(rng.randn(*v.shape[2:]) * 0.3, v.dtype)
        for k, v in zeros.items()}
    want_y, want_c = jitted(f"mamba{mode}", lambda p, x, c: R.mamba_block_apply(
        p, x, cfg, None, mode, c, cfg.ssm_chunk))(mp, x, cache)
    with torch.no_grad():
        got_y, got_c = P.mamba_block_apply(
            tree_map(_t, mp), _t(x), pm.cfg, mode,
            None if cache is None else tree_map(_t, cache), pm.cfg.ssm_chunk)
    bits_equal(got_y, want_y, "block output")
    bits_equal(got_c["conv"], want_c["conv"], "conv state")
    f32_close(got_c["ssm"], want_c["ssm"], "ssm state")


# ---------------------------------------------------------------------------
# Sliding-window attention


@pytest.mark.parametrize("s,window,H,K", [(40, 16, 4, 2), (3072, 1300, 2, 1)])
def test_windowed_attention_matches_reference(s, window, H, K):
    rng = np.random.RandomState(s)
    q = jnp.asarray(rng.randn(1, s, H, 16), jnp.bfloat16)
    k = jnp.asarray(rng.randn(1, s, K, 16), jnp.bfloat16)
    v = jnp.asarray(rng.randn(1, s, K, 16), jnp.bfloat16)
    want = jitted(f"win{s}", lambda q, k, v: RL._windowed_attention(
        q, k, v, window))(q, k, v)
    got = PL._windowed_attention(_t(q), _t(k), _t(v), window)
    close(got, want, "windowed", steps=0.5)
    # the band: a query sees no key at or before i - window
    dense = PL.dot_attention(_t(q), _t(k), _t(v), causal=True)
    assert not torch.equal(got, dense)
    close(got[:, :window], dense[:, :window], "inside the first window",
          steps=0.5)


def test_attention_takes_the_window_in_prefill():
    rm, rp, pm, pp = models(window=16)
    cfg = rm.cfg
    s = 40
    x = jnp.asarray(np.random.RandomState(3).randn(2, s, cfg.d_model),
                    jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
    want, wkv = jitted("attn_w", lambda p, x: RL.attention(
        p, x, cfg, None, positions=pos, mode="prefill", window=16))(
        rp["shared"]["attn"], x)
    with torch.no_grad():
        got, gkv = PL.attention(pp["shared"]["attn"], _t(x), pm.cfg,
                                positions=_t(pos), mode="prefill", window=16)
        plain, _ = PL.attention(pp["shared"]["attn"], _t(x), pm.cfg,
                                positions=_t(pos), mode="prefill")
    close(got, want, "windowed prefill", steps=0.5)
    close(gkv["k"], wkv["k"], "K", steps=0.5)
    assert not torch.equal(got, plain)


def _grow_ref(cache, n):
    """The reference's own decode test's growth of every K/V
    (``tests/test_models_decode.py``)."""
    out = {}
    for key, v in cache.items():
        if isinstance(v, dict):
            out[key] = _grow_ref(v, n)
        elif key in ("k", "v") and hasattr(v, "ndim") and v.ndim >= 3:
            pad = [(0, 0)] * v.ndim
            pad[2 if v.ndim == 5 else 1] = (0, n)
            out[key] = jnp.pad(v, pad)
        else:
            out[key] = v
    return out


def _cache_close(got, want):
    """K/V and conv states within one bf16 step of the largest entry, the
    SSD states in f32 within 2e-4."""
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _cache_close(g, w)
        elif w.dtype == jnp.bfloat16:
            close(g, w, key, steps=0.5)
        elif key != "index":
            f32_close(g, w, key)


def _drive(window, s, b, grow, steps=6, seed=0):
    """Prefill, then ``steps`` decode steps of both models, each step from
    the reference's cache (so that the f32 sums of the SSD state, whose
    order differs, do not accumulate over the steps): every logit within
    one bf16 step of the largest, every new cache as ``_cache_close``
    holds it.  Returns both final caches."""
    rm, rp, pm, pp = models(window)
    tok = RefSource(rm.cfg.vocab_size, seed).batch(rm.batch_table(
        RefShape("p", s, b, "prefill")), 0)["tokens"]
    rl, rc = jitted(f"prefill{window}_{s}_{b}", lambda p, t: rm.prefill(
        p, {"tokens": t}, None))(rp, jnp.asarray(tok))
    with torch.no_grad():
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(tok)})
    close(pl, rl, "prefill logits", steps=0.5)
    _cache_close(pc, rc)
    if grow:
        rc = _grow_ref(rc, steps)
        assert port_serve.grow_kv(pc, steps)["shared_kv"]["k"].shape == \
            rc["shared_kv"]["k"].shape
    ref_decode = jitted(f"decode{window}", ref_steps.build_decode_step(rm))
    decode = port_steps.build_decode_step(pm)
    toks = np.random.default_rng(s).integers(
        1, rm.cfg.vocab_size - 1, (steps, b, 1)).astype(np.int32)
    for i in range(steps):
        pc = params_from_jax(jax.tree.map(np.asarray, rc))
        rl, rc = ref_decode(rp, rc, jnp.asarray(toks[i]))
        pl, pc = decode(pp, pc, torch.from_numpy(toks[i]))
        close(pl, rl, f"decode step {i}", steps=0.5)
        _cache_close(pc, rc)
        assert int(pc["index"]) == int(rc["index"]) == s + i + 1
    return rc, pc


@pytest.mark.parametrize("window,s", [(0, 24), (0, 37), (16, 40)])
def test_prefill_and_decode_match_reference(window, s, xla_cpu):
    """``window=0``: the smoke config; a window of 16 with a 40-token
    prompt: a windowed prefill, then decode over the grown cache (t > the
    window: the contiguous branch, as the reference)."""
    _drive(window, s, 2, grow=True)


def test_ring_buffer_decode_matches_reference(xla_cpu):
    """A cache no longer than the window is a ring: with the prompt's 12
    positions and a window of 16, each decode write lands at ``index mod
    12``, over the prompt's first positions, in both packages."""
    rc, pc = _drive(16, 12, 2, grow=False, steps=4)
    assert pc["shared_kv"]["k"].shape[2] == 12
    # the four writes went over the prompt's positions 0-3
    assert int(pc["index"]) == 16


def test_prefill_plus_decode_matches_longer_prefill():
    """``tests/test_models_decode.py``'s property in the port (its
    tolerance), over the grown cache."""
    rm, _, pm, pp = models()
    s = 32
    tok = torch.from_numpy(RefSource(pm.cfg.vocab_size, 0).batch(
        rm.batch_table(RefShape("p", s + 1, 2, "prefill")), 0)["tokens"])
    with torch.no_grad():
        want, _ = pm.prefill(pp, {"tokens": tok})
        _, cache = pm.prefill(pp, {"tokens": tok[:, :-1]})
        got, _ = port_steps.build_decode_step(pm)(
            pp, port_serve.grow_kv(cache, 1), tok[:, -1:])
    a, b = _np(want[:, -1]), _np(got[:, -1])
    assert np.abs(a - b).max() < 0.05 * (np.abs(a).max() + 1)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5


def test_decode_past_an_ungrown_cache_raises():
    """Where the reference's ``dynamic_update_slice`` clamps the write
    onto the last prompt position, the port raises; ``grow_kv`` grows the
    nested shared K/V (and a top-level one) along its sequence axis."""
    _, _, pm, pp = models()
    tok = torch.randint(1, 200, (2, 9), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    with torch.no_grad():
        _, cache = pm.prefill(pp, {"tokens": tok})
    assert cache["shared_kv"]["k"].shape == (2, 2, 9, 4, 112)
    with pytest.raises(ValueError, match="past a cache of 9"):
        port_steps.build_decode_step(pm)(pp, cache, tok[:, :1])
    grown = port_serve.grow_kv(cache, 5)
    assert grown["shared_kv"]["k"].shape == (2, 2, 14, 4, 112)
    assert torch.equal(grown["shared_kv"]["v"][:, :, :9],
                       cache["shared_kv"]["v"])
    assert not grown["shared_kv"]["k"][:, :, 9:].any()
    assert grown["mamba"]["ssm"] is cache["mamba"]["ssm"]
    dense = port_serve.grow_kv({"k": torch.ones(3, 2, 4, 1, 8),
                                "index": torch.tensor(4)}, 2)
    assert dense["k"].shape == (3, 2, 6, 1, 8)


# ---------------------------------------------------------------------------
# Loss and gradients


def _train_batch(seed=0):
    rm = models()[0]
    rb = RefPipeline(rm, RefShape("t", 40, 4, "train"), seed=seed) \
        .batch_at(0)
    return rb, {k: _t(v) for k, v in rb.items()}


def test_loss_and_grads_match_reference(xla_cpu):
    rm, rp, pm, pp = models()
    rb, pb = _train_batch()
    (want, _), g_ref = jitted("grad", jax.value_and_grad(
        lambda p, b: rm.loss(p, b, None), has_aux=True))(rp, rb)
    loss, _, grads = port_steps.loss_and_grads(pm, pp, pb)
    assert float(loss) == pytest.approx(float(want), rel=1e-3)
    seen = 0
    for path, want_g in jax.tree_util.tree_leaves_with_path(g_ref):
        keys = [k.key for k in path]
        got = grads
        for k in keys:
            got = got[k]
        got = torch.stack(got) if isinstance(got, list) else got
        got = _np(got).reshape(np.shape(want_g))
        w = np.asarray(want_g, np.float32)
        rel = float(np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30))
        lim = 2e-2 if keys[0] in ("ln_f",) or keys[-1] == "unembed" else 1e-1
        assert rel <= lim, (keys, rel)
        seen += 1
    assert seen == len(jax.tree.leaves(g_ref))


def test_train_main_matches_reference(monkeypatch, xla_cpu):
    def draw(table, generator, device):
        return params_from_jax(jax.tree.map(np.asarray, models()[1]),
                               device)
    monkeypatch.setattr(port_train, "init_params", draw)
    kw = dict(arch=SMOKE, steps=3, seq_len=40, global_batch=4, log=quiet)
    want = ref_train_main(**kw)
    got = port_train.train_main(**kw, device="cpu")
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-3)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)


def test_remat_policies_bitwise_equal():
    _, _, _, pp = models()
    _, pb = _train_batch(seed=2)
    out = {}
    for remat in ("none", "dots", "full"):
        m = model_for(get_config(SMOKE), remat=remat)
        loss, _, grads = port_steps.loss_and_grads(m, pp, pb)
        out[remat] = (loss, grads)
    assert len(out["none"][1]["mamba"]["w_in"]) == 4
    assert len(out["none"][1]["mamba_tail"]["w_in"]) == 1
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(jax.tree.leaves(out[remat][1]),
                        jax.tree.leaves(out["none"][1])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Serving and the build


@pytest.fixture
def reference_weights(monkeypatch):
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
    """Every row's greedy tokens of the port's legacy path, and the
    length of the shared K/V each decode step was given."""
    runs = []
    make_step = port_steps.build_decode_step

    def recording(model):
        step = make_step(model)
        fed = []
        runs.append(fed)

        def decode(params, cache, tokens):
            t = cache["shared_kv"]["k"].shape[2]
            logits, cache = step(params, cache, tokens)
            fed.append((tokens, logits[:, -1].argmax(-1), t))
            return logits, cache
        return decode
    monkeypatch.setattr(port_steps, "build_decode_step", recording)

    def streams(i=-1):
        fed = runs[i]
        cols = [t[:, 0] for t, _, _ in fed] + [fed[-1][1]]
        return torch.stack(cols, dim=1).cpu().numpy(), {n for _, _, n in fed}
    return streams


def _ref_streams(batch, prefill_len, decode_tokens, seed):
    """The reference model driven as the legacy path drives it, over the
    cache grown as its own decode test grows it."""
    rm = ref_model_for(ref_config(SMOKE), remat="none")
    params = ref_init(rm.param_table(), jax.random.PRNGKey(seed))
    req = RefSource(rm.cfg.vocab_size, seed).batch(
        rm.batch_table(RefShape("p", prefill_len, batch, "prefill")), 0)
    logits, cache = jax.jit(ref_steps.build_prefill_step(rm))(params, req)
    cache = _grow_ref(cache, decode_tokens)
    decode = jitted("decode0", ref_steps.build_decode_step(rm))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(decode_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("batch,prefill_len,decode_tokens,seed",
                         [(2, 32, 8, 0), (3, 21, 6, 0)])
def test_serve_main_matches_reference_on_the_grown_cache(
        batch, prefill_len, decode_tokens, seed, reference_weights,
        port_streams, xla_cpu):
    kw = dict(arch=SMOKE, batch=batch, prefill_len=prefill_len,
              decode_tokens=decode_tokens, seed=seed, log=quiet)
    want = ref_serve_main(**kw)
    got = port_serve.serve_main(**kw, device="cpu")
    assert set(got) == set(want) and got["mode"] == "legacy-static"
    streams, lengths = port_streams()
    np.testing.assert_array_equal(streams, _ref_streams(
        batch, prefill_len, decode_tokens, seed))
    assert got["sample"] == streams[0][:8].tolist()
    assert lengths == {prefill_len + decode_tokens}


def test_run_command_matches_reference_on_the_grown_cache(
        reference_weights, port_streams, xla_cpu):
    cmd = f"serve --arch {SMOKE} --batch 2 --prefill 24 --decode 6"
    got, want = run_command(cmd, device="cpu"), ref_run_command(cmd)
    assert set(got) == set(want)
    streams, _ = port_streams()
    np.testing.assert_array_equal(streams, _ref_streams(2, 24, 6, 0))
    assert got["sample"] == streams[0].tolist()


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_hybrid_build_lists_the_rmsnorm_kernel_alone(shape):
    app = parse_appfile(f"FROM arch:{ARCH}\nSHAPE {shape}\n"
                        f"###include_local_kernels###\n")
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert list(res.program["kernels"]) == ["rmsnorm"] and res.built == {}


def test_the_engine_refuses_the_hybrid_and_windows():
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.serving import ServeEngine
    for engine, kw in ((RefEngine, {}), (ServeEngine, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="legacy static path"):
            engine(arch=SMOKE, num_slots=2, max_len=32, log=quiet, **kw)


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_hybrid_serve_on_the_card(cuda, port_streams, monkeypatch):
    """K2 on every norm: per forward, two a Mamba2 block (its input norm
    and the gated norm), the shared block's first norm and ``ln_f`` on the
    ``rmsnorm`` entry, its second fused with the residual add; the same
    tokens with the plain norm in K2's place."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
    kw = dict(arch=SMOKE, batch=4, prefill_len=48, decode_tokens=12,
              log=quiet)
    cfg = get_config(SMOKE)
    per, segs, _ = model_for(cfg)._layout()
    rmsnorm_cuda.launches = add_rmsnorm_cuda.launches = 0
    got = port_serve.serve_main(**kw)
    assert (rmsnorm_cuda.launches, add_rmsnorm_cuda.launches) == \
        ((2 * cfg.num_layers + segs + 1) * 12, segs * 12)
    kernel, _ = port_streams()
    monkeypatch.setattr(ops, "rmsnorm_cuda",
                        lambda x, w, *, eps=1e-6, out_dtype=None:
                        ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype))
    monkeypatch.setattr(ops, "add_rmsnorm_cuda",
                        lambda x, a, w, *, eps=1e-6, norm_of_rounded:
                        ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                            norm_of_rounded=norm_of_rounded))
    plain = port_serve.serve_main(**kw)
    assert plain["sample"] == got["sample"]
    np.testing.assert_array_equal(port_streams()[0], kernel)
