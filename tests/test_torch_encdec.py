"""The port's enc-dec family (``repro_torch/models/encdec.py``, Whisper),
its config and its layer features (``models/layers.py``: gelu, learned
and sinusoidal positions, cross-attention) against the JAX reference on
the CPU, on the reference's weights (``init_params`` under
``PRNGKey(0)``, crossed bit for bit with ``params_from_jax``) and on
seeded numpy inputs.

* ``whisper-tiny`` and its smoke equal the reference's configs field for
  field; the full width is 439,115,136 parameters (402,653,184 of them
  the learned position table) and its cache for 4 requests of 1,056
  positions 51.9 MB.
* gelu (the tanh form) bit for bit against ``jax.nn.gelu`` on bf16, its
  gradient bit for bit against ``jax.vjp``'s (XLA rounds every step of
  both chains to bf16, and so does the port).
* ``sinusoidal_positions`` in f32 within 1.3e-4 of the reference's (XLA's
  CPU ``pow``, ``sin`` and ``cos`` are not torch's); cast to bf16, the
  table at (1,024, 384) differs in at most 0.1% of its entries (349 of
  393,216 here), each by at most one bf16 step of the table's largest
  entries (2^-8): the allowance the encoder's tolerance carries.  Learned and sinusoidal ``embed`` against the
  reference's; cross-attention (``kv_source``) within one bf16 step.
* The smoke model on XLA's CPU arithmetic (fixture ``xla_cpu``: bf16
  einsums as f32 products rounded once, XLA's rsqrt), as the Zamba2
  tests run it: under the reference's init law (fan-in from the stacked
  axis, 2 layers) the smoke activations reach ~180, and torch's own bf16
  products, a step off in a few elements, move single cache entries by
  up to 1.2% of the largest.  There ``encode``, ``prefill`` (logits and
  all four caches) and 4 whole-batch decode steps from the reference's
  cache are within two bf16 steps of the largest entry, and the prefill's
  logits and caches are the reference's bits, which pins the norms that
  read unrounded residual sums (every block's second norm, and the
  decoder's ``ln_x``).  The legacy path grows the self K/V and never the
  cross K/V.
* The cross-attention gap, both sides: with nonzero biases the
  reference's prefill + decode departs from its own longer prefill (its
  cached cross K/V lack ``bk``/``bv``, its decode query ``bq``); the
  port's stays within two bf16 steps of its own; at the reference's zero
  biases the port's decode is the reference's, within two bf16 steps.
* The loss within rtol 1e-3; per-leaf gradients within the dense
  family's tolerances (``tests/test_torch_train.py``: relative L2 1e-1
  and within the control's distance, ``ln_f`` 2e-2).  The key biases
  ``bk`` get no gradient in exact arithmetic (softmax is unchanged by a
  shift shared by all keys), so both packages' are rounding noise: each
  under 5e-2 of its ``bq``'s (0.016 and 0.004 at most measured).
* ``serve_main``, ``run_command`` and ``run_easey`` return the
  reference's result and every row's greedy stream; the build lists no
  kernel; the engine refuses the family, as the reference's does.
* Training: ``train_main`` for 3 steps within rtol 1e-3 of the
  reference's losses; remat ``none``, ``dots`` and ``full`` bitwise
  equal within the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.core.appspec import parse_appfile as ref_parse_appfile
from repro.core.jobspec import parse_jobspec as ref_parse_jobspec
from repro.core.workflow import run_easey as ref_run_easey
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import SyntheticSource as RefSource
from repro.launch.run import run_command as ref_run_command
from repro.launch.serve import serve_main as ref_serve_main
from repro.launch.train import train_main as ref_train_main
from repro.models import layers as RL
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training import steps as ref_steps
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobs import JobState
from repro_torch.core.jobspec import parse_jobspec
from repro_torch.core.tuning import param_count_estimate
from repro_torch.core.workflow import run_easey
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.run import run_command
from repro_torch.models import encdec as P
from repro_torch.models import layers
from repro_torch.models.params import params_from_jax, tree_map
from repro_torch.models.transformer import model_for
from repro_torch.training import steps as port_steps

ARCH, SMOKE = "whisper-tiny", "whisper-tiny-smoke"
BF16_STEP = 2.0 ** -7
TIMINGS = ("prefill_s", "decode_s", "decode_tok_per_s")


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
    """bf16 einsums and rsqrt as XLA's CPU computes them: a bf16 einsum is
    the f32 product of the exact bf16 values, rounded once to bf16; rsqrt
    is XLA's own (not correctly rounded).  Forward only: this rsqrt
    carries no gradient."""
    plain = torch.einsum

    def einsum(eq, *ops):
        if any(o.dtype == torch.bfloat16 for o in ops):
            return plain(eq, *(o.float() for o in ops)).to(torch.bfloat16)
        return plain(eq, *ops)

    xla_rsqrt = jax.jit(jax.lax.rsqrt)

    def rsqrt(t):
        out = xla_rsqrt(t.detach().float().numpy())
        return torch.from_numpy(np.array(out)).to(t.dtype)
    monkeypatch.setattr(torch, "einsum", einsum)
    monkeypatch.setattr(torch, "rsqrt", rsqrt)


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


def bits_equal(got, want, what=""):
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16)), what


_MODELS: dict = {}


def models(biased=False):
    """(reference model, its params, port model, the same params); with
    ``biased``, every attention bias redrawn nonzero from a seed (std
    0.5), as training leaves them."""
    if biased not in _MODELS:
        rm = ref_model_for(ref_config(SMOKE), remat="none")
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        if biased:
            rng = np.random.RandomState(7)
            for stack in ("enc_blocks", "dec_blocks"):
                for attn in ("attn", "xattn"):
                    p = rp[stack].get(attn)
                    for b in ("bq", "bk", "bv") if p else ():
                        p[b] = jnp.asarray(rng.randn(*p[b].shape) * 0.5,
                                           jnp.bfloat16)
        _MODELS[biased] = (rm, rp, model_for(get_config(SMOKE),
                                             remat="none"),
                           params_from_jax(jax.tree.map(np.asarray, rp)))
    return _MODELS[biased]


_JIT: dict = {}


def jitted(name, fn):
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


def _batch(s, b, n=0, seed=0):
    """Seeded frames of s positions and tokens of s + n."""
    rm = models()[0]
    return RefSource(rm.cfg.vocab_size, seed).batch(
        rm.batch_table(RefShape("p", s + n, b, "prefill")), 0)


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
    assert isinstance(model_for(port), P.EncDecLM)


def test_full_width_parameters_and_cache():
    cfg = get_config(ARCH)
    assert param_count_estimate(cfg) == 439_115_136
    assert cfg.max_position * cfg.d_model == 402_653_184
    table = model_for(cfg).cache_table(4, 1056)
    rt = ref_model_for(ref_config(ARCH)).cache_table(4, 1056)
    assert {k: d.shape for k, d in table.items()} == \
        {k: d.shape for k, d in rt.items()}
    nbytes = sum(np.prod(d.shape) * d.dtype.itemsize
                 for d in table.values())
    assert round(nbytes / 1e5) == 519


# ---------------------------------------------------------------------------
# Layer features


def test_gelu_and_its_gradient_bit_for_bit():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 3).astype(ml_dtypes.bfloat16)
    g = rng.randn(4096).astype(ml_dtypes.bfloat16)
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x))
    want_dx = jax.jit(lambda x, g: jax.vjp(jax.nn.gelu, x)[1](g)[0])(
        jnp.asarray(x), jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y = layers.gelu(xt)
    y.backward(_t(g))
    bits_equal(y.detach(), want, "gelu")
    bits_equal(xt.grad, want_dx, "gelu's gradient")
    # the tanh form, not torch's erf default
    assert not torch.equal(y.detach(), torch.nn.functional.gelu(_t(x)))


def test_sinusoidal_positions_within_the_allowance():
    s, d = 1024, 384
    want = np.asarray(jitted("pe", lambda: RL.sinusoidal_positions(s, d))())
    got = layers.sinusoidal_positions(s, d).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1.3e-4)
    gb, wb = got.astype(ml_dtypes.bfloat16), want.astype(ml_dtypes.bfloat16)
    parted = gb != wb
    assert parted.mean() <= 1e-3, parted.sum()
    # within one bf16 step of the table's largest entries (|pe| <= 1);
    # near a zero of sin or cos an f32 ulp of the angle is many bf16 steps
    # of the entry itself
    gap = np.abs(gb.astype(np.float32) - wb.astype(np.float32))
    assert gap.max() <= 2.0 ** -8


@pytest.mark.parametrize("pos", ["learned", "sinusoidal"])
def test_embed_adds_positions_as_the_reference(pos):
    rm, rp, _, pp = models()
    cfg_r, cfg_p = rm.cfg.replace(pos=pos), get_config(SMOKE).replace(pos=pos)
    rng = np.random.RandomState(1)
    tok = rng.randint(0, cfg_r.vocab_size, (3, 11)).astype(np.int32)
    positions = (np.arange(11)[None] + np.array([[0], [40], [1000]])) \
        .astype(np.int32)
    want = jitted(f"embed{pos}", lambda p, t, q: RL.embed(
        p, t, cfg_r, None, positions=q))(rp["embed"], tok, positions)
    got = layers.embed(pp["embed"], torch.from_numpy(tok), cfg_p,
                       torch.from_numpy(positions))
    if pos == "learned":
        bits_equal(got, want)
    else:       # the sinusoid allowance: one bf16 step of an entry
        close(got, want, steps=0.5)
    with pytest.raises(ValueError, match="positions"):
        layers.embed(pp["embed"], torch.from_numpy(tok), cfg_p)


def test_cross_attention_matches_reference(xla_cpu):
    rm, rp, _, pp = models(biased=True)
    cfg = rm.cfg
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 5, cfg.d_model), jnp.bfloat16)
    src = jnp.asarray(rng.randn(2, 13, cfg.d_model), jnp.bfloat16)
    p = jax.tree.map(lambda t: t[1], rp["dec_blocks"]["xattn"])
    want, _ = jitted("xattn", lambda p, x, e: RL.attention(
        p, x, cfg, None, positions=jnp.zeros((2, 5), jnp.int32),
        mode="full", kv_source=e))(p, x, src)
    pt = tree_map(_t, p)
    got, none = layers.attention(pt, _t(x), get_config(SMOKE),
                                 positions=None, mode="full",
                                 kv_source=_t(src))
    bits_equal(got, want)
    assert none is None
    # prefill returns the projected K/V; the pair form gives the same
    again, fresh = layers.attention(pt, _t(x), get_config(SMOKE),
                                    positions=None, mode="prefill",
                                    kv_source=_t(src))
    pair, _ = layers.attention(pt, _t(x), get_config(SMOKE), positions=None,
                               mode="decode",
                               kv_source=(fresh["k"], fresh["v"]))
    assert torch.equal(again, got) and torch.equal(pair, got)
    assert fresh["k"].shape == (2, 13, cfg.num_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# The smoke model


def _ref_prefill(rm, rp, batch):
    return jitted("prefill", lambda p, b: rm.prefill(p, b, None))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_encode_matches_reference(xla_cpu):
    rm, rp, pm, pp = models()
    frames = _batch(24, 2)["frames"]
    want = jitted("encode", lambda p, f: rm.encode(p, f, None))(
        rp, jnp.asarray(frames))
    with torch.no_grad():
        enc, _ = pm.layer_params(pp)
        got = pm.encode(enc, pp["enc_ln_f"], _t(frames))
    close(got, want, "encoder output")


@pytest.mark.parametrize("s,b", [(24, 2), (37, 3)])
def test_prefill_and_decode_match_reference(s, b, xla_cpu):
    """Prefill (logits, the four caches) and 4 decode steps, each from the
    reference's cache grown as the legacy path grows it."""
    rm, rp, pm, pp = models()
    n = 4
    batch = _batch(s, b, n)
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    rl, rc = _ref_prefill(rm, rp, prompt)
    with torch.no_grad():
        pl, pc = pm.prefill(pp, _port_batch(prompt))
    close(pl, rl, "prefill logits")
    for k in ("k", "v", "xk", "xv"):
        close(pc[k], rc[k], k)
    assert (pc["index"].dim(), int(pc["index"]), pc["layout"]) == \
        (0, s, "contiguous")
    grown = port_serve.grow_kv(pc, n)
    assert grown["k"].shape[2] == grown["v"].shape[2] == s + n
    assert grown["xk"] is pc["xk"] and grown["xv"] is pc["xv"]
    rc = dict(rc, **{k: jnp.pad(rc[k], [(0, 0)] * 2 + [(0, n)] +
                                [(0, 0)] * 2) for k in ("k", "v")})
    decode = port_steps.build_decode_step(pm)
    ref_decode = jitted("decode", ref_steps.build_decode_step(rm))
    for i in range(n):
        tok = batch["tokens"][:, s + i:s + i + 1]
        from_ref = {k: _t(v) for k, v in rc.items() if k != "index"}
        from_ref.update(index=torch.tensor(int(rc["index"]),
                                           dtype=torch.int32),
                        layout="contiguous")
        pl, _ = decode(pp, from_ref, torch.from_numpy(tok))
        rl, rc = ref_decode(rp, rc, jnp.asarray(tok))
        close(pl, rl, f"decode step {i}")
        assert int(rc["index"]) == s + i + 1


def test_prefill_is_the_reference_s_bit_for_bit_on_xla_arithmetic(xla_cpu):
    """On XLA's products and rsqrt the prefill's logits and caches are the
    reference's bits: the norms that read the unrounded residual sum are
    the ones XLA hands it (rounding any of them first parts the bits)."""
    rm, rp, pm, pp = models()
    batch = _batch(24, 2)
    rl, rc = _ref_prefill(rm, rp, batch)
    with torch.no_grad():
        pl, pc = pm.prefill(pp, _port_batch(batch))
    bits_equal(pl, rl, "logits")
    for k in ("k", "v", "xk", "xv"):
        bits_equal(pc[k], rc[k], k)


def _ref_forced(rm):
    """The reference's teacher-forced logits of every position (its
    ``loss`` forward)."""
    def fn(p, batch):
        b, s = batch["tokens"].shape
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        enc = rm.encode(p, batch["frames"], None)
        x = rm._embed_tokens(p, batch["tokens"], positions, None)
        x, _ = rm.decoder(p, x, enc, positions, None, "full")
        x = RL.apply_norm(p["ln_f"], x, rm.cfg.norm)
        return RL.unembed(p["embed"], x, rm.cfg, None)
    return fn


def _gap(steps, forced, s):
    """Max |logit| gap of each decode step from the teacher-forced logits
    at its position, over the largest logit."""
    return max(float(np.abs(_np(got[:, -1]) - _np(forced[:, s + i])).max()
                     / np.abs(_np(forced[:, s + i])).max())
               for i, got in enumerate(steps))


@pytest.mark.parametrize("biased", [False, True])
def test_cross_attention_gap_closed_in_the_port(biased):
    """Prefill of s tokens and n teacher-forced decode steps against the
    teacher-forced forward of all s + n, in each package: the
    reference's own departs once the biases are nonzero; the port's holds
    within two bf16 steps either way."""
    rm, rp, pm, pp = models(biased)
    s, n = 20, 3
    batch = _batch(s, 2, n, seed=3)
    tokens = batch["tokens"]
    prompt = dict(batch, tokens=tokens[:, :s])
    decode = port_steps.build_decode_step(pm)
    with torch.no_grad():
        forced, _ = pm.full_forward(pm.train_leaves(pp), _port_batch(batch))
        _, cache = pm.prefill(pp, _port_batch(prompt))
        cache, steps = port_serve.grow_kv(cache, n), []
        for i in range(n):
            logits, cache = decode(pp, cache, torch.from_numpy(
                tokens[:, s + i:s + i + 1]))
            steps.append(logits)
    port_gap = _gap(steps, forced, s)
    assert port_gap <= BF16_STEP, port_gap
    forced = jitted("forced", _ref_forced(rm))(rp, batch)
    _, rc = _ref_prefill(rm, rp, prompt)
    rc = dict(rc, **{k: jnp.pad(rc[k], [(0, 0)] * 2 + [(0, n)] +
                                [(0, 0)] * 2) for k in ("k", "v")})
    ref_decode = jitted("decode", ref_steps.build_decode_step(rm))
    steps = []
    for i in range(n):
        logits, rc = ref_decode(rp, rc, jnp.asarray(tokens[:, s + i:s + i + 1]))
        steps.append(logits)
    ref_gap = _gap(steps, forced, s)
    if biased:
        assert ref_gap > 0.05, ref_gap
    else:
        assert ref_gap <= BF16_STEP, ref_gap


def test_zero_biases_port_equals_reference_through_decode(xla_cpu):
    """At the reference's zero biases the gap's repair changes nothing:
    prefill + decode steps, each from the port's own cache, within two
    bf16 steps of the reference's (its LayerNorm sums run in another
    order, so a rare element sits one step off)."""
    rm, rp, pm, pp = models()
    s, n = 20, 3
    batch = _batch(s, 2, n, seed=4)
    prompt = batch
    _, rc = _ref_prefill(rm, rp, dict(prompt,
                                      tokens=prompt["tokens"][:, :s]))
    rc = dict(rc, **{k: jnp.pad(rc[k], [(0, 0)] * 2 + [(0, n)] +
                                [(0, 0)] * 2) for k in ("k", "v")})
    with torch.no_grad():
        _, pc = pm.prefill(pp, _port_batch(dict(
            batch, tokens=batch["tokens"][:, :s])))
    pc = port_serve.grow_kv(pc, n)
    decode = port_steps.build_decode_step(pm)
    ref_decode = jitted("decode", ref_steps.build_decode_step(rm))
    for i in range(n):
        tok = batch["tokens"][:, s + i:s + i + 1]
        pl, pc = decode(pp, pc, torch.from_numpy(tok))
        rl, rc = ref_decode(rp, rc, jnp.asarray(tok))
        close(pl, rl, f"decode step {i}")


def test_decode_needs_a_whole_batch_index():
    _, _, pm, pp = models()
    with torch.no_grad():
        _, cache = pm.prefill(pp, _port_batch(_batch(8, 2)))
    with pytest.raises(ValueError, match="0-d index"):
        pm.decode_step(pp, dict(cache, index=torch.tensor([8, 8])),
                       torch.ones((2, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Loss and gradients


def _train_batch(seed=0):
    rm = models()[0]
    rb = RefPipeline(rm, RefShape("t", 40, 4, "train"), seed=seed) \
        .batch_at(0)
    return rb, {k: _t(v) for k, v in rb.items()}


def _stacked(g):
    return torch.stack(g) if isinstance(g, list) else g


def _rel(got, want):
    got, want = _np(got).ravel(), np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_loss_and_grads_match_reference(monkeypatch):
    rm, rp, pm, pp = models()
    rb, pb = _train_batch()
    (want, _), g_ref = jitted("grad", jax.value_and_grad(
        lambda p, b: rm.loss(p, b, None), has_aux=True))(rp, rb)
    loss, _, grads = port_steps.loss_and_grads(pm, pp, pb)
    assert float(loss) == pytest.approx(float(want), rel=1e-3)
    # the control: every block's second norm (and ln_x) of the rounded
    # residual sum, one extra bf16 rounding a norm, the same math
    plain = layers.add_norm

    def rounded(p, x, a, kind, *, norm_of_rounded=True):
        return plain(p, x, a, kind, norm_of_rounded=True)
    monkeypatch.setattr(layers, "add_norm", rounded)
    _, _, ctrl = port_steps.loss_and_grads(pm, pp, pb)
    monkeypatch.undo()
    seen = 0
    for path, want_g in jax.tree_util.tree_leaves_with_path(g_ref):
        keys = [k.key for k in path]
        got, c = grads, ctrl
        for k in keys:
            got, c = got[k], c[k]
        got = _stacked(got).reshape(np.shape(want_g))
        assert got.dtype == torch.bfloat16, keys
        if keys[-1] == "bk":
            # no gradient in exact arithmetic: noise, in both packages
            parent_r, parent_p = g_ref, grads
            for k in keys[:-1]:
                parent_r, parent_p = parent_r[k], parent_p[k]
            for g, q in ((got, _stacked(parent_p["bq"])),
                         (np.asarray(want_g, np.float32),
                          np.asarray(parent_r["bq"], np.float32))):
                assert np.linalg.norm(_np(g)) <= \
                    5e-2 * np.linalg.norm(_np(q)), keys
            seen += 1
            continue
        rel = _rel(got, want_g)
        ctrl_rel = _rel(_stacked(c).reshape(np.shape(want_g)), _np(got))
        if keys[0] == "ln_f":
            assert rel <= 2e-2, (keys, rel)
        assert rel <= 1e-1 and rel <= ctrl_rel, (keys, rel, ctrl_rel)
        seen += 1
    assert seen == len(jax.tree.leaves(g_ref))


def test_remat_policies_bitwise_equal():
    _, _, _, pp = models()
    _, pb = _train_batch(seed=2)
    out = {}
    for remat in ("none", "dots", "full"):
        m = model_for(get_config(SMOKE), remat=remat)
        out[remat] = port_steps.loss_and_grads(m, pp, pb)
    cfg = get_config(SMOKE)
    assert len(out["none"][2]["enc_blocks"]["attn"]["wq"]) == \
        cfg.num_encoder_layers
    assert len(out["none"][2]["dec_blocks"]["xattn"]["wk"]) == \
        cfg.num_layers
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(jax.tree.leaves(out[remat][2]),
                        jax.tree.leaves(out["none"][2])):
            assert torch.equal(a, b)


def test_train_main_matches_reference(monkeypatch):
    """``train_main`` for 3 steps on the reference's weights and batches
    (frames included): every loss within rtol 1e-3."""
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
    cache = dict(cache, **{k: jnp.pad(cache[k], [(0, 0)] * 2 +
                                      [(0, decode_tokens)] + [(0, 0)] * 2)
                           for k in ("k", "v")})
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
        if k in TIMINGS:
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


def test_run_easey_serves_a_whisper_appfile(tmp_path, reference_weights,
                                           port_streams):
    app = (f"FROM arch:{SMOKE}\nSHAPE prefill_32k\n"
           f"###include_local_kernels###\n"
           f"RUN serve --arch {SMOKE} --batch 2 --prefill 16 --decode 5\n")
    spec = {"job": {"name": "serve-whisper"}, "execution": [
        {"serial": {"command": f"serve --arch {SMOKE} --batch 2 "
                               f"--prefill 16 --decode 5"}}]}
    mw, jid, res = run_easey(parse_appfile(app), "local:cpu",
                             parse_jobspec(spec), storage=tmp_path / "port")
    assert mw.status(jid) is JobState.FINISHED, mw.logs(jid)
    rmw, rjid, _ = ref_run_easey(ref_parse_appfile(app), "local:cpu",
                                 ref_parse_jobspec(spec),
                                 storage=tmp_path / "ref")
    _same_result(mw.scheduler.result(jid)[0], rmw.scheduler.result(rjid)[0])
    np.testing.assert_array_equal(port_streams(), _ref_streams(2, 16, 5, 0))
    assert (res.step_name, res.program["arch"], res.built) == \
        ("prefill_step", "reference", {})


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_whisper_build_lists_no_kernel(shape):
    """A LayerNorm model on the legacy path: nothing to build."""
    app = parse_appfile(f"FROM arch:{ARCH}\nSHAPE {shape}\n"
                        f"###include_local_kernels###\n")
    res = BuildService().build(app, "nvidia:h100", lower=False)
    assert res.program["arch"] == "sm_90a"
    assert list(res.program["kernels"]) == [] and res.built == {}


def test_the_engine_refuses_whisper_as_the_reference_does():
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.serving import ServeEngine
    for engine, kw in ((RefEngine, {}), (ServeEngine, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="legacy static path"):
            engine(arch=SMOKE, num_slots=2, max_len=32, log=quiet, **kw)
