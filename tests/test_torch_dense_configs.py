"""The port's ``stablelm-1.6b``, ``mistral-large-123b`` and
``nemotron-4-340b`` configs and the layers they need, against the JAX
reference on the CPU.

* Each config, full and smoke, equals the reference's field for field
  (dtypes compared by name), with the same skipped shapes.
* ``layernorm`` (f32 inside, scale and bias, eps 1e-5) and the squared
  ReLU agree with the reference's on the same bf16 inputs: within one
  bf16 step of the largest entry, since XLA's CPU ``rsqrt`` is not
  correctly rounded (``tests/test_torch_model.py``); the squared ReLU and
  the residual stream of ``add_norm`` bit for bit.
* On the reference's weights (crossed bit for bit), smoke prefill logits
  and K/V, chunked prefill into a paged pool and teacher-forced paged
  decode agree within two bf16 steps of the largest entry (``close``,
  the model tests' allowance), for all three configs.  The block's
  second LayerNorm reads the unrounded f32 residual sum, as XLA's
  compiled HLO for the reference does (the fusion feeding it takes the
  f32 ``dot + residual``); the squared ReLU rounds once, after the
  square.
* ``stablelm-1.6b-smoke``'s greedy streams through the paged engine are
  identical to the reference's, and so are its scheduling counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models import layers as ref_layers
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.serving import ServeEngine as RefEngine
from repro.serving import zipf_trace as ref_zipf
from repro.training.steps import (
    build_decode_step_slots_paged as ref_decode_builder,
    build_prefill_chunk_step_paged as ref_chunk_builder)
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.serving import ServeEngine, zipf_trace
from repro_torch.serving.prefill import bucket_len
from repro_torch.training.steps import (build_decode_step_slots_paged,
                                        build_prefill_chunk_step_paged)

ARCHS_NEW = ("stablelm-1.6b", "mistral-large-123b", "nemotron-4-340b")
SMOKES = tuple(a + "-smoke" for a in ARCHS_NEW)
BF16_STEP = 2.0 ** -7    # two bf16 rounding steps, relative
PAGE, MAX_PAGES, NUM_PAGES = 8, 8, 40
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got: torch.Tensor, want, what: str = "", steps: float = 1.0):
    """Agreement to within ``steps`` x two bf16 rounding steps of the
    largest entry."""
    want = np.asarray(want, np.float32)
    tol = BF16_STEP * steps
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _bf16(a: np.ndarray):
    """(jnp bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return j, t


_MODELS: dict = {}


def models(arch):
    """(reference model, its params, port model, the same params)."""
    if arch not in _MODELS:
        rm = ref_model_for(ref_config(arch), remat="none")
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        pm = model_for(get_config(arch))
        _MODELS[arch] = (rm, rp, pm,
                         params_from_jax(jax.tree.map(np.asarray, rp)))
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# Configs


def _fields(cfg):
    return {k: (v.__name__ if k.endswith("_dtype") and hasattr(v, "__name__")
                else str(v).replace("torch.", "") if k.endswith("_dtype")
                else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", ARCHS_NEW + SMOKES)
def test_config_equals_the_reference_field_for_field(arch):
    got, want = get_config(arch), ref_config(arch)
    assert _fields(got) == _fields(want)
    assert ARCHS[arch]["skip_shapes"] == REF_ARCHS[arch]["skip_shapes"]


def test_full_widths_and_attention_shapes():
    st, mi, ne = (get_config(a) for a in ARCHS_NEW)
    assert (st.num_layers, st.d_model, st.num_heads, st.num_kv_heads,
            st.head_dim, st.norm, st.rope_fraction) == \
        (24, 2048, 32, 32, 64, "layernorm", 0.25)
    assert (mi.num_heads // mi.num_kv_heads, mi.head_dim,
            mi.norm, mi.activation) == (12, 128, "rmsnorm", "silu")
    assert (ne.num_heads // ne.num_kv_heads, ne.head_dim,
            ne.norm, ne.activation, ne.rope_fraction) == \
        (12, 192, "layernorm", "sq_relu", 0.5)


# ---------------------------------------------------------------------------
# Layers


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 192])
def test_layernorm_matches_reference(seed, d):
    rng = np.random.default_rng(seed)
    xj, xt = _bf16(rng.normal(0.5, 2.0, (3, 7, d)))
    sj, st = _bf16(rng.normal(1.0, 0.2, (d,)))
    bj, bt = _bf16(rng.normal(0.0, 0.2, (d,)))
    want = ref_layers.layernorm(xj, sj, bj).astype(jnp.float32)
    got = layers.layernorm(xt, st, bt)
    assert got.dtype == torch.bfloat16
    close(got, want, "layernorm", steps=0.5)
    want32 = ref_layers.layernorm(xj.astype(jnp.float32), sj, bj)
    close(layers.layernorm(xt.float(), st, bt), want32, "f32 layernorm",
          steps=0.5)


@pytest.mark.parametrize("rounded", [True, False])
def test_add_layernorm_stream_and_norm(rounded):
    rng = np.random.default_rng(3)
    xj, xt = _bf16(rng.normal(0, 1, (2, 5, 64)))
    aj, at = _bf16(rng.normal(0, 1, (2, 5, 64)))
    _, st = _bf16(rng.normal(1, 0.1, (64,)))
    _, bt = _bf16(rng.normal(0, 0.1, (64,)))
    p = {"scale": st, "bias": bt}
    stream, normed = layers.add_norm(p, xt, at, "layernorm",
                                     norm_of_rounded=rounded)
    want_stream = np.asarray((xj + aj).astype(jnp.float32))
    assert np.array_equal(stream.float().numpy(), want_stream)
    src = stream if rounded else xt.float() + at.float()
    assert torch.equal(normed, layers.layernorm(src, st, bt,
                                                out_dtype=torch.bfloat16))
    only, norm_only = layers.add_norm(p, xt, None, "layernorm")
    assert only is xt and torch.equal(norm_only, layers.layernorm(xt, st, bt))


def test_sq_relu_matches_reference():
    rng = np.random.default_rng(4)
    hj, ht = _bf16(rng.normal(0, 3, (4, 9, 128)))
    want = np.asarray(jax.jit(lambda h: jnp.square(jax.nn.relu(h)))(hj)
                      .astype(jnp.float32))
    got = layers.sq_relu(ht)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# Smoke models on the reference's weights


def _tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, (1, n)).astype(np.int32)


@pytest.mark.parametrize("arch", SMOKES)
def test_smoke_prefill_logits_and_cache_match_reference(arch):
    rm, rp, pm, pp = models(arch)
    for seed in (0, 1):
        toks = _tokens(24, seed, rm.cfg.vocab_size)
        rl, rc = jax.jit(lambda p, b: rm.prefill(p, b, None))(
            rp, {"tokens": jnp.asarray(toks), "last": jnp.int32(20)})
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                                 "last": 20})
        close(pl, rl, f"{arch} prefill logits")
        close(pc["k"], rc["k"], f"{arch} prefill K")
        close(pc["v"], rc["v"], f"{arch} prefill V")


def _pools(cfg, slots):
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads,
             cfg.head_dim)
    ref = {"k": jnp.zeros(shape, jnp.bfloat16),
           "v": jnp.zeros(shape, jnp.bfloat16),
           "index": jnp.zeros((slots,), jnp.int32)}
    port = {"k": torch.zeros(shape, dtype=torch.bfloat16),
            "v": torch.zeros(shape, dtype=torch.bfloat16),
            "index": torch.zeros((slots,), dtype=torch.int32),
            "layout": "paged"}
    return ref, port


@pytest.mark.parametrize("arch", SMOKES)
def test_smoke_chunked_prefill_and_paged_decode_match_reference(arch):
    """Two slots: chunked prefill of different prompts into shuffled pages,
    then four teacher-forced decode ticks through the page table (the
    port's kernel dispatch, whose plain version runs on the CPU)."""
    rm, rp, pm, pp = models(arch)
    cfg = rm.cfg
    ref_chunk = jax.jit(ref_chunk_builder(rm), static_argnums=(6,))
    ref_decode = jax.jit(ref_decode_builder(rm))
    port_chunk = build_prefill_chunk_step_paged(pm)
    port_decode = build_decode_step_slots_paged(pm, use_kernel=True)
    rpool, ppool = _pools(cfg, 2)
    order = np.random.default_rng(5).permutation(
        np.arange(1, NUM_PAGES, dtype=np.int32))
    table = np.zeros((2, MAX_PAGES), np.int32)
    table[0, :4], table[1, :4] = order[:4], order[4:8]
    lens = (13, 19)
    for slot, n in enumerate(lens):
        toks = _tokens(n, 10 + slot, cfg.vocab_size)
        for off in range(0, n, 8):
            c = min(8, n - off)
            b = bucket_len(c)
            chunk = np.zeros((1, b), np.int32)
            chunk[0, :c] = toks[0, off:off + c]
            bound = bucket_len(off + c)
            rl, rpool = ref_chunk(rp, rpool, jnp.asarray(chunk),
                                  jnp.int32(slot), jnp.int32(off),
                                  jnp.int32(c), bound,
                                  jnp.asarray(table[slot]))
            pl, ppool = port_chunk(pp, ppool, torch.from_numpy(chunk), slot,
                                   off, c, bound,
                                   torch.from_numpy(table[slot]))
        close(pl, rl, f"{arch} chunk logits slot {slot}")
    pages = torch.from_numpy(table)
    for tick in range(4):
        nxt = _tokens(2, 20 + tick, cfg.vocab_size).reshape(2, 1)
        active = np.ones((2,), np.int32)
        rl, rpool = ref_decode(rp, rpool, jnp.asarray(nxt),
                               jnp.asarray(active), jnp.asarray(table))
        pl, ppool = port_decode(pp, ppool, torch.from_numpy(nxt),
                                torch.from_numpy(active), pages)
        close(pl, rl, f"{arch} decode tick {tick}")
    close(ppool["k"], rpool["k"], f"{arch} pool K")


def test_stablelm_smoke_greedy_streams_equal_the_reference():
    kw = dict(arch="stablelm-1.6b-smoke", target="local:cpu", num_slots=4,
              max_len=64, seed=0, kv_layout="paged", log=quiet)
    ref = RefEngine(**kw)
    port = ServeEngine(device="cpu", **kw)
    port.params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    args = dict(n=8, vocab_size=256, max_prompt=24, max_new=16, seed=1)
    want = ref.run(ref_zipf(**args))
    got = port.run(zipf_trace(**args))
    streams = lambda s: [r.tokens for r in sorted(s.results,  # noqa: E731
                                                  key=lambda r: r.rid)]
    assert streams(got) == streams(want)
    assert (got.decode_steps, got.preemptions, got.prefill_chunks,
            got.peak_active, got.mean_ttft_steps) == \
        (want.decode_steps, want.preemptions, want.prefill_chunks,
         want.peak_active, want.mean_ttft_steps)
