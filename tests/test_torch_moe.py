"""The port's MoE family (``repro_torch/models/moe.py``), its two configs
and the tuner's active-parameter count, against the JAX reference on the
CPU.

* ``granite-moe-3b-a800m`` and ``dbrx-132b``, full and smoke, equal the
  reference's configs field for field (dtypes by name), with the same
  skipped shapes.
* The reference's MoE weights cross bit for bit (``params_from_jax``:
  the stacked (L, m, E) router and (L, E, m, f) experts), and the port's
  ``init_params`` draws the same table.
* ``route_tokens`` on the same f32 logits: ``slot`` and ``keep`` bit for
  bit, ``gates`` and ``aux`` within f32 rtol 1e-6 — on random rows, on
  rows of exact ties (``lax.top_k`` ranks a tie by the lower index:
  experts ``0..k-1``), and on saturated rows whose probabilities are
  denormal in an unflushed f32 softmax (XLA's CPU flushes them to zero;
  the test asserts it built such rows).
* ``moe_mlp_chunk`` with the router scaled so that assignments are
  dropped past capacity (the drop count is asserted > 0): every output
  within one bf16 step of the reference's value (atol 0, rtol 2^-7:
  both round each expert product once to bf16, and f32 sums in another
  order can move a rounding by one step).
* ``moe_mlp`` at s = 2 x 2048 (width 16), through the sequence chunks,
  to the same bound, and its aux (the mean over chunks) to rtol 1e-6.
* ``MoELM`` on the reference's weights (crossed bit for bit): prefill
  logits and K/V, chunked prefill into a paged pool and teacher-forced
  paged decode within two bf16 steps of the largest entry (``close``,
  the dense model tests' allowance), for both smoke configs.
* ``active_param_count`` and the serve plan of both MoE archs, full and
  smoke, equal the reference's; ``_plan_serve`` prices a chunk by the
  active parameters (on a target where all-parameter pricing would
  pick another chunk).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro_torch.core.target as port_target
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core.tuning import active_param_count as ref_active
from repro.core.tuning import tune as ref_tune
from repro.models import moe as ref_moe
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training.steps import (
    build_decode_step_slots_paged as ref_decode_builder,
    build_prefill_chunk_step_paged as ref_chunk_builder)
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.tuning import active_param_count, tune
from repro_torch.models import moe
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.serving.prefill import bucket_len
from repro_torch.training.steps import (build_decode_step_slots_paged,
                                        build_prefill_chunk_step_paged)

MOE_ARCHS = ("granite-moe-3b-a800m", "dbrx-132b")
SMOKES = tuple(a + "-smoke" for a in MOE_ARCHS)
BF16_STEP = 2.0 ** -7    # two bf16 rounding steps, relative
PAGE, MAX_PAGES, NUM_PAGES = 8, 8, 40
F32_TINY = np.finfo(np.float32).tiny
# all-parameter pricing picks chunk 8 here, active-parameter pricing 32
GRAIN = "test:moe-grain"


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


def within_one_bf16_step(got: torch.Tensor, want, what: str = ""):
    """Every element within one bf16 step of the reference's value."""
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=0, err_msg=what)


def _bf16(a: np.ndarray):
    """(jnp bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, params_from_jax(np.asarray(j))


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


def _layer0_mlp(arch, router_scale=1.0):
    """Layer 0's MoE weights of ``models(arch)``, the router scaled by
    ``router_scale`` (in bf16, the same bits on both sides)."""
    _, rp, _, pp = models(arch)
    rw = jax.tree.map(lambda a: a[0], rp["blocks"]["mlp"])
    rw["router"] = (rw["router"].astype(jnp.float32) * router_scale
                    ).astype(jnp.bfloat16)
    pw = {k: v[0] for k, v in pp["blocks"]["mlp"].items()}
    pw["router"] = params_from_jax(np.asarray(rw["router"]))
    return rw, pw


# ---------------------------------------------------------------------------
# Configs


def _fields(cfg):
    return {k: (str(v).replace("torch.", "") if k.endswith("_dtype")
                else v) for k, v in dataclasses.asdict(cfg).items()}


def _ref_fields(cfg):
    return {k: (np.dtype(v).name if k.endswith("_dtype") else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", MOE_ARCHS + SMOKES)
def test_config_equals_the_reference_field_for_field(arch):
    got, want = get_config(arch), ref_config(arch)
    assert _fields(got) == _ref_fields(want)
    assert ARCHS[arch]["skip_shapes"] == REF_ARCHS[arch]["skip_shapes"] == \
        ("long_500k",)
    assert isinstance(model_for(got), moe.MoELM)


def test_full_widths():
    gr, db = (get_config(a) for a in MOE_ARCHS)
    assert (gr.num_layers, gr.d_model, gr.num_heads, gr.num_kv_heads,
            gr.head_dim, gr.d_ff, gr.num_experts, gr.experts_per_token,
            gr.norm) == (32, 1536, 24, 8, 64, 512, 40, 8, "rmsnorm")
    assert (db.num_layers, db.d_model, db.num_heads, db.num_kv_heads,
            db.head_dim, db.d_ff, db.num_experts, db.experts_per_token,
            db.norm, db.rope_theta) == \
        (40, 6144, 48, 8, 128, 10752, 16, 4, "layernorm", 5e5)
    assert "40 experts" in gr.notes


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", SMOKES)
def test_moe_weights_cross_bit_for_bit_and_init_draws_the_table(arch):
    rm, rp, pm, pp = models(arch)
    cfg = rm.cfg
    L, m, E, f = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in pp["blocks"]["mlp"].items()} == \
        {"router": (L, m, E), "wi": (L, E, m, f), "wg": (L, E, m, f),
         "wo": (L, E, f, m)}
    want = dict(_walk(rp))
    got = dict(_walk(pp))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w)
        assert got[path].dtype == torch.bfloat16, path
        assert np.array_equal(got[path].view(torch.int16).numpy(),
                              w.view(np.int16)), path
    drawn = init_params(pm.param_table(), torch.Generator().manual_seed(0),
                        "cpu")
    for path, t in _walk(drawn):
        assert tuple(t.shape) == tuple(np.shape(want[path])), path
        assert t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
    assert float(drawn["blocks"]["mlp"]["wi"].float().std()) > 0


# ---------------------------------------------------------------------------
# route_tokens


def _route_both(logits: np.ndarray, k: int, C: int):
    want = jax.jit(ref_moe.route_tokens, static_argnums=(1, 2))(
        jnp.asarray(logits), k, C)
    got = moe.route_tokens(torch.from_numpy(logits), k, C)
    return got, [np.asarray(w) for w in want]


def _route_equal(got, want):
    slot, gates, keep, aux = got
    assert slot.dtype == torch.int32 and keep.dtype == torch.bool
    assert np.array_equal(slot.numpy(), want[0])
    assert np.array_equal(keep.numpy(), want[2])
    np.testing.assert_allclose(gates.numpy(), want[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(aux), float(want[3]), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("E,k,C", [(4, 2, 8), (8, 2, 16), (40, 8, 8),
                                   (16, 4, 8)])
def test_route_tokens_matches_reference_on_random_rows(seed, E, k, C):
    logits = np.random.default_rng(seed).normal(
        0, 2, (2, 24, E)).astype(np.float32)
    got, want = _route_both(logits, k, C)
    _route_equal(got, want)
    assert not want[2].all() or C * E >= 24 * k   # C=8 at E=4 drops


@pytest.mark.parametrize("E,k", [(40, 8), (24, 8), (16, 4), (4, 2)])
def test_route_tokens_ties_go_to_the_lower_index(E, k):
    """Also the gates bit for bit: the k equal probabilities are summed
    in rank order, as XLA sums them (8 x f32(1/40) in a tree is 0.2)."""
    logits = np.zeros((2, 5, E), np.float32)
    got, want = _route_both(logits, k, 8)
    _route_equal(got, want)
    assert np.array_equal(got[1].numpy(), want[1])
    first = got[0][0, :k].numpy() // 8         # token 0's experts
    assert first.tolist() == list(range(k))


@pytest.mark.parametrize("seed", [0, 1])
def test_route_tokens_flushes_denormal_probabilities(seed):
    """A saturated router row: one logit far above the rest, as a
    random-weight router gives.  Unflushed, torch's f32 softmax keeps
    denormal probabilities that would order the zero-weight experts."""
    rng = np.random.default_rng(seed)
    E, k = 8, 4
    logits = -rng.uniform(3.7, 52.0, (2, 64, E)).astype(np.float32)
    hot = rng.integers(0, E, (2, 64))
    np.put_along_axis(logits, hot[..., None], 87.8, axis=-1)
    raw = torch.softmax(torch.from_numpy(logits), -1)
    assert bool(((raw > 0) & (raw < F32_TINY)).any()), \
        "the test row has no denormal probability"
    got, want = _route_both(logits, k, 64)
    _route_equal(got, want)
    # each token's first choice is its hot expert; the zero-probability
    # rest follow by index
    ranked = got[0].numpy().reshape(2, 64, k) // 64
    assert np.array_equal(ranked[..., 0], hot)


# ---------------------------------------------------------------------------
# moe_mlp_chunk / moe_mlp


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", SMOKES)
def test_moe_mlp_chunk_drops_and_matches_reference(arch, seed):
    cfg = get_config(arch)
    rw, pw = _layer0_mlp(arch, router_scale=30.0)
    # a shared component in every token makes one expert popular
    xj, xt = _bf16(np.random.default_rng(seed).normal(
        1.0, 1.0, (2, 32, cfg.d_model)))
    C = moe.expert_capacity(cfg, 32)
    keep = moe.route_tokens(
        torch.einsum("bsm,me->bse", xt.float(), pw["router"].float()),
        cfg.experts_per_token, C)[2]
    assert int((~keep).sum()) > 0, "no assignment was dropped"
    want_y, want_aux = jax.jit(
        lambda p, x: ref_moe.moe_mlp_chunk(p, x, ref_config(arch), None))(
            rw, xj)
    y, aux = moe.moe_mlp_chunk(pw, xt, cfg)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    within_one_bf16_step(y, want_y.astype(jnp.float32), f"{arch} chunk")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_mlp_runs_sequence_chunks_like_the_reference():
    arch = "granite-moe-3b-a800m-smoke"
    rcfg = ref_config(arch).replace(d_model=16, d_ff=16)
    cfg = get_config(arch).replace(d_model=16, d_ff=16)
    rp = ref_init(ref_moe.moe_defs(rcfg), jax.random.PRNGKey(3))
    pp = params_from_jax(jax.tree.map(np.asarray, rp))
    s = 2 * moe._MOE_SEQ_CHUNK
    xj, xt = _bf16(np.random.default_rng(4).normal(0, 1, (1, s, 16)))
    want_y, want_aux = jax.jit(
        lambda p, x: ref_moe.moe_mlp(p, x, rcfg, None))(rp, xj)
    y, aux = moe.moe_mlp(pp, xt, cfg)
    within_one_bf16_step(y, want_y.astype(jnp.float32), "moe_mlp")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        moe.moe_mlp(pp, xt[:, :s - 8], cfg)


# ---------------------------------------------------------------------------
# MoELM on the reference's weights


def _tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, (1, n)).astype(np.int32)


@pytest.mark.parametrize("arch", SMOKES)
def test_moelm_prefill_logits_and_cache_match_reference(arch):
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
    assert torch.isfinite(pm._last_aux)


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


def _xla_rsqrt(t: torch.Tensor) -> torch.Tensor:
    """The reference's rsqrt on the CPU (XLA's), on a torch tensor."""
    out = jax.jit(jax.lax.rsqrt)(t.detach().float().numpy())
    return torch.from_numpy(np.array(out)).to(t.dtype)


@pytest.mark.parametrize("arch,rsqrt", [
    ("granite-moe-3b-a800m-smoke", "torch"),
    ("granite-moe-3b-a800m-smoke", "xla"),
    ("dbrx-132b-smoke", "xla")])
def test_moelm_chunked_prefill_and_paged_decode_match_reference(
        arch, rsqrt, monkeypatch):
    """Two slots: chunked prefill of different prompts into shuffled pages,
    then four teacher-forced decode ticks through the page table (the
    port's kernel dispatch, whose plain version runs on the CPU).

    ``rsqrt="xla"`` gives the port's norms the reference's rsqrt.  XLA's
    CPU rsqrt is one f32 ulp off the correctly rounded value for ~15% of
    inputs, torch's for ~29%, and they differ from each other on ~36%.
    On ``dbrx-132b-smoke`` one such ulp moves one element of layer 0's
    first LayerNorm at slot 1's first decode token by a bf16 step; its
    random weights (fan-in over the stacked layer axis) make attention
    outputs of ~100, which carry that step to ~4% of max |logit|, past
    the allowance.  With the reference's rsqrt the two agree within it,
    so the MoE path itself is held; the greedy streams
    (``tests/test_torch_moe_serving.py``) are identical either way."""
    if rsqrt == "xla":
        monkeypatch.setattr(torch, "rsqrt", _xla_rsqrt)
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
    for slot, n in enumerate((13, 19)):
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


# ---------------------------------------------------------------------------
# Tuner: active parameters


@pytest.mark.parametrize("arch", MOE_ARCHS + SMOKES + ("deepseek-7b",))
def test_active_param_count_matches_reference(arch):
    got = active_param_count(get_config(arch))
    assert got == ref_active(ref_config(arch))
    if arch == "granite-moe-3b-a800m":  # "a800m": ~800 M active
        embeddings = 2 * get_config(arch).vocab_size * 1536
        assert 0.8e9 < got - embeddings < 0.9e9


def _plans(arch, target, **overrides):
    want = ref_tune(ref_config(arch),
                    dataclasses.replace(REF_SHAPES["decode_32k"], **overrides),
                    ref_target.get_target(target))
    got = tune(get_config(arch),
               dataclasses.replace(SHAPES["decode_32k"], **overrides),
               port_target.get_target(target))
    return got, want


@pytest.fixture(scope="module")
def grain_target():
    """A target whose peak rate over its memory rate is 10 flop a byte,
    registered with the same numbers in both packages."""
    for module in (ref_target, port_target):
        module.register(module.TargetSpec(
            name=GRAIN, chip="cpu", mesh_shape=(1,), mesh_axes=("data",),
            peak_flops=1e12, hbm_bw=1e11, hbm_bytes=80e9, ici_bw=1e9,
            scheduler="local", kernels="reference"))
    yield GRAIN
    for module in (ref_target, port_target):
        module.TARGETS.pop(GRAIN)


@pytest.mark.parametrize("arch", MOE_ARCHS + SMOKES)
@pytest.mark.parametrize("slots,max_len,replicas", [
    (8, 128, 1), (4, 512, 1), (8, 512, 3)])
def test_moe_serve_plan_matches_reference(arch, slots, max_len, replicas):
    got, want = _plans(arch, "local:cpu", seq_len=max_len,
                       global_batch=slots * replicas,
                       serve_replicas=replicas)
    for field in dataclasses.fields(got):
        if field.name.startswith("serve_") or field.name in (
                "microbatches", "remat_policy", "kernels",
                "sequence_parallel"):
            assert getattr(got, field.name) == getattr(want, field.name), \
                (arch, field.name)


def test_chunk_grain_prices_active_parameters(grain_target):
    got, want = _plans("granite-moe-3b-a800m", grain_target, seq_len=512,
                       global_batch=8)
    assert got.serve_prefill_chunk == want.serve_prefill_chunk == 32
    dense = _plans("deepseek-7b", grain_target, seq_len=512,
                   global_batch=8)
    assert dense[0].serve_prefill_chunk == dense[1].serve_prefill_chunk == 8
