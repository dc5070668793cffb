"""The port's VLM family (``repro_torch/models/vlm.py``), its config, the
float inputs of the synthetic source, the whole-batch decode and
``init_params`` in slices, against the JAX reference on the CPU, on the
reference's weights (``init_params`` under ``PRNGKey(0)``, crossed bit
for bit with ``params_from_jax``).

* ``llava-next-34b`` and its smoke equal the reference's configs field
  for field (dtypes by name), with the same skipped shapes; the tuner's
  serve and train plans for both equal the reference's on ``local:cpu``
  and on the port's ``nvidia:h100`` constants.
* The synthetic batches of the VLM's tables are the reference's bit for
  bit: the bf16 ``patch_embeds`` compared as int16, the tokens and the
  labels; a bf16 draw rounds through f32 as ml_dtypes does.
* Prefill logits and K/V, and 8 teacher-forced whole-batch decode steps
  over the prefill's padded cache, within two bf16 steps of the largest
  entry (``close``: XLA's CPU rsqrt is not correctly rounded, so a norm
  output can sit one bf16 step off; the model tests' allowance).
* The reference's own property (``tests/test_models_decode.py``):
  prefill(s) + one decode step equals prefill(s + 1), to that test's
  tolerance (5% of max |logit| + 0.05, and the top token on at least half
  the rows); in the port the two agree far closer, within two bf16
  steps.
* The whole-batch decode (a 0-d index) equals the slot-wise contiguous
  decode with every row at the same length, bit for bit.
* The smoke loss within rtol 1e-3 of the reference's (with torch's
  rsqrt and with XLA's); per-leaf gradients, on XLA's rsqrt (see
  ``test_grads_match_reference``), within the dense family's tolerances
  of ``tests/test_torch_train.py`` (relative L2 <= 1e-1 and within the
  control's distance, the unembedding and ``ln_f`` <= 2e-2);
  ``train_main`` for 3 steps within rtol 1e-3 of the reference's losses
  (``tests/test_torch_optim.py``).
* ``init_params`` draws a stacked leaf a layer at a time: the std of a
  stacked leaf is the whole leaf's law, 1/sqrt(layers); the largest f32
  draw is one layer's slice.
* On the card (``cuda``): K2 at the widths 7,168 (``llava-next-34b``)
  and 6,144 (``dbrx-132b``), where each thread holds two vectors.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.core.tuning import tune as ref_tune
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import SyntheticSource as RefSource
from repro.launch.train import train_main as ref_train_main
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training.steps import build_decode_step as ref_decode_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.target import get_target
from repro_torch.core.tuning import param_count_estimate, tune
from repro_torch.data.pipeline import SyntheticSource, to_device
from repro_torch.kernels import ref
from repro_torch.launch import train as port_train
from repro_torch.models import layers
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.transformer import DenseLM, model_for
from repro_torch.models.vlm import VLM
from repro_torch.training.steps import (build_decode_step,
                                        build_decode_step_slots,
                                        loss_and_grads)

ARCH, SMOKE = "llava-next-34b", "llava-next-34b-smoke"
BF16_STEP = 2.0 ** -7    # two bf16 rounding steps, relative
H100 = "test:h100-constants"


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


def _t(a) -> torch.Tensor:
    """A reference array as a torch tensor of the same bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


_MODELS: dict = {}


def models(arch=SMOKE):
    """(reference model, its params, port model, the same params)."""
    if arch not in _MODELS:
        rm = ref_model_for(ref_config(arch), remat="none")
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        pm = model_for(get_config(arch), remat="none")
        _MODELS[arch] = (rm, rp, pm,
                         params_from_jax(jax.tree.map(np.asarray, rp)))
    return _MODELS[arch]


def _batches(arch, s, b, kind="prefill", seed=0, step=0):
    """(reference batch as jnp arrays, the port's as tensors) of one
    synthetic draw each."""
    rm, _, pm, _ = models(arch)
    vocab = rm.cfg.vocab_size
    rb = RefSource(vocab, seed).batch(rm.batch_table(RefShape("p", s, b,
                                                              kind)), step)
    pb = to_device(SyntheticSource(vocab, seed).batch(
        pm.batch_table(ShapeConfig("p", s, b, kind)), step), "cpu")
    return {k: jnp.asarray(v) for k, v in rb.items()}, pb


# ---------------------------------------------------------------------------
# Config, plans


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_config_equals_the_reference_field_for_field(arch):
    port, want = get_config(arch), ref_config(arch)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(want, f.name)
        if f.name.endswith("_dtype"):
            assert str(a).split(".")[-1] == np.dtype(b).name, f.name
        else:
            assert a == b, (arch, f.name)
    assert ARCHS[arch]["skip_shapes"] == REF_ARCHS[arch]["skip_shapes"] == \
        ("long_500k",)
    assert isinstance(model_for(port), VLM)


def test_full_width_parameters_and_kv():
    """34.39 B parameters (68.78 GB of bf16) and 245,760 KV bytes a token:
    4 x 1,120 tokens take 1.10 GB, so the full model serves on one card."""
    cfg = get_config(ARCH)
    n = param_count_estimate(cfg)
    assert n == 34_388_917_248
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    assert kv == 245_760 and abs(kv * 4 * 1120 / 1e9 - 1.10) < 0.01


def _h100_constants():
    h = get_target("nvidia:h100")
    if H100 not in ref_target.TARGETS:
        ref_target.register(ref_target.TargetSpec(
            name=H100, chip="h100", mesh_shape=h.mesh_shape,
            mesh_axes=h.mesh_axes, peak_flops=h.peak_flops, hbm_bw=h.hbm_bw,
            hbm_bytes=h.hbm_bytes, ici_bw=h.ici_bw, scheduler="local"))
    return H100


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
@pytest.mark.parametrize("shape,over", [
    ("prefill_32k", {"seq_len": 1088, "global_batch": 4}),
    ("prefill_32k", {}),
    ("decode_32k", {"seq_len": 1120, "global_batch": 4}),
    ("train_4k", {"seq_len": 1024, "global_batch": 4})])
def test_plans_equal_reference(arch, shape, over):
    for target, ref_name in (("local:cpu", "local:cpu"),
                             ("nvidia:h100", _h100_constants())):
        got = tune(get_config(arch), dataclasses.replace(SHAPES[shape],
                                                         **over),
                   get_target(target))
        want = ref_tune(ref_config(arch),
                        dataclasses.replace(REF_SHAPES[shape], **over),
                        ref_target.get_target(ref_name))
        for f in dataclasses.fields(got):
            if f.name.startswith("serve_") or f.name in (
                    "microbatches", "remat_policy", "kernels",
                    "sequence_parallel", "optimizer", "grad_accum_dtype",
                    "grad_compression") or (shape == "train_4k" and
                                            f.name in ("notes", "napkin")):
                want_v = getattr(want, f.name)
                if want_v == "pallas":  # the reference's TPU kernels are
                    want_v = "cuda"     # the port's CUDA ones
                assert getattr(got, f.name) == want_v, (target, f.name)


# ---------------------------------------------------------------------------
# Float inputs


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 13), (3, 9999)])
def test_float_batch_is_the_reference_bit_for_bit(kind, seed, step):
    rm, _, pm, _ = models()
    vocab = rm.cfg.vocab_size
    table = pm.batch_table(ShapeConfig("t", 40, 3, kind))
    assert list(table) == list(rm.batch_table(RefShape("t", 40, 3, kind)))
    got = SyntheticSource(vocab, seed).batch(table, step)
    want = RefSource(vocab, seed).batch(
        rm.batch_table(RefShape("t", 40, 3, kind)), step)
    assert set(got) == set(want) == ({"patch_embeds", "tokens", "labels"}
                                     if kind == "train"
                                     else {"patch_embeds", "tokens"})
    pe = got["patch_embeds"]
    assert pe.dtype == torch.bfloat16 and pe.shape == (3, 16, 64)
    assert np.array_equal(pe.view(torch.int16).numpy(),
                          want["patch_embeds"].view(np.int16))
    for k in set(want) - {"patch_embeds"}:
        assert got[k].dtype == np.int32
        assert np.array_equal(got[k], want[k]), k
    # the training pipeline puts both kinds of leaf on the device
    if kind == "train":
        ref_pipe = RefPipeline(rm, RefShape("t", 40, 3, kind), seed=seed)
        from repro_torch.data.pipeline import DataPipeline
        port_pipe = DataPipeline(pm, ShapeConfig("t", 40, 3, kind),
                                 seed=seed)
        a, b = port_pipe.batch_at(step), ref_pipe.batch_at(step)
        for k in b:
            assert np.array_equal(_f32(a[k]), _f32(b[k])), k


def test_bf16_draws_round_through_f32_as_ml_dtypes():
    """A float64 draw rounded straight to bf16 can differ from one rounded
    to f32 first (1 + 2^-8 + 2^-30: 0x3F81 straight, 0x3F80 through f32);
    the reference's ``astype`` rounds through f32, and so does the port."""
    x = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -29), 0.02])
    want = x.astype(ml_dtypes.bfloat16).view(np.int16)
    got = torch.from_numpy(x).to(torch.float32).to(torch.bfloat16)
    assert np.array_equal(got.view(torch.int16).numpy(), want)
    assert hex(int(want[0]) & 0xFFFF) == "0x3f80"


# ---------------------------------------------------------------------------
# Prefill and whole-batch decode


def _pad(cache, n):
    """The legacy path's growth of a prefill's K/V by ``n`` positions."""
    out = dict(cache)
    for key in ("k", "v"):
        c = cache[key]
        if isinstance(c, torch.Tensor):
            out[key] = torch.cat([c, c.new_zeros(c.shape[:2] + (n,) +
                                                 c.shape[3:])], dim=2)
        else:
            out[key] = jnp.pad(c, [(0, 0)] * 2 + [(0, n)] +
                               [(0, 0)] * (c.ndim - 3))
    return out


@pytest.mark.parametrize("s,b", [(24, 2), (40, 3)])
def test_prefill_and_decode_match_reference(s, b):
    rm, rp, pm, pp = models()
    rb, pb = _batches(SMOKE, s, b, seed=s)
    rl, rc = jax.jit(lambda p, x: rm.prefill(p, x, None))(rp, rb)
    with torch.no_grad():
        pl, pc = pm.prefill(pp, pb)
    assert pl.shape == (b, 1, rm.cfg.vocab_size)
    close(pl, rl, "prefill logits")
    close(pc["k"], rc["k"], "prefill K")
    close(pc["v"], rc["v"], "prefill V")
    assert (pc["index"].dim(), int(pc["index"]), pc["layout"]) == \
        (0, s, "contiguous")
    steps = 8
    rc, pc = _pad(rc, steps), _pad(pc, steps)
    ref_decode = jax.jit(ref_decode_step(rm))
    decode = build_decode_step(pm)
    toks = np.random.default_rng(s).integers(
        1, rm.cfg.vocab_size - 1, (steps, b, 1)).astype(np.int32)
    for i in range(steps):
        rl, rc = ref_decode(rp, rc, jnp.asarray(toks[i]))
        pl, pc = decode(pp, pc, torch.from_numpy(toks[i]))
        close(pl, rl, f"decode step {i}")
        assert int(pc["index"]) == int(rc["index"]) == s + i + 1
        assert pc["index"].dim() == 0 and pc["index"].device.type == "cpu"
    close(pc["k"], rc["k"], "decode K")


@pytest.mark.parametrize("arch", [SMOKE, "deepseek-7b-smoke"])
def test_prefill_plus_decode_matches_longer_prefill(arch):
    """The reference's property of ``tests/test_models_decode.py``, in the
    port: prefill on s positions then one decode step gives the logits of
    a prefill on s + 1 (the reference's tolerance, and two bf16 steps)."""
    if arch == SMOKE:
        _, _, pm, pp = models(arch)
    else:
        pm = model_for(get_config(arch), remat="none")
        pp = params_from_jax(jax.tree.map(np.asarray, ref_init(
            ref_model_for(ref_config(arch)).param_table(),
            jax.random.PRNGKey(0))))
    s = 32
    src = SyntheticSource(pm.cfg.vocab_size, 0)
    long = to_device(src.batch(pm.batch_table(
        ShapeConfig("p", s + 1, 2, "prefill")), 0), "cpu")
    short = dict(long, tokens=long["tokens"][:, :-1])
    with torch.no_grad():
        want, _ = pm.prefill(pp, long)
        _, cache = pm.prefill(pp, short)
        got, _ = build_decode_step(pm)(pp, _pad(cache, 1),
                                       long["tokens"][:, -1:])
    a, b = _f32(want[:, -1]), _f32(got[:, -1])
    assert np.abs(a - b).max() < 0.05 * (np.abs(a).max() + 1)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5
    close(got[:, -1], a, f"{arch} decode vs longer prefill")


@pytest.mark.parametrize("arch", [SMOKE, "deepseek-7b-smoke"])
def test_whole_batch_decode_equals_slot_decode_bit_for_bit(arch):
    """A 0-d index (every row at one length, the legacy path's cache) and a
    (b,) index holding that length in every row (the contiguous pool's
    slot-wise decode): the same logits and K/V, bit for bit."""
    pm = model_for(get_config(arch), remat="none")
    pp = init_params(pm.param_table(), torch.Generator().manual_seed(1),
                     "cpu")
    b, s = 3, 20
    src = SyntheticSource(pm.cfg.vocab_size, 1)
    batch = to_device(src.batch(pm.batch_table(
        ShapeConfig("p", s, b, "prefill")), 0), "cpu")
    with torch.no_grad():
        _, cache = pm.prefill(pp, batch)
    whole = _pad(cache, 6)
    slots = dict(whole, k=whole["k"].clone(), v=whole["v"].clone(),
                 index=torch.full((b,), s, dtype=torch.int32))
    decode, slot_decode = build_decode_step(pm), build_decode_step_slots(pm)
    active = torch.ones(b, dtype=torch.int32)
    toks = torch.randint(1, pm.cfg.vocab_size - 1, (5, b, 1),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    for i in range(5):
        lw, whole = decode(pp, whole, toks[i])
        ls, slots = slot_decode(pp, slots, toks[i], active)
        assert torch.equal(lw, ls), i
        assert torch.equal(slots["index"],
                           torch.full((b,), int(whole["index"]),
                                      dtype=torch.int32))
    assert torch.equal(whole["k"], slots["k"])
    assert torch.equal(whole["v"], slots["v"])
    with pytest.raises(ValueError, match="0-d index"):
        decode(pp, slots, toks[0])


# ---------------------------------------------------------------------------
# Loss, gradients, training


def _train_batch(seed=0):
    rm, _, pm, _ = models()
    rb = RefPipeline(rm, RefShape("t", 48, 4, "train"), seed=seed) \
        .batch_at(0)
    return rb, {k: _t(v) for k, v in rb.items()}


def _xla_rsqrt(t: torch.Tensor) -> torch.Tensor:
    """The reference's rsqrt on the CPU (XLA's), on a torch tensor."""
    out = jax.jit(jax.lax.rsqrt)(t.detach().float().numpy())
    return torch.from_numpy(np.array(out)).to(t.dtype)


@pytest.mark.parametrize("rsqrt", ["torch", "xla"])
def test_loss_matches_reference(rsqrt, monkeypatch):
    if rsqrt == "xla":
        monkeypatch.setattr(torch, "rsqrt", _xla_rsqrt)
    rm, rp, pm, pp = models()
    rb, pb = _train_batch()
    loss_ref, _ = jax.jit(lambda p, b: rm.loss(p, b, None))(rp, rb)
    with torch.no_grad():
        loss, _ = pm.loss(pm.train_leaves(pp), pb)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-3)


def test_grads_match_reference(monkeypatch):
    """Per-leaf gradients on the reference's rsqrt.  With torch's, the
    block gradients of this smoke model sit 0.14-0.36 (relative L2) from
    the reference's, past the dense family's 1e-1, and the control sits
    0.18-0.41 from them: XLA's CPU rsqrt is not correctly rounded, its
    norms move a bf16 step, and the random-weight model carries that step
    to the gradients.  With XLA's rsqrt in the port every leaf is within
    0.011 and the loss is equal, so the VLM's own path is held to the
    dense family's tolerances (as the ``dbrx-132b-smoke`` decode test
    does, tests/test_torch_moe.py)."""
    monkeypatch.setattr(torch, "rsqrt", _xla_rsqrt)
    rm, rp, pm, pp = models()
    rb, pb = _train_batch()
    fn = jax.jit(jax.value_and_grad(lambda p, b: rm.loss(p, b, None),
                                    has_aux=True))
    (loss_ref, _), g_ref = fn(rp, rb)
    loss, _, g = loss_and_grads(pm, pp, pb)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-3)
    # the control: each block's second norm of the rounded residual sum
    mp = pytest.MonkeyPatch()
    plain = layers.add_norm
    mp.setattr(layers, "add_norm", lambda p, x, a, kind, norm_of_rounded=True:
               plain(p, x, a, kind, norm_of_rounded=True))
    try:
        _, _, g_ctrl = loss_and_grads(pm, pp, pb)
    finally:
        mp.undo()

    def pairs(r, p, c, path=()):
        if isinstance(r, dict):
            for k in r:
                yield from pairs(r[k], p[k], c[k], path + (k,))
        else:
            st = (lambda t: torch.stack(t) if isinstance(t, list) else t)
            yield "/".join(path), r, st(p), st(c)
    seen = 0
    for path, want, got, ctrl in pairs(g_ref, g, g_ctrl):
        assert got.dtype == torch.bfloat16 and \
            got.shape == tuple(want.shape), path
        rel, ctrl_rel = _rel(got, want), _rel(ctrl, got)
        if path.startswith(("embed/unembed", "ln_f")):
            assert rel <= 2e-2, (path, rel)
        assert rel <= 1e-1 and rel <= ctrl_rel, (path, rel, ctrl_rel)
        seen += 1
    assert seen == len(jax.tree.leaves(g_ref))


def test_loss_reads_text_positions_only():
    """Labels on the patches would change the loss; the VLM's loss is the
    mean over the text positions, as the reference's: a logit change at a
    patch position leaves it as it is."""
    _, _, pm, pp = models()
    _, pb = _train_batch(seed=3)
    leaves = pm.train_leaves(pp)
    logits, _ = pm.full_forward(leaves, pb)
    assert logits.shape[1] == pb["tokens"].shape[1]
    want = layers.softmax_xent(logits, pb["labels"])
    loss, _ = pm.loss(leaves, pb)
    assert torch.equal(loss, want)


def test_train_main_matches_reference(monkeypatch):
    """``train_main`` on the smoke VLM for 3 steps on the reference's
    weights and batches: every loss within rtol 1e-3."""
    def draw(table, generator, device):
        assert table == models()[2].param_table()
        return params_from_jax(jax.tree.map(np.asarray, models()[1]),
                               device)
    monkeypatch.setattr(port_train, "init_params", draw)
    kw = dict(arch=SMOKE, steps=3, seq_len=48, global_batch=4,
              log=lambda *a, **k: None)
    want = ref_train_main(**kw)
    got = port_train.train_main(**kw, device="cpu")
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-3)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)
    assert len(got["losses"]) == 3


# ---------------------------------------------------------------------------
# init_params in slices


def test_init_draws_a_stacked_leaf_a_layer_at_a_time(monkeypatch):
    cfg = get_config(SMOKE).replace(num_layers=16, d_model=256, d_ff=512)
    table = model_for(cfg).param_table()
    sizes = []
    randn = torch.randn

    def spy(*shape, **kw):
        out = randn(*shape, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", spy)
    params = init_params(table, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.undo()
    wi = params["blocks"]["mlp"]["wi"]
    assert wi.shape == (16, 256, 512) and wi.dtype == torch.bfloat16
    # the reference's law on the whole leaf: 1/sqrt(layers), not the
    # slice's own shape[0] (the model width)
    std = float(wi.float().std())
    assert abs(std - 1 / math.sqrt(16)) < 0.01 * (1 / math.sqrt(16)), std
    per_layer = [float(wi[i].float().std()) for i in range(16)]
    assert max(per_layer) / min(per_layer) < 1.02
    # every layer drawn anew, not one slice repeated
    assert not torch.equal(wi[0], wi[1])
    # the largest f32 draw is one layer of the largest stacked leaf or the
    # embedding, never a whole stacked leaf
    emb = cfg.vocab_size * cfg.d_model
    assert max(sizes) == max(256 * 512, emb)
    assert 16 * 256 * 512 not in sizes
    assert float(params["embed"]["embedding"].float().std()) == \
        pytest.approx(0.02, rel=0.05)
    assert torch.equal(params["blocks"]["ln1"]["scale"],
                       torch.ones((16, 256), dtype=torch.bfloat16))


def test_init_bits_repeat_from_the_seed():
    table = model_for(get_config(SMOKE)).param_table()
    a = init_params(table, torch.Generator().manual_seed(5), "cpu")
    b = init_params(table, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_vlm_is_a_dense_backbone():
    rm, _, pm, _ = models()
    assert isinstance(pm, DenseLM) and pm.loss_from == 16
    assert pm.param_table() == DenseLM(get_config(SMOKE)).param_table()
    assert list(pm.batch_table(ShapeConfig("d", 64, 2, "decode"))) == \
        ["tokens"]
    with pytest.raises(ValueError, match="no text"):
        pm.batch_table(ShapeConfig("p", 16, 2, "prefill"))


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7168, 6144])
@pytest.mark.parametrize("rows", [4, 4352])
def test_k2_at_two_vectors_a_thread_on_the_card(cuda, d, rows):
    from repro_torch.kernels.rmsnorm import (add_rmsnorm_cuda, plan,
                                             rmsnorm_cuda)
    assert plan(d)[1] == 2
    g = torch.Generator(device="cuda").manual_seed(d + rows)
    x = (3 * torch.randn((rows, d), generator=g, device="cuda")).bfloat16()
    a = torch.randn((rows, d), generator=g, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).bfloat16()
    y, want = rmsnorm_cuda(x, w), ref.rmsnorm_ref(x, w)
    lim = 1e-4 + 2.0 ** -7 * want.float().abs()
    assert bool(((y.float() - want.float()).abs() <= lim).all())
    for rounded in (False, True):
        r, y = add_rmsnorm_cuda(x, a, w, norm_of_rounded=rounded)
        r_w, y_w = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=rounded)
        assert torch.equal(r.view(torch.int16), r_w.view(torch.int16))
        lim = 1e-4 + 2.0 ** -7 * y_w.float().abs()
        assert bool(((y.float() - y_w.float()).abs() <= lim).all())
