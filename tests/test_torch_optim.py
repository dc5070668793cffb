"""The training substrate of the port against the JAX reference on the
CPU: optimizer, schedule, error feedback, data pipeline, checkpoints,
fault tolerance, the tuner's train plans and the train entry points.

* ``AdamW`` and ``AdamW8bit`` (``repro_torch/optim/adamw.py``) on the
  same gradients and state as the reference's: over five steps whose
  global norm stays under the clip, parameters, f32 moments, int8
  moments, their scales and the count are equal bit for bit.  Where the
  norm clips, the norm differs by a few f32 ulps (XLA sums the squares
  in another order), which moves the scale and so the f32 moments by
  tens of ulps (held to rtol 1e-5); AdamW's parameters stay bit-equal,
  and AdamW8bit's int8 moments, and so its parameters, differ in at most
  1% of the entries (an int8 moment by one step, a bf16 weight by at
  most 4 steps).
* The update runs layer by layer (and by chunks of rows); it equals the
  whole-leaf update bit for bit, and a gradient given per layer equals
  the same gradient stacked.
* ``_ef_int8`` equals the reference's bit for bit, and with a per-layer
  split keeps the whole leaf's amax.
* ``warmup_cosine``: given XLA's cos, within 2 f32 ulps of the
  reference's at every step of several schedules (XLA contracts
  ``0.1 + 0.45 * (1 + cos)`` into a fused multiply-add).  XLA's CPU
  ``cos`` itself is not correctly rounded: one ulp from torch's on the
  schedule's angles, up to 6 ulps of the learning rate where ``1 + cos``
  cancels (both asserted).
* ``DataPipeline`` batches equal the reference's exactly for several
  (seed, step).
* Checkpoint archives (``arrays.npz`` and ``meta.json``) of the same
  train state under a fixed clock are byte-identical to the reference's,
  and each package restores the other's; plus twins of the reference's
  ``test_checkpoint_ft.py`` and ``test_optimizer.py`` cases.
* Train plans equal the reference's for every ported arch, smoke and
  full, on ``local:cpu`` and on a target with the H100's constants
  (``deepseek-7b`` at ``train_4k`` escalates to 128 microbatches).
* ``train_main``, ``run_command("train ...")`` and ``run_easey`` of a
  training Appfile, on the reference's weights: first and final loss
  within rtol 1e-3 of the reference's, the same restarts, and a restart
  from a checkpoint equal to the uninterrupted run bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.core.appspec import parse_appfile as ref_parse_appfile
from repro.core.jobspec import parse_jobspec as ref_parse_jobspec
from repro.core.tuning import tune as ref_tune
from repro.core.workflow import run_easey as ref_run_easey
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.launch.train import train_main as ref_train_main
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.optim import AdamW as RefAdamW
from repro.optim import AdamW8bit as RefAdamW8bit
from repro.optim.schedule import warmup_cosine as ref_warmup_cosine
from repro.training.steps import _ef_int8 as ref_ef_int8
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.appspec import parse_appfile
from repro_torch.core.build import BuildService
from repro_torch.core.jobspec import parse_jobspec
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.target import get_target
from repro_torch.core.tuning import tune
from repro_torch.core.workflow import run_easey
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.launch import train as port_train
from repro_torch.launch.run import run_command
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.optim import AdamW, AdamW8bit
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 HeartbeatMonitor,
                                                 SimulatedFailure,
                                                 StragglerMonitor,
                                                 run_with_restarts)
from repro_torch.training.steps import (_ef_int8, build_train_step,
                                        init_train_state, train_state_table)

BF16 = ml_dtypes.bfloat16
H100 = "test:h100-constants"
LM_ARCHS = sorted(a for a in ARCHS if ARCHS[a]["full"].family != "stencil")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    """A port tensor as the reference's numpy array (bf16 by its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ------------------------------------------------------------ optimizer

def _opt_tree(rng, scale, one=1.0):
    return {"blocks": {"w": (rng.randn(3, 16, 32) * scale).astype(BF16),
                       "s": (one + rng.randn(3, 32) * scale).astype(BF16)},
            "embed": {"e": (rng.randn(50, 32) * scale).astype(BF16)}}


def _run_both(ref_cls, cls, grad_scale, steps=5):
    rng = np.random.RandomState(0)
    params, grads = _opt_tree(rng, 1.0), _opt_tree(rng, grad_scale, 0.0)
    ro, po = ref_cls(), cls()
    rp = jax.tree.map(jnp.asarray, params)
    rs = ro.init(rp)
    pp = params_from_jax(params)
    ps = po.init(pp)
    for step in range(steps):
        g = jax.tree.map(lambda a: (a * (step + 1)).astype(a.dtype), grads)
        rp, rs, rm = ro.update(jax.tree.map(jnp.asarray, g), rs, rp,
                               jnp.float32(1e-2))
        pp, ps, pm = po.update(params_from_jax(g), ps, pp,
                               torch.tensor(1e-2))
    return (rp, rs, rm), (pp, ps, pm)


@pytest.mark.parametrize("ref_cls,cls", [(RefAdamW, AdamW),
                                         (RefAdamW8bit, AdamW8bit)])
def test_update_equals_reference_bit_for_bit(ref_cls, cls):
    (rp, rs, rm), (pp, ps, pm) = _run_both(ref_cls, cls, 3e-3)
    assert float(pm["grad_norm"]) < 1.0           # the clip is not hit
    # XLA sums the squares in another order; unclipped, the norm moves
    # nothing else
    np.testing.assert_allclose(_np(pm["grad_norm"]), rm["grad_norm"],
                               rtol=1e-5)
    ref = dict(_flat({"p": jax.tree.map(np.asarray, rp),
                      "s": jax.tree.map(np.asarray, rs)}))
    got = dict(_flat({"p": pp, "s": ps}))
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].dtype == _np(got[k]).dtype, k
        assert np.array_equal(ref[k].reshape(-1).view(np.uint8),
                              _np(got[k]).reshape(-1).view(np.uint8)), k


@pytest.mark.parametrize("ref_cls,cls", [(RefAdamW, AdamW),
                                         (RefAdamW8bit, AdamW8bit)])
def test_clipped_update_differs_only_by_the_norm_s_sum_order(ref_cls, cls):
    (rp, rs, rm), (pp, ps, pm) = _run_both(ref_cls, cls, 1.0)
    assert float(pm["grad_norm"]) > 1.0            # the clip is hit
    # XLA sums the squares in another order: a few f32 ulps of the norm
    assert _ulps(rm["grad_norm"], _np(pm["grad_norm"])) <= 16
    ref = dict(_flat({"p": jax.tree.map(np.asarray, rp),
                      "s": jax.tree.map(np.asarray, rs)}))
    for k, t in _flat({"p": pp, "s": ps}):
        got, want = _np(t), ref[k]
        if want.dtype == np.int8:
            off = np.abs(got.astype(int) - want.astype(int))
            assert off.max() <= 1 and (off > 0).mean() <= 0.01, k
        elif want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
        elif cls is AdamW or want.dtype != BF16:
            assert np.array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8)), k
        else:
            # a weight whose int8 moment moved by one step (a small
            # sqrt(v) most): a few bf16 steps
            off = _ulps(got.astype(np.float32), want.astype(np.float32))
            assert off.max() <= 4 << 16 and (off > 0).mean() <= 0.01, k


@pytest.mark.parametrize("cls", [AdamW, AdamW8bit])
def test_sliced_update_equals_whole_leaf_update(cls, monkeypatch):
    """Layer by layer (a stacked leaf), by chunks of rows (a large
    unstacked one) and with per-layer gradients: the same bits as one
    update of each whole leaf."""
    rng = np.random.RandomState(1)
    params, grads = _opt_tree(rng, 1.0), _opt_tree(rng, 0.5)

    def run(slicing, per_layer):
        if slicing == "whole":
            monkeypatch.setattr(adamw_mod, "slices",
                                lambda path, shape: [slice(None)])
        else:
            monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", 7 * 32)
        opt = cls()
        p = params_from_jax(params)
        st = opt.init(p)
        for step in range(3):
            g = params_from_jax(grads)
            if per_layer:
                g["blocks"] = {k: list(v) for k, v in g["blocks"].items()}
            opt.update(g, st, p, torch.tensor(1e-2 * (step + 1)))
        monkeypatch.undo()
        return dict(_flat({"p": p, "s": st}))

    whole = run("whole", False)
    assert adamw_mod.slices(("embed", "e"), (50, 32)) == [slice(None)]
    for per_layer in (False, True):
        sliced = run("rows", per_layer)
        for k in whole:
            assert torch.equal(whole[k], sliced[k]), (k, per_layer)
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", 7 * 32)
    assert len(adamw_mod.slices(("embed", "e"), (50, 32))) == 8
    assert adamw_mod.slices(("blocks", "w"), (3, 16, 32)) == [0, 1, 2]


def test_ef_int8_equals_reference_and_keeps_the_whole_leaf_amax():
    rng = np.random.RandomState(0)
    g = (rng.randn(4, 64) * 1e-3).astype(BF16)
    err = (rng.randn(4, 64) * 1e-6).astype(np.float32)
    deq_r, err_r = ref_ef_int8(jnp.asarray(g), jnp.asarray(err))
    deq, new = _ef_int8(params_from_jax(g), torch.from_numpy(err))
    assert np.array_equal(np.asarray(deq_r), deq.numpy())
    assert np.array_equal(np.asarray(err_r), new.numpy())
    # one layer at a time with the whole leaf's amax: the same bits
    gt, et = params_from_jax(g), torch.from_numpy(err)
    amax = (gt.float() + et).abs().amax()
    for i in range(4):
        d_i, e_i = _ef_int8(gt[i], et[i], amax)
        assert torch.equal(d_i, deq[i]) and torch.equal(e_i, new[i])
    # a layer alone would take its own amax and other bits
    i = int((gt.float() + et).abs().amax(dim=1).argmin())
    d_i, _ = _ef_int8(gt[i], et[i])
    assert (gt[i].float() + et[i]).abs().amax() < amax
    assert not torch.equal(d_i, deq[i])


def test_ef_int8_error_feedback_reduces_bias():
    rng = np.random.RandomState(0)
    g = torch.from_numpy((rng.randn(256) * 1e-3).astype(np.float32))
    err = torch.zeros_like(g)
    total_q = torch.zeros_like(g)
    for _ in range(64):
        q, err = _ef_int8(g, err)
        total_q = total_q + q
    rel = float((total_q - 64 * g).norm() / (64 * g).norm())
    assert rel < 0.05, rel


def _xla_cos(t: torch.Tensor) -> torch.Tensor:
    """The reference's cos on the CPU (XLA's), on a torch tensor."""
    return torch.from_numpy(np.array(jax.jit(jnp.cos)(t.numpy())))


def _schedules(warmup, total, cos=None):
    steps = sorted(set(range(0, min(total, 300) + 5)) |
                   set(range(max(total - 300, 0), total + 5)))
    mp = pytest.MonkeyPatch()
    if cos is not None:
        mp.setattr(torch, "cos", cos)
    try:
        got = np.array([np.float32(warmup_cosine(
            torch.tensor(s, dtype=torch.int32), peak_lr=3e-4,
            warmup_steps=warmup, total_steps=total)) for s in steps])
    finally:
        mp.undo()
    want = np.array([np.float32(ref_warmup_cosine(
        jnp.asarray(s, jnp.int32), peak_lr=3e-4, warmup_steps=warmup,
        total_steps=total)) for s in steps])
    return np.array(steps), got, want


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (5, 100),
                                          (100, 10_000), (2, 10)])
def test_warmup_cosine_within_two_ulps_of_reference(warmup, total):
    """Given XLA's cos, the schedule is within 2 f32 ulps of the
    reference's: XLA contracts its 0.1 + 0.45 * (1 + cos) into a fused
    multiply-add.  The warm-up steps are exact."""
    steps, got, want = _schedules(warmup, total, cos=_xla_cos)
    assert _ulps(got, want).max() <= 2
    warm = steps < warmup
    assert np.array_equal(got[warm], want[warm])


def test_cos_is_the_other_difference():
    """With torch's own cos: XLA's CPU cos is not correctly rounded, and
    its one-ulp differences (asserted on the schedule's angles) become up
    to 6 ulps of the learning rate where cos is near -1 (``1 + cos``
    cancels); held here to that."""
    frac = torch.linspace(0, 1, 4097)
    angles = torch.pi * frac
    assert _ulps(torch.cos(angles).numpy(), _xla_cos(angles).numpy()) \
        .max() <= 1
    _, got, want = _schedules(100, 10_000)
    assert _ulps(got, want).max() <= 6


def test_warmup_cosine_shape():
    lr = [float(warmup_cosine(s, peak_lr=1e-3, warmup_steps=10,
                              total_steps=100)) for s in (0, 10, 100)]
    assert lr[0] == 0.0 and abs(lr[1] - 1e-3) < 1e-9 and lr[2] < 2e-4


def _quadratic(n=8, seed=0):
    rng = np.random.RandomState(seed)
    target = torch.from_numpy(rng.randn(n).astype(np.float32))
    return {"w": torch.zeros(n)}, target


@pytest.mark.parametrize("cls,limit", [(AdamW, 1e-2), (AdamW8bit, 0.3)])
def test_optimizer_converges_on_a_quadratic(cls, limit):
    """Twins of the reference's test_adamw_converges_quadratic and
    test_adamw8bit_tracks_fp32."""
    params, target = _quadratic(16 if cls is AdamW8bit else 8)
    opt = cls(weight_decay=0.0)
    st = opt.init(params)
    for _ in range(300 if cls is AdamW else 100):
        g = {"w": 2 * (params["w"] - target)}
        opt.update(g, st, params, torch.tensor(0.05))
    assert float(((params["w"] - target) ** 2).sum()) < limit


def test_state_table_matches_init_structure():
    m = model_for(get_config("deepseek-7b-smoke"))
    table = m.param_table()
    from repro_torch.models.params import init_params
    params = init_params(table, torch.Generator().manual_seed(0), "cpu")
    for opt in (AdamW(), AdamW8bit()):
        declared = dict(_flat(opt.state_table(table)))
        actual = dict(_flat(opt.init(params)))
        assert declared.keys() == actual.keys()
        for k, d in declared.items():
            assert (d.shape, d.dtype) == (tuple(actual[k].shape),
                                          actual[k].dtype), k
    plan = DeploymentPlan(arch="x", shape="t", target="cpu",
                          mesh_shape=(1,), mesh_axes=("data",),
                          grad_compression="ef_int8")
    st = init_train_state(m, AdamW8bit(), params, plan)
    declared = dict(_flat(train_state_table(m, AdamW8bit(), plan)))
    assert declared.keys() == dict(_flat(st)).keys()


@pytest.mark.parametrize("micro", [2, 4])
def test_grad_accumulation_equivalence(micro):
    """Microbatched gradients == full-batch gradients (same update)."""
    cfg = get_config("stablelm-1.6b-smoke")
    model = model_for(cfg, remat="none")
    rm = ref_model_for(ref_config("stablelm-1.6b-smoke"))
    rp = jax.tree.map(np.asarray, ref_init(rm.param_table(),
                                           jax.random.PRNGKey(micro)))
    batch = DataPipeline(model, ShapeConfig("t", 16, 4, "train"),
                         seed=micro).batch_at(0)
    outs = []
    for m in (1, micro):
        plan = DeploymentPlan(arch="x", shape="t", target="cpu",
                              mesh_shape=(1,), mesh_axes=("data",),
                              microbatches=m)
        opt = AdamW(weight_decay=0.0)
        state = init_train_state(model, opt, params_from_jax(rp), plan)
        state, _ = build_train_step(model, opt, plan)(state, batch)
        outs.append(dict(_flat(state["params"])))
    for k in outs[0]:
        np.testing.assert_allclose(outs[0][k].float().numpy(),
                                   outs[1][k].float().numpy(),
                                   rtol=2e-2, atol=2e-3, err_msg=k)


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("arch", ["deepseek-7b-smoke", "stablelm-1.6b-smoke",
                                  "granite-moe-3b-a800m-smoke"])
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 13), (3, 9999),
                                       (2**20, 1)])
def test_batches_equal_reference(arch, seed, step):
    shape = ShapeConfig("t", 32, 2, "train")
    got = DataPipeline(model_for(get_config(arch)), shape,
                       seed=seed).batch_at(step)
    want = RefPipeline(ref_model_for(ref_config(arch)),
                       RefShape("t", 32, 2, "train"), seed=seed).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    t, lab = got["tokens"].numpy(), got["labels"].numpy()
    np.testing.assert_array_equal(lab[:, :-1], t[:, 1:])
    assert t.min() >= 0 and t.max() < get_config(arch).vocab_size


def test_source_refuses_float_inputs():
    """Float inputs are no longer refused: an f32 leaf is the reference's
    draw bit for bit, in the stream after the int leaves before it (the
    bf16 patches are held in tests/test_torch_vlm.py).  A dtype that is
    neither int32 nor float is refused."""
    from repro.models.params import ParamDef as RefDef
    from repro.data.pipeline import SyntheticSource as RefSource
    from repro_torch.models.params import ParamDef
    got = SyntheticSource(256, 3).batch(
        {"tokens": ParamDef((2, 4), (None, None), torch.int32),
         "frames": ParamDef((2, 5), (None, None), torch.float32)}, 1)
    want = RefSource(256, 3).batch(
        {"tokens": RefDef((2, 4), (None, None), jnp.int32),
         "frames": RefDef((2, 5), (None, None), jnp.float32)}, 1)
    assert got["frames"].dtype == torch.float32
    assert np.array_equal(got["frames"].numpy().view(np.int32),
                          want["frames"].view(np.int32))
    assert np.array_equal(got["tokens"], want["tokens"])
    with pytest.raises(ValueError, match="no synthetic draw"):
        SyntheticSource(256).batch(
            {"mask": ParamDef((2, 4), (None, None), torch.bool)}, 0)


# ------------------------------------------------------------ checkpoints

def _train_states(optimizer="adamw8bit", ef="ef_int8"):
    """The reference's init_train_state for deepseek-7b-smoke, one step
    in, and the port's copy of it."""
    from repro.core.plan import DeploymentPlan as RefPlan
    from repro.optim import make_optimizer as ref_make
    from repro.training.steps import build_train_step as ref_build
    from repro.training.steps import init_train_state as ref_init_state
    rm = ref_model_for(ref_config("deepseek-7b-smoke"), remat="none")
    rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
    plan = RefPlan(arch="x", shape="t", target="cpu", mesh_shape=(1,),
                   mesh_axes=("data",), optimizer=optimizer,
                   grad_compression=ef)
    opt = ref_make(optimizer)
    st = ref_init_state(rm, opt, rp, plan)
    batch = RefPipeline(rm, RefShape("t", 16, 2, "train"), seed=0).batch_at(0)
    st, _ = jax.jit(ref_build(rm, opt, plan, warmup_steps=1))(st, batch)
    return st, params_from_jax(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("optimizer,ef", [("adamw8bit", "ef_int8"),
                                          ("adamw", "none")])
def test_archive_byte_identical_to_reference_and_cross_restores(
        tmp_path, optimizer, ef):
    ref_state, state = _train_states(optimizer, ef)
    RefCheckpointer(tmp_path / "ref", now=lambda: 1234.5).save(3, ref_state)
    Checkpointer(tmp_path / "port", now=lambda: 1234.5).save(3, state)
    for name in ("arrays.npz", "meta.json"):
        assert (tmp_path / "ref" / "step_3" / name).read_bytes() == \
            (tmp_path / "port" / "step_3" / name).read_bytes(), name
    assert (tmp_path / "ref" / "manifest.json").read_bytes() == \
        (tmp_path / "port" / "manifest.json").read_bytes()
    keys = json.loads((tmp_path / "port" / "step_3" / "meta.json")
                      .read_text())["dtypes"]
    assert "params/blocks/attn/wq" in keys
    # each package restores the other's archive
    got, step = Checkpointer(tmp_path / "ref").restore(state)
    assert step == 3
    for (k, a), (_, b) in zip(_flat(got), _flat(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    back, step = RefCheckpointer(tmp_path / "port").restore(ref_state)
    assert step == 3
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8))


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": params_from_jax(rng.randn(4, 8).astype(BF16)),
                       "b": torch.from_numpy(rng.randn(8).astype(
                           np.float32))},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip_including_bf16(tmp_path):
    ck = Checkpointer(tmp_path)
    st = _state()
    ck.save(3, st)
    restored, step = ck.restore(st)
    assert step == 3
    for (_, a), (_, b) in zip(_flat(st), _flat(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_snapshot_is_taken_when_saved(tmp_path):
    """Training updates its tensors in place: the archive holds the state
    as it was at save(), also for async writes."""
    ck = Checkpointer(tmp_path, async_writes=True)
    st = _state()
    want = st["params"]["b"].clone()
    ck.save(1, st)
    st["params"]["b"].add_(1.0)
    ck.wait()
    got, _ = ck.restore(st)
    assert torch.equal(got["params"]["b"], want)


def test_keep_last_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    steps = json.loads((tmp_path / "manifest.json").read_text())["steps"]
    assert steps == [3, 4]
    assert not (tmp_path / "step_1").exists()


def test_atomic_no_partial_visible(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _state())
    (tmp_path / "step_9.tmp").mkdir()
    assert ck.latest_step() == 1


def test_async_writer(tmp_path):
    ck = Checkpointer(tmp_path, async_writes=True)
    for s in range(5):
        ck.save(s, _state(s))
    ck.wait()
    assert ck.latest_step() == 4


def test_recheckpoint_byte_identical(tmp_path):
    blobs = []
    for d in ("a", "b"):
        ck = Checkpointer(tmp_path / d, now=lambda: 1234.5)
        ck.save(3, _state())
        blobs.append(((tmp_path / d / "step_3" / "arrays.npz").read_bytes(),
                      (tmp_path / d / "step_3" / "meta.json").read_bytes()))
    assert blobs[0] == blobs[1]
    assert json.loads(blobs[0][1])["time"] == 1234.5


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path).restore(_state())


# -------------------------------------------------------- fault tolerance

def test_run_with_restarts_gives_up():
    class _FakeCk:
        def latest_step(self):
            return None

    def loop(start):
        raise SimulatedFailure("always")

    with pytest.raises(RuntimeError, match="exceeded"):
        run_with_restarts(loop, checkpointer=_FakeCk(), max_restarts=2,
                          logger=lambda *_: None)


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(deadline_s=1.0)
    hb.beat("host0", now=100.0)
    hb.beat("host1", now=100.0)
    assert hb.sweep(now=100.5) == set()
    hb.beat("host0", now=101.0)
    assert hb.sweep(now=101.5) == {"host1"}
    assert hb.healthy == {"host0"}


def test_straggler_monitor_flags_outlier():
    sm = StragglerMonitor(window=8, factor=3.0, warmup=3)
    for step in range(6):
        assert not sm.observe(step, 0.1)
    assert sm.observe(6, 1.0)
    assert not sm.observe(7, 0.11)
    assert len(sm.flagged) == 1


# ------------------------------------------------------------ train plans

@pytest.fixture(scope="module")
def h100_constants():
    """The port's nvidia:h100 constants as a reference target."""
    h = get_target("nvidia:h100")
    if H100 not in ref_target.TARGETS:
        ref_target.register(ref_target.TargetSpec(
            name=H100, chip="h100", mesh_shape=h.mesh_shape,
            mesh_axes=h.mesh_axes, peak_flops=h.peak_flops, hbm_bw=h.hbm_bw,
            hbm_bytes=h.hbm_bytes, ici_bw=h.ici_bw, scheduler="local"))
    return H100


TRAIN_FIELDS = ("microbatches", "remat_policy", "grad_accum_dtype",
                "optimizer", "sequence_parallel", "grad_compression",
                "notes", "napkin")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_plans_equal_reference(arch, h100_constants):
    for target, ref_name in (("local:cpu", "local:cpu"),
                             ("nvidia:h100", h100_constants)):
        for over in ({}, {"seq_len": 1024, "global_batch": 4},
                     {"seq_len": 64, "global_batch": 4}):
            got = tune(get_config(arch),
                       dataclasses.replace(SHAPES["train_4k"], **over),
                       get_target(target))
            want = ref_tune(ref_config(arch),
                            dataclasses.replace(REF_SHAPES["train_4k"],
                                                **over),
                            ref_target.get_target(ref_name))
            for f in TRAIN_FIELDS:
                assert getattr(got, f) == getattr(want, f), (target, over, f)


def test_deepseek_7b_train_plans_on_the_h100():
    h100 = get_target("nvidia:h100")
    full = get_config("deepseek-7b")
    p = tune(full, SHAPES["train_4k"], h100)
    assert (p.optimizer, p.grad_accum_dtype, p.remat_policy,
            p.microbatches) == ("adamw8bit", "float32", "dots", 128)
    p = tune(full, dataclasses.replace(SHAPES["train_4k"], seq_len=1024,
                                       global_batch=4), h100)
    assert (p.optimizer, p.grad_accum_dtype, p.remat_policy,
            p.microbatches) == ("adamw8bit", "float32", "dots", 1)
    assert p.napkin["params"] == "6.91B"
    assert p.napkin["headroom_for_activations"] == "12.29 GB"
    assert p.napkin["est_temp_per_chip"] == "6.04 GB"


def test_train_build_lists_k2_for_rmsnorm_models():
    res = BuildService().build(parse_appfile(
        "FROM arch:deepseek-7b\nSHAPE train_4k\n###include_local_kernels###\n"),
        "nvidia:h100", lower=False)
    assert (res.step_name, res.plan.optimizer) == ("train_step", "adamw8bit")
    assert list(res.program["kernels"]) == ["rmsnorm"]
    assert callable(res.step_fn) and set(res.tables) == {"state", "batch",
                                                         "params"}
    ln = BuildService().build(parse_appfile(
        "FROM arch:stablelm-1.6b\nSHAPE train_4k\n###include_local_kernels###\n"),
        "nvidia:h100", lower=False)
    assert ln.program["kernels"] == {}
    cpu = BuildService().build(parse_appfile(
        "FROM arch:deepseek-7b-smoke\nSHAPE train_4k\n"), "local:cpu")
    assert (cpu.program["arch"], cpu.built) == ("reference", {})


# ----------------------------------------------------------- entry points

@pytest.fixture
def reference_weights(monkeypatch):
    """The port's train_main draws the reference's weights (the parity
    convention: weights cross, never re-drawn)."""
    def draw(table, generator, device):
        arch = next(a for a in LM_ARCHS
                    if model_for(get_config(a)).param_table() == table)
        rm = ref_model_for(ref_config(arch))
        rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
        return params_from_jax(jax.tree.map(np.asarray, rp), device)
    monkeypatch.setattr(port_train, "init_params", draw)


QUIET = dict(log=lambda *a, **k: None)


@pytest.mark.parametrize("arch", ["deepseek-7b-smoke",
                                  "granite-moe-3b-a800m-smoke"])
def test_train_main_matches_reference(arch, reference_weights):
    kw = dict(arch=arch, steps=4, seq_len=32, global_batch=4)
    want = ref_train_main(**kw, **QUIET)
    got = port_train.train_main(**kw, device="cpu", **QUIET)
    assert got["plan"].optimizer == want["plan"].optimizer
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-3)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)
    assert len(got["losses"]) == 4 and got["device"] == "cpu"


def test_restart_resumes_bitwise(tmp_path, reference_weights):
    """Train with an injected failure == train without: the same final
    state bit for bit, and the reference's restarts and losses."""
    kw = dict(arch="stablelm-1.6b-smoke", steps=8, seq_len=32,
              global_batch=2, ckpt_every=2, async_ckpt=False, **QUIET)
    clean = port_train.train_main(ckpt_dir=str(tmp_path / "a"),
                                  device="cpu", **kw)
    faulty = port_train.train_main(ckpt_dir=str(tmp_path / "b"),
                                   fail_at=(5,), device="cpu", **kw)
    assert faulty["restarts"] == 1 and clean["restarts"] == 0
    assert faulty["final_loss"] == clean["final_loss"]
    for (k, a), (_, b) in zip(_flat(clean["state"]), _flat(faulty["state"])):
        assert torch.equal(a, b), k
    ref = ref_train_main(ckpt_dir=str(tmp_path / "r"), fail_at=(5,), **kw)
    assert ref["restarts"] == faulty["restarts"]
    assert faulty["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-3)


def test_run_command_train_matches_reference(tmp_path, reference_weights):
    cmd = "train --arch deepseek-7b-smoke --steps 3 --seq-len 32"
    from repro.launch.run import run_command as ref_run_command
    want = ref_run_command(cmd, workdir=tmp_path / "r")
    got = run_command(cmd, workdir=tmp_path / "p", device="cpu")
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)
    # both checkpoint into the job's working directory
    assert (tmp_path / "p" / "ckpt" / "step_2").is_dir()
    assert (tmp_path / "r" / "ckpt" / "step_2").is_dir()


def test_run_easey_deploys_a_training_appfile(tmp_path, reference_weights):
    cmd = "train --steps 4 --seq-len 64 --global-batch 4"
    text = (f"FROM arch:deepseek-7b-smoke\nSHAPE train_4k\n"
            f"###include_local_kernels###\nRUN {cmd}\n")
    job = {"job": {"name": "train-smoke"},
           "execution": [{"serial": {"command": cmd}}]}
    mw, jid, res = run_easey(parse_appfile(text), "local:cpu",
                             parse_jobspec(job), storage=tmp_path / "p")
    rmw, rjid, _ = ref_run_easey(ref_parse_appfile(text), "local:cpu",
                                 ref_parse_jobspec(job),
                                 storage=tmp_path / "r")
    assert mw.status(jid).value == rmw.status(rjid).value == "finished"
    assert res.step_name == "train_step" and res.program["kernels"] == {}
    got, want = mw.scheduler.result(jid)[0], rmw.scheduler.result(rjid)[0]
    assert (got["steps"], got["restarts"]) == (want["steps"],
                                               want["restarts"])
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-3)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)
