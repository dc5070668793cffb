"""The split train step on 8 CPU ranks over gloo, against one process and
the reference's own 8-device run.

One spawn of 8 ranks on ``local:cpu-mesh8`` ((2, 4) over ``("data",
"model")``) runs every check that needs ranks; the one-process side runs
in this process while the ranks run, and one subprocess beside them runs
the reference on 8 forced host devices from the same initial weights:

(i) the microbatch grouping: ``deepseek-7b-smoke`` at 2 microbatches
    with a ``loss_mask`` that keeps a different number of tokens in each
    row.  Microbatch j is the whole batch's rows ``[j B/M, (j+1) B/M)``
    (the reference's scan), each split over ``data``; cutting each rank's
    rows into M instead groups other rows, whose masked means differ
    (the test shows that grouping's loss stands apart);
(ii) ``granite-moe-3b-a800m-smoke`` (4 experts top-2, 2 KV heads on the
    4-way model axis: ``kv_heads`` kept whole) for 3 steps at 1 and at 2
    microbatches: the router's aux loss over the whole batch, experts
    split over ``model``, the shared K/V heads' gradients summed;
(iii) a checkpoint of (ii)'s sharded state: the archive byte for byte
    one process's archive of the gathered state; restored onto (2, 4)
    (the next step bit for bit the unbroken run's), onto the degraded
    (1, 4) mesh and onto one process (the next step's loss within the
    first-step tolerance of the unbroken run's, the update held leaf by
    leaf against one process's);
(iv) ``train_main(target="local:cpu-mesh8", ckpt_dir=..., fail_at=...)``:
    the restarted run's losses equal the unbroken run's;
(vi) the weights each rank holds gathered at once during a step (weak
    references to every ``sharding.split.gather_leaf`` output): at most
    the dry run's reckoning (``launch.dryrun.gathered_at_once``), reached,
    and no gathered weight whole along a dimension its spec splits over
    ``model``; for the dense and MoE models and for the recurrent ones
    (``xlstm-1.3b-smoke``: its mLSTM and sLSTM layers differ;
    ``zamba2-7b-smoke``: the shared block's weights, gathered once a
    step, held beside each layer's), each from ``init_params``' draw.

The tolerances are ``tests/test_torch_spmd.py``'s: against one process
the first loss within LOSS1_RTOL, every loss within LOSS_RTOL and the
step-1 gradients within GRAD_L2 of each leaf's L2 norm; against the
reference its REF_* limits.  The split step keeps each product's partial
input gradient in f32 and sums it over the model axis once per product
(and a KV head shared by several ranks' query heads once per head), so
it rounds where one device rounds: its gradients stand as close to one
process's as the data-parallel sum alone leaves them (measured about
0.3% of each leaf's norm).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_train.py``.  The file is also each rank's program:
``python tests/test_torch_spmd_train.py RANK DIR``.
"""

import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_spmd import (GRAD_L2, LOSS1_RTOL, LOSS_RTOL, LR,
                             REF_GRAD_L2, REF_GRAD_L2_HEAD, REF_LATER_RTOL,
                             REF_LOSS_RTOL, REF_UPDATE_COS, _Capture,
                             _flat_grads, _hold_state, _leaf, _rel,
                             _whole_grads)
from test_torch_spmd_serve import SPAWN_TIMEOUT_S

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.params import (leaf_items, params_from_jax,
                                      tree_map)
from repro_torch.models.transformer import model_for
from repro_torch.optim import make_optimizer
from repro_torch.training.steps import build_train_step, init_train_state

REPO = Path(__file__).resolve().parents[1]
TARGET = "local:cpu-mesh8"
WORLD = 8
DENSE, MOE = "deepseek-7b-smoke", "granite-moe-3b-a800m-smoke"
RECURRENT = ("xlstm-1.3b-smoke", "zamba2-7b-smoke")
SEQ, BATCH, STEPS = 32, 4, 3
# (i): tokens each row's mask keeps
KEPT = (32, 6, 20, 3)
# (ii)'s schedule: the build's warm-up.  At LR (1e-3 from the first step)
# the MoE smoke's third loss stands 0.5% from one process's even on a
# (2, 1) mesh that splits only the rows: Adam moves an element whose
# gradient sign the two bf16 roundings of the row sum flip by 2 lr, and
# the router's top-k turns that into other experts for some tokens
MOE_LR = {}
# (iii): the checkpoint clock, and (iv)'s run
CLOCK = 1234.5
TRAIN_MAIN = dict(arch=DENSE, steps=5, seq_len=SEQ, global_batch=BATCH)
CKPT_EVERY, FAIL_AT = 2, 3
_quiet = lambda *a, **k: None  # noqa: E731


def _build(arch, overrides=None, target=TARGET):
    app = AppSpec(arch=arch, shape="train_4k",
                  shape_overrides={"seq_len": SEQ, "global_batch": BATCH})
    return BuildService().build(app, target, overrides=overrides,
                                lower=False)


def _parts(res):
    model = model_for(res.appspec.model_config,
                      remat=res.plan.remat_policy)
    return model, _Capture(make_optimizer(res.plan.optimizer))


def _state(res, params, mesh=None):
    from repro_torch.runtime.elastic import reshard_state
    model, opt = _parts(res)
    state = init_train_state(model, opt, tree_map(torch.clone, params),
                             res.plan)
    if mesh is not None:
        state = reshard_state(state, res.tables["state"], mesh)
    return model, opt, state


def _pipe(model, res):
    return DataPipeline(model, res.appspec.shape_config, seed=0,
                        device="cpu")


def _masked_batch(model, res) -> dict:
    """Step 0's batch with a mask keeping KEPT[r] tokens of row r."""
    batch = _pipe(model, res).batch_at(0)
    keep = torch.arange(SEQ)[None, :] < torch.tensor(KEPT)[:, None]
    return dict(batch, loss_mask=keep.float())


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _host(state):
    return tree_map(lambda x: _whole(x).detach().clone(), state)


def _steps(res, params, mesh=None, lr=LR, n=STEPS):
    """n steps from the initial state under the schedule ``lr``:
    (losses, step-1 gradients whole, the state, the model, the
    optimizer, the step)."""
    model, opt, state = _state(res, params, mesh)
    step = build_train_step(model, opt, res.plan, mesh, **lr)
    pipe = _pipe(model, res)
    losses, grads1 = [], None
    for i in range(n):
        state, metrics = step(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        if grads1 is None:
            grads1 = _whole_grads(opt.grads[0], state["params"]) \
                if mesh is not None else _flat_grads(opt.grads[0])
    return losses, grads1, state, model, opt, step


class _GatheredWatch:
    """Weak references to every weight a split step gathers along
    ``data`` (``sharding.split.gather_leaf``): the most bytes alive at
    once, and each gathered weight's shape.  A leaf with no ``data``
    split passes through ``gather_leaf`` too (its gradient is summed
    over the data-parallel ranks) as its shard's own storage, which
    counts nothing."""

    def __init__(self):
        from repro_torch.sharding import split
        self.split, self.orig = split, split.gather_leaf
        self.refs, self.most, self.shapes = [], 0, set()
        split.gather_leaf = self

    def __call__(self, shard, split, gather):
        out = self.orig(shard, split, gather)
        if out.untyped_storage().data_ptr() == \
                shard.untyped_storage().data_ptr():
            return out
        self.refs = [(r, n) for r, n in self.refs if r() is not None]
        self.refs.append((weakref.ref(out), out.numel() * out.element_size()))
        self.most = max(self.most, sum(n for _, n in self.refs))
        self.shapes.add(tuple(out.shape))
        return out

    def close(self) -> dict:
        self.split.gather_leaf = self.orig
        return {"most": self.most, "shapes": sorted(self.shapes)}


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import degraded_mesh
    from repro_torch.launch.train import train_main
    from repro_torch.core.target import get_target
    from repro_torch.runtime.elastic import reshard_state
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    got = {"rank": rank}
    dense, moe = torch.load(out / "dense.pt"), torch.load(out / "moe.pt")

    # (i) the masked batch at 2 microbatches
    res = _build(DENSE, {"microbatches": 2})
    model, opt, state = _state(res, dense, res.mesh)
    step = build_train_step(model, opt, res.plan, res.mesh, **LR)
    _, m = step(state, _masked_batch(model, res))
    got["masked_loss"] = float(m["loss"])
    masked = _whole_grads(opt.grads[0], state["params"])

    # (vi) one step of each model under watch
    watches = {}
    from repro_torch.models.params import init_params
    recurrent = [(a, init_params(model_for(_build(a).appspec.model_config)
                                 .param_table(), torch.Generator()
                                 .manual_seed(0), "cpu"))
                 for a in RECURRENT]
    for arch, params in [(DENSE, dense), (MOE, moe)] + recurrent:
        r = _build(arch)
        model, opt, state = _state(r, params, r.mesh)
        step = build_train_step(model, opt, r.plan, r.mesh, **LR)
        watch = _GatheredWatch()
        try:
            step(state, _pipe(model, r).batch_at(0))
        finally:
            watches[arch] = watch.close()
    got["gathered"] = watches

    # (ii) the MoE model at 1 and 2 microbatches
    saved = {}
    for M in (1, 2):
        r = _build(MOE, {"microbatches": M})
        losses, grads1, state, _, _, _ = _steps(r, moe, r.mesh, MOE_LR)
        got[f"moe_losses_{M}"] = losses
        saved[f"moe_grads_{M}"] = grads1
        if M == 1:
            saved["moe_final"] = _host(state)

    # (iii) a checkpoint of the sharded state after 3 steps at LR
    r = _build(MOE)
    _, _, state, model, _, step = _steps(r, moe, r.mesh)
    saved["moe_state"] = _host(state)
    ckdir = out / "ckpt"
    ck = Checkpointer(ckdir, async_writes=True, now=lambda: CLOCK,
                      mesh=r.mesh)
    ck.save(STEPS - 1, state)
    got["latest_step"] = ck.latest_step()
    nxt = _pipe(model, r).batch_at(STEPS)
    state, m = step(state, nxt)                       # the unbroken run
    got["unbroken_loss"] = float(m["loss"])
    unbroken = _host(state)
    template = _state(r, moe, r.mesh)[2]
    restored, at = ck.restore(template)
    got["restored_at"] = at
    got["restored_equal"] = all(torch.equal(_whole(a), b) for (_, a), (_, b)
                                in zip(leaf_items(restored),
                                       leaf_items(saved["moe_state"])))
    restored, m = step(restored, nxt)
    got["restored_loss"] = float(m["loss"])
    got["restored_step_bitwise"] = all(
        torch.equal(_whole(a), b) for (_, a), (_, b) in
        zip(leaf_items(restored), leaf_items(unbroken)))
    small = degraded_mesh(get_target(TARGET))
    if small.coordinate() is not None:
        model2, opt2, tmpl = _state(r, moe, small)
        state2, at2 = Checkpointer(ckdir, mesh=small).restore(tmpl)
        got["small_equal"] = all(
            torch.equal(_whole(a), b) for (_, a), (_, b) in
            zip(leaf_items(state2), leaf_items(saved["moe_state"])))
        step2 = build_train_step(model2, opt2, r.plan, small, **LR)
        state2, m2 = step2(state2, nxt)
        got["small_loss"] = float(m2["loss"])
        saved["small_state"] = _host(state2)
    if rank == 0:
        # one process's archive of the gathered state, the same clock
        one = Checkpointer(out / "one_ckpt", now=lambda: CLOCK)
        one.save(STEPS - 1, saved["moe_state"])
        saved["unbroken"] = unbroken

    # (iv) train_main with a failure, beside the unbroken run
    kw = dict(TRAIN_MAIN, target=TARGET, device="cpu", log=_quiet)
    got["train_main"] = train_main(**kw)["losses"]
    run = train_main(ckpt_dir=str(out / "tm_ckpt"), ckpt_every=CKPT_EVERY,
                     fail_at=(FAIL_AT,), **kw)
    got["train_main_restarted"] = run["losses"]
    got["train_main_restarts"] = run["restarts"]
    if rank == 0:
        torch.save(dict(saved, masked=masked), out / "saved.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's run on 8 forced host devices

REF_TRAIN = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.appspec import AppSpec
from repro.core.build import BuildService
from repro.data.pipeline import DataPipeline
from repro.models.transformer import model_for
from repro.optim import make_optimizer
from repro.training.steps import build_train_step, init_train_state
dense, moe, seq, batch, steps, lr, kept, out = json.loads(sys.argv[1])
moe_lr = {}


def tree(flat):
    t = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = t
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return t


def flat(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(t).astype(np.float32)


def params_of(name):
    return tree({k: v.view(ml_dtypes.bfloat16) if v.dtype.kind == "V" else v
                 for k, v in np.load(os.path.join(out, name)).items()})


def build(arch, M):
    app = AppSpec(arch=arch, shape="train_4k",
                  shape_overrides={"seq_len": seq, "global_batch": batch})
    res = BuildService().build(app, "local:cpu-mesh8",
                               overrides={"microbatches": M}, lower=False)
    return app, res, model_for(app.model_config,
                               remat=res.plan.remat_policy)


got, arrays = {}, {}
# (i): the masked batch's loss and gradients at 2 microbatches on the mesh
app, res, model = build(dense, 2)
state_sh, batch_sh = res.in_shardings
pipe = DataPipeline(model, app.shape_config, mesh=res.mesh)
b0 = pipe.batch_at(0)
mask = (np.arange(seq)[None, :] < np.array(kept)[:, None]).astype(
    np.float32)
b0 = dict(b0, loss_mask=jax.device_put(
    mask, NamedSharding(res.mesh, P("data", None))))
params = jax.device_put(params_of("dense.npz"), state_sh["params"])


def mean_loss(p, b):
    n = batch // 2
    return sum(model.loss(p, {k: v[j * n:(j + 1) * n] for k, v in b.items()},
                          res.mesh)[0] for j in range(2)) / 2


loss, g = jax.jit(jax.value_and_grad(mean_loss))(params, b0)
got["masked_loss"] = float(loss)
arrays.update({"masked/" + k: v for k, v in flat(g)})
mesh = res.mesh
res.mesh = None
g1 = jax.jit(jax.grad(mean_loss))(
    jax.tree.map(np.asarray, params_of("dense.npz")),
    jax.tree.map(np.asarray, b0))
res.mesh = mesh
arrays.update({"masked_one/" + k: v for k, v in flat(g1)})
# (ii): the MoE model, 3 steps at 1 and at 2 microbatches
for M in (1, 2):
    app, res, model = build(moe, M)
    opt = make_optimizer(res.plan.optimizer)
    state_sh, batch_sh = res.in_shardings
    p0 = params_of("moe.npz")
    state = jax.device_put(init_train_state(model, opt, p0, res.plan),
                           state_sh)
    pipe = DataPipeline(model, app.shape_config, mesh=res.mesh)
    if M == 1:
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, res.mesh)[0]),
            in_shardings=(state_sh["params"], batch_sh))
        loss0, g = grad(state["params"], pipe.batch_at(0))
        g1 = jax.jit(jax.grad(lambda p, b: model.loss(p, b, None)[0]))(
            jax.tree.map(np.asarray, p0), pipe.batch_at(0))
        got["moe_loss0"] = float(loss0)
        arrays.update({"grads/" + k: v for k, v in flat(g)})
        arrays.update({"one/" + k: v for k, v in flat(g1)})
    step = jax.jit(build_train_step(model, opt, res.plan, res.mesh,
                                    param_specs=state_sh["params"],
                                    **moe_lr),
                   in_shardings=res.in_shardings,
                   out_shardings=(state_sh, None))
    losses = []
    for i in range(steps):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    got[f"moe_losses_{M}"] = losses
    if M == 1:
        arrays.update({"state3/" + k: v for k, v in
                       flat(jax.tree.map(np.asarray, state["params"]))})
np.savez(os.path.join(out, "ref.npz"), **arrays)
print("RESULT:" + json.dumps(got))
"""


def _write_params(out: Path, ref: dict) -> None:
    for name, tree in ref.items():
        torch.save(params_from_jax(tree), out / f"{name}.pt")
        np.savez(out / f"{name}.npz", **{
            "/".join(path): x for path, x in leaf_items(tree)})


def _ref_params(arch) -> dict:
    import jax
    from repro.configs import get_config as ref_config
    from repro.models.params import init_params as ref_init
    from repro.models.transformer import model_for as ref_model_for
    table = ref_model_for(ref_config(arch)).param_table()
    return jax.tree.map(np.asarray, ref_init(table, jax.random.PRNGKey(0)))


def _one(params: dict, out: Path) -> dict:
    """The one-process side of every check, run while the ranks run."""
    from repro_torch.launch.train import train_main
    torch.set_num_threads(1)
    one = {}
    # (i) the masked batch, and the grouping that cuts each rank's rows
    res = _build(DENSE, {"microbatches": 2}, "local:cpu")
    model, opt, state = _state(res, params["dense"])
    step = build_train_step(model, opt, res.plan, **LR)
    batch = _masked_batch(model, res)
    _, m = step(state, batch)
    one["masked_loss"] = float(m["loss"])
    one["masked_grads"] = _flat_grads(opt.grads[0])
    # each rank's rows first (data rank d: rows 2d, 2d+1), then cut in
    # two: microbatch j of the ranks is rows {j, 2 + j}
    from repro_torch.models import layers as L
    leaves = model.train_leaves(state["params"])
    with torch.no_grad():
        parts = []
        for rows in ((0, 2), (1, 3)):
            mb = {k: v[list(rows)] for k, v in batch.items()}
            logits, _ = model.full_forward(leaves, mb)
            parts.append(L.softmax_xent(logits, mb["labels"],
                                        mb["loss_mask"]))
    one["rows_first_loss"] = float(sum(parts) / 2)
    # (ii)
    for M in (1, 2):
        r = _build(MOE, {"microbatches": M}, "local:cpu")
        losses, grads1, _, model, opt, _ = _steps(r, params["moe"],
                                                  lr=MOE_LR)
        one[f"moe_losses_{M}"] = losses
        one[f"moe_grads_{M}"] = grads1
        if M == 1:
            one["moe_res"], one["moe_model"] = r, model
            one["moe_opt"] = opt
            one["moe_step"] = build_train_step(model, opt, r.plan, **LR)
            one["moe_state0"] = _host(_state(r, params["moe"])[2])
    # (iv)
    one["train_main"] = train_main(**TRAIN_MAIN, target="local:cpu",
                                   device="cpu", log=_quiet)["losses"]
    return one


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """One spawn of the 8 ranks and the reference's run, the one-process
    side run meanwhile here."""
    out = tmp_path_factory.mktemp("spmd_train")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    ref = {"dense": _ref_params(DENSE), "moe": _ref_params(MOE)}
    _write_params(out, ref)
    with (out / "ref.log").open("w") as log:
        refp = subprocess.Popen(
            [sys.executable, "-c", REF_TRAIN,
             json.dumps([DENSE, MOE, SEQ, BATCH, STEPS, LR, list(KEPT),
                         str(out)])],
            env=dict(env, JAX_PLATFORMS="cpu"), stdout=log,
            stderr=subprocess.STDOUT)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    params = {k: params_from_jax(v) for k, v in ref.items()}
    try:
        one = _one(params, out)
        for p in procs:
            left = SPAWN_TIMEOUT_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0])
        refp.wait(timeout=max(SPAWN_TIMEOUT_S -
                              (time.perf_counter() - t0), 1))
    finally:
        for p in procs + [refp]:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    stdout = (out / "ref.log").read_text()
    assert refp.returncode == 0, stdout[-4000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT:")]
    return {"ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(WORLD)],
            "saved": torch.load(out / "saved.pt"), "one": one,
            "ref": dict(json.loads(line[0][len("RESULT:"):]),
                        **np.load(out / "ref.npz")),
            "out": out, "params": params,
            "seconds": time.perf_counter() - t0}


def _hold_grads(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        err = float((got[k] - want[k]).norm())
        assert err <= GRAD_L2 * float(want[k].norm()) + 1e-30, \
            (k, err / max(float(want[k].norm()), 1e-30))


def test_microbatches_are_the_reference_grouping(spawn):
    """(i): the mesh's loss and gradients at 2 microbatches under a mask
    whose kept counts differ by row, against one process's and the
    reference mesh's; the grouping that cuts each rank's rows instead
    lands elsewhere."""
    one, ref = spawn["one"], spawn["ref"]
    want = one["masked_loss"]
    for r in spawn["ranks"]:
        assert abs(r["masked_loss"] - want) <= LOSS1_RTOL * abs(want), \
            (r["rank"], r["masked_loss"], want)
    assert abs(ref["masked_loss"] - want) <= REF_LOSS_RTOL * abs(want)
    assert abs(one["rows_first_loss"] - want) > 100 * LOSS1_RTOL * abs(want)
    got = spawn["saved"]["masked"]
    _hold_grads(got, one["masked_grads"])
    # the reference's mesh stands from its own device as far as its
    # tensor-parallel sums round (see tests/test_torch_spmd.py)
    for k, g in got.items():
        mesh, dev = ref[f"masked/{k}"], ref[f"masked_one/{k}"]
        tol = REF_GRAD_L2_HEAD if k.startswith(("embed/unembed", "ln_f")) \
            else REF_GRAD_L2
        assert _rel(g.numpy(), dev) <= tol, (k, _rel(g.numpy(), dev))
        assert _rel(g.numpy(), mesh) <= _rel(mesh, dev) + tol, k


@pytest.mark.parametrize("M", [1, 2])
def test_moe_on_the_mesh_matches_one_process(spawn, M):
    one = spawn["one"]
    for r in spawn["ranks"]:
        got = r[f"moe_losses_{M}"]
        want = one[f"moe_losses_{M}"]
        assert abs(got[0] - want[0]) <= LOSS1_RTOL * abs(want[0]), \
            (r["rank"], got[0], want[0])
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the shared K/V heads' weights (kv_heads whole on the model axis)
    # and the router are among the leaves held
    got = spawn["saved"][f"moe_grads_{M}"]
    assert {"blocks/attn/wk", "blocks/mlp/router"} <= got.keys()
    _hold_grads(got, one[f"moe_grads_{M}"])


@pytest.mark.parametrize("M", [1, 2])
def test_moe_on_the_mesh_matches_the_reference_mesh(spawn, M):
    ref, saved = spawn["ref"], spawn["saved"]
    for r in spawn["ranks"]:
        got = r[f"moe_losses_{M}"]
        want = ref[f"moe_losses_{M}"]
        assert abs(got[0] - want[0]) <= REF_LOSS_RTOL * want[0]
        np.testing.assert_allclose(got, want, rtol=REF_LATER_RTOL)
    if M == 2:
        return
    assert abs(spawn["ranks"][0]["moe_losses_1"][0] - ref["moe_loss0"]) \
        <= REF_LOSS_RTOL * ref["moe_loss0"]
    for k, g in saved["moe_grads_1"].items():
        mesh, dev = ref[f"grads/{k}"], ref[f"one/{k}"]
        tol = REF_GRAD_L2_HEAD if k.startswith(("embed/unembed", "ln_f")) \
            else REF_GRAD_L2
        assert _rel(g.numpy(), dev) <= tol, (k, _rel(g.numpy(), dev))
        assert _rel(g.numpy(), mesh) <= _rel(mesh, dev) + tol, k
    p0 = spawn["one"]["moe_state0"]["params"]
    for path, got in leaf_items(saved["moe_final"]["params"]):
        start = _leaf(p0, path).float().numpy()
        d_ref = ref["state3/" + "/".join(path)] - start
        d = got.float().numpy() - start
        if not d_ref.any():
            assert not d.any(), path
            continue
        cos = float((d_ref * d).sum() /
                    (np.linalg.norm(d_ref) * np.linalg.norm(d)))
        assert cos >= REF_UPDATE_COS, (path, cos)


def test_checkpoint_of_a_sharded_state(spawn):
    """(iii): the archive is one process's; restores onto (2, 4), (1, 4)
    and one process hold the saved state, and the next step follows."""
    out, saved, one = spawn["out"], spawn["saved"], spawn["one"]
    name = f"step_{STEPS - 1}"
    for f in ("arrays.npz", "meta.json"):
        assert (out / "ckpt" / name / f).read_bytes() == \
            (out / "one_ckpt" / name / f).read_bytes(), f
    ranks = spawn["ranks"]
    for r in ranks:
        assert r["latest_step"] == r["restored_at"] == STEPS - 1
        assert r["restored_equal"] and r["restored_step_bitwise"], r["rank"]
    unbroken = ranks[0]["unbroken_loss"]
    for r in ranks[:4]:
        assert r["small_equal"], r["rank"]
        assert abs(r["small_loss"] - unbroken) <= LOSS1_RTOL * unbroken
    assert all("small_loss" not in r for r in ranks[4:])
    # onto one process: the archive restored into a fresh state, and its
    # next step against the mesh's
    res, model = one["moe_res"], one["moe_model"]
    template = _state(res, spawn["params"]["moe"])[2]
    state, at = Checkpointer(out / "ckpt").restore(template)
    assert at == STEPS - 1
    for (p, a), (_, b) in zip(leaf_items(state),
                              leaf_items(saved["moe_state"])):
        assert torch.equal(a, b), p
    one["moe_opt"].grads.clear()
    start = _host(state)
    state, m = one["moe_step"](state, _pipe(model, res).batch_at(STEPS))
    assert abs(float(m["loss"]) - unbroken) <= LOSS1_RTOL * unbroken
    _hold_state(saved["unbroken"], state, start)
    _hold_state(saved["small_state"], state, start)


def test_train_main_restarts_on_the_mesh(spawn):
    """(iv): a failure at step FAIL_AT, the restart from the step the
    checkpoint every CKPT_EVERY steps holds: the losses are the unbroken
    run's, bit for bit, and within LOSS_RTOL of one process's."""
    for r in spawn["ranks"]:
        assert r["train_main_restarts"] == 1
        assert r["train_main_restarted"] == r["train_main"], r["rank"]
        np.testing.assert_allclose(r["train_main"],
                                   spawn["one"]["train_main"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", [DENSE, MOE] + list(RECURRENT))
def test_gathered_weights_are_one_layer_at_a_time(spawn, arch):
    """(vi): the bytes of weights a rank holds gathered along ``data`` at
    once equal the dry run's reckoning, and no gathered weight is whole
    along a dimension its spec splits over ``model``."""
    from repro_torch.launch.dryrun import gathered_at_once
    from repro_torch.sharding.rules import placements
    from repro_torch.sharding.split import layer_axes
    res = _build(arch)
    table, specs = res.tables["state"]["params"], res.specs["state"]["params"]
    want = gathered_at_once(table, specs, res.mesh, res.plan.remat_policy)
    model = res.mesh.axis_names.index("model")
    whole = set()
    for (path, d), (_, spec) in zip(leaf_items(table), leaf_items(specs)):
        pls = placements(spec, res.mesh)
        if pls[model].is_shard():
            whole.add(tuple(d.shape[layer_axes(path):]))
    assert whole
    for r in spawn["ranks"]:
        g = r["gathered"][arch]
        assert g["most"] == want > 0, (r["rank"], g["most"], want)
        assert not whole & {tuple(s) for s in g["shapes"]}, r["rank"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
