"""The port's SPMD path on 8 CPU ranks over gloo, against one process.

One spawn of 8 ranks on ``local:cpu-mesh8`` ((2, 4) over ``("data",
"model")``) runs every check that needs ranks, as the reference's
``tests/test_spmd_small.py`` runs its 8 forced host devices in one
subprocess; the ranks write what they saw and the tests here hold it
against the same work in this single process and, beside them, in the
reference's own 8-device run:

(a) sharded training: ``deepseek-7b-smoke``'s initial state through
    ``reshard_state``, 3 steps of 4 x 32 tokens;
(b) the elastic re-mesh: the host state after (a), restored onto the
    degraded (1, 4) mesh (ranks 4-7 sit out), one step on the whole
    batch as one device takes it;
(c) LULESH at grid 16, each rank an (8, 4, 16) block, 10 plain steps
    through the stencil build's ``step_fn``: bit for bit one device's;
(d) ``train_main(target="local:cpu-mesh8")`` against one process's;
(e) (a) under another plan: 2 microbatches, ``adamw8bit``, ``ef_int8``.

Every run starts from the reference's initial parameters (``init_params``
under ``PRNGKey(0)``, crossed bit for bit with ``params_from_jax``, as in
``tests/test_torch_train.py``).  (a), (b) and the reference's run take a
learning rate of 1e-3 from the first step (no warm-up), so that one
update moves a weight by some eight bf16 steps and a step whose update
is lost shows; (e) keeps the build's warm-up, since 8-bit moments and
error feedback carry a flipped gradient sign further than rtol 1e-3
within 3 steps.

Against one process, on the same state: the step-1 loss within 1e-5
relative (the f32 sums of the token losses in another order); every loss
within rtol 1e-3 (the ``train_main`` tests'); the step-1 gradients
within 2^-7 of each leaf's L2 norm in L2 (each rank's gradient of its
rows is rounded to bf16 once before the f32 sum, one device rounds the
sum once: two bf16 roundings); under ``ef_int8``, within 1.5 int8 steps
of each leaf's amax.  The state after each of (a)'s steps and after
(b)'s step, against one process's step from the same state: the step
counters equal, and each float leaf's change within UPDATE_L2 = 2^-3 of
the one-process change's L2 norm (a lost update is off by all of it;
measured: the moments within 0.9%, the parameters within 5.3%, as an
element whose gradient's sign the roundings flip moves 2 lr the other
way under Adam).  After all 3 steps, each parameter's change points the
one process's way (cosine >= 0.9; measured 0.97-1.0).

Against the reference: one subprocess with 8 forced host devices, run
beside the ranks, builds the same initial state on the reference's
(2, 4) mesh, takes its step-1 gradients there and on one device, its 3
sharded steps, then re-meshes its host state onto (1, 4) and takes one
more step, as ``tests/test_spmd_small.py`` does.  The port's mesh is
held to it at the tolerances that ``tests/test_torch_train.py`` holds
one device to the reference's, for the same reasons (the port's forward
differs from XLA's by a bf16 step in some logits, which random-weight
models carry into their gradients): the loss before the first update
within rtol 1e-3; the losses after an update, the re-mesh's too, within
1e-2 (Adam's first steps move every weight by about the learning rate,
so an element whose gradient's sign flips moves by twice that); each
parameter's change over the 3 steps pointing the reference's way
(cosine >= 0.5; measured 0.82-0.98).  The step-1 gradients are held
against the reference's one-device gradients, within 1e-1 in relative
L2 (the unembedding and ``ln_f`` within 2e-2; measured 0.5-3.6%), since
the reference's GSPMD step does not compute what its one device does:
its tensor-parallel partial sums are rounded in another order, and its
mesh's gradients stand 1-18% from its own device's.  Against the
reference's mesh they must stand no farther than that distance plus the
same tolerance.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_spmd.py``.
The file is also each rank's program: ``python tests/test_torch_spmd.py
RANK DIR``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_spmd_serve import SPAWN_TIMEOUT_S

from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.core.target import get_target
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import describe
from repro_torch.models import lulesh
from repro_torch.models.params import (init_params, leaf_items,
                                      params_from_jax, tree_map)
from repro_torch.models.transformer import model_for
from repro_torch.optim import make_optimizer
from repro_torch.training.steps import build_train_step, init_train_state

REPO = Path(__file__).resolve().parents[1]
TARGET = "local:cpu-mesh8"
WORLD = 8
ARCH, SEQ, BATCH, STEPS = "deepseek-7b-smoke", 32, 4, 3
GRID, LULESH_STEPS = 16, 10
LOSS1_RTOL = 1e-5
LOSS_RTOL = 1e-3
GRAD_L2 = 2.0 ** -7
INT8_STEPS = 1.5
UPDATE_L2 = 2.0 ** -3
THREE_STEP_COS = 0.9
LR = {"peak_lr": 1e-3, "warmup_steps": 0, "total_steps": 10}
REF_LOSS_RTOL, REF_LATER_RTOL = 1e-3, 1e-2
REF_GRAD_L2, REF_GRAD_L2_HEAD = 1e-1, 2e-2
REF_UPDATE_COS = 0.5
_quiet = lambda *a, **k: None  # noqa: E731


# (e)'s plan
OTHER_PLAN = {"microbatches": 2, "optimizer": "adamw8bit",
              "grad_compression": "ef_int8"}


def _app():
    return AppSpec(arch=ARCH, shape="train_4k",
                   shape_overrides={"seq_len": SEQ, "global_batch": BATCH})


def _build(overrides=None):
    return BuildService().build(_app(), TARGET, overrides=overrides,
                                lower=False)


def _steps(res, params, mesh=None, lr=LR):
    """STEPS steps of ``res``'s plan from the initial state on ``params``,
    under the schedule ``lr``: (losses, collectives, the first step's
    gradients, the whole state after each step on the CPU)."""
    model, opt = _parts(res)
    from repro_torch.runtime.elastic import reshard_state
    state = _initial_state(model, opt, res.plan, params)
    if mesh is not None:
        state = reshard_state(state, res.tables["state"], mesh)
    step = build_train_step(model, opt, res.plan, mesh, **lr)
    pipe = DataPipeline(model, res.appspec.shape_config, seed=0,
                        device="cpu", mesh=mesh)
    losses, comms, hosts = [], [], []
    for i in range(STEPS):
        state, metrics = step(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        comms.append(metrics["collectives"])
        hosts.append(_host(state))
        if i == 0:
            grads1 = _flat_grads(opt.grads[0]) if mesh is None \
                else _whole_grads(opt.grads[0], state["params"])
    return losses, comms, grads1, hosts


def _lulesh_app():
    return AppSpec(arch="lulesh-dash", shape="train_4k",
                   run=f"lulesh -i {LULESH_STEPS} -s {GRID}")


class _Capture:
    """An optimizer whose ``update`` keeps a copy of the gradients it is
    given (on the mesh: after the all-reduce and the cast)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params, lr):
        self.grads.append(tree_map(lambda g: g.detach().clone(), grads))
        return self.opt.update(grads, state, params, lr)


def _parts(result):
    model = model_for(result.appspec.model_config,
                      remat=result.plan.remat_policy)
    return model, _Capture(make_optimizer(result.plan.optimizer))


def _initial_state(model, opt, plan, params):
    return init_train_state(model, opt, tree_map(torch.clone, params), plan)


def _ref_params() -> dict:
    """The reference's initial parameters of ARCH (``init_params`` under
    ``PRNGKey(0)``, as ``tests/test_torch_train.py`` takes them) as numpy
    arrays, bf16 as ``ml_dtypes``'."""
    import jax
    from repro.configs import get_config as ref_config
    from repro.models.params import init_params as ref_init
    from repro.models.transformer import model_for as ref_model_for
    table = ref_model_for(ref_config(ARCH)).param_table()
    return jax.tree.map(np.asarray, ref_init(table, jax.random.PRNGKey(0)))


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _host(state):
    """The whole state as CPU tensors (a mesh's leaves gathered)."""
    return tree_map(lambda x: _whole(x).detach().clone(), state)


def _whole_grads(grads, params) -> dict:
    """path -> the whole f32 gradient of a split step's shards (each
    stacked and put back as its parameter's DTensor, then gathered)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for path, g in leaf_items(grads, lambda x: not isinstance(x, dict)):
        local = torch.stack(g) if isinstance(g, list) else g
        x = _leaf(params, path)
        whole = DTensor.from_local(local.contiguous(), x.device_mesh,
                                   x.placements, run_check=False,
                                   shape=x.shape, stride=x.stride())
        out["/".join(path)] = whole.full_tensor().float()
    return out


def _flat_grads(grads) -> dict:
    """path -> the whole gradient in f32 (a per-layer list stacked)."""
    out = {}
    for path, g in leaf_items(grads, lambda x: not isinstance(x, dict)):
        out["/".join(path)] = torch.stack(g).float() \
            if isinstance(g, list) else g.float()
    return out


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    """Each rank's checks; the initial parameters come from ``out``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import degraded_mesh
    from repro_torch.launch.train import train_main
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding.rules import (PartitionSpec, distribute,
                                            local_slices)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    got = {"rank": rank}
    res = _build()
    mesh, plan = res.mesh, res.plan
    model, opt = _parts(res)
    coord = mesh.coordinate()
    got["coordinate"] = list(coord)
    params = torch.load(out / "params.pt")

    # (a) sharded training from the resharded initial state
    host0 = _initial_state(model, opt, plan, params)
    state = reshard_state(host0, res.tables["state"], mesh)
    shapes_ok, whole_ok = [], []
    for (path, x), (_, spec) in zip(
            leaf_items(state), leaf_items(res.specs["state"])):
        idx = local_slices(spec, x.shape, mesh, coord)
        want = tuple(s.stop - s.start for s in idx)
        shapes_ok.append(tuple(x.to_local().shape) == want)
        whole_ok.append(torch.equal(x.full_tensor(),
                                    _whole(_leaf(host0, path))))
    # a tuple entry: rows over (data, model), major first, as JAX
    t = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    whole_ok.append(torch.equal(distribute(
        t, PartitionSpec(("data", "model"), None), mesh).full_tensor(), t))
    got["local_shapes_match_specs"] = all(shapes_ok)
    got["full_tensor_is_host"] = all(whole_ok)
    got["leaves"] = len(shapes_ok)
    got["losses"], got["collectives"], grads1, hosts = _steps(
        res, params, mesh)
    host3 = hosts[-1]
    # (e) another plan
    other = _build(OTHER_PLAN)
    got["other_losses"], _, other1, _ = _steps(other, params, other.mesh,
                                               lr={})
    if rank == 0:
        torch.save({"grads1": grads1, "hosts": hosts, "other1": other1},
                   out / "a.pt")

    # (b) the re-mesh onto (1, 4): every rank builds it, 4-7 sit out
    small = degraded_mesh(get_target(TARGET))
    got["degraded_coordinate"] = small.coordinate()
    if small.coordinate() is not None:
        opt.grads.clear()
        restate = reshard_state(host3, res.tables["state"], small)
        step2 = build_train_step(model, opt, plan, small, **LR)
        # the whole batch, as one device takes it: the step keeps the
        # rank's rows
        pipe2 = DataPipeline(model, res.appspec.shape_config, seed=0,
                             device="cpu")
        restate, m2 = step2(restate, pipe2.batch_at(STEPS))
        got["remesh_loss"] = float(m2["loss"])
        got["remesh_collectives"] = m2["collectives"]
        host_b = _host(restate)
        grads_b = _whole_grads(opt.grads[0], restate["params"])
        if rank == 0:
            torch.save({"grads": grads_b, "state": host_b}, out / "b.pt")

    # (c) LULESH through the stencil build's step on the mesh
    lres = BuildService().build(_lulesh_app(), TARGET, lower=False)
    st = lulesh.init_state(lulesh.LuleshConfig(grid=GRID), "cpu")
    for _ in range(LULESH_STEPS):
        st = lres.step_fn(st)
    got["lulesh_local_shape"] = list(st["rho"].to_local().shape)
    whole = lulesh.state_to_numpy(st)
    if rank == 0:
        np.savez(out / "c.npz", **whole)

    # (d) train_main on the mesh
    run = train_main(arch=ARCH, steps=STEPS, target=TARGET, seq_len=SEQ,
                     global_batch=BATCH, device="cpu",
                     log=lambda *a, **k: None)
    got["train_main_losses"] = run["losses"]
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the reference's sharded run, from the same initial state

REF_SPMD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import ml_dtypes
import numpy as np
from repro.core.appspec import AppSpec
from repro.core.build import BuildService
from repro.data.pipeline import DataPipeline
from repro.launch.mesh import _mesh
from repro.models.transformer import model_for
from repro.optim import make_optimizer
from repro.runtime.elastic import reshard_state
from repro.training.steps import (build_train_step, init_train_state,
                                  train_state_table)
arch, seq, batch, steps, lr, out = json.loads(sys.argv[1])


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


app = AppSpec(arch=arch, shape="train_4k",
              shape_overrides={"seq_len": seq, "global_batch": batch})
res = BuildService().build(app, "local:cpu-mesh8", lower=False)
model = model_for(app.model_config, remat=res.plan.remat_policy)
opt = make_optimizer(res.plan.optimizer)
state_sh, batch_sh = res.in_shardings
# bf16 arrives as 2-byte voids: npz keeps no ml_dtypes type
params = {k: v.view(ml_dtypes.bfloat16) if v.dtype.kind == "V" else v
          for k, v in np.load(os.path.join(out, "params.npz")).items()}
state = jax.device_put(init_train_state(model, opt, tree(params), res.plan),
                       state_sh)
pipe = DataPipeline(model, app.shape_config, mesh=res.mesh)
grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, res.mesh),
                                  has_aux=True),
               in_shardings=(state_sh["params"], batch_sh))
(loss0, _), g = grad(state["params"], pipe.batch_at(0))
g1 = jax.jit(jax.grad(lambda p, b: model.loss(p, b, None)[0]))(
    jax.tree.map(np.asarray, tree(params)), pipe.batch_at(0))
step = jax.jit(build_train_step(model, opt, res.plan, res.mesh,
                                param_specs=state_sh["params"], **lr),
               in_shardings=res.in_shardings,
               out_shardings=(state_sh, None))
losses = []
for i in range(steps):
    state, m = step(state, pipe.batch_at(i))
    losses.append(float(m["loss"]))
host = jax.tree.map(np.asarray, state)
small = _mesh((1, 4), ("data", "model"))
restate = reshard_state(host, train_state_table(model, opt, res.plan), small)
step2 = jax.jit(build_train_step(model, opt, res.plan, small, **lr))
restate, m2 = step2(restate, DataPipeline(model, app.shape_config,
                                          mesh=small).batch_at(steps))
np.savez(os.path.join(out, "ref.npz"),
         **{"grads/" + k: v for k, v in flat(g)},
         **{"one/" + k: v for k, v in flat(g1)},
         **{"state3/" + k: v for k, v in flat(host["params"])})
print("RESULT:" + json.dumps({"loss0": float(loss0), "losses": losses,
                              "remesh_loss": float(m2["loss"])}))
"""


def _write_params(out: Path, ref_params: dict) -> None:
    """The initial parameters for the ranks (``params.pt``, the port's
    tensors) and for the reference (``params.npz``, path -> array)."""
    torch.save(params_from_jax(ref_params), out / "params.pt")
    np.savez(out / "params.npz", **{
        "/".join(path): x for path, x in leaf_items(ref_params)})


def _reference(out: Path, proc, timeout: float) -> dict:
    """The reference run's readings: its losses and, as f32 numpy,
    ``grads/<path>`` (step 1 on the mesh), ``one/<path>`` (the same on
    one device) and ``state3/<path>`` (the parameters after 3 steps)."""
    proc.wait(timeout=timeout)
    stdout = (out / "ref.log").read_text()
    assert proc.returncode == 0, stdout[-4000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT:")]
    return dict(json.loads(line[0][len("RESULT:"):]),
                **np.load(out / "ref.npz"))


# ---------------------------------------------------------------------------
# the tests


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params()


@pytest.fixture(scope="module")
def spmd(tmp_path_factory, ref_params):
    """One spawn of the 8 ranks; their results by rank and rank 0's
    tensors."""
    out = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    _write_params(out, ref_params)
    with (out / "ref.log").open("w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", REF_SPMD,
             json.dumps([ARCH, SEQ, BATCH, STEPS, LR, str(out)])],
            env=dict(env, JAX_PLATFORMS="cpu"), stdout=log,
            stderr=subprocess.STDOUT)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            left = SPAWN_TIMEOUT_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0])
        ref_out = _reference(out, ref, max(
            SPAWN_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        for p in procs + [ref]:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return {"ranks": ranks, "a": torch.load(out / "a.pt"),
            "b": torch.load(out / "b.pt"),
            "c": dict(np.load(out / "c.npz")), "ref": ref_out,
            "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def one(ref_params):
    """The same plans' steps in this one process, from the same state."""
    torch.set_num_threads(1)
    res = _build()
    params = params_from_jax(ref_params)
    losses, comms, grads1, hosts = _steps(res, params)
    model, opt = _parts(res)
    other_losses, _, other1, _ = _steps(_build(OTHER_PLAN), params, lr={})
    return {"res": res, "model": model, "opt": opt,
            "step": build_train_step(model, opt, res.plan, **LR),
            "pipe": DataPipeline(model, res.appspec.shape_config, seed=0,
                                 device="cpu"),
            "losses": losses, "collectives": comms, "grads1": grads1,
            "host0": _initial_state(model, opt, res.plan, params),
            "state3": hosts[-1],
            "other_losses": other_losses, "other1": other1}


def _hold_grads(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        err = float((got[k] - want[k]).norm())
        assert err <= GRAD_L2 * float(want[k].norm()) + 1e-30, \
            (k, err, float(want[k].norm()))


def _hold_state(got, want, start) -> None:
    """Leaf by leaf: integer leaves (the step counters) equal; each float
    leaf changed from ``start`` as ``want`` did, within UPDATE_L2 of that
    change's L2 norm (a leaf that did not change must not change); and
    the parameters changed."""
    assert len(leaf_items(got)) == len(leaf_items(want))
    moved = 0.0
    for (path, g), (p2, w), (p3, s) in zip(
            leaf_items(got), leaf_items(want), leaf_items(start)):
        assert path == p2 == p3
        if not w.dtype.is_floating_point:
            assert torch.equal(g, w), (path, g, w)
            continue
        dw, dg = w.float() - s.float(), g.float() - s.float()
        err, size = float((dg - dw).norm()), float(dw.norm())
        assert err <= UPDATE_L2 * size, (path, err, size)
        if path[0] == "params":
            moved += size
    assert moved > 0


def test_sharded_training_matches_one_process(spmd, one):
    for r in spmd["ranks"]:
        got = r["losses"]
        assert abs(got[0] - one["losses"][0]) <= \
            LOSS1_RTOL * abs(one["losses"][0]), (r["rank"], got[0])
        np.testing.assert_allclose(got, one["losses"], rtol=LOSS_RTOL)
    _hold_grads(spmd["a"]["grads1"], one["grads1"])


def test_each_sharded_step_keeps_its_update(spmd, one):
    """Each of (a)'s steps against one process's step from the state the
    mesh held before it: the update was computed and kept, leaf by leaf."""
    prev = one["host0"]
    for i, host in enumerate(spmd["a"]["hosts"]):
        want, _ = one["step"](tree_map(lambda t: t.clone(), prev),
                              one["pipe"].batch_at(i))
        assert int(host["step"]) == int(host["opt"]["count"]) == i + 1
        _hold_state(host, want, prev)
        prev = host


def test_sharded_state_after_three_steps_matches_one_process(spmd, one):
    """(a)'s state after 3 steps against one process's after the same 3
    steps from the same state: the counters equal, and each parameter's
    change points the same way.  Not closer: Adam moves an element by
    about the learning rate whatever its gradient's size, so an element
    whose gradient sign the two bf16 roundings flip moves 2 lr the other
    way, and the next steps' gradients carry that on (each step alone is
    held tightly above)."""
    host3, want, p0 = spmd["a"]["hosts"][-1], one["state3"], one["host0"]
    assert int(host3["step"]) == int(want["step"]) == STEPS
    assert int(host3["opt"]["count"]) == int(want["opt"]["count"]) == STEPS
    for path, got in leaf_items(host3["params"]):
        start = _leaf(p0["params"], path).float()
        d, d_one = got.float() - start, _leaf(want["params"], path).float() \
            - start
        if not d_one.any():
            assert not d.any(), path
            continue
        cos = float((d * d_one).sum() / (d.norm() * d_one.norm()))
        assert cos >= THREE_STEP_COS, (path, cos)


def test_sharded_training_under_another_plan(spmd, one):
    """2 microbatches of each rank's rows, 8-bit moments, error feedback:
    the update's gradients come quantized to int8 steps of each leaf's
    amax / 127, so an element near a rounding boundary moves one step
    (INT8_STEPS allows 1.5: the two amaxes differ by a few ulps too)."""
    assert one["res"].plan.microbatches == 1
    for r in spmd["ranks"]:
        np.testing.assert_allclose(r["other_losses"], one["other_losses"],
                                   rtol=LOSS_RTOL)
    got, want = spmd["a"]["other1"], one["other1"]
    assert got.keys() == want.keys()
    for k in want:
        step = float(want[k].abs().max()) / 127
        err = float((got[k] - want[k]).abs().max())
        assert err <= INT8_STEPS * step, (k, err / step)


def test_every_local_shard_has_its_specs_shape(spmd):
    coords = sorted(tuple(r["coordinate"]) for r in spmd["ranks"])
    assert coords == [(d, m) for d in range(2) for m in range(4)]
    for r in spmd["ranks"]:
        assert r["leaves"] > 0
        assert r["local_shapes_match_specs"], r["rank"]
        # the port's slice of each rank is where DTensor puts it
        assert r["full_tensor_is_host"], r["rank"]


def test_collectives_counted_on_the_mesh_and_zero_on_one_rank(spmd, one):
    for c in one["collectives"]:
        assert all(v == {"calls": 0, "bytes": 0} for v in c.values()), c
    for r in spmd["ranks"]:
        for c in r["collectives"]:
            assert c["all_gather"]["calls"] > 0 and \
                c["all_gather"]["bytes"] > 0, c
            assert c["all_reduce"]["calls"] > 0 and \
                c["all_reduce"]["bytes"] > 0, c
        # the split step: each layer's weights gathered along data, their
        # gradients reduce-scattered back
        assert c["reduce_scatter"]["calls"] > 0, c
    # one data row on the degraded mesh: nothing split along data is
    # gathered or reduce-scattered; the model axis's all-reduces remain
    for r in spmd["ranks"][:4]:
        c = r["remesh_collectives"]
        assert c["all_gather"]["calls"] == 0 and \
            c["reduce_scatter"]["calls"] == 0 and \
            c["all_reduce"]["calls"] > 0, c


def test_elastic_remesh_matches_one_process(spmd, one):
    ranks = spmd["ranks"]
    assert [r["degraded_coordinate"] is None for r in ranks] == \
        [False] * 4 + [True] * 4
    # one process's step from the same host state
    res, model, opt = one["res"], one["model"], one["opt"]
    opt.grads.clear()
    state = tree_map(lambda t: t.clone(), spmd["a"]["hosts"][-1])
    state, metrics = one["step"](state, one["pipe"].batch_at(STEPS))
    want = float(metrics["loss"])
    for r in ranks[:4]:
        assert abs(r["remesh_loss"] - want) <= LOSS1_RTOL * abs(want), \
            (r["rank"], r["remesh_loss"], want)
    _hold_grads(spmd["b"]["grads"], _flat_grads(opt.grads[0]))
    assert int(spmd["b"]["state"]["step"]) == STEPS + 1
    _hold_state(spmd["b"]["state"], state, spmd["a"]["hosts"][-1])


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_sharded_training_matches_the_reference_mesh(spmd, one):
    """The port's 8 ranks against the reference's 8 forced host devices
    from the same initial state (see the module's docstring)."""
    ref = spmd["ref"]
    for r in spmd["ranks"]:
        got = r["losses"]
        assert abs(got[0] - ref["loss0"]) <= REF_LOSS_RTOL * ref["loss0"]
        assert abs(got[0] - ref["losses"][0]) <= \
            REF_LOSS_RTOL * ref["losses"][0]
        np.testing.assert_allclose(got, ref["losses"], rtol=REF_LATER_RTOL)
    grads = spmd["a"]["grads1"]
    assert {f"grads/{k}" for k in grads} == \
        {k for k in ref if k.startswith("grads/")}
    for k, g in grads.items():
        mesh, dev = ref[f"grads/{k}"], ref[f"one/{k}"]
        tol = REF_GRAD_L2_HEAD if k.startswith(("embed/unembed", "ln_f")) \
            else REF_GRAD_L2
        assert _rel(g.numpy(), dev) <= tol, (k, _rel(g.numpy(), dev))
        own = _rel(mesh, dev)
        assert _rel(g.numpy(), mesh) <= own + tol, \
            (k, _rel(g.numpy(), mesh), own)
    p0 = one["host0"]["params"]
    for path, got in leaf_items(spmd["a"]["hosts"][-1]["params"]):
        start = _leaf(p0, path).float().numpy()
        d_ref = ref["state3/" + "/".join(path)] - start
        d = got.float().numpy() - start
        if not d_ref.any():
            # a norm's scale of 1.0 moves less than half a bf16 step
            assert not d.any(), path
            continue
        cos = float((d_ref * d).sum() /
                    (np.linalg.norm(d_ref) * np.linalg.norm(d)))
        assert cos >= REF_UPDATE_COS, (path, cos)


def test_elastic_remesh_matches_the_reference(spmd):
    """The re-mesh onto (1, 4) after 3 steps: the port's loss against the
    reference's, each from its own mesh's state (a later step's
    tolerance)."""
    want = spmd["ref"]["remesh_loss"]
    for r in spmd["ranks"][:4]:
        assert abs(r["remesh_loss"] - want) <= REF_LATER_RTOL * want, \
            (r["rank"], r["remesh_loss"], want)


def test_lulesh_on_the_mesh_is_one_device_bit_for_bit(spmd):
    for r in spmd["ranks"]:
        assert r["lulesh_local_shape"] == [GRID // 2, GRID // 4, GRID]
    cfg = lulesh.LuleshConfig(grid=GRID)
    want = lulesh.state_to_numpy(lulesh.run(lulesh.init_state(cfg, "cpu"),
                                            cfg, LULESH_STEPS))
    for k in ("rho", "e", "v", "t"):
        assert want[k].tobytes() == spmd["c"][k].tobytes(), k
    assert float(np.abs(want["rho"] - 1).max()) > 1e-3   # the wave moved


def test_train_main_on_the_mesh(spmd):
    from repro_torch.launch.train import train_main
    torch.set_num_threads(1)
    want = train_main(arch=ARCH, steps=STEPS, target="local:cpu",
                      seq_len=SEQ, global_batch=BATCH, device="cpu",
                      log=lambda *a, **k: None)["losses"]
    for r in spmd["ranks"]:
        np.testing.assert_allclose(r["train_main_losses"], want,
                                   rtol=LOSS_RTOL)


def test_mesh_without_ranks_and_kernel_on_a_mesh_refuse():
    """A step on a mesh description raises: the build's train step, and
    LULESH's plain step and its fused stencil kernel's run (which on a
    mesh of ranks steps the global grid on every rank,
    ``tests/test_torch_spmd_encdec.py``); nothing falls back to one
    device."""
    res = _build()
    assert not res.mesh.live
    model, opt = _parts(res)
    state = _initial_state(model, opt, res.plan, init_params(
        model.param_table(), torch.Generator().manual_seed(0), "cpu"))
    batch = DataPipeline(model, res.appspec.shape_config,
                         device="cpu").batch_at(0)
    with pytest.raises(RuntimeError, match="no ranks"):
        res.step_fn(state, batch)
    cfg = lulesh.LuleshConfig(grid=8)
    mesh = describe((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="no ranks"):
        lulesh.run(lulesh.init_state(cfg, "cpu"), cfg, 1, mesh=mesh,
                   use_kernel=True)
    with pytest.raises(RuntimeError, match="no ranks"):
        lulesh.step(lulesh.init_state(cfg, "cpu"), cfg, mesh)


def test_serving_on_a_mesh_without_ranks_refuses():
    """The engine, ``serve_main`` (engine and legacy families), the
    legacy path and the build's serve steps on a multi-chip target in a
    process holding none of its ranks raise; nothing falls back to one
    device."""
    from repro_torch.launch.serve import _legacy_serve_main, serve_main
    from repro_torch.serving import ServeEngine
    with pytest.raises(RuntimeError, match="no ranks"):
        ServeEngine(ARCH, target=TARGET, device="cpu", log=_quiet)
    with pytest.raises(RuntimeError, match="no ranks"):
        serve_main(arch=ARCH, target=TARGET, device="cpu", log=_quiet)
    with pytest.raises(RuntimeError, match="no ranks"):
        serve_main(arch="xlstm-1.3b-smoke", target=TARGET, device="cpu",
                   log=_quiet)
    with pytest.raises(RuntimeError, match="no ranks"):
        _legacy_serve_main("llava-next-34b-smoke", 2, 32, 4, TARGET, 0,
                           _quiet, torch.device("cpu"))
    # the build's serve steps on the mesh description
    for shape in ("prefill_32k", "decode_32k"):
        res = BuildService().build(AppSpec(arch=ARCH, shape=shape), TARGET,
                                   lower=False)
        assert not res.mesh.live
        with pytest.raises(RuntimeError, match="no ranks"):
            res.step_fn({}, {"tokens": torch.zeros((2, 1))})


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
