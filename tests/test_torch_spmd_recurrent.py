"""The recurrent families split along the model axis: ``xlstm-1.3b-smoke``
and ``zamba2-7b-smoke`` trained and served on 8 CPU ranks over gloo,
against one process.

One spawn of 8 ranks runs every check that needs ranks, on
``local:cpu-mesh8`` ((2, 4) over ``("data", "model")``), on the (1, 4)
mesh of its first four ranks, on (4, 2) (``xlstm-1.3b-smoke``'s 2 heads
then split one a rank; on (2, 4) and (1, 4) they fall back to every
head on each rank, as ``xlstm-1.3b``'s 4 heads do on 16) and on the
data-only (8, 1); ranks outside a smaller mesh build its groups and sit
it out.  The one-process side runs in this process meanwhile, from the
same weights (``init_params`` from seed 0, written for the ranks):

(a) two train steps at 1 microbatch on every mesh, at 2 on (2, 4) and
    with 8-bit moments on (4, 2) and (2, 4), where the heads split: each
    loss within LOSS1_RTOL of one process's for the first step and
    LOSS_RTOL after, the first step's gradients within GRAD_L2 of each
    leaf's L2 norm, each leaf's update over the two steps within
    UPDATE_L2 of one process's (``tests/test_torch_spmd.py``'s limits),
    or, where one process stands farther from itself under one flipped
    bf16 step in 1% of its first block's outputs (the control, run
    here), within CONTROL_X times the control's distance (each loss
    within CONTROL_X times the control's largest loss difference): the
    xLSTM's losses and gradients at the fixed limits alone
    (``FIXED_ONLY``), its updates and the hybrid's readings against the
    control too;
(b) an xLSTM train step (an sLSTM block among its layers) counts the
    same collectives at 32 and at 64 tokens a row: none runs inside the
    time loop, the recurrent weight's gradient is summed once a step;
(c) the legacy serve path (``_legacy_serve_main``, 4 x 16 + 6 greedy
    tokens) on (2, 4) and (1, 4): the streams exactly one process's,
    each step's logits within LOGITS_STEP_L2 in L2, each rank's shard of
    every cache leaf (the recurrent states, the conv states, Zamba2's
    shared K/V) of the shape its spec gives and within STATE_L2 of the
    matching slice of one process's (the count of unequal entries
    printed).  Where a greedy stream parts from one process's, it parts
    at a near tie: one process's top-2 margin at that row and step is no
    wider than the split's own deviation of that row's logits there
    (printed); the later steps, fed other tokens, are not compared.  On
    the data-only (8, 1), where no product is split, streams, logits and
    every rank's cache bit for bit one process's;
(d) the weights each serve step gathers (weak references to every
    ``sharding.split.serve_gather`` output): no weight whole along a
    dimension its spec splits over ``model``, at most the dry run's
    reckoning alive at once (a layer's, or the shared block's beside
    one), none after the run (the train step's are held to the
    reckoning exactly by ``tests/test_torch_spmd_train.py``);
(f) each split block (mLSTM, sLSTM, Mamba2, the shared attention +
    MLP block) on the same inputs and weights as one process's: its
    output within BLOCK_OUT_L2, its input's and every weight's gradient
    within GRAD_L2;
(g) the hybrid's shared attention with a sliding window (WINDOW; the
    smoke config has none) split by heads on (2, 4) and (1, 4): a
    prefill past the window (its band by q-chunks), a prefill of the
    window's length and one decode step over that cache as a ring
    buffer, and the same decode step over one process's cache put at
    rest under the sequence-parallel rules (the ring split along its
    sequence, every KV head and SSM head kept whole: the rank writes the
    positions it holds and reads its heads' state), each one's logits
    within LOGITS_STEP_L2 of one process's;
(e) the build's train, prefill and decode steps' collectives counted on
    the live (2, 4) mesh equal the dry run's reckoning of the same cells;
    a checkpoint of each arch's sharded state after (a)'s steps is byte
    for byte one process's archive of the gathered state, and restored
    onto (2, 4) (the next step bit for bit the unbroken run's), onto
    (1, 4) and onto one process, the next step's loss within (a)'s limit
    of a first loss.

A row-parallel product sums its f32 partials over the model ranks in
another order than one device's product, and each rank's weight
gradients are rounded to bf16 before the data-parallel sum (one process
rounds once: the data split rounds as one process at twice the
microbatches does), so the split steps are held to tolerances, not
bits.  The smoke hybrid amplifies such a rounding about 4.5x a Mamba2
block: one flipped bf16 step in 1% of its first block's outputs moves
its gradients by 2-3% (measured), past GRAD_L2, so its whole-model
gates read the control beside the fixed limits, and (f) holds each
block to them alone.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_recurrent.py`` (about a minute); the file is also
each rank's program: ``python tests/test_torch_spmd_recurrent.py RANK
DIR``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_spmd import (GRAD_L2, LOSS1_RTOL, LOSS_RTOL, LR,
                             UPDATE_L2, _Capture)
from test_torch_spmd_serve import (SPAWN_TIMEOUT_S, _SplitWatch,
                                   _counted_vs_reckoned, register_targets,
                                   serve_reckoning)

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.params import init_params, leaf_items, tree_map
from repro_torch.models.transformer import model_for
from repro_torch.optim import make_optimizer
from repro_torch.training.steps import build_train_step, init_train_state

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
XLSTM, ZAMBA = "xlstm-1.3b-smoke", "zamba2-7b-smoke"
ARCHS = (XLSTM, ZAMBA)
MESHES = {"2x4": "local:cpu-mesh8", "1x4": "local:cpu-mesh1x4",
          "4x2": "local:cpu-mesh4x2", "8x1": "local:cpu-dp8"}
TRAIN = {XLSTM: ("2x4", "1x4", "4x2"), ZAMBA: ("2x4", "1x4")}
# (a)'s plans: 1 microbatch of the build's plan (AdamW) on every mesh, 2
# on (2, 4) (their rows split over ``data`` too), and the 8-bit moments
# (row scales over a split row; ``A_log``, ``D`` and ``dt_bias`` split by
# heads) on the meshes that split the heads
PLANS = {"1": {"microbatches": 1}, "2": {"microbatches": 2},
         "8bit": {"microbatches": 1, "optimizer": "adamw8bit"}}
EIGHT_BIT = {(XLSTM, "4x2"), (ZAMBA, "2x4")}
SERVE = ("2x4", "1x4", "8x1")
SEQ, BATCH, STEPS = 32, 4, 2
LEGACY = (4, 16, 6)
CLOCK = 1234.5
# each legacy step's logits against one process's in L2 (the split serve
# steps' limit, tests/test_torch_spmd_serve_split.py)
LOGITS_STEP_L2 = 2.0 ** -4
# a cache leaf's shard against the matching slice of one process's, in
# L2 (a split product rounds where one device's may round otherwise, and
# the recurrences carry it through the steps: at most 0.5% of the leaf's
# largest entry measured on (2, 4))
STATE_L2 = 2.0 ** -5
# (f): a split block's output against one process's on the same inputs
# and weights, in L2 (one bf16 step); its input's and weights' gradients
# within GRAD_L2
BLOCK_OUT_L2 = 2.0 ** -8
# (a)'s control: one process whose first block's output has one bf16
# step flipped in CONTROL_FLIPS of its entries; the split may stand from
# one process as far as CONTROL_X times the control does, where that is
# past the fixed limits
CONTROL_FLIPS, CONTROL_X = 0.01, 2.0
# the readings each arch is held to at the fixed limits alone.  The
# xLSTM's updates and every reading of the smoke hybrid may stand as far
# as the control reaches: Adam's first step moves every element by the
# learning rate whatever its gradient's size, so an element whose
# gradient is near zero moves the other way under another rounding (one
# process at 2 microbatches stands from itself at 1 by 22-24% of the
# xLSTM's conv_w, wk and ln/bias updates, as the (2, 4) split does), and
# the hybrid amplifies a rounding about 4.5x a block (the module's
# docstring)
FIXED_ONLY = {XLSTM: ("loss0", "loss", "grads"), ZAMBA: ()}
# (g): the shared attention's window
WINDOW = 8
quiet = lambda *a, **k: None  # noqa: E731


def _register() -> None:
    """The meshes beside ``local:cpu-mesh8``: (8, 1), (1, 4) and (4, 2)
    (registered in the ranks' processes only)."""
    from repro_torch.core.target import TARGETS, get_target, register
    register_targets()
    base = get_target(MESHES["2x4"])
    if MESHES["4x2"] not in TARGETS:
        register(dataclasses.replace(base, name=MESHES["4x2"],
                                     mesh_shape=(4, 2)))


def _build(arch, target, plan="1", seq=SEQ):
    app = AppSpec(arch=arch, shape="train_4k",
                  shape_overrides={"seq_len": seq, "global_batch": BATCH})
    return BuildService().build(app, target, overrides=PLANS[plan],
                                lower=False)


def _plans(arch, key) -> tuple:
    return ("1",) + (("2",) if key == "2x4" else ()) + \
        (("8bit",) if (arch, key) in EIGHT_BIT else ())


# the axis of a stacked block weight (past its layer axes) that its
# product contracts, where it is not the first: the mLSTM's per-head
# projections (heads, dv, dqk)
_CONTRACTED = {"wq": 1, "wk": 1, "wv": 1}


def _params(arch) -> dict:
    """``init_params`` from seed 0, each stacked block weight drawn with
    its own layer's fan-in (``init_params`` takes a stacked leaf's fan-in
    from its first layer axis, 2 here).  Under that law the smoke models
    are chaotic: a one-rounding change of one block's output grows about
    10x a block (measured on ``zamba2-7b-smoke``: 2.3e-5 at its third
    block, 2.1e-3 three blocks on), so no rounding order could hold the
    gradients to GRAD_L2; ``chip_smoke.py``'s gradient gates redraw the
    same way (``_fan_in_draw``)."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.split import layer_axes
    table = model_for(get_config(arch)).param_table()
    params = init_params(table, torch.Generator().manual_seed(0), "cpu")
    for (path, d), (_, w) in zip(leaf_items(table), leaf_items(params)):
        lead = layer_axes(path)
        if lead and d.init == "normal" and d.scale is None and \
                w.dim() - lead >= 2:
            fan_in = w.shape[lead + _CONTRACTED.get(path[-1], 0)]
            w.mul_((w.shape[0] / fan_in) ** 0.5)
    return params


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _host(state):
    return tree_map(lambda x: _whole(x).detach().clone(), state)


def _grads(grads, params) -> dict:
    """path -> the whole f32 gradient, in its parameter's shape (a
    per-layer list stacked; a split step's shards put back as the
    parameter's DTensor and gathered)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for path, g in leaf_items(grads, lambda x: not isinstance(x, dict)):
        x = params
        for k in path:
            x = x[k]
        local = x.to_local() if hasattr(x, "to_local") else x
        g = (torch.stack(g) if isinstance(g, list) else g).reshape(
            local.shape)
        if hasattr(x, "to_local"):
            g = DTensor.from_local(g.contiguous(), x.device_mesh,
                                   x.placements, run_check=False,
                                   shape=x.shape,
                                   stride=x.stride()).full_tensor()
        out["/".join(path)] = g.float()
    return out


def _state(res, params, mesh=None, remat=None):
    from repro_torch.runtime.elastic import reshard_state
    model = model_for(res.appspec.model_config,
                      remat=remat or res.plan.remat_policy)
    opt = _Capture(make_optimizer(res.plan.optimizer))
    state = init_train_state(model, opt, tree_map(torch.clone, params),
                             res.plan)
    if mesh is not None:
        state = reshard_state(state, res.tables["state"], mesh)
    return model, opt, state


def _run(res, params, mesh=None, n=STEPS, remat=None):
    """n steps from ``params`` (the plan's remat policy, or ``remat``):
    (losses, the first step's collectives and gradients, the state, the
    model and the step)."""
    model, opt, state = _state(res, params, mesh, remat)
    step = build_train_step(model, opt, res.plan, mesh, **LR)
    pipe = DataPipeline(model, res.appspec.shape_config, seed=0,
                        device="cpu")
    losses, comm, grads = [], None, None
    for i in range(n):
        state, metrics = step(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            comm = metrics["collectives"]
            grads = _grads(opt.grads[0], state["params"])
    return losses, comm, grads, state, model, step


def _next_batch(model, res):
    return DataPipeline(model, res.appspec.shape_config, seed=0,
                        device="cpu").batch_at(STEPS)


def _shards(tree, path=()) -> dict:
    """path -> (a cache leaf's local tensor, its [start, stop) along each
    axis of the whole)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_shards(v, path + (k,)))
        return out
    if not isinstance(tree, torch.Tensor):
        return out
    name = "/".join(path)
    if hasattr(tree, "to_local"):
        from repro_torch.sharding.rules import shard_index
        dm = tree.device_mesh
        idx = shard_index(tree.shape, tree.placements, tuple(dm.shape),
                          dm.get_coordinate())
        out[name] = (tree.to_local().clone(),
                     [(s.start, s.stop) for s in idx])
    else:
        out[name] = (tree.clone(), [(0, n) for n in tree.shape])
    return out


def _legacy_run(arch, target, out: Path, tag: str) -> dict:
    """(c) and (d) on ``target``: the tokens, the weights' gathers, and
    whether every cache leaf's local shape is its spec's shard; the
    logits of the prefill and each decode step and the last cache's
    shards go to ``out`` as ``<tag>.pt``."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.params import partition_specs
    from repro_torch.sharding.rules import DEFAULT_RULES, local_slices
    seen, logits, last = [], [], {}
    generate = serve_mod.legacy_generate

    def wrap(fn):
        def step(*args):
            out_, cache = fn(*args)
            logits.append(out_.float().clone())
            last["cache"] = cache
            return out_, cache
        return step

    def keep(prefill, decode, *args):
        res = generate(wrap(prefill), wrap(decode), *args)
        seen.append(res[0].tolist())
        return res
    serve_mod.legacy_generate = keep
    watch = _SplitWatch()
    b, s, n = LEGACY
    try:
        serve_mod._legacy_serve_main(arch, b, s, n, target, 0, quiet,
                                     torch.device("cpu"))
    finally:
        serve_mod.legacy_generate = generate
        watch.close()
    cache = last["cache"]
    shapes_ok = True
    if any(hasattr(x, "to_local") for _, x in leaf_items(cache)):
        from repro_torch.configs import get_config
        model = model_for(get_config(arch))
        x0 = next(x for _, x in leaf_items(cache) if hasattr(x, "to_local"))
        mesh = _MeshOf(x0)
        specs = dict(leaf_items(partition_specs(
            model.cache_table(b, s + n), mesh, DEFAULT_RULES)))
        for path, x in leaf_items(cache):
            if hasattr(x, "to_local"):
                want = tuple(sl.stop - sl.start for sl in local_slices(
                    specs[path], x.shape, mesh, mesh.coordinate()))
                shapes_ok &= tuple(x.to_local().shape) == want
    torch.save({"logits": logits, "cache": _shards(cache)},
               out / f"{tag}.pt")
    return {"tokens": seen[0], "gathers": watch.read(),
            "local_shapes_match_specs": shapes_ok}


class _MeshOf:
    """The names, shape and coordinate of a DTensor's mesh, as the rules
    read a ``launch.mesh.Mesh``."""

    def __init__(self, x):
        dm = x.device_mesh
        self.axis_names = tuple(dm.mesh_dim_names)
        self.shape = tuple(dm.shape)
        self._coord = tuple(dm.get_coordinate())

    def coordinate(self):
        return self._coord


# the blocks (f) holds, by arch: (params key, kind)
BLOCKS = {XLSTM: (("mlstm", "mlstm"), ("slstm", "slstm")),
          ZAMBA: (("mamba", "mamba"), ("shared", "shared"))}


def _block(arch, key, kind, params, split=None, pls=None) -> dict:
    """(f): the first layer of ``params[key]`` (the rank's shards, or
    whole) on seeded inputs, its output's dot with a seeded cotangent
    differentiated: {"out", "dx", "grads"} (the gradients whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as MB, ssm as SS
    from repro_torch.models.ssm import per_layer
    from repro_torch.sharding.split import layer_axes, layer_placements
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen).to(
        cfg.activation_dtype).requires_grad_()
    G = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
    lead = layer_axes((key,))

    def local(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return (per_layer(t, lead)[0] if lead else t).detach() \
            .requires_grad_()
    p = tree_map(local, params[key])
    used = p if split is None else split.use(p, (key,))
    if kind == "mlstm":
        out = SS.mlstm_block_apply(used, x, cfg, "full", None,
                                   cfg.ssm_chunk, split)[0]
    elif kind == "slstm":
        out = SS.slstm_block_apply(used, x, cfg, "full", None, split)[0]
    elif kind == "mamba":
        out = MB.mamba_block_apply(used, x, cfg, "full", None,
                                   cfg.ssm_chunk, split)[0]
    else:
        model = model_for(cfg)
        model.tp = split
        positions = torch.arange(SEQ).expand(BATCH, SEQ)
        out = model.shared_block_apply(used, x, positions, "full", None)[0]
    (out.float() * G).sum().backward()
    grads = {}
    for path, w in leaf_items(p):
        g = w.grad
        whole = params[key]
        for k in path:
            whole = whole[k]
        if hasattr(whole, "to_local"):
            g = DTensor.from_local(g.contiguous(), whole.device_mesh,
                                   layer_placements(list(whole.placements),
                                                    lead),
                                   run_check=False).full_tensor()
        grads["/".join(path)] = g.float()
    return {"out": out.detach().float(), "dx": x.grad.float(),
            "grads": grads}


class _Flip:
    """(a)'s control: one process whose first block (of each forward)
    hands on its output with one bf16 step flipped in CONTROL_FLIPS of
    its entries (a seeded mask, the same at every call)."""

    def __init__(self, arch, per_forward: int):
        from repro_torch.models import mamba as MB, ssm as SS
        self.mod, self.name = (SS, "mlstm_block_apply") if arch == XLSTM \
            else (MB, "mamba_block_apply")
        self.orig, self.calls, self.per = getattr(self.mod, self.name), 0, \
            per_forward
        setattr(self.mod, self.name, self)

    def __call__(self, *args, **kw):
        x, cache = self.orig(*args, **kw)
        self.calls += 1
        if self.calls % self.per == 1:
            gen = torch.Generator().manual_seed(7)
            flip = torch.rand(x.shape, generator=gen) < CONTROL_FLIPS
            x = torch.where(flip, (x.float() * (1 + 2.0 ** -7)).to(x.dtype),
                            x)
        return x, cache

    def close(self):
        setattr(self.mod, self.name, self.orig)


def _distance(got: dict, want: dict, start) -> dict:
    """How far a run (``got``: losses, grads, state) stands from
    ``want``: each loss's relative difference, the worst leaf's gradient
    in L2 (relative), the worst leaf's change over the steps in L2
    (relative to ``want``'s change)."""
    losses = [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                  want["losses"])]
    grads = max(float((got["grads"][k] - w).norm()) /
                max(float(w.norm()), 1e-30)
                for k, w in want["grads"].items())
    update = 0.0
    for (path, g), (_, w), (_, s0) in zip(leaf_items(got["state"]),
                                          leaf_items(want["state"]),
                                          leaf_items(start)):
        if w.dtype.is_floating_point:
            dw, dg = w.float() - s0.float(), g.float() - s0.float()
            if float(dw.norm()):
                update = max(update, float((dg - dw).norm()) /
                             float(dw.norm()))
    return {"loss0": losses[0], "loss": max(losses), "grads": grads,
            "update": update}


def _window_run(mesh=None) -> list:
    """(g): ``zamba2-7b-smoke`` with a WINDOW-position sliding window, on
    ``mesh`` (the split steps) or one process: the logits of a prefill of
    2 WINDOW tokens, of one of WINDOW tokens, of one decode step over the
    latter's cache (a ring buffer of WINDOW positions), and of that step
    over one process's cache at rest under the sequence-parallel rules
    (one process: the step over its own cache again)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import partition_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding.rules import SEQUENCE_PARALLEL_RULES, distribute
    from repro_torch.training.steps import (build_decode_step,
                                            build_prefill_step)
    model = model_for(get_config(ZAMBA).replace(window=WINDOW),
                      remat="none")
    whole = _params(ZAMBA)
    params = whole if mesh is None else reshard_state(
        whole, model.param_table(), mesh)
    prefill, decode = build_prefill_step(model, mesh), \
        build_decode_step(model, mesh)
    tokens = (torch.arange(BATCH * 2 * WINDOW, dtype=torch.int32) * 7 %
              251).reshape(BATCH, 2 * WINDOW)
    nxt = tokens[:, WINDOW:WINDOW + 1]
    long, _ = prefill(params, {"tokens": tokens})
    short, cache = prefill(params, {"tokens": tokens[:, :WINDOW]})
    step, _ = decode(params, cache, nxt)
    if mesh is None:
        return [t.float() for t in (long, short, step, step)]
    _, one = build_prefill_step(model)(whole, {"tokens": tokens[:, :WINDOW]})
    specs = dict(leaf_items(partition_specs(
        model.cache_table(BATCH, WINDOW), mesh, SEQUENCE_PARALLEL_RULES)))
    at_rest = {}
    for path, x in leaf_items(one):
        at = at_rest
        for k in path[:-1]:
            at = at.setdefault(k, {})
        at[path[-1]] = x if path == ("index",) else distribute(
            x, specs[path], mesh)
    # the ring split along its sequence over ``model``, the heads whole
    model_dim = mesh.axis_names.index("model")
    k_pl = at_rest["shared_kv"]["k"].placements[model_dim]
    ssm_pl = at_rest["mamba"]["ssm"].placements[model_dim]
    assert k_pl.is_shard() and k_pl.dim == 2 and not ssm_pl.is_shard()
    sp, _ = decode(params, at_rest, nxt)
    return [t.float() for t in (long, short, step, sp)]


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist
    from repro_torch.core.target import get_target
    from repro_torch.launch.mesh import degraded_mesh, mesh_for_target
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    _register()
    params = {a: torch.load(out / f"{a}.pt") for a in ARCHS}
    got, saved = {"rank": rank}, {}

    # (a), and (e)'s checkpoints after the (2, 4) mesh's steps at M = 1
    for arch in ARCHS:
        for key in TRAIN[arch]:
            for plan in _plans(arch, key):
                res = _build(arch, MESHES[key], plan)
                if res.mesh.coordinate() is None:
                    continue
                losses, comm, grads, state, model, step = _run(
                    res, params[arch], res.mesh)
                host = _host(state)
                got[f"train {arch} {key} {plan}"] = {"losses": losses,
                                                     "collectives": comm}
                if rank == 0:
                    saved[f"grads {arch} {key} {plan}"] = grads
                    saved[f"state {arch} {key} {plan}"] = host
                if key != "2x4" or plan != "1":
                    continue
                ck_dir = out / f"ckpt_{arch}"
                Checkpointer(ck_dir, now=lambda: CLOCK,
                             mesh=res.mesh).save(STEPS - 1, state)
                nxt = _next_batch(model, res)
                _, m = step(state, nxt)
                ck = {"unbroken": float(m["loss"])}
                template = _state(res, params[arch], res.mesh)[2]
                restored, at = Checkpointer(ck_dir, mesh=res.mesh).restore(
                    template)
                ck["at"] = at
                ck["equal"] = all(torch.equal(_whole(a), b) for (_, a), (
                    _, b) in zip(leaf_items(restored), leaf_items(host)))
                _, m = step(restored, nxt)
                ck["restored"] = float(m["loss"])
                small = degraded_mesh(get_target(MESHES["2x4"]))
                if small.coordinate() is not None:
                    model2, opt2, tmpl = _state(res, params[arch], small)
                    state2, _ = Checkpointer(ck_dir, mesh=small).restore(tmpl)
                    ck["small_equal"] = all(
                        torch.equal(_whole(a), b) for (_, a), (_, b) in
                        zip(leaf_items(state2), leaf_items(host)))
                    step2 = build_train_step(model2, opt2, res.plan, small,
                                             **LR)
                    _, m = step2(state2, nxt)
                    ck["small"] = float(m["loss"])
                if rank == 0:
                    Checkpointer(out / f"one_ckpt_{arch}",
                                 now=lambda: CLOCK).save(STEPS - 1, host)
                got[f"ckpt {arch}"] = ck

    # (f): each block alone on every training mesh
    from repro_torch.training.steps import split_for
    from repro_torch.runtime.elastic import reshard_state
    for arch in ARCHS:
        for key in TRAIN[arch]:
            res = _build(arch, MESHES[key])
            if res.mesh.coordinate() is None:
                continue
            at_rest = reshard_state(params[arch], res.tables["params"],
                                    res.mesh)
            split = split_for(res.mesh, at_rest, ())
            for pkey, kind in BLOCKS[arch]:
                got_b = _block(arch, pkey, kind, at_rest, split)
                if rank == 0:
                    saved[f"block {arch} {key} {kind}"] = got_b

    # (b): the xLSTM step at twice the tokens a row
    res = _build(XLSTM, MESHES["2x4"], "1", 2 * SEQ)
    got["xlstm_seq64"] = _run(res, params[XLSTM], res.mesh, 1)[1]

    # (c), (d): the legacy serve path on each mesh
    for key in SERVE:
        target = get_target(MESHES[key])
        for arch in ARCHS:
            if rank < target.num_chips:
                got[f"serve {arch} {key}"] = _legacy_run(
                    arch, MESHES[key], out, f"rank{rank}_{key}_{arch}")
            else:
                mesh_for_target(target)
            most, whole = serve_reckoning(arch, MESHES[key])
            got[f"reckoning {arch} {key}"] = [most, sorted(whole)]

    # (g): the windowed shared attention split by heads
    for key in ("2x4", "1x4"):
        res = BuildService().build(AppSpec(arch=ZAMBA, shape="prefill_32k"),
                                   MESHES[key], lower=False)
        if res.mesh.coordinate() is not None:
            got[f"window {key}"] = True
            logits = _window_run(res.mesh)
            if rank == 0:
                saved[f"window {key}"] = logits

    # (e): the build's steps, counted against the reckoning (rank 0's, as
    # the dry run traces it; every rank runs the steps)
    got["collectives"] = {arch: _counted_vs_reckoned(arch, rank == 0)
                          for arch in ARCHS}
    if rank == 0:
        torch.save(saved, out / "saved.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests


def _one(params: dict, out: Path) -> dict:
    """The one-process side, run while the ranks run."""
    from repro_torch.configs import get_config
    torch.set_num_threads(1)
    one = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        per = cfg.num_layers - cfg.num_layers // cfg.slstm_every \
            if arch == XLSTM else cfg.num_layers
        for plan in PLANS:
            res = _build(arch, "local:cpu", plan)
            losses, _, grads, state, model, step = _run(res, params[arch])
            one[f"train {arch} {plan}"] = {"losses": losses, "grads": grads,
                                           "state": _host(state)}
            if plan != "2":
                one[f"start {arch} {plan}"] = _host(
                    _state(res, params[arch])[2])
            if plan == "1":
                one[f"res {arch}"] = res
            # no recompute: the flip lands once a forward (remat moves no
            # bit of a step)
            flip = _Flip(arch, per)
            try:
                losses, _, grads, state, _, _ = _run(res, params[arch],
                                                     remat="none")
            finally:
                flip.close()
            one[f"control {arch} {plan}"] = _distance(
                {"losses": losses, "grads": grads, "state": _host(state)},
                one[f"train {arch} {plan}"], _start(one, arch, plan))
        for pkey, kind in BLOCKS[arch]:
            one[f"block {arch} {kind}"] = _block(arch, pkey, kind,
                                                 params[arch])
        one[f"serve {arch}"] = _legacy_run(arch, "local:cpu", out,
                                           f"one_{arch}")
    one["window"] = _window_run()
    return one


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """One spawn of the 8 ranks and, while they run, the same work in
    this one process on one device."""
    out = tmp_path_factory.mktemp("spmd_recurrent")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    params = {a: _params(a) for a in ARCHS}
    for a, p in params.items():
        torch.save(p, out / f"{a}.pt")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    n = torch.get_num_threads()
    try:
        one = _one(params, out)
        for p in procs:
            left = SPAWN_TIMEOUT_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0])
    finally:
        torch.set_num_threads(n)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    return {"out": out, "params": params, "one": one,
            "saved": torch.load(out / "saved.pt"),
            "ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(WORLD)],
            "seconds": time.perf_counter() - t0}


def _members(spawn, key):
    size = 1
    for k in key.split("x"):
        size *= int(k)
    return spawn["ranks"][:size]


def _start(one, arch, plan):
    """The initial state a plan's run starts from (one process's)."""
    return one[f"start {arch} {'8bit' if plan == '8bit' else '1'}"]


_TRAIN_CASES = [(a, k, p) for a in ARCHS for k in TRAIN[a]
                for p in _plans(a, k)]


@pytest.mark.parametrize("arch,key,plan", _TRAIN_CASES)
def test_split_training_matches_one_process(spawn, arch, key, plan):
    """(a): the losses, the first step's gradients and each leaf's update
    within the fixed limits, or within CONTROL_X times the control's
    distance where that is farther (printed beside the split's)."""
    one = spawn["one"]
    want = one[f"train {arch} {plan}"]
    control = one[f"control {arch} {plan}"]
    limits = {"loss0": LOSS1_RTOL, "loss": LOSS_RTOL, "grads": GRAD_L2,
              "update": UPDATE_L2}
    # a scalar's difference is as likely small as large for a perturbation
    # of one size: each loss is held to the control's largest
    control = dict(control, loss0=control["loss"])
    for r in _members(spawn, key):
        losses = r[f"train {arch} {key} {plan}"]["losses"]
        saved = spawn["saved"]
        got = _distance({"losses": losses,
                         "grads": saved[f"grads {arch} {key} {plan}"],
                         "state": saved[f"state {arch} {key} {plan}"]},
                        want, _start(one, arch, plan))
        if r["rank"] == 0:
            print(f"{arch} on {key}, plan {PLANS[plan]}: split {got}, "
                  f"control {control}")
        for k, limit in limits.items():
            if k not in FIXED_ONLY[arch]:
                limit = max(limit, CONTROL_X * control[k])
            assert got[k] <= limit, (r["rank"], k, got[k], limit)
    assert spawn["saved"][f"grads {arch} {key} {plan}"].keys() == \
        want["grads"].keys()


@pytest.mark.parametrize("arch,key", [(a, k) for a in ARCHS
                                      for k in TRAIN[a]])
def test_each_split_block_matches_one_process(spawn, arch, key):
    """(f): every block alone, on the same inputs and weights: output
    within BLOCK_OUT_L2, its input's and weights' gradients within
    GRAD_L2."""
    for pkey, kind in BLOCKS[arch]:
        want = spawn["one"][f"block {arch} {kind}"]
        got = spawn["saved"][f"block {arch} {key} {kind}"]

        def rel(a, b):
            return float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert rel(got["out"], want["out"]) <= BLOCK_OUT_L2, (kind, key)
        assert rel(got["dx"], want["dx"]) <= GRAD_L2, (kind, key)
        assert got["grads"].keys() == want["grads"].keys()
        worst = max(rel(got["grads"][k], w) for k, w in
                    want["grads"].items() if float(w.norm()))
        assert worst <= GRAD_L2, (kind, key, worst)
        print(f"{arch} {kind} on {key}: output "
              f"{rel(got['out'], want['out']):.3g}, input gradient "
              f"{rel(got['dx'], want['dx']):.3g}, worst weight gradient "
              f"{worst:.3g}")


def test_no_collective_inside_the_time_loop(spawn):
    """(b): the same calls, of the same kinds, at 32 and 64 tokens a
    row; only the activations' bytes grow."""
    for r in spawn["ranks"]:
        short = r[f"train {XLSTM} 2x4 1"]["collectives"]
        long = r["xlstm_seq64"]
        assert {k: v["calls"] for k, v in short.items()} == \
            {k: v["calls"] for k, v in long.items()}, r["rank"]
        assert short["reduce_scatter"]["calls"] > 0


def _parting(got: list, want: list, logits_got: list, logits_want: list):
    """The first decode step (an index into the logits: 0 is the
    prefill's) at which a greedy stream parts from one process's, and
    the row, or None."""
    for i in range(len(want[0])):
        for row, (g, w) in enumerate(zip(got, want)):
            if g[i] != w[i]:
                return i, row
    return None


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", SERVE)
def test_split_legacy_serving_matches_one_process(spawn, arch, key):
    """(c): the streams exactly, or parted at a near tie (printed); each
    step's logits within LOGITS_STEP_L2 up to any parting (on (8, 1) bit
    for bit); each cache leaf's shard of its spec's shape and, where no
    stream parted, within STATE_L2 of one process's (on (8, 1) bit for
    bit)."""
    out = spawn["out"]
    want = spawn["one"][f"serve {arch}"]
    b, s, n = LEGACY
    assert len(want["tokens"]) == b and len(want["tokens"][0]) == n
    one = torch.load(out / f"one_{arch}.pt")
    exact = key == "8x1"
    worst, parted = 0.0, 0
    for r in _members(spawn, key):
        got = r[f"serve {arch} {key}"]
        assert got["local_shapes_match_specs"], (r["rank"], key)
        saved = torch.load(out / f"rank{r['rank']}_{key}_{arch}.pt")
        assert len(saved["logits"]) == len(one["logits"]) == n
        part = _parting(got["tokens"], want["tokens"], saved["logits"],
                        one["logits"])
        assert part is None or not exact, (r["rank"], key)
        if part is not None:
            i, row = part
            w = one["logits"][i][row, -1]
            top2 = w.topk(2).values
            margin = float(top2[0] - top2[1])
            dev = float((saved["logits"][i][row, -1] - w).abs().max())
            print(f"{arch} on {key} rank {r['rank']}: row {row} parts at "
                  f"decode step {i} at a top-2 margin of {margin:.4g} "
                  f"(largest logit {float(w.abs().max()):.4g}), the "
                  f"split's deviation there {dev:.4g}")
            assert margin <= dev, (r["rank"], key, i, row, margin, dev)
        steps = n if part is None else part[0] + 1
        for i, (g, w) in enumerate(zip(saved["logits"][:steps],
                                       one["logits"][:steps])):
            rel = float((g - w).norm() / w.norm())
            worst, parted = max(worst, rel), parted + (rel > 0)
            assert rel <= (0.0 if exact else LOGITS_STEP_L2), \
                (r["rank"], key, i, rel)
        assert saved["cache"].keys() == one["cache"].keys()
        for name, (shard, idx) in saved["cache"].items():
            ref = one["cache"][name][0][tuple(slice(a, z) for a, z in idx)]
            assert ref.shape == shard.shape, (name, ref.shape, shard.shape)
            unequal = int((shard != ref).sum())
            if exact:
                assert unequal == 0, (r["rank"], name)
                continue
            if part is not None or not shard.dtype.is_floating_point:
                assert part is not None or unequal == 0, (r["rank"], name)
                continue
            rel = float((shard.float() - ref.float()).norm()) / \
                max(float(ref.float().norm()), 1e-30)
            print(f"{arch} on {key} rank {r['rank']} {name}: {unequal} of "
                  f"{shard.numel()} entries unequal, {rel:.3g} in L2")
            assert rel <= STATE_L2, (r["rank"], key, name, rel)
    print(f"{arch} on {key}: {parted} step logits not equal bit for bit "
          f"over the ranks, worst L2 {worst:.3g}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", SERVE)
def test_split_legacy_gathers_one_layer_along_data(spawn, arch, key):
    """(d): no weight gathered along ``model``; at most the reckoning
    alive at once, none after the run; the (1, 4) mesh has no ``data``
    split (nothing is gathered); one process gathers nothing."""
    for r in _members(spawn, key):
        g = r[f"serve {arch} {key}"]["gathers"]
        most, whole = r[f"reckoning {arch} {key}"]
        assert g["alive_after"] == 0, (r["rank"], key)
        assert g["most"] <= most, (r["rank"], key, g["most"], most)
        if key == "1x4":
            assert g["gathered"] == 0
        else:
            assert g["gathered"] > 0 and g["most"] > 0
        assert not {tuple(s) for s in whole} & \
            {tuple(s) for s in g["shapes"]}, r["rank"]
        if key == "2x4":
            assert whole
    assert spawn["one"][f"serve {ARCHS[0]}"]["gathers"]["gathered"] == 0


@pytest.mark.parametrize("key", ["2x4", "1x4"])
def test_windowed_shared_attention_split_by_heads(spawn, key):
    """(g): the windowed prefill, the window-long prefill and the ring
    buffer's decode step, split by heads, within LOGITS_STEP_L2 of one
    process's."""
    assert all(r.get(f"window {key}") for r in _members(spawn, key))
    got, want = spawn["saved"][f"window {key}"], spawn["one"]["window"]
    for what, g, w in zip(("prefill 2 x window", "prefill window",
                           "ring decode", "ring decode, sequence-parallel "
                           "cache"), got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        rel = float((g - w).norm() / w.norm())
        print(f"{key} {what}: logits {rel:.3g} in L2")
        assert rel <= LOGITS_STEP_L2, (key, what, rel)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_recurrent_collectives_equal_the_reckoning(spawn, arch, shape):
    """(e): the build's steps on (2, 4) send what the dry run counts for
    their cells (rank 0's, the rank the dry run traces)."""
    for r in spawn["ranks"][:1]:
        c = r["collectives"][arch][shape]
        assert c["counted"] == c["reckoned"], (r["rank"], arch, shape)
        assert c["counted"]["all_gather"]["calls"] > 0
        assert c["counted"]["all_reduce"]["calls"] > 0
        assert c["wire_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_of_a_sharded_recurrent_state(spawn, arch):
    """(e): the archive is one process's; restores onto (2, 4), (1, 4)
    and one process hold the saved state, and the next step follows."""
    out, one = spawn["out"], spawn["one"]
    name = f"step_{STEPS - 1}"
    for f in ("arrays.npz", "meta.json"):
        assert (out / f"ckpt_{arch}" / name / f).read_bytes() == \
            (out / f"one_ckpt_{arch}" / name / f).read_bytes(), f
    ranks = spawn["ranks"]
    unbroken = ranks[0][f"ckpt {arch}"]["unbroken"]
    # (a)'s limit of a first loss
    limit = max(LOSS1_RTOL, CONTROL_X * one[f"control {arch} 1"]["loss"])
    for r in ranks:
        ck = r[f"ckpt {arch}"]
        assert ck["at"] == STEPS - 1 and ck["equal"], r["rank"]
        assert ck["restored"] == ck["unbroken"] == unbroken, r["rank"]
    for r in ranks[:4]:
        ck = r[f"ckpt {arch}"]
        assert ck["small_equal"], r["rank"]
        assert abs(ck["small"] - unbroken) <= limit * unbroken
    assert all("small" not in r[f"ckpt {arch}"] for r in ranks[4:])
    res = one[f"res {arch}"]
    model, opt, template = _state(res, spawn["params"][arch])
    state, at = Checkpointer(out / f"ckpt_{arch}").restore(template)
    assert at == STEPS - 1
    saved = spawn["saved"][f"state {arch} 2x4 1"]
    for (p, a), (_, b) in zip(leaf_items(state), leaf_items(saved)):
        assert torch.equal(a, b), p
    step = build_train_step(model, opt, res.plan, **LR)
    _, m = step(state, _next_batch(model, res))
    assert abs(float(m["loss"]) - unbroken) <= limit * unbroken


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
