"""The enc-dec family split along the model axis, and the two refusals on a
mesh lifted with it: ``whisper-tiny-smoke`` trained and served on 8 CPU
ranks over gloo against one process, the fused stencil kernel's run on
several ranks, and a legacy decode over a cache split along its
sequence grown for the tokens to come.

One spawn of 8 ranks runs every check that needs ranks, on
``local:cpu-mesh8`` ((2, 4) over ``("data", "model")``: the smoke
model's 2 heads do not divide the model axis, so attention and
cross-attention run every head on each rank while the MLP and the tied
vocabulary split), on (4, 2) (the heads split one a rank: self- and
cross-attention by heads) and on the data-only (8, 1).  The one-process
side runs in this process meanwhile, from the same weights
(``init_params`` from seed 0, each stacked matrix redrawn at its own
layer's fan-in as the other split tests draw them, written for the
ranks):

(a) two train steps at 1 microbatch on (2, 4) and (4, 2), at 2 on
    (2, 4) and with 8-bit moments on (4, 2): the first loss within
    LOSS1_RTOL of one process's and every loss within LOSS_RTOL, the
    first step's gradients within GRAD_L2 of each leaf's L2 norm, each
    leaf's update over the two steps within UPDATE_L2 of one process's
    (``tests/test_torch_spmd.py``'s limits), every rank's losses the
    same;
(b) the weights a train step holds gathered along ``data`` at once
    equal to the dry run's reckoning (``launch.dryrun.
    gathered_at_once``), and none whole along a dimension its spec
    splits over ``model``;
(c) the legacy serve path (``_legacy_serve_main``, 4 x 16 + 6 greedy
    tokens) through the split prefill and decode steps on each mesh:
    the streams one process's, each step's logits within LOGITS_STEP_L2
    in L2 (``tests/test_torch_spmd_serve_split.py``'s limit), every
    cache leaf's shard of the shape its spec gives; on (8, 1), where no
    product is split, logits and every rank's cache shards bit for bit
    one process's; the weights each serve step gathers at most the dry
    run's reckoning alive at once, none after the run, none whole along
    a dimension split over ``model``;
(d) the build's train, prefill and decode steps' collectives counted on
    the live (2, 4) mesh equal the dry run's reckoning of the same cells;
(e) ``lulesh.run(..., mesh, use_kernel=True)`` on (2, 4): the kernel
    (on the CPU its plain version) steps the global grid, each rank
    keeping its block, bit for bit one device's kernel run over several
    steps;
(f) on (2, 4), for ``whisper-tiny-smoke`` (its self and cross K/V) and
    ``mistral-large-123b-smoke`` (4 heads over 2 kv heads: the heads
    split, the kv heads whole): a prefill whose cache rests under
    ``DECODE_SEQ_CACHE_RULES`` (split along its sequence over
    ``model``), ``grow_kv`` by GROW positions (the grown K/V rest split
    along the sequence again), then teacher-forced whole-batch decode
    steps: each step's logits within LOGITS_STEP_L2 of one process's.

``test_cross_attention_split_by_heads`` needs no ranks: each rank's
``layers.attention(..., kv_source=, tp=)`` on its heads of a 2- or 4-way
model axis, its partial sums added, against the whole call.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_encdec.py``; the file is also each rank's program:
``python tests/test_torch_spmd_encdec.py RANK DIR``.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_spmd import (GRAD_L2, LOSS1_RTOL, LOSS_RTOL, UPDATE_L2)
from test_torch_spmd_recurrent import (_host, _legacy_run, _register, _run,
                                       _state)
from test_torch_spmd_serve import (SPAWN_TIMEOUT_S, _counted_vs_reckoned,
                                   serve_reckoning)
from test_torch_spmd_serve_split import LOGITS_STEP_L2
from test_torch_spmd_train import _GatheredWatch

from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.models.params import init_params, leaf_items
from repro_torch.models.transformer import model_for

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
ARCH = "whisper-tiny-smoke"
GQA = "mistral-large-123b-smoke"
MESHES = {"2x4": "local:cpu-mesh8", "4x2": "local:cpu-mesh4x2",
          "8x1": "local:cpu-dp8"}
# (a)'s plans: 1 microbatch on both meshes, 2 on (2, 4), 8-bit moments
# on (4, 2), where the heads split
PLANS = {"1": {"microbatches": 1}, "2": {"microbatches": 2},
         "8bit": {"microbatches": 1, "optimizer": "adamw8bit"}}
TRAIN = {"2x4": ("1", "2"), "4x2": ("1", "8bit")}
SEQ, BATCH = 32, 4
SERVE = ("2x4", "4x2", "8x1")
# (e): LULESH's grid and kernel steps
LULESH_GRID, LULESH_STEPS = 16, 4
# (f): rows, prompt and frames, the positions grown (the prompt and the
# grown length both divide the model axis's 4 ranks), the decode steps
GROW = (4, 16, 8)
GROW_ARCHS = (ARCH, GQA)


def _build(target, plan="1"):
    app = AppSpec(arch=ARCH, shape="train_4k",
                  shape_overrides={"seq_len": SEQ, "global_batch": BATCH})
    return BuildService().build(app, target, overrides=PLANS[plan],
                                lower=False)


def _params(arch=ARCH) -> dict:
    """``init_params`` from seed 0, each stacked matrix redrawn at its own
    layer's fan-in, the axes its product contracts (``wo``'s heads and
    head dim; ``init_params`` takes a stacked leaf's fan-in from its
    layer axis, 2 here, under which the smoke model amplifies one
    rounding of its first attention's output past LOSS1_RTOL)."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.split import layer_axes
    table = model_for(get_config(arch)).param_table()
    params = init_params(table, torch.Generator().manual_seed(0), "cpu")
    for (path, d), (_, w) in zip(leaf_items(table), leaf_items(params)):
        lead = layer_axes(path)
        if lead and d.init == "normal" and d.scale is None and \
                w.dim() - lead >= 2:
            fan_in = math.prod(w.shape[lead:-1]) if path[-1] == "wo" and \
                w.dim() - lead == 3 else w.shape[lead]
            w.mul_((w.shape[0] / fan_in) ** 0.5)
    return params


def _reckoning(target: str) -> list:
    """[the dry run's reckoning of the weights a serve step holds gathered
    at once, the shapes a weight has whole along a dimension its spec
    splits over ``model`` that no weight has as a split step gathers it
    (whisper-smoke's embedding gathered on (4, 2), its vocabulary halved,
    has the MLP's ``wo``'s whole shape)] on ``target``'s mesh."""
    from repro_torch.sharding.rules import placements
    from repro_torch.sharding.split import layer_axes
    most, whole = serve_reckoning(ARCH, target)
    res = BuildService().build(AppSpec(arch=ARCH, shape="decode_32k"),
                               target, lower=False)
    mesh, used = res.mesh, set()
    model = mesh.axis_names.index("model")
    for (path, d), (_, spec) in zip(leaf_items(res.tables["params"]),
                                    leaf_items(res.specs["params"])):
        shape = list(d.shape)
        for m, pl in enumerate(placements(spec, mesh)):
            if pl.is_shard() and m == model:
                shape[pl.dim] //= mesh.shape[m]
        used.add(tuple(shape[layer_axes(path):]))
    return [most, sorted(whole - used)]


def _grow_run(arch, params, mesh=None) -> list:
    """(f): the prefill of GROW's rows (whisper: frames and prompt of one
    length), its cache (on ``mesh`` at rest under
    ``DECODE_SEQ_CACHE_RULES``) grown by GROW positions, then GROW - 1
    whole-batch decode steps fed seeded tokens: the logits of each, and
    on a mesh the grown K/V's placements."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.launch.serve import grow_kv
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding.rules import DECODE_SEQ_CACHE_RULES
    from repro_torch.training.steps import (build_decode_step,
                                            build_prefill_step)
    import dataclasses
    cfg = get_config(arch)
    model = model_for(cfg, remat="none")
    b, s, n = GROW
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=s,
                                global_batch=b)
    req = to_device(SyntheticSource(cfg.vocab_size, 3).batch(
        model.batch_table(shape), 0), "cpu")
    if mesh is not None:
        params = reshard_state(params, model.param_table(), mesh)
    prefill = build_prefill_step(model, mesh, DECODE_SEQ_CACHE_RULES)
    decode = build_decode_step(model, mesh)
    logits, cache = prefill(params, req)
    out = [logits.float()]
    cache = grow_kv(cache, n)
    placed = {k: [pl.dim if pl.is_shard() else None
                  for pl in cache[k].placements]
              for k in ("k", "xk") if hasattr(cache.get(k), "placements")}
    feed = torch.Generator().manual_seed(4)
    for _ in range(n - 1):
        tok = torch.randint(1, cfg.vocab_size, (b, 1), generator=feed,
                            dtype=torch.int32)
        logits, cache = decode(params, cache, tok)
        out.append(logits.float())
    return out, placed, int(cache["index"]), tuple(cache["k"].shape)


def _lulesh_kernel(mesh) -> dict:
    """(e): LULESH_STEPS kernel steps on ``mesh`` against the same steps
    on one device, in this rank: every field's block bit for bit the
    slice of one device's, at rest under the fields' placements."""
    from repro_torch.models import lulesh
    cfg = lulesh.LuleshConfig(grid=LULESH_GRID)
    one = lulesh.run(lulesh.init_state(cfg, "cpu"), cfg, LULESH_STEPS,
                     use_kernel=True)
    got = lulesh.run(lulesh.init_state(cfg, "cpu"), cfg, LULESH_STEPS,
                     mesh=mesh, use_kernel=True)
    step = lulesh.run(lulesh.init_state(cfg, "cpu"), cfg, LULESH_STEPS,
                      mesh=mesh)
    out = {"local_shape": list(got["rho"].to_local().shape),
           "placements": [str(p) for p in got["rho"].placements],
           "plain_placements": [str(p) for p in step["rho"].placements]}
    for k in ("rho", "e", "v", "t"):
        out[k] = bool(torch.equal(got[k].full_tensor(), one[k]))
    return out


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist
    from repro_torch.core.target import get_target
    from repro_torch.launch.mesh import mesh_for_target
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    _register()
    params = torch.load(out / "params.pt")
    got, saved = {"rank": rank}, {}

    # (a), (b)
    from repro_torch.launch.dryrun import gathered_at_once
    for key, plans in TRAIN.items():
        for plan in plans:
            res = _build(MESHES[key], plan)
            watch = _GatheredWatch()
            try:
                losses, comm, grads, state, _, _ = _run(res, params,
                                                        res.mesh)
            finally:
                gathered = watch.close()
            gathered["reckoned"] = gathered_at_once(
                res.tables["state"]["params"], res.specs["state"]["params"],
                res.mesh, res.plan.remat_policy)
            got[f"train {key} {plan}"] = {"losses": losses,
                                          "collectives": comm,
                                          "gathered": gathered}
            host = _host(state)      # every rank gathers the state
            if rank == 0:
                saved[f"grads {key} {plan}"] = grads
                saved[f"state {key} {plan}"] = host

    # (c)
    for key in SERVE:
        got[f"serve {key}"] = _legacy_run(ARCH, MESHES[key], out,
                                          f"rank{rank}_{key}")
        got[f"reckoning {key}"] = _reckoning(MESHES[key])

    mesh = mesh_for_target(get_target(MESHES["2x4"]))
    # (e)
    got["lulesh"] = _lulesh_kernel(mesh)
    # (f)
    for arch in GROW_ARCHS:
        logits, placed, index, shape = _grow_run(arch, _params(arch), mesh)
        got[f"grow {arch}"] = {"placements": placed, "index": index,
                               "shape": list(shape)}
        if rank == 0:
            saved[f"grow {arch}"] = logits
    # (d): rank 0's reckoning, as the dry run traces it; every rank runs
    # the steps
    got["collectives"] = _counted_vs_reckoned(ARCH, rank == 0)
    if rank == 0:
        torch.save(saved, out / "saved.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests


def _one(params: dict, out: Path) -> dict:
    """The one-process side, run while the ranks run."""
    torch.set_num_threads(1)
    one = {}
    for plan in PLANS:
        res = _build("local:cpu", plan)
        losses, _, grads, state, _, _ = _run(res, params)
        one[f"train {plan}"] = {"losses": losses, "grads": grads,
                                "state": _host(state),
                                "start": _host(_state(res, params)[2])}
    one["serve"] = _legacy_run(ARCH, "local:cpu", out, "one")
    for arch in GROW_ARCHS:
        one[f"grow {arch}"] = _grow_run(arch, _params(arch))[0]
    return one


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """One spawn of the 8 ranks and, while they run, the same work in
    this one process on one device."""
    out = tmp_path_factory.mktemp("spmd_encdec")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    params = _params()
    torch.save(params, out / "params.pt")
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
    return {"out": out, "one": one, "saved": torch.load(out / "saved.pt"),
            "ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(WORLD)]}


def _cases():
    return [(key, plan) for key, plans in TRAIN.items() for plan in plans]


def _dequantized(tree):
    """A state with each 8-bit moment (``m_q``, ``m_s``, ``v_q``, ``v_s``)
    as the f32 moments it stands for: an int8 step flips where a split
    step's moment lands by a rounding on the other side of a step's
    boundary, so the moments are held as the floats they dequantize to."""
    from repro_torch.optim.adamw import _dq8
    if not isinstance(tree, dict):
        return tree
    if "m_q" in tree:
        return {"m": _dq8(tree["m_q"], tree["m_s"]),
                "v": _dq8(tree["v_q"], tree["v_s"])}
    return {k: _dequantized(v) for k, v in tree.items()}


def _scale_of(grads: dict, k: str):
    """The gradient a leaf's is measured against: its own, but for a key
    bias (``bk``), whose gradient is zero in exact arithmetic (softmax is
    invariant to a shift every key shares), its layer's value bias's."""
    return grads[k[:-2] + "bv"] if k.endswith("/bk") else grads[k]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm()) / \
        max(float(want.float().norm()), 1e-30)


@pytest.mark.parametrize("key,plan", _cases())
def test_split_train_matches_one_process(spawn, key, plan):
    """(a): the split train step's losses, first gradients and two steps'
    updates against one process's at the fixed limits; every rank's
    losses the same."""
    want = spawn["one"][f"train {plan}"]
    first = spawn["ranks"][0][f"train {key} {plan}"]["losses"]
    assert abs(first[0] - want["losses"][0]) <= \
        LOSS1_RTOL * abs(want["losses"][0]), (first, want["losses"])
    for g, w in zip(first, want["losses"]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (first, want["losses"])
    for r in spawn["ranks"]:
        assert r[f"train {key} {plan}"]["losses"] == first, r["rank"]
    grads = spawn["saved"][f"grads {key} {plan}"]
    assert grads.keys() == want["grads"].keys()
    far = {}
    for k, w in want["grads"].items():
        scale = float(_scale_of(want["grads"], k).norm())
        if k.endswith("/bk"):
            # zero in exact arithmetic: one process's is rounding residue
            assert float(w.norm()) <= GRAD_L2 * scale, (k, float(w.norm()))
        err = float((grads[k] - w).norm())
        if err > GRAD_L2 * scale + 1e-30:
            far[k] = err / scale
    assert not far, (key, plan, far)
    state, start = (_dequantized(spawn["saved"][f"state {key} {plan}"]),
                    _dequantized(want["start"]))
    for (path, g), (_, w), (_, s0) in zip(leaf_items(state),
                                          leaf_items(_dequantized(
                                              want["state"])),
                                          leaf_items(start)):
        if "bk" in path:
            # a key bias's Adam state and step are its gradient's
            # rounding residue normalized (held above, at its layer's
            # value-bias gradient's scale)
            continue
        if not w.dtype.is_floating_point:
            assert torch.equal(g, w), path
            continue
        dw, dg = w.float() - s0.float(), g.float() - s0.float()
        err = float((dg - dw).norm())
        if err > UPDATE_L2 * float(dw.norm()) + 1e-30:
            far["/".join(path)] = err / float(dw.norm())
    assert not far, (key, plan, far)


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_split_train_gathers_one_layer_at_a_time(spawn, key):
    """(b): the bytes of weights a rank holds gathered along ``data`` at
    once equal the dry run's reckoning, none whole along a dimension its
    spec splits over ``model``; the step sends its collectives."""
    for r in spawn["ranks"]:
        g = r[f"train {key} 1"]["gathered"]
        _, whole = r[f"reckoning {key}"]
        assert g["most"] == g["reckoned"] > 0, (r["rank"], g)
        assert not {tuple(s) for s in whole} & \
            {tuple(s) for s in g["shapes"]}, r["rank"]
        comm = r[f"train {key} 1"]["collectives"]
        assert comm["all_gather"]["calls"] and \
            comm["reduce_scatter"]["calls"], (r["rank"], comm)


@pytest.mark.parametrize("key", SERVE)
def test_split_legacy_serve_matches_one_process(spawn, key):
    """(c): streams, each step's logits and the cache shards against one
    process's; on the data-only (8, 1) bit for bit."""
    want = spawn["one"]["serve"]
    one = torch.load(spawn["out"] / "one.pt")
    exact = key == "8x1"
    for r in spawn["ranks"]:
        got = r[f"serve {key}"]
        assert got["tokens"] == want["tokens"], (r["rank"], key)
        assert got["local_shapes_match_specs"], (r["rank"], key)
        mine = torch.load(spawn["out"] / f"rank{r['rank']}_{key}.pt")
        assert len(mine["logits"]) == len(one["logits"])
        for i, (g, w) in enumerate(zip(mine["logits"], one["logits"])):
            if exact:
                assert torch.equal(g, w), (r["rank"], key, i)
            else:
                assert _rel(g, w) <= LOGITS_STEP_L2, (r["rank"], key, i)
        if exact:
            for name, (t, idx) in mine["cache"].items():
                whole = one["cache"][name][0]
                sl = tuple(slice(a, b) for a, b in idx)
                assert torch.equal(t, whole[sl]), (r["rank"], name)


@pytest.mark.parametrize("key", SERVE)
def test_split_serve_gathers_one_layer_at_a_time(spawn, key):
    """(c): the serve steps gather each layer's shards along ``data``
    alone: at most the dry run's reckoning alive at once, none after the
    run, none whole along a dimension split over ``model``."""
    for r in spawn["ranks"]:
        g = r[f"serve {key}"]["gathers"]
        most, whole = r[f"reckoning {key}"]
        assert g["gathered"] > 0 and 0 < g["most"] <= most, \
            (r["rank"], key, g, most)
        assert g["alive_after"] == 0, (r["rank"], key, g)
        assert not {tuple(s) for s in whole} & \
            {tuple(s) for s in g["shapes"]}, (r["rank"], key)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_reckoned_collectives_equal_the_counted(spawn, shape):
    """(d): Whisper's split steps on (2, 4) send the collectives the dry
    run counts for its cell."""
    c0 = spawn["ranks"][0]["collectives"][shape]
    assert c0["counted"] == c0["reckoned"], shape
    assert c0["counted"]["all_gather"]["calls"] > 0
    assert c0["counted"]["all_reduce"]["calls"] > 0
    assert c0["wire_bytes"] > 0
    for r in spawn["ranks"][1:]:
        assert r["collectives"][shape]["counted"] == c0["counted"], \
            (r["rank"], shape)


def test_kernel_lulesh_on_the_mesh_is_one_device_bit_for_bit(spawn):
    """(e): the fused stencil kernel on 8 ranks steps the global grid:
    every field bit for bit one device's kernel run, each rank's block at
    rest as the plain mesh step leaves it."""
    for r in spawn["ranks"]:
        got = r["lulesh"]
        assert all(got[k] for k in ("rho", "e", "v", "t")), (r["rank"], got)
        assert got["local_shape"] == [LULESH_GRID // 2, LULESH_GRID // 4,
                                      LULESH_GRID]
        assert got["placements"] == got["plain_placements"], r["rank"]


@pytest.mark.parametrize("arch", GROW_ARCHS)
def test_grown_sequence_split_cache_decodes_as_one_process(spawn, arch):
    """(f): a cache at rest split along its sequence over ``model``, grown
    by ``grow_kv``, rests split along it again at the new length, and
    the decode steps over it stand within LOGITS_STEP_L2 of one
    process's."""
    b, s, n = GROW
    want = spawn["one"][f"grow {arch}"]
    got = spawn["saved"][f"grow {arch}"]
    assert len(got) == len(want) == n
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g, w) <= LOGITS_STEP_L2, (arch, i, _rel(g, w))
    for r in spawn["ranks"]:
        rec = r[f"grow {arch}"]
        assert rec["index"] == s + n - 1
        assert rec["shape"][2] == s + n
        # the self K/V (and Whisper's cross K/V) split along the sequence
        # (tensor axis 2) over ``model``, the rows over ``data``
        for k, pls in rec["placements"].items():
            assert pls == [1, 2], (r["rank"], k, pls)
        assert ("xk" in rec["placements"]) == (arch == ARCH)


def _head_shard(p: dict, cfg, r: int, tp: int) -> dict:
    """Rank ``r``'s shard of an attention layer's weights on a ``tp``-way
    model axis: its query heads (``wq``, ``bq``, ``wo``) and its KV heads
    where they divide the axis, every KV head where they do not."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    h = slice(r * H // tp, (r + 1) * H // tp)
    k = slice(r * K // tp, (r + 1) * K // tp) if K % tp == 0 \
        else slice(0, K)
    return {"wq": p["wq"][:, h], "bq": p["bq"][h], "wo": p["wo"][h],
            "wk": p["wk"][:, k], "wv": p["wv"][:, k], "bk": p["bk"][k],
            "bv": p["bv"][k]}


@pytest.mark.parametrize("heads,kv_heads,tp",
                         [(2, 2, 2), (4, 4, 4), (4, 2, 4)])
def test_cross_attention_split_by_heads(heads, kv_heads, tp):
    """``layers.attention`` as cross-attention on each rank's heads of a
    ``tp``-way model axis (the KV heads split where they divide it, kept
    whole where not), onto an encoder's output (``full`` and ``prefill``)
    and onto a cached (k, v) pair (a decode step): the ranks' f32 partial
    sums of ``wo``, added, within one bf16 rounding of the whole call,
    and a prefill's fresh K/V the rank's KV heads of the whole's."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.sharding.split import Collectives, ServeSplit

    class Partials(ServeSplit):
        """A rank whose model-axis sum is left to the test."""

        def reduce_out(self, x):
            self.partial = x
            return x

    cfg = get_config(ARCH).replace(num_heads=heads, num_kv_heads=kv_heads,
                                   head_dim=16)
    gen = torch.Generator().manual_seed(5)
    p = {k: (torch.randn(d.shape, generator=gen) * 0.3).to(d.dtype)
         for k, d in L.attention_defs(cfg).items()}
    b, s, t = 2, 3, 7
    x = torch.randn((b, s, cfg.d_model), generator=gen).bfloat16()
    enc = torch.randn((b, t, cfg.d_model), generator=gen).bfloat16()
    pos = torch.zeros((b, s), dtype=torch.int32)
    whole_y, whole_kv = L.attention(p, x, cfg, positions=pos,
                                    mode="prefill", kv_source=enc)
    pair = (whole_kv["k"], whole_kv["v"])
    whole_d, _ = L.attention(p, x[:, :1], cfg, positions=pos[:, :1],
                             mode="full", kv_source=pair)
    parts = {"prefill": [], "decode": []}
    for r in range(tp):
        split = ServeSplit.__new__(Partials)
        ServeSplit.__init__(split, (1, tp), (0, r), [None, None],
                            Collectives(), {}, ("data", "model"))
        mine = _head_shard(p, cfg, r, tp)
        _, kv = L.attention(mine, x, cfg, positions=pos, mode="prefill",
                            kv_source=enc, tp=split)
        parts["prefill"].append(split.partial)
        k = slice(r * kv_heads // tp, (r + 1) * kv_heads // tp) \
            if kv_heads % tp == 0 else slice(0, kv_heads)
        for name in ("k", "v"):
            g, w = kv[name].float(), whole_kv[name][:, :, k].float()
            assert float((g - w).abs().max()) <= \
                2.0 ** -7 * float(w.abs().max()), (r, name)
        L.attention(mine, x[:, :1], cfg, positions=pos[:, :1], mode="full",
                    kv_source=(pair[0][:, :, k], pair[1][:, :, k]),
                    tp=split)
        parts["decode"].append(split.partial)
    for mode, want in (("prefill", whole_y), ("decode", whole_d)):
        got = torch.stack(parts[mode]).sum(0).to(want.dtype).float()
        want = want.float()
        assert _rel(got, want) <= 2.0 ** -8, (mode, _rel(got, want))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
