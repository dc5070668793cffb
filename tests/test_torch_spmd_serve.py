"""The port's serving on a mesh: 8 CPU ranks over gloo against one
process.

One spawn of 8 ranks runs every check that needs ranks; the ranks write
what they saw and the tests hold it against the same work in this
process on ``local:cpu`` (one device, run while the ranks run), from the
same weights (the engines' own draw from seed 0, the same on every rank
and here):

(a) ``deepseek-7b-smoke`` through ``ServeEngine`` on a data-only mesh of
    the 8 ranks (``DP_TARGET``: (8, 1) over ``("data", "model")``, where
    no product is split, so every bit must match one device's) on
    ``BENCH_serving.json``'s trace (12 Zipf requests, max prompt 48, 32
    new tokens, seed 0; 8 slots x 128), chunked prefill (the tuner's
    grain):
    paged with the prefix cache on (8-token pages, 24 pages, so
    preemptions happen), contiguous, and paged sampled (temperature 0.8,
    top-k 16; 8 Zipf requests of up to 32 + 16) with ``spec_k=2`` (the
    verify step on the mesh); and a shared-prefix trace (8 requests)
    through the paged engine with the cache on, so cached pages are
    shared by slots that different ranks compute;
(b) ``whisper-tiny-smoke`` through ``_legacy_serve_main`` (4 x 16 + 6)
    on the data-only (8, 1) mesh, the split prefill and decode steps (the
    enc-dec family's; on meshes that split along ``model`` they are
    ``tests/test_torch_spmd_encdec.py``'s, the recurrent families'
    ``tests/test_torch_spmd_recurrent.py``'s);
(c) one call of the build's decode step (the whole-batch legacy step at
    ``decode_32k`` cut to 4 x 16), of its prefill step (``prefill_32k``
    cut to 4 x 16) and of its train step (4 x 32) on (2, 4), all three
    split along ``model``, the collectives ``Collectives`` counted on
    the live mesh against the dry run's reckoning of the same cell
    (``launch/dryrun.collectives_of``: the rank step traced on its
    shards);
(d) the weights each mesh step of (a) and (b) gathers, watched through
    weak references: the split steps gather each layer's shards along
    ``data`` alone, at most one layer's alive at once and none after the
    run, and no weight whole along a dimension its spec splits over
    ``model``; and the contiguous pool's chunk step, which gathers its
    slot's row, not the pool.

Every rank's streams and ``ServeStats`` counts equal one process's, and
so do its pools after each run: a paged pool bit for bit on every rank
(every rank keeps the whole pool; each step's writes are all-gathered
in the one device's order), a contiguous pool's shards, each of the
shape its spec gives, gathered bit for bit; and (b)'s tokens.  The split over data ranks
changes no bit of a row's arithmetic: each rank runs the same operations
on fewer rows.  The split along ``model`` (row-parallel products summed
in another order) is held to tolerances in
``tests/test_torch_spmd_serve_split.py``.

The spawn's time limit (SPAWN_TIMEOUT_S) is set for the whole suite's
load: under ``pytest -n 6 --dist loadfile`` the other files' 8-rank
spawns and the workers share the host's cores with these ranks, and a
spawn that takes about a minute alone took past 240 s there.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_serve.py``; the file is also each rank's program:
``python tests/test_torch_spmd_serve.py RANK DIR``.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TARGET = "local:cpu-mesh8"
DP_TARGET = "local:cpu-dp8"
WORLD = 8
ARCH = "deepseek-7b-smoke"
LEGACY = ("whisper-tiny-smoke", 4, 16, 6)
# each 8-rank spawn of the tests' files waits this long for its ranks: a
# whole suite under ``-n 6 --dist loadfile`` runs up to five such spawns
# beside six workers on the host's cores (this file's, a minute alone,
# outran 240 s there)
SPAWN_TIMEOUT_S = 600
quiet = lambda *a, **k: None  # noqa: E731

# run -> (engine options, trace)
RUNS = {
    "paged_cached": (dict(kv_layout="paged", prefix_cache=True), "bench"),
    "contiguous": (dict(kv_layout="contiguous"), "bench"),
    "paged_sampled_spec": (dict(kv_layout="paged", spec_k=2), "sampled"),
    "paged_shared": (dict(kv_layout="paged", prefix_cache=True), "shared"),
}


def _trace(name):
    from repro_torch.serving import sharedprefix_trace, zipf_trace
    if name == "shared":
        return sharedprefix_trace(8, 256, head_len=16, max_suffix=16,
                                  max_new=8, seed=0)
    if name == "sampled":
        return zipf_trace(n=8, vocab_size=256, max_prompt=32, max_new=16,
                          alpha=1.3, seed=0, temperature=0.8, top_k=16)
    return zipf_trace(n=12, vocab_size=256, max_prompt=48, max_new=32,
                      alpha=1.3, seed=0)


def _stats_counts(stats) -> dict:
    """Every ServeStats field but the results and the wall clock."""
    out = {}
    for f in dataclasses.fields(stats):
        if f.name in ("results", "wall_s"):
            continue
        v = getattr(stats, f.name)
        out[f.name] = v if v == v else "nan"    # NaN == NaN for the test
    return json.loads(json.dumps(out, default=str))


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def register_targets() -> None:
    """The meshes of the 8 ranks this file and the split serve tests use
    beside ``local:cpu-mesh8``: data-only (8, 1) and the degraded (1, 4)
    (registered in the ranks' processes only)."""
    from repro_torch.core.target import TARGETS, get_target, register
    base = get_target(TARGET)
    for name, shape in ((DP_TARGET, (8, 1)), ("local:cpu-mesh1x4", (1, 4))):
        if name not in TARGETS:
            register(dataclasses.replace(base, name=name, mesh_shape=shape))


class _SplitWatch:
    """Weak references to every weight shard a split serve step gathers
    along ``data`` (``sharding.split.serve_gather``): the most bytes
    alive at once, how many are alive now, and each gathered weight's
    shape."""

    def __init__(self):
        from repro_torch.sharding import split
        self.split, self.orig = split, split.serve_gather
        self.refs, self.most, self.shapes, self.n = [], 0, set(), 0
        split.serve_gather = self

    def __call__(self, shard, split, gather):
        out = self.orig(shard, split, gather)
        self.refs = [(r, n) for r, n in self.refs if r() is not None]
        self.refs.append((weakref.ref(out), out.numel() * out.element_size()))
        self.most = max(self.most, sum(n for _, n in self.refs))
        self.shapes.add(tuple(out.shape))
        self.n += 1
        return out

    def read(self) -> dict:
        gc.collect()
        return {"gathered": self.n, "most": self.most,
                "alive_after": sum(r() is not None for r, _ in self.refs),
                "shapes": sorted(self.shapes)}

    def close(self) -> None:
        self.split.serve_gather = self.orig


def serve_reckoning(arch: str, target: str) -> tuple:
    """(the dry run's reckoning of the weights a split serve step holds
    gathered along ``data`` at once, the shapes a weight has whole along
    a dimension its spec splits over ``model``) for ``arch``'s params on
    ``target``'s mesh."""
    from repro_torch.core.appspec import AppSpec
    from repro_torch.core.build import BuildService
    from repro_torch.launch.dryrun import gathered_at_once
    from repro_torch.models.params import leaf_items
    from repro_torch.sharding.rules import placements
    from repro_torch.sharding.split import layer_axes
    res = BuildService().build(AppSpec(arch=arch, shape="decode_32k"),
                               target, lower=False)
    table, specs = res.tables["params"], res.specs["params"]
    model = res.mesh.axis_names.index("model")
    whole = set()
    for (path, d), (_, spec) in zip(leaf_items(table), leaf_items(specs)):
        if placements(spec, res.mesh)[model].is_shard() and \
                res.mesh.shape[model] > 1:
            whole.add(tuple(d.shape[layer_axes(path):]))
    return gathered_at_once(table, specs, res.mesh, None), whole


def _serve_runs(target: str, out: Path, tag: str) -> dict:
    """(a) and (b) on ``target``: streams, counts and sizes, and the
    gathered weights' lifetimes (``_SplitWatch``); the pools after each
    run go to ``out`` as ``<tag>_<run>.pt``."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving import ServeEngine
    from repro_torch.sharding.rules import local_slices
    from repro_torch.models.params import partition_specs
    got = {}
    for run, (opts, trace) in RUNS.items():
        pages = dict(page_size=8, num_pages=24) \
            if opts["kv_layout"] == "paged" else {}
        eng = ServeEngine(ARCH, target=target, num_slots=8, max_len=128,
                          device="cpu", log=quiet, **pages, **opts)
        pools = []
        make = eng.make_pool
        eng.make_pool = lambda **kw: pools.append(make(**kw)) or pools[-1]
        split = _SplitWatch()
        try:
            stats = eng.run(_trace(trace))
        finally:
            split.close()
        cache = pools[0].cache
        got[run] = {
            "sizes": [eng.num_slots, eng.num_pages, eng.page_size,
                      eng.max_len, eng.chunk_unit, eng.prefill_chunk,
                      eng.spec_k],
            "streams": [r.tokens for r in sorted(stats.results,
                                                 key=lambda r: r.rid)],
            "preempted": [r.preemptions for r in sorted(
                stats.results, key=lambda r: r.rid)],
            "counts": _stats_counts(stats),
            "mesh": None if eng.mesh is None else list(eng.mesh.shape),
            "split_gathers": split.read(),
            "chunk_gather_bytes": getattr(eng._chunk, "collectives", {
                "all_gather": {"bytes": 0}})["all_gather"]["bytes"]}
        if hasattr(cache["k"], "to_local"):
            specs = partition_specs(
                eng.model.cache_table(eng.num_slots, eng.max_len), eng.mesh,
                eng.cache_rules)
            got[run]["local_shapes_match_specs"] = all(
                tuple(cache[k].to_local().shape) == tuple(
                    s.stop - s.start for s in local_slices(
                        specs[k], cache[k].shape, eng.mesh,
                        eng.mesh.coordinate()))
                for k in ("k", "v"))
        torch.save({k: _whole(cache[k]) for k in ("k", "v", "index")},
                   out / f"{tag}_{run}.pt")
    seen = []
    generate = serve_mod.legacy_generate

    def keep(*args):
        res = generate(*args)
        seen.append(res[0].tolist())
        return res
    serve_mod.legacy_generate = keep
    split = _SplitWatch()
    try:
        arch, b, s, n = LEGACY
        sample = serve_mod._legacy_serve_main(arch, b, s, n, target, 0,
                                              quiet,
                                              torch.device("cpu"))["sample"]
    finally:
        serve_mod.legacy_generate = generate
        split.close()
    got["legacy"] = {"tokens": seen[0], "sample": sample}
    got["legacy"]["split_gathers"] = split.read()
    return got


def _counted_vs_reckoned(arch: str = ARCH, reckon: bool = True) -> dict:
    """(c): the build's decode, prefill and train steps of ``arch`` on the
    live mesh, their counted collectives beside the dry run's reckoning
    (traced only where ``reckon``: every rank must run the steps)."""
    from repro_torch.analysis.cost import trace
    from repro_torch.core.appspec import AppSpec
    from repro_torch.core.build import BuildService
    from repro_torch.data.pipeline import (DataPipeline, SyntheticSource,
                                           to_device)
    from repro_torch.launch.dryrun import cell_step, collectives_of
    from repro_torch.models.params import init_params, leaf_items
    from repro_torch.models.transformer import model_for
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding.rules import distribute
    from repro_torch.training.steps import init_train_state
    out = {}
    for shape, over in (("decode_32k", {"seq_len": 16, "global_batch": 4}),
                        ("prefill_32k", {"seq_len": 16, "global_batch": 4}),
                        ("train_4k", {"seq_len": 32, "global_batch": 4})):
        app = AppSpec(arch=arch, shape=shape, shape_overrides=over)
        res = BuildService().build(app, TARGET, lower=False)
        model = model_for(app.model_config, remat=res.plan.remat_policy)
        params = init_params(res.tables["params"],
                             torch.Generator().manual_seed(0), "cpu")
        if shape == "train_4k":
            opt = make_optimizer(res.plan.optimizer)
            state = reshard_state(init_train_state(model, opt, params,
                                                   res.plan),
                                  res.tables["state"], res.mesh)
            batch = DataPipeline(model, app.shape_config, seed=0,
                                 device="cpu").batch_at(0)
            _, metrics = res.step_fn(state, batch)
            counted = metrics["collectives"]
        elif shape == "prefill_32k":
            batch = to_device(SyntheticSource(
                app.model_config.vocab_size, 0).batch(res.tables["batch"],
                                                      0), "cpu")
            res.step_fn(reshard_state(params, res.tables["params"],
                                      res.mesh), batch)
            counted = res.step_fn.collectives
        else:
            cache = {}
            specs = dict(leaf_items(res.specs["cache"]))
            for path, d in leaf_items(res.tables["cache"]):
                at = cache
                for k in path[:-1]:
                    at = at.setdefault(k, {})
                at[path[-1]] = torch.tensor(
                    over["seq_len"] - 1, dtype=d.dtype) if path == (
                    "index",) else distribute(torch.randn(d.shape).to(
                        d.dtype), specs[path], res.mesh)
            tokens = torch.ones((over["global_batch"], 1), dtype=torch.int32)
            res.step_fn(reshard_state(params, res.tables["params"],
                                      res.mesh), cache, tokens)
            counted = res.step_fn.collectives
        out[shape] = {"counted": counted}
        if reckon:
            step, args, _ = cell_step(res)
            traced, _ = trace(step, *args)
            reckoned = collectives_of(res, traced, step)
            out[shape].update(reckoned=reckoned.counts,
                              wire_bytes=reckoned.wire_bytes)
    return out


def _listed(reckoning: tuple) -> list:
    most, whole = reckoning
    return [most, sorted(whole)]


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    register_targets()
    got = {"rank": rank,
           "serve": _serve_runs(DP_TARGET, out, f"rank{rank}"),
           "collectives": _counted_vs_reckoned(),
           "reckoning": {arch: _listed(serve_reckoning(arch, DP_TARGET))
                         for arch in (ARCH, LEGACY[0])}}
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One spawn of the 8 ranks and, while they run, the same runs in
    this one process on one device: (the ranks' results, this
    process's)."""
    out = tmp_path_factory.mktemp("spmd_serve")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"out": out, "serve": _serve_runs("local:cpu", out, "one")}
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
    return {"out": out, "ranks": [json.loads((out / f"rank{r}.json")
                                             .read_text())
                                  for r in range(WORLD)]}, one


@pytest.fixture(scope="module")
def spawn(both):
    return both[0]


@pytest.fixture(scope="module")
def one(both):
    return both[1]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_on_the_mesh_matches_one_process(spawn, one, run):
    want = one["serve"][run]
    assert want["mesh"] is None
    for r in spawn["ranks"]:
        got = r["serve"][run]
        assert got["mesh"] == [8, 1]
        assert got["sizes"] == want["sizes"], (r["rank"], run)
        assert got["streams"] == want["streams"], (r["rank"], run)
        assert got["preempted"] == want["preempted"], (r["rank"], run)
        assert got["counts"] == want["counts"], (r["rank"], run)
    counts = want["counts"]
    assert counts["prefill_chunks"] > 0
    if run == "paged_cached":
        assert counts["preemptions"] > 0
    if run == "paged_shared":
        assert counts["prefix_hits"] > 0
    if run == "paged_sampled_spec":
        assert counts["spec_verify_steps"] > 0


def test_every_rank_holds_the_same_tokens(spawn):
    first = spawn["ranks"][0]
    for r in spawn["ranks"][1:]:
        for run in RUNS:
            assert r["serve"][run]["streams"] == \
                first["serve"][run]["streams"], (r["rank"], run)
        assert r["serve"]["legacy"]["tokens"] == \
            first["serve"]["legacy"]["tokens"]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_every_rank_pool_equals_one_process_bit_for_bit(spawn, one, run):
    want = torch.load(one["out"] / f"one_{run}.pt")
    for r in range(WORLD):
        got = torch.load(spawn["out"] / f"rank{r}_{run}.pt")
        for k in ("k", "v", "index"):
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k].view(torch.int16) if
                               got[k].dtype == torch.bfloat16 else got[k],
                               want[k].view(torch.int16) if
                               want[k].dtype == torch.bfloat16 else want[k]
                               ), (r, run, k)
    assert want["k"].abs().sum() > 0
    if run == "contiguous":
        for r in spawn["ranks"]:
            assert r["serve"][run]["local_shapes_match_specs"], r["rank"]


def test_contiguous_chunk_moves_the_slot_row_alone(spawn):
    """A prompt chunk on the mesh gathers its slot's row of the
    contiguous pool along ``data``, not the pool: beside the paged
    chunk's gathers (each layer's weights alone; that pool is whole along
    ``data``) it moves at most two whole rows of K and of V."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    row = cfg.num_layers * 128 * cfg.num_kv_heads * cfg.head_dim * 2
    for r in spawn["ranks"]:
        cache = r["serve"]["contiguous"]["chunk_gather_bytes"] - \
            r["serve"]["paged_cached"]["chunk_gather_bytes"]
        assert 0 < cache <= 2 * 2 * row, (r["rank"], cache, row)


@pytest.mark.parametrize("run", sorted(RUNS) + ["legacy"])
def test_no_gathered_weight_outlives_its_step(spawn, one, run):
    """The split steps, the engine's and the legacy Whisper path's, gather
    no weight whole along a dimension its spec splits over ``model``:
    each layer's shards along ``data`` alone, at most the dry run's
    reckoning of one layer's (or the embedding's, or the head's) bytes
    alive at once, and none once the run is done (the engine still
    alive).  One process gathers nothing."""
    arch = LEGACY[0] if run == "legacy" else ARCH
    for r in spawn["ranks"]:
        most, whole = r["reckoning"][arch]
        whole = {tuple(s) for s in whole}
        g = r["serve"][run]["split_gathers"]
        assert g["gathered"] > 0 and 0 < g["most"] <= most, \
            (r["rank"], run, g, most)
        assert g["alive_after"] == 0, (r["rank"], run, g)
        assert not whole & {tuple(s) for s in g["shapes"]}, (r["rank"], run)
    assert one["serve"][run]["split_gathers"]["gathered"] == 0


def test_legacy_path_on_the_mesh_matches_one_process(spawn, one):
    """(b): Whisper's split legacy steps on the data-only mesh, every
    row's tokens and the sample one process's."""
    want = one["serve"]["legacy"]
    arch, b, s, n = LEGACY
    assert len(want["tokens"]) == b and len(want["tokens"][0]) == n
    for r in spawn["ranks"]:
        got = r["serve"]["legacy"]
        assert (got["tokens"], got["sample"]) == (want["tokens"],
                                                  want["sample"]), r["rank"]


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_reckoned_collectives_equal_the_counted(spawn, shape):
    """Each of the build's steps split over (2, 4) sends the collectives
    the dry run counts for its cell: the layers' ``data`` gathers, the
    row-parallel products' all-reduces over ``model``, the logits'
    gathers (serving) or the gradients' reduce-scatters (training)."""
    for r in spawn["ranks"]:
        c = r["collectives"][shape]
        assert c["counted"] == c["reckoned"], (r["rank"], shape)
        assert c["counted"]["all_gather"]["calls"] > 0
        assert c["counted"]["all_reduce"]["calls"] > 0
        assert c["wire_bytes"] > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
