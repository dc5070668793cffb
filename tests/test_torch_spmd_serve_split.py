"""The port's serve steps split along the model axis: 8 CPU ranks over gloo
against one process.

One spawn of 8 ranks serves, on ``local:cpu-mesh8`` ((2, 4) over
``("data", "model")``) and on the degraded (1, 4) mesh of its first four
ranks (the others sit that out), through the split steps of
``training/steps.py`` (``sharding.split.ServeSplit``): each rank keeps
its weight shards, gathers one layer's along ``data`` at a time,
computes its heads, MLP columns or experts and vocabulary columns, and
reads its shard of the KV cache where it rests.

(a) ``deepseek-7b-smoke`` (4 heads over 4 KV heads: the heads and the
    paged pool split along ``model``) and ``granite-moe-3b-a800m-smoke``
    (4 heads over 2 KV heads, 4 experts: the pool keeps every KV head on
    each model rank, each rank's query heads read theirs in place; the
    experts split along ``model``) through the paged engine on
    ``BENCH_serving.json``'s trace (12 Zipf requests, max prompt 48, 32
    new tokens, seed 0; 8 slots x 128, 8-token pages, 24 pages, so
    preemptions happen); and ``granite-moe-3b-a800m-smoke`` through the
    contiguous engine with ``spec_k=2`` on the same trace (its pool
    split along the sequence, as the build's decode cache is: each
    layer's KV heads gathered by an all-to-all for the decode, the
    verify and the prompt chunks);
(b) ``llava-next-34b-smoke`` through ``_legacy_serve_main`` (4 x 48 + 6;
    its 2 KV heads whole on each model rank, its cache's rows along
    ``data``).

Against one process on ``local:cpu`` (run here while the ranks run, the
same weights from seed 0): the streams, the preemptions and every
``ServeStats`` count exactly; the logits of every step (each step's
input is the one process's, so they are teacher-forced): their loss, each
row scored at one process's greedy token, within LOSS_RTOL of one
process's (the split train step's forward tolerance), and each step's
within LOGITS_STEP_L2 in L2, the steps not equal bit for bit counted;
each rank's K/V shard, of the shape its spec gives, within
POOL_STEPS bf16 steps of the matching slice of one process's pool, the
count of unequal entries printed.  A row-parallel product split along
``model`` sums its f32 partials over the ranks, in another order than
one device's product, as the reference's GSPMD step does: so these are
tolerances, not bits (the data-only mesh keeps every bit:
``tests/test_torch_spmd_serve.py``).  And the weights each rank gathers
(weak references to every ``sharding.split.serve_gather`` output): at
most the dry run's reckoning of one layer's (or the embedding's, or the
head's) alive at once, none after the run, no weight whole along a
dimension its spec splits over ``model``.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_serve_split.py`` (~50 s); the file is also each
rank's program: ``python tests/test_torch_spmd_serve_split.py RANK
DIR``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_spmd_serve import (SPAWN_TIMEOUT_S, _SplitWatch,
                                   _stats_counts, register_targets,
                                   serve_reckoning)

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
MESHES = {"2x4": "local:cpu-mesh8", "1x4": "local:cpu-mesh1x4"}
# run -> (arch, engine options)
RUNS = {
    "deepseek_paged": ("deepseek-7b-smoke",
                       dict(kv_layout="paged", page_size=8, num_pages=24)),
    "granite_paged": ("granite-moe-3b-a800m-smoke",
                      dict(kv_layout="paged", page_size=8, num_pages=24)),
    "granite_contiguous_spec": ("granite-moe-3b-a800m-smoke",
                                dict(kv_layout="contiguous", spec_k=2)),
}
ARCHS = ("deepseek-7b-smoke", "granite-moe-3b-a800m-smoke")
VLM = ("llava-next-34b-smoke", 4, 48, 6)
# the split train step's forward tolerance (its loss rtol): the
# teacher-forced loss of a run's logits, every step's rows scored at one
# process's greedy token
LOSS_RTOL = 1e-3
# each step's logits in L2 against one process's.  Most steps are equal
# bit for bit; where a row-parallel sum rounds otherwise, a few bf16
# roundings carried through the smoke models' two layers move a row's
# logits by up to ~1% (deepseek-7b-smoke), and where that turns a near
# tie of the MoE router to another expert by up to ~3%
# (granite-moe-3b-a800m-smoke); a wrong head, shard or position moves
# them by tens of percent
LOGITS_STEP_L2 = 2.0 ** -4
# a K/V entry of a pool against one process's: bf16 steps at the largest
# magnitude of its layer's K (or V) entries.  A split projection rounds
# its f32 product where one device's bf16 product may round otherwise,
# and a later layer's K/V carry the roundings that parted upstream: at
# the scale of one head's row they reach 3.3 steps (deepseek-7b-smoke's
# V), printed beside the gate
POOL_STEPS = 2
quiet = lambda *a, **k: None  # noqa: E731


def _trace():
    from repro_torch.serving import zipf_trace
    return zipf_trace(n=12, vocab_size=256, max_prompt=48, max_new=32,
                      alpha=1.3, seed=0)


class _Logits:
    """The logits of every call of the wrapped steps, in call order."""

    def __init__(self):
        self.seen = []

    def wrap(self, fn):
        def step(*args):
            logits, cache = fn(*args)
            self.seen.append(logits.float().clone())
            return logits, cache
        return step


def _engine_run(run: str, target: str, out: Path, tag: str) -> dict:
    """(a)'s ``run`` on ``target``: streams, counts, the weights'
    gathers; the logits and the pool (each K/V leaf's local shard and
    where it sits in the whole) go to ``out`` as ``<tag>.pt``."""
    from repro_torch.serving import ServeEngine
    from repro_torch.sharding.rules import shard_index
    arch, opts = RUNS[run]
    eng = ServeEngine(arch, target=target, num_slots=8, max_len=128,
                      device="cpu", log=quiet, **opts)
    rec = _Logits()
    eng._decode, eng._chunk, eng._verify = (
        rec.wrap(eng._decode), rec.wrap(eng._chunk), rec.wrap(eng._verify))
    pools = []
    make = eng.make_pool
    eng.make_pool = lambda **kw: pools.append(make(**kw)) or pools[-1]
    watch = _SplitWatch()
    try:
        stats = eng.run(_trace())
    finally:
        watch.close()
    cache, saved = pools[0].cache, {"logits": rec.seen}
    for k in ("k", "v"):
        x = cache[k]
        if hasattr(x, "to_local"):
            dm = x.device_mesh
            idx = shard_index(x.shape, x.placements, tuple(dm.shape),
                              dm.get_coordinate())
            saved[k] = (x.to_local().clone(),
                        [(s.start, s.stop) for s in idx])
        else:
            saved[k] = (x.clone(), [(0, n) for n in x.shape])
    torch.save(saved, out / f"{tag}.pt")
    results = sorted(stats.results, key=lambda r: r.rid)
    return {"streams": [r.tokens for r in results],
            "preempted": [r.preemptions for r in results],
            "counts": _stats_counts(stats),
            "mesh": None if eng.mesh is None else list(eng.mesh.shape),
            "gathers": watch.read()}


def _vlm_run(target: str, out: Path, tag: str) -> dict:
    """(b) on ``target``: the tokens; the logits of the prefill and each
    decode step go to ``out`` as ``<tag>.pt``."""
    from repro_torch.launch import serve as serve_mod
    rec, seen = _Logits(), []
    generate = serve_mod.legacy_generate

    def keep(prefill, decode, *args):
        res = generate(rec.wrap(prefill), rec.wrap(decode), *args)
        seen.append(res[0].tolist())
        return res
    serve_mod.legacy_generate = keep
    watch = _SplitWatch()
    try:
        arch, b, s, n = VLM
        serve_mod._legacy_serve_main(arch, b, s, n, target, 0, quiet,
                                     torch.device("cpu"))
    finally:
        serve_mod.legacy_generate = generate
        watch.close()
    torch.save({"logits": rec.seen}, out / f"{tag}.pt")
    return {"tokens": seen[0], "gathers": watch.read()}


def _runs(target: str, out: Path, tag: str) -> dict:
    got = {run: _engine_run(run, target, out, f"{tag}_{run}")
           for run in RUNS}
    got["vlm"] = _vlm_run(target, out, f"{tag}_vlm")
    return got


# ---------------------------------------------------------------------------
# each rank's program


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist
    from repro_torch.core.target import get_target
    from repro_torch.launch.mesh import mesh_for_target
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=WORLD)
    register_targets()
    got = {"rank": rank}
    for key, target in MESHES.items():
        size = get_target(target).num_chips
        if rank < size:
            got[key] = _runs(target, out, f"rank{rank}_{key}")
        else:
            # outside the smaller mesh: take part in building its groups
            # (once per engine and legacy build), serve nothing
            for _ in range(len(RUNS) + 1):
                mesh_for_target(get_target(target))
        got[f"reckoning_{key}"] = {}
        for arch in ARCHS + (VLM[0],):
            most, whole = serve_reckoning(arch, target)
            got[f"reckoning_{key}"][arch] = [most, sorted(whole)]
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """One spawn of the 8 ranks and, while they run, the same runs in
    this one process on one device."""
    out = tmp_path_factory.mktemp("spmd_serve_split")
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
        one = _runs("local:cpu", out, "one")
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
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return {"out": out, "ranks": ranks, "one": one}


def _members(spawn, key):
    return [r for r in spawn["ranks"] if key in r]


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("key", sorted(MESHES))
def test_split_engine_matches_one_process(spawn, key, run):
    """Streams, preemptions and every ServeStats count exactly one
    process's, on every rank of the mesh."""
    want = spawn["one"][run]
    ranks = _members(spawn, key)
    assert len(ranks) == (8 if key == "2x4" else 4)
    if RUNS[run][1]["kv_layout"] == "paged":
        assert want["counts"]["preemptions"] > 0
    else:
        assert want["counts"]["spec_verify_steps"] > 0
    for r in ranks:
        got = r[key][run]
        assert got["mesh"] == [int(n) for n in key.split("x")]
        assert got["streams"] == want["streams"], (r["rank"], key, run)
        assert got["preempted"] == want["preempted"], (r["rank"], key, run)
        assert got["counts"] == want["counts"], (r["rank"], key, run)


def test_split_legacy_vlm_matches_one_process(spawn):
    want = spawn["one"]["vlm"]["tokens"]
    arch, b, s, n = VLM
    assert len(want) == b and len(want[0]) == n
    for key in MESHES:
        for r in _members(spawn, key):
            assert r[key]["vlm"]["tokens"] == want, (r["rank"], key)


def _forced_loss(logits: list, labels: list) -> float:
    """The mean cross entropy of every step's rows at ``labels``."""
    total = sum(float(torch.nn.functional.cross_entropy(
        g.reshape(-1, g.shape[-1]), t.reshape(-1), reduction="sum"))
        for g, t in zip(logits, labels))
    return total / sum(t.numel() for t in labels)


@pytest.mark.parametrize("run", sorted(RUNS) + ["vlm"])
@pytest.mark.parametrize("key", sorted(MESHES))
def test_split_logits_within_tolerance(spawn, key, run):
    """Every step's whole logits on every rank against one process's: the
    teacher-forced loss within LOSS_RTOL, each step within
    LOGITS_STEP_L2 in L2."""
    out = spawn["out"]
    want = torch.load(out / f"one_{run}.pt")["logits"]
    labels = [w.argmax(-1) for w in want]
    loss = _forced_loss(want, labels)
    worst, parted = 0.0, 0
    for r in _members(spawn, key):
        got = torch.load(out / f"rank{r['rank']}_{key}_{run}.pt")["logits"]
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (r["rank"], i)
            rel = float((g - w).norm() / w.norm())
            worst, parted = max(worst, rel), parted + (rel > 0)
            assert rel <= LOGITS_STEP_L2, (r["rank"], key, run, i, rel)
        got_loss = _forced_loss(got, labels)
        assert abs(got_loss - loss) <= LOSS_RTOL * loss, \
            (r["rank"], key, run, got_loss, loss)
    print(f"{run} on {key}: {len(want)} steps a rank, {parted} of them "
          f"not equal bit for bit over the ranks, worst L2 {worst:.3g}")


def _bf16_steps(got, want, dims):
    """|got - want| in bf16 steps at the largest magnitude of either over
    the axes ``dims``."""
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).amax(dims, keepdim=True)
    exp = torch.frexp(top).exponent
    return (g - w).abs() / torch.ldexp(torch.ones_like(top), exp - 8)


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("key", sorted(MESHES))
def test_split_pool_shards_within_two_bf16_steps(spawn, key, run):
    """Each rank's K/V shard is the slice its spec gives (KV heads along
    ``model`` where they divide it, else every head, a contiguous pool's
    sequence split then) and within POOL_STEPS bf16 steps (at each
    layer's largest magnitude) of one process's pool there."""
    from repro_torch.configs import get_config
    out = spawn["out"]
    want = torch.load(out / f"one_{run}.pt")
    arch = RUNS[run][0]
    cfg = get_config(arch)
    model = int(key.split("x")[1])
    heads = cfg.num_kv_heads // model if cfg.num_kv_heads % model == 0 \
        else cfg.num_kv_heads
    for r in _members(spawn, key):
        got = torch.load(out / f"rank{r['rank']}_{key}_{run}.pt")
        for k in ("k", "v"):
            shard, idx = got[k]
            assert shard.shape[3] == heads, (r["rank"], k, shard.shape)
            ref = want[k][0][tuple(slice(a, b) for a, b in idx)]
            assert ref.shape == shard.shape
            steps = _bf16_steps(shard, ref, (1, 2, 3, 4))
            row = _bf16_steps(shard, ref, (4,))
            unequal = int((shard != ref).sum())
            print(f"{run} on {key} rank {r['rank']} {k}: {unequal} of "
                  f"{shard.numel()} entries unequal, at most "
                  f"{float(steps.max()):.3g} bf16 steps of the layer "
                  f"({float(row.max()):.3g} of the row)")
            assert float(steps.max()) <= POOL_STEPS, (r["rank"], k)
    assert want["k"][0].abs().sum() > 0


@pytest.mark.parametrize("run", sorted(RUNS) + ["vlm"])
@pytest.mark.parametrize("key", sorted(MESHES))
def test_split_steps_gather_one_layer_along_data(spawn, key, run):
    """No serve step gathers a weight along ``model``: every gathered
    weight is split along ``model`` as its spec says, at most the dry
    run's reckoning of one layer's bytes alive at once (the (1, 4) mesh
    has no ``data`` split: nothing is gathered), none after the run; one
    process gathers nothing."""
    arch = VLM[0] if run == "vlm" else RUNS[run][0]
    for r in _members(spawn, key):
        g = r[key][run]["gathers"]
        want, whole = r[f"reckoning_{key}"][arch]
        assert g["alive_after"] == 0, (r["rank"], key, run)
        assert g["most"] <= want, (r["rank"], key, run, g["most"], want)
        if key == "2x4":
            assert g["gathered"] > 0 and g["most"] > 0
        else:
            assert g["gathered"] == 0
        assert not {tuple(s) for s in whole} & {tuple(s) for s in
                                                g["shapes"]}, r["rank"]
    assert spawn["one"][run]["gathers"]["gathered"] == 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
