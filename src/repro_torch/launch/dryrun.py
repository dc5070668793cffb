"""Dry run of every (architecture x input shape x mesh) cell on the H100
cluster targets (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for its two TPU pods
on 512 forced host devices and reads XLA's memory and cost analyses.
The port builds each cell on the H100 counterparts of those pods,
``nvidia:h100x256`` (16 x 16 over ``data``, ``model``) and
``nvidia:h100x512`` (2 x 16 x 16 over ``pod``, ``data``, ``model``),
described targets with no ranks behind them, and traces the step on the
``meta`` device (``analysis/cost.trace``): the step that one rank of the
port's mesh step computes, the split step itself, every family's
(``steps.described_rank_step`` for training,
``steps.described_serve_step`` for the prefill and the decode) on rank
0's shards of the state, the weights or the cache and its rows, its
collectives sending nothing and counted as they are issued.  It needs
no device and no process group, and sets no environment.

For each cell it prints the memory per card, the FLOPs, the three
roofline terms and the plan, and writes one JSON record under
``artifacts/dryrun_torch/`` with the reference's keys:

* ``memory_analysis``: ``argument_size_in_bytes`` (the inputs' bytes a
  card holds at rest, each leaf's shard under its spec),
  ``temp_size_in_bytes`` (the trace's peak of the step's own
  allocations: the split step's gathers, one layer's weights along
  ``data`` at a time and a sequence-split cache's heads one layer at a
  time, are allocations of its trace), ``output_size_in_bytes`` (the
  logits gathered whole, the cache or state at rest),
  ``alias_size_in_bytes`` (the outputs written in place into inputs:
  a decode's cache, the train state), ``per_chip_total_gb`` (arguments
  plus temporaries); ``generated_code_size_in_bytes`` is null: the port
  generates no program (its kernels are built once, ahead of the run);
* ``cost_analysis`` and ``hlo_cost``: the trace's dot FLOPs and least
  bytes a card, the reckoned wire bytes and collectives; ``while_trips``
  is null (a Python loop has no while op to count);
* ``model_flops``, ``roofline`` (``Roofline.row()`` on the target's
  rates), ``plan``, ``fallbacks``; the times: ``lower_s`` (the build),
  ``trace_s``, ``total_s``; ``compile_s`` and ``hlo_parse_s`` are null;
* ``kernels_traced_as``: ``"plain"``: the hand-written kernels cannot
  run on ``meta``, so their plain versions stand in for them.

A split step holds its shards of the state (training: and of the
gradients; serving: of the weights and the cache), and one layer's
weights gathered along ``data`` at a time (``gathered_at_once``: the
reckoning the live step's gather records are held to), so its memory
per card shrinks with both mesh axes.
A failing cell records ``"status": "error"`` and its traceback, and the
run returns 1.

    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch deepseek-7b --target \\
        nvidia:h100 --overrides '{"global_batch": 8, "seq_len": 4096}'
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import cost as cost_mod
from repro_torch.analysis.flops import model_flops
from repro_torch.analysis.roofline import from_cost
from repro_torch.configs.base import ShapeConfig, cells
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.core.target import get_target
from repro_torch.sharding.rules import data_parallel_dims

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

MESHES = {"single": "nvidia:h100x256", "multi": "nvidia:h100x512"}

SHAPE_FIELDS = {f.name for f in dataclasses.fields(ShapeConfig)} - {"name",
                                                                    "kind"}


def _timed(fn, *args, **kw):
    """(fn's result, host seconds it took): a cell's advisory times."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def split_overrides(overrides: dict | None) -> tuple[dict, dict]:
    """``--overrides`` as (the shape's fields, such as ``seq_len`` and
    ``global_batch``, the tuner's plan fields)."""
    overrides = overrides or {}
    shape = {k: v for k, v in overrides.items() if k in SHAPE_FIELDS}
    return shape, {k: v for k, v in overrides.items()
                   if k not in SHAPE_FIELDS}


def split_cell(result) -> bool:
    """Whether a build's cell runs split on its mesh (a mesh of several
    chips: every family's steps split there, ``steps.SPLIT_FAMILIES``)."""
    from repro_torch.training import steps
    return result.target.num_chips > 1 and \
        result.appspec.model_config.family in steps.SPLIT_FAMILIES


def cell_step(result):
    """(the step one rank runs, its meta arguments, the ranks splitting
    the rows) of a build: the build's step on a single card; on a mesh
    the split step of rank 0 on its shards (``split_cell``)."""
    from repro_torch.models.transformer import model_for
    from repro_torch.training import steps
    plan, tables = result.plan, result.tables
    shape = result.appspec.shape_config
    cfg = result.appspec.model_config
    rows = shape.global_batch
    dp = data_parallel_dims(rows, result.mesh)
    split = math.prod(result.mesh.shape[m] for m in dp)
    model = model_for(cfg, remat=plan.remat_policy)
    meta = cost_mod.meta_tree
    if shape.kind == "train":
        from repro_torch.optim import make_optimizer
        opt = make_optimizer(plan.optimizer)
        if split_cell(result):
            step = steps.described_rank_step(model, opt, plan, result.mesh,
                                             result.specs["state"]["params"],
                                             rows)
            return step, (cost_mod.meta_shards(
                tables["state"], result.specs["state"], result.mesh),
                meta(tables["batch"], split)), split
        step = steps.build_train_step(model, opt, plan)
        return step, (meta(tables["state"]),
                      meta(tables["batch"], split)), split
    batch = meta(tables["batch"], split)
    if split_cell(result):
        step = steps.described_serve_step(
            model, result.mesh, result.specs["params"], shape.kind, rows,
            result.specs["cache"])
        params = cost_mod.meta_shards(tables["params"],
                                      result.specs["params"], result.mesh)
        if shape.kind == "prefill":
            return step, (params, batch), split
        cache = dict(cost_mod.meta_shards(
            tables["cache"], result.specs["cache"], result.mesh),
            index=torch.tensor(shape.seq_len - 1, dtype=torch.int32))
        return step, (params, cache, batch["tokens"]), split
    params = meta(tables["params"])
    if shape.kind == "prefill":
        return steps.build_prefill_step(model), (params, batch), split
    # the whole-batch decode at the cache's last position: the step
    # attends every position of the cache, as the reference's does
    cache = meta(tables["cache"], split, index=shape.seq_len - 1)
    return steps.build_decode_step(model), (params, cache,
                                            batch["tokens"]), split


def collectives_of(result, out, step=None) -> cost_mod.Reckoning:
    """The collectives one rank of the port's mesh step issues in one
    call of the build's step (none on one card), as the split step's
    trace logged them: ``out``'s metrics in training (``out`` is the
    traced one-rank step's result), the traced ``step``'s log in
    serving."""
    if not split_cell(result):
        return cost_mod.Reckoning()
    calls = out[1]["collective_calls"] \
        if result.appspec.shape_config.kind == "train" \
        else step.collective_calls
    return cost_mod.Reckoning.of_calls(calls)


def gathered_at_once(table, specs, mesh, remat: str | None) -> int:
    """The most bytes of weights a rank of a split step holds gathered
    along ``data`` at once (a weight split only along ``model`` is not
    gathered): the largest of the embedding's, one layer's and the
    head's (``ln_f`` and the unembedding, or a tied embedding), each
    freed before the next is gathered, a layer's being the largest of a
    stack's (an xLSTM's mLSTM and sLSTM layers differ); a Zamba2 hybrid's
    shared block, gathered once a step for its every application, is
    held beside each layer and the head.  In a train step under
    ``remat="none"`` autograd keeps every layer's for its backward, so
    all layers' (and the shared block's) and the head's.  A serve step's
    ``remat`` is None."""
    from repro_torch.models.params import leaf_items
    from repro_torch.sharding.rules import placements
    from repro_torch.sharding.split import layer_axes
    model = list(mesh.axis_names).index("model") \
        if "model" in mesh.axis_names else None
    tied = "unembed" not in table["embed"]
    groups, stacks = {}, {}
    for (path, d), (_, spec) in zip(leaf_items(table), leaf_items(specs)):
        n, gathered = [1] * len(d.shape), False
        for m, pl in enumerate(placements(spec, mesh)):
            if pl.is_shard() and m == model:
                n[pl.dim] *= mesh.shape[m]
            elif pl.is_shard() and mesh.shape[m] > 1:
                gathered = True
        if not gathered:
            continue
        lead = layer_axes(path)
        nbytes = math.prod(k // f for k, f in zip(d.shape[lead:], n[lead:])) \
            * d.dtype.itemsize
        if lead:
            layers, one = stacks.get(path[0], (0, 0))
            stacks[path[0]] = (math.prod(d.shape[:lead]), one + nbytes)
            continue
        keys = ["shared"] if path[0] == "shared" else \
            ["embed"] + (["head"] if tied and path[-1] == "embedding"
                         else []) \
            if path[-1] in ("embedding", "pos_embedding") else ["head"]
        for k in keys:
            groups[k] = groups.get(k, 0) + nbytes
    shared, head = groups.get("shared", 0), groups.get("head", 0)
    if remat == "none":
        return max(groups.get("embed", 0), shared + head + sum(
            n * one for n, one in stacks.values()))
    layer = max((one for _, one in stacks.values()), default=0)
    return max(groups.get("embed", 0), shared + layer, shared + head)


def memory_per_chip(result, cost, out) -> dict:
    """The reference's ``memory_analysis`` keys for one card (see the
    module's docstring)."""
    tables, specs, mesh = result.tables, result.specs, result.mesh
    kind = result.appspec.shape_config.kind
    at_rest = cost_mod.spec_bytes
    if kind == "train":
        args = at_rest(tables["state"], specs["state"], mesh) + \
            at_rest(tables["batch"], specs["batch"], mesh)
        alias = at_rest(tables["state"], specs["state"], mesh)
        metrics = sum(t.numel() * t.element_size()
                      for t in cost_mod._tensors(out[1]))
        output = alias + metrics
    else:
        weights = at_rest(tables["params"], specs["params"], mesh)
        batch = at_rest(tables["batch"], specs["batch"], mesh)
        cache = at_rest(tables["cache"], specs["cache"], mesh)
        # the step's logits come out whole
        logits = out[0].numel() * out[0].element_size()
        if kind == "decode":
            args = weights + cache + batch
            alias = cache
        else:
            args = weights + batch
            alias = 0
        output = logits + cache
    mem = {"argument_size_in_bytes": float(args),
           "output_size_in_bytes": float(output),
           "temp_size_in_bytes": float(cost.peak_bytes),
           "alias_size_in_bytes": float(alias),
           "generated_code_size_in_bytes": None}
    mem["per_chip_total_gb"] = (mem["argument_size_in_bytes"] +
                                mem["temp_size_in_bytes"]) / 1e9
    return mem


def _label(mesh_key: str) -> str:
    return mesh_key.replace(":", "-")


def run_cell(arch: str, shape_name: str, mesh_key: str,
             overrides: dict | None = None, out_dir: Path = ART,
             tag: str = "", target: str | None = None, log=print) -> dict:
    """Dry-run one cell on ``MESHES[mesh_key]`` (or on ``target``, which
    then names the cell's mesh) and write its record."""
    target = get_target(target or MESHES[mesh_key])
    shape_over, plan_over = split_overrides(overrides)
    app = AppSpec(arch=arch, shape=shape_name, shape_overrides=shape_over)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_key,
           "target": target.name, "status": "ok", "tag": tag,
           "overrides": overrides or {}, "kernels_traced_as": "plain"}
    name = f"[{arch} x {shape_name} x {mesh_key}]"
    _, rec["total_s"] = _timed(_cell, rec, app, target, plan_over, name, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape_name}__{_label(mesh_key)}{suffix}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    log(f"  wrote {path} ({rec['total_s']:.1f}s total)")
    return rec


def _cell(rec: dict, app: AppSpec, target, plan_over: dict, name: str,
          log) -> None:
    """Build, trace and record one cell into ``rec`` (its error, with the
    traceback, where any step fails)."""
    arch, shape_name, mesh_key = rec["arch"], rec["shape"], rec["mesh"]
    try:
        result, rec["lower_s"] = _timed(
            BuildService().build, app, target, overrides=plan_over or None,
            lower=False)
        rec["compile_s"] = None
        rec["hlo_parse_s"] = None
        rec["plan"] = json.loads(result.plan.to_json())
        rec["fallbacks"] = result.plan.sharding_fallbacks
        step, args, _ = cell_step(result)
        (out, cost), rec["trace_s"] = _timed(cost_mod.trace, step, *args)
        log(f"{name} traced on meta in {rec['trace_s']:.1f}s "
            f"({cost.dot_count} products)")
        mem = memory_per_chip(result, cost, out)
        rec["memory_analysis"] = mem
        if split_cell(result):
            train = result.appspec.shape_config.kind == "train"
            tables, specs = (result.tables["state"], result.specs["state"]) \
                if train else (result.tables, result.specs)
            rec["gathered_at_once_bytes"] = gathered_at_once(
                tables["params"], specs["params"], result.mesh,
                result.plan.remat_policy if train else None)
        log(f"{name} memory_analysis: "
            f"args={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
            f"temp={mem['temp_size_in_bytes'] / 1e9:.2f}GB "
            f"({mem['per_chip_total_gb']:.2f} GB a card of "
            f"{target.hbm_bytes / 1e9:.0f})")
        rec["cost_analysis"] = {"flops": cost.flops,
                                "bytes_accessed": cost.hbm_bytes}
        log(f"  cost_analysis (meta trace, a card): "
            f"flops={cost.flops:.3e} bytes={cost.hbm_bytes:.3e}")
        wire = collectives_of(result, out, step)
        cost.wire_bytes = wire.wire_bytes
        cost.collective_breakdown = wire.breakdown
        mf = model_flops(app.model_config, app.shape_config)
        roof = from_cost(cost, target=target, arch=arch, shape=shape_name,
                         mesh=mesh_key, chips=target.num_chips,
                         model_flops=mf["total"], memory_per_chip=mem)
        rec["hlo_cost"] = {
            "flops_per_chip": cost.flops, "hbm_bytes_per_chip":
                cost.hbm_bytes, "wire_bytes_per_chip": cost.wire_bytes,
            "collectives": wire.breakdown, "collective_calls": wire.counts,
            "while_trips": None, "dot_count": cost.dot_count,
            "peak_bytes": cost.peak_bytes}
        rec["model_flops"] = mf
        rec["roofline"] = roof.row()
        rec["notes"] = [
            "flops, bytes and peak: a meta-device trace of the step rank "
            "0 computes (its shards and rows in a split cell; else its "
            "rows, the weights whole)",
            "hand-written kernels traced as their plain versions",
            "no generated program: compile_s, hlo_parse_s, "
            "generated_code_size_in_bytes and while_trips are null"]
        log(f"  roofline: compute={roof.t_compute * 1e3:.1f}ms "
            f"memory={roof.t_memory * 1e3:.1f}ms "
            f"collective={roof.t_collective * 1e3:.1f}ms "
            f"-> {roof.bottleneck}-bound, "
            f"fraction={roof.roofline_fraction:.2f}")
        log(f"  plan: {result.plan.optimizer}, microbatches "
            f"{result.plan.microbatches}, remat {result.plan.remat_policy}"
            f", kernels {result.plan.kernels}; "
            f"{len(rec['fallbacks'])} fallbacks")
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        log(f"{name} FAILED: {rec['error']}")


def main(argv=None, out_dir: Path = ART, log=print) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single")
    p.add_argument("--target", default=None,
                   help="dry-run on this registered target instead of the "
                        "meshes (e.g. nvidia:h100, one card)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--tag", default="")
    p.add_argument("--overrides", default="",
                   help="JSON overrides: the shape's fields (seq_len, "
                        "global_batch) cut the cell, the rest go to the "
                        "tuner's plan")
    a = p.parse_args(argv)

    meshes = [a.target] if a.target else \
        (["single", "multi"] if a.mesh == "both" else [a.mesh])
    overrides = json.loads(a.overrides) if a.overrides else None
    if a.all:
        todo = [(arch, shape, mk) for arch, shape, _ in cells()
                for mk in meshes]
    elif a.arch and a.shape:
        todo = [(a.arch, a.shape, mk) for mk in meshes]
    elif a.arch:
        # the arch's cells; a config outside them (a smoke one) the three
        # standard shapes
        shapes = [shape for arch, shape, _ in cells() if arch == a.arch] \
            or ["train_4k", "prefill_32k", "decode_32k"]
        todo = [(a.arch, shape, mk) for shape in shapes for mk in meshes]
    else:
        p.error("--arch [--shape] or --all")

    ok = err = skip = 0
    for arch, shape, mk in todo:
        suffix = f"__{a.tag}" if a.tag else ""
        out = out_dir / f"{arch}__{shape}__{_label(mk)}{suffix}.json"
        if a.skip_existing and out.exists() and \
                json.loads(out.read_text()).get("status") == "ok":
            skip += 1
            continue
        rec = run_cell(arch, shape, mk, overrides=overrides,
                       out_dir=out_dir, tag=a.tag, target=a.target,
                       log=log)
        ok += rec["status"] == "ok"
        err += rec["status"] != "ok"
    log(f"dry-run summary: {ok} ok, {err} failed, {skip} skipped-existing")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
