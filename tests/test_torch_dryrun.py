"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
reference's build of the same cells, on the CPU, without a device.

* At smoke size on ``local:cpu`` (``seq_len`` 32, ``global_batch`` 2),
  for ``deepseek-7b-smoke``, ``granite-moe-3b-a800m-smoke`` and the
  legacy path's ``llava-next-34b-smoke``, at the prefill, decode and
  train shapes: the dry run's record (a ``meta``-device trace) against
  the reference's build compiled on one CPU device: its dot FLOPs equal
  ``hlo.analyze`` of the compiled step, its argument bytes the compiled
  step's ``memory_analysis().argument_size_in_bytes``, ``model_flops``,
  the plan (every field but the tuner's free-text ``napkin`` notes, which
  the port leaves out of a serve plan) and the fallbacks equal.  One
  difference, exact: the MoE train step's FLOPs exceed the reference's
  by ``layers x 2 b s k d``, the gradient of the expert combine
  ``einsum("bskm,bsk->bsm")`` with respect to the expert outputs, an
  outer product (no contracted axis): XLA rewrites a dot without
  contracting dimensions as a multiply, which ``hlo.analyze`` does not
  count; torch runs it as a product of inner size 1 (with the remat
  policy ``none`` the difference is the same, so it is not the
  recompute).
* On the two cluster targets, every LM arch's cells: the build's specs
  and fallbacks equal the reference's on its pods entry for entry (the
  same tables under the port's plan, on the reference test's
  placeholder-device meshes).
* ``main`` on one full-width cell (``deepseek-7b`` x ``decode_32k``, both
  meshes) ends ``ok``, traced as one rank's split step, its arguments a
  card the sum of the specs' shard bytes, worked out here;
  ``nemotron-4-340b`` x ``decode_32k`` on ``nvidia:h100x256``, split
  (its cache along the sequence), fits a card's 80 GB, and so does the
  enc-dec family's, split too since every family is: ``whisper-tiny``'s
  shards at rest and one layer's gathers, worked out here.
  ``granite-moe-3b-a800m`` x ``train_4k``, once the
  refusal of MoE training on a data-parallel mesh, runs split: its
  shards at rest and one layer's gathers, worked out here.
* The smoke prefill and decode cells on ``local:cpu-mesh8`` ((2, 4),
  described here): the port's traced rank step takes per card the
  argument bytes the reference's build compiled on 8 forced host devices
  takes per device (a subprocess, as ``tests/test_torch_spmd_train.py``
  runs the reference's mesh), the heads split (``deepseek-7b-smoke``) or
  the decode cache split along its sequence
  (``granite-moe-3b-a800m-smoke``'s 2 KV heads on a 4-way model axis);
  and the train and decode cells of ``xlstm-1.3b-smoke`` (its heads
  whole, its ``mlp`` split) and ``zamba2-7b-smoke`` (heads, ``mlp`` and
  the shared block split), each traced as one rank's split step.
* The trace on ``meta`` counts what ``cost.measure`` counts running the
  same step on CPU tensors: FLOPs, bytes and the peak of the step's own
  allocations.
"""

import json

import numpy as np
import pytest
import torch

from repro.analysis import hlo
from repro.configs import get_config as ref_get_config
from repro.core.appspec import AppSpec as RefAppSpec
from repro.core.build import BuildService as RefBuild
from repro.core.plan import DeploymentPlan as RefPlan
from repro.models.params import partition_specs as ref_partition_specs
from repro.models.transformer import model_for as ref_model_for
from repro.optim import make_optimizer as ref_make_optimizer
from repro.sharding import rules as ref_rules
from repro.training.steps import train_state_table as ref_train_state_table
from jax.sharding import Mesh as RefMesh

from repro_torch.analysis import cost, roofline
from repro_torch.configs import get_config
from repro_torch.configs.base import cells
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.core.target import get_target
from repro_torch.launch import dryrun
from repro_torch.models.params import init_params, leaf_items

SMOKE = {"seq_len": 32, "global_batch": 2}
SMOKE_ARCHS = ("deepseek-7b-smoke", "granite-moe-3b-a800m-smoke",
               "llava-next-34b-smoke")
SHAPES = ("prefill_32k", "decode_32k", "train_4k")
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch, shape):
    """The reference's build of the smoke cell, compiled on one CPU
    device: (its dot FLOPs, argument bytes, plan, fallbacks)."""
    app = RefAppSpec(arch=arch, shape=shape, shape_overrides=SMOKE)
    res = RefBuild().build(app, "local:cpu", lower=True)
    compiled = res.lowered.compile()
    return (hlo.analyze(compiled.as_text()).flops,
            compiled.memory_analysis().argument_size_in_bytes,
            json.loads(res.plan.to_json()), res.plan.sharding_fallbacks)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cell_equals_the_reference_build(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, "local:cpu", overrides=SMOKE,
                          out_dir=tmp_path, target="local:cpu", log=quiet)
    assert rec["status"] == "ok", rec.get("traceback")
    flops, args, plan, fallbacks = _reference(arch, shape)
    got = rec["hlo_cost"]["flops_per_chip"]
    cfg = get_config(arch)
    if shape == "train_4k" and cfg.family == "moe":
        b, s = SMOKE["global_batch"], SMOKE["seq_len"]
        outer = 2.0 * b * s * cfg.experts_per_token * cfg.d_model
        assert got == flops + cfg.num_layers * outer
    else:
        assert got == flops
    assert rec["memory_analysis"]["argument_size_in_bytes"] == args
    from repro.analysis.flops import model_flops as ref_model_flops
    ref_app = RefAppSpec(arch=arch, shape=shape, shape_overrides=SMOKE)
    assert rec["model_flops"] == ref_model_flops(ref_app.model_config,
                                                 ref_app.shape_config)
    assert {k: v for k, v in rec["plan"].items() if k != "napkin"} == \
        {k: v for k, v in plan.items() if k != "napkin"}
    assert rec["fallbacks"] == fallbacks
    assert rec["kernels_traced_as"] == "plain"
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["hlo_cost"]["wire_bytes_per_chip"] == 0.0
    # a smoke step is far below a card's bound, on a CPU target's rates
    assert rec["roofline"]["chips"] == 1 and rec["roofline"]["mesh"] == \
        "local:cpu"


def _fake_mesh(shape, axes):
    """The reference test's placeholder-device mesh."""
    class _Dev:
        def __init__(self, i):
            self.id = i
    devs = np.array([_Dev(i) for i in range(int(np.prod(shape)))]
                    ).reshape(shape)
    return RefMesh(devs, axes)


def _ref_specs(result, cfg_name):
    """The reference's spec trees and fallbacks of the build's tables:
    the same tables under the port build's plan, bound as the reference's
    build binds them, on its pod's mesh shape."""
    plan, target = result.plan, result.target
    shape = result.appspec.shape_config
    mesh = _fake_mesh(target.mesh_shape, target.mesh_axes)
    rules = ref_rules.SEQUENCE_PARALLEL_RULES if plan.sequence_parallel \
        else ref_rules.DEFAULT_RULES
    model = ref_model_for(ref_get_config(cfg_name))
    fb = []

    def specs(table, r=rules):
        return [(p, tuple(s.spec)) for p, s in leaf_items(
            ref_partition_specs(table, mesh, r, fb))]
    from repro.configs.base import SHAPES as REF_SHAPES
    ref_shape = REF_SHAPES[shape.name]
    out = {"batch": specs(model.batch_table(ref_shape))}
    if shape.kind == "train":
        rp = RefPlan(arch=cfg_name, shape=shape.name, target="t",
                     mesh_shape=(1,), mesh_axes=("data",),
                     optimizer=plan.optimizer,
                     grad_compression=plan.grad_compression)
        out["state"] = specs(ref_train_state_table(
            model, ref_make_optimizer(plan.optimizer), rp))
    else:
        out["params"] = specs(model.param_table())
        cache_rules = rules
        model_size = dict(zip(target.mesh_axes,
                              target.mesh_shape)).get("model", 1)
        if shape.kind == "decode" and model.cfg.num_kv_heads and \
                model.cfg.num_kv_heads % model_size:
            cache_rules = ref_rules.DECODE_SEQ_CACHE_RULES
        out["cache"] = specs(model.cache_table(ref_shape.global_batch,
                                               ref_shape.seq_len),
                             cache_rules)
    return out, sorted(set(fb))


@pytest.mark.parametrize("target", sorted(dryrun.MESHES.values()))
def test_cluster_specs_equal_the_reference_pods(target):
    assert get_target(target).mesh_shape in ((16, 16), (2, 16, 16))
    for arch, shape, _ in cells():
        if get_config(arch).family == "stencil":
            continue
        res = BuildService().build(AppSpec(arch=arch, shape=shape), target,
                                   lower=False)
        assert not res.mesh.live
        want, want_fb = _ref_specs(res, arch)
        got = {k: [(p, tuple(s)) for p, s in leaf_items(v)]
               for k, v in res.specs.items()}
        assert got == want, (arch, shape, target)
        assert res.plan.sharding_fallbacks == want_fb, (arch, shape, target)


def _shard_bytes(table, specs, mesh_shape, axes) -> int:
    """Each leaf's bytes over the ranks its spec splits it across."""
    size = dict(zip(axes, mesh_shape))
    total = 0
    for (_, d), (_, spec) in zip(leaf_items(table), leaf_items(specs)):
        split = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                split *= size[a]
        total += int(np.prod(d.shape)) * d.dtype.itemsize // split
    return total


def test_main_on_a_full_width_cell(tmp_path):
    code = dryrun.main(["--arch", "deepseek-7b", "--shape", "decode_32k",
                        "--mesh", "both"], out_dir=tmp_path, log=quiet)
    assert code == 0
    wants = {}
    for key, target in dryrun.MESHES.items():
        rec = json.loads((tmp_path / f"deepseek-7b__decode_32k__{key}.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["target"] == target
        res = BuildService().build(AppSpec(arch="deepseek-7b",
                                           shape="decode_32k"), target,
                                   lower=False)
        tgt = get_target(target)
        want = sum(_shard_bytes(res.tables[k], res.specs[k], tgt.mesh_shape,
                                tgt.mesh_axes)
                   for k in ("params", "cache", "batch"))
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] == want
        # the KV cache alone: 2.06 TB over batch and heads (8.05 GB a
        # card of 256), the weights' shards beside it
        kv = 30 * 2 * 32 * 128 * 2 * 32768 * 128
        assert kv / tgt.num_chips < want < kv / tgt.num_chips + 2e9
        assert rec["roofline"]["chips"] == tgt.num_chips
        assert rec["hlo_cost"]["wire_bytes_per_chip"] > 0
        assert rec["compile_s"] is None and \
            mem["generated_code_size_in_bytes"] is None
        wants[key] = want
    assert wants["multi"] < wants["single"]


def test_whole_weights_on_a_mesh_show_in_memory_per_card(tmp_path):
    """A split step holds its shards and one layer: nemotron-4-340b's 680
    GB of bf16 weights rest a 256th to a card on nvidia:h100x256 and stay
    so in its decode step (a 9.66 GB cache shard along the sequence,
    each layer's weights gathered along ``data`` alone), under a card's
    80 GB.  The enc-dec family, which once gathered every weight whole
    for each step, splits too: whisper-tiny's arguments a card are its
    weights' and its cache's shards (the self and cross K/V split along
    the sequence), and the weights it holds gathered at once, the
    reckoning of the embedding and the learned position table it reads
    together, fall short of the whole weights."""
    rec = dryrun.run_cell("nemotron-4-340b", "decode_32k", "single",
                          out_dir=tmp_path, log=quiet)
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory_analysis"]
    n_params = rec["model_flops"]["n_active"]
    assert mem["temp_size_in_bytes"] < 2 * n_params / 16
    assert 12 < mem["per_chip_total_gb"] < 80
    assert 0 < rec["gathered_at_once_bytes"] < mem["temp_size_in_bytes"]
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "single",
                          out_dir=tmp_path, log=quiet)
    assert rec["status"] == "ok", rec.get("traceback")
    res = BuildService().build(AppSpec(arch="whisper-tiny",
                                       shape="decode_32k"),
                               dryrun.MESHES["single"], lower=False)
    tgt = res.target
    whole = sum(int(np.prod(d.shape)) * d.dtype.itemsize
                for _, d in leaf_items(res.tables["params"]))
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(
        _shard_bytes(res.tables[k], res.specs[k], tgt.mesh_shape,
                     tgt.mesh_axes) for k in ("params", "cache", "batch"))
    cfg = get_config("whisper-tiny")
    at_once = 2 * cfg.d_model * (cfg.vocab_size + cfg.max_position)
    assert rec["gathered_at_once_bytes"] == at_once == \
        dryrun.gathered_at_once(res.tables["params"], res.specs["params"],
                                res.mesh, None)
    assert 0 < at_once < whole and at_once < mem["temp_size_in_bytes"]
    assert any("I1" in n for n in rec["plan"]["notes"])


def test_moe_training_on_a_data_parallel_mesh_records_the_refusal(tmp_path):
    """MoE training on a data-parallel mesh, once refused, now runs split:
    the cell is ``ok``; its arguments are the state's and the batch's
    shards; the trace of the split step gathers one layer's weights along
    ``data`` at a time, whose reckoning is the largest of the
    embedding's, one block's and the head's, worked out here; its
    collectives are the traced step's, reduce-scatters among them."""
    rec = dryrun.run_cell("granite-moe-3b-a800m", "train_4k", "single",
                          out_dir=tmp_path, log=quiet)
    assert rec["status"] == "ok", rec.get("traceback")
    res = BuildService().build(AppSpec(arch="granite-moe-3b-a800m",
                                       shape="train_4k"),
                               dryrun.MESHES["single"], lower=False)
    tgt = res.target
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(
        _shard_bytes(res.tables[k], res.specs[k], tgt.mesh_shape,
                     tgt.mesh_axes) for k in ("state", "batch"))
    assert mem["temp_size_in_bytes"] > 0
    # 40 experts on a 16-way model axis: experts whole, their mlp split;
    # every weight's embed axis gathered over data
    cfg = get_config("granite-moe-3b-a800m")
    d, f, E, dh = cfg.d_model, cfg.d_ff // 16, cfg.num_experts, \
        cfg.head_dim
    block = 2 * (d * (cfg.num_heads // 16) * dh * 2
                 + d * cfg.num_kv_heads * dh * 2     # kv_heads 8: whole
                 + d * E + 3 * E * d * f + 2 * d)
    vocab = cfg.vocab_size                            # 49,155: whole
    head = 2 * (d * vocab + d)
    assert rec["gathered_at_once_bytes"] == max(block, head, 2 * vocab * d)
    calls = rec["hlo_cost"]["collective_calls"]
    assert calls["reduce_scatter"]["calls"] > 0
    assert calls["all_gather"]["calls"] > 0
    assert rec["memory_analysis"]["per_chip_total_gb"] > 0


REF_MESH_ARGS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from repro.core.appspec import AppSpec
from repro.core.build import BuildService
got = {}
for arch, shape, over in json.loads(sys.argv[1]):
    res = BuildService().build(AppSpec(arch=arch, shape=shape,
                                       shape_overrides=over),
                               "local:cpu-mesh8", lower=True)
    mem = res.lowered.compile().memory_analysis()
    got[f"{arch} {shape}"] = mem.argument_size_in_bytes
print("RESULT:" + json.dumps(got))
"""
MESH_CELLS = [("deepseek-7b-smoke", "prefill_32k"),
              ("deepseek-7b-smoke", "decode_32k"),
              ("granite-moe-3b-a800m-smoke", "decode_32k"),
              ("xlstm-1.3b-smoke", "train_4k"),
              ("xlstm-1.3b-smoke", "decode_32k"),
              ("zamba2-7b-smoke", "train_4k"),
              ("zamba2-7b-smoke", "decode_32k")]
MESH_SMOKE = {"seq_len": 32, "global_batch": 4}


def test_split_rank_step_takes_the_reference_meshs_arguments(tmp_path):
    """The smoke cells on (2, 4): the bytes of the meta arguments the
    port's rank step is traced on, and the record's arguments a card,
    equal the reference's compiled step's per device on 8 forced host
    devices."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", REF_MESH_ARGS, json.dumps(
            [(a, sh, MESH_SMOKE) for a, sh in MESH_CELLS])],
        env=dict(os.environ, PYTHONPATH=str(repo / "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT:")]
    want = json.loads(line[0][len("RESULT:"):])
    for arch, shape in MESH_CELLS:
        res = BuildService().build(AppSpec(arch=arch, shape=shape,
                                           shape_overrides=MESH_SMOKE),
                                   "local:cpu-mesh8", lower=False)
        assert not res.mesh.live and dryrun.split_cell(res)
        step, args, split = dryrun.cell_step(res)
        # every meta argument (a train state's 0-d counters among them)
        traced = sum(t.numel() * t.element_size()
                     for t in cost._tensors(list(args))
                     if t.device.type == "meta")
        index = 4 if shape == "decode_32k" else 0     # the host's 0-d index
        assert traced + index == want[f"{arch} {shape}"], (arch, shape)
        rec = dryrun.run_cell(arch, shape, "mesh8", overrides=MESH_SMOKE,
                              out_dir=tmp_path, target="local:cpu-mesh8",
                              log=quiet)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            want[f"{arch} {shape}"]
        calls = rec["hlo_cost"]["collective_calls"]
        assert calls["all_reduce"]["calls"] > 0
        if arch.startswith("granite") and shape == "decode_32k":
            # the cache split along its sequence: each layer's heads by
            # an all-to-all over the model axis
            assert calls["all_to_all"]["calls"] == \
                2 * get_config(arch).num_layers


def test_split_moe_prefill_longer_than_a_chunk(tmp_path):
    """A split MoE prefill past the MoE layer's 2,048-token chunk (the
    ``prefill_32k`` cells of dbrx-132b and granite-moe-3b-a800m): the
    chunks' routers compute no aux loss in serving, and the cell traces
    ``ok``."""
    rec = dryrun.run_cell("granite-moe-3b-a800m-smoke", "prefill_32k",
                          "mesh8", overrides={"seq_len": 4096,
                                              "global_batch": 4},
                          out_dir=tmp_path, target="local:cpu-mesh8",
                          log=quiet)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["gathered_at_once_bytes"] > 0


def test_meta_trace_counts_what_measure_counts_on_the_cpu():
    """The smoke prefill and decode steps, once on CPU tensors under
    ``measure``, once on their meta twins under ``trace``: the same dot
    FLOPs and the same peak; the same bytes where no gather's rows repeat
    (the token ids here are distinct)."""
    from repro_torch.training import steps
    from repro_torch.models.transformer import model_for
    app = AppSpec(arch="deepseek-7b-smoke", shape="decode_32k",
                  shape_overrides={"seq_len": 16, "global_batch": 4})
    res = BuildService().build(app, "local:cpu", lower=False)
    model = model_for(app.model_config, remat="none")
    params = init_params(res.tables["params"],
                         torch.Generator().manual_seed(0), "cpu")
    cache = {k: torch.randn(d.shape).to(d.dtype) if d.shape else
             torch.tensor(15, dtype=d.dtype)
             for (k,), d in leaf_items(res.tables["cache"])}
    tokens = torch.arange(4, dtype=torch.int32)[:, None] + 3
    _, real = cost.measure(steps.build_decode_step(model), params, cache,
                           tokens)
    step, args, split = dryrun.cell_step(res)
    assert split == 1
    _, meta = cost.trace(step, *args)
    assert (meta.flops, meta.dot_count) == (real.flops, real.dot_count)
    assert meta.peak_bytes == real.peak_bytes > 0
    assert meta.hbm_bytes == real.hbm_bytes


def test_roofline_report_fields_by_hand():
    rec = cost.StepCost(flops=2.0e12, hbm_bytes=6.7e9, wire_bytes=1.0e9,
                        collective_breakdown={"all-gather": {"count": 1}})
    tgt = get_target("nvidia:h100x256")
    r = roofline.from_cost(rec, target=tgt, arch="a", shape="s",
                           mesh="single", chips=256, model_flops=1.0e14,
                           memory_per_chip={"per_chip_total_gb": 1.0})
    assert r.t_collective == pytest.approx(1.0e9 / 50e9, rel=1e-12)
    assert r.bottleneck == "collective" and r.t_bound == r.t_collective
    assert r.roofline_fraction == pytest.approx(r.t_compute / r.t_collective)
    assert r.useful_ratio == pytest.approx(1.0e14 / (2.0e12 * 256))
    assert r.mfu_bound == pytest.approx(
        1.0e14 / 256 / 989e12 / r.t_collective)
    from repro.analysis.roofline import Roofline as RefRoofline
    ref = RefRoofline(arch="a", shape="s", mesh="single", chips=256,
                      hlo_flops=1.0, hbm_bytes=1.0, wire_bytes=1.0,
                      model_flops=1.0).finalize()
    assert r.row().keys() == ref.row().keys()
    assert r.collective_breakdown == {"all-gather": {"count": 1}}
    # the one card's roofline as before
    one = roofline.from_cost(rec)
    assert one.link_bw == roofline.NVLINK_BW == get_target(
        "nvidia:h100").ici_bw
    assert one.t_collective == pytest.approx(1.0e9 / 450e9, rel=1e-12)
