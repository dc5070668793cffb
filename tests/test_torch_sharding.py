"""The port's sharding rules, meshes and build bindings against the JAX
reference, in this one process (no ranks).

* The reference's own cases (``tests/test_sharding_rules.py``) give the
  same spec and fallbacks through the port's ``logical_to_spec``, and
  its two properties hold for the port.
* For every LM arch, on the reference's meshes (16, 16) and (2, 16, 16)
  and on (2, 4), the port's spec trees and fallbacks equal the
  reference's entry for entry: the param table, the train-state table
  under ``adamw`` and ``adamw8bit`` + ``ef_int8``, the train and decode
  batch tables, and the cache table under the default rules and
  ``DECODE_SEQ_CACHE_RULES``; and LULESH's field specs.
* The port's build on ``local:cpu-mesh8`` records the reference build's
  ``plan.sharding_fallbacks`` and I1 note at the train, prefill and
  decode shapes (the reference's build needs 8 devices: it runs in one
  subprocess with 8 forced host devices, ``lower=False``).
* Placements and local slices of a tuple entry on a 3-axis mesh
  description; a multi-chip target without ranks raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from jax.sharding import Mesh as RefMesh
from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core.plan import DeploymentPlan as RefPlan
from repro.models import lulesh as ref_lulesh
from repro.models.params import bytes_of as ref_bytes_of
from repro.models.params import partition_specs as ref_partition_specs
from repro.models.params import shape_structs as ref_shape_structs
from repro.models.transformer import model_for as ref_model_for
from repro.optim import make_optimizer as ref_make_optimizer
from repro.sharding import rules as ref_rules
from repro.training.steps import train_state_table as ref_train_state_table

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.target import get_target
from repro_torch.launch.mesh import (degraded_mesh, describe,
                                     mesh_for_target)
from repro_torch.models import lulesh
from repro_torch.models.params import (bytes_of, leaf_items,
                                       partition_specs, replicated_specs)
from repro_torch.models.transformer import model_for
from repro_torch.optim import make_optimizer
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (DEFAULT_RULES, AxisRules,
                                        PartitionSpec, local_slices,
                                        logical_to_spec, placements,
                                        shard_constraint)
from repro_torch.training.steps import train_state_table

REPO = Path(__file__).resolve().parents[1]


def _fake_mesh(shape=(16, 16), axes=("data", "model")):
    """The reference test's placeholder-device mesh."""
    class _Dev:
        def __init__(self, i):
            self.id = i
    devs = np.array([_Dev(i) for i in range(int(np.prod(shape)))]
                    ).reshape(shape)
    return RefMesh(devs, axes)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
MESH = describe(*MESHES["16x16"])
MESH3 = describe(*MESHES["2x16x16"])


def _both(logicals, dims, mesh_key, rule_names=("DEFAULT_RULES",),
          custom=None):
    """The port's and the reference's (spec, fallbacks)."""
    shape, axes = MESHES[mesh_key]
    fb, rfb = [], []
    r = custom[0] if custom else getattr(rules, rule_names[0])
    rr = custom[1] if custom else getattr(ref_rules, rule_names[0])
    got = logical_to_spec(logicals, dims, describe(shape, axes), r, fb)
    want = ref_rules.logical_to_spec(logicals, dims, _fake_mesh(shape, axes),
                                     rr, rfb)
    return (got, fb), (want, rfb)


# the reference's cases: (logicals, dims, mesh, its expected spec)
CASES = {
    "divisible_dims_shard": (("embed", "mlp"), (2048, 5632), "16x16",
                             ("data", "model")),
    "indivisible_dim_falls_back_with_record": (("kv_heads", None), (8, 128),
                                               "16x16", (None, None)),
    "multi_axis_batch_on_multipod": (("act_batch", "act_seq"), (256, 4096),
                                     "2x16x16", (("pod", "data"), None)),
    "partial_multi_axis_when_batch_small": (("act_batch",), (2,), "2x16x16",
                                            ("pod",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases(case):
    logicals, dims, mesh, expect = CASES[case]
    (got, fb), (want, rfb) = _both(logicals, dims, mesh)
    assert tuple(got) == tuple(want) == expect
    assert got == want
    assert fb == rfb
    if case == "indivisible_dim_falls_back_with_record":
        assert any("kv_heads" in f for f in fb)


def test_axis_never_reused_within_spec():
    custom = (AxisRules(rules={"a": ("model",), "b": ("model",)}),
              ref_rules.AxisRules(rules={"a": ("model",), "b": ("model",)}))
    (got, _), (want, _) = _both(("a", "b"), (16, 16), "16x16", custom=custom)
    assert tuple(got) == tuple(want) == ("model", None)


def test_rule_tables_are_the_reference():
    assert rules.LOGICAL_AXES == ref_rules.LOGICAL_AXES
    for name in ("DEFAULT_RULES", "SEQUENCE_PARALLEL_RULES",
                 "DECODE_SEQ_CACHE_RULES"):
        assert dict(getattr(rules, name).rules) == \
            dict(getattr(ref_rules, name).rules), name


@settings(max_examples=50, deadline=None)
@given(
    dim=st.integers(1, 4096),
    logical=st.sampled_from(["embed", "mlp", "heads", "vocab", "act_batch"]),
)
def test_spec_always_valid(dim, logical):
    """Whatever the dim, the produced spec's axis product divides it, and
    it is the reference's."""
    (got, fb), (want, rfb) = _both((logical,), (dim,), "2x16x16")
    assert (tuple(got), fb) == (tuple(want), rfb)
    entry = got[0]
    if entry is None:
        return
    axes = entry if isinstance(entry, tuple) else (entry,)
    sizes = dict(zip(MESH3.axis_names, MESH3.shape))
    assert dim % int(np.prod([sizes[a] for a in axes])) == 0


@settings(max_examples=30, deadline=None)
@given(
    shape=st.lists(st.sampled_from([1, 2, 8, 16, 40, 96, 256, 4096]),
                   min_size=1, max_size=4),
)
def test_no_mesh_axis_used_twice(shape):
    logicals = ["act_batch", "heads", "mlp", "vocab"][:len(shape)]
    spec = logical_to_spec(tuple(logicals), tuple(shape), MESH3,
                           DEFAULT_RULES)
    used = []
    for entry in spec:
        if entry is None:
            continue
        used += list(entry) if isinstance(entry, tuple) else [entry]
    assert len(used) == len(set(used)), spec


# ---------------------------------------------------------------------------
# spec trees of every arch's tables


def _ref_specs(table, mesh, rules_, fb):
    return [(p, tuple(s.spec)) for p, s in leaf_items(
        ref_partition_specs(table, mesh, rules_, fb))]


def _port_specs(table, mesh, rules_, fb):
    return [(p, tuple(s)) for p, s in leaf_items(
        partition_specs(table, mesh, rules_, fb))]


def _tables(mk_model, mk_opt, state_table, plan_cls, shapes, cfg):
    """The tables of one package: name -> (table, rules name)."""
    model = mk_model(cfg)
    train, decode = shapes["train_4k"], shapes["decode_32k"]
    out = {"params": (model.param_table(), "DEFAULT_RULES")}
    for opt, comp in (("adamw", "none"), ("adamw8bit", "ef_int8")):
        plan = plan_cls(arch=cfg.name, shape="train_4k", target="t",
                        mesh_shape=(1,), mesh_axes=("data",), optimizer=opt,
                        grad_compression=comp)
        out[f"state_{opt}"] = (state_table(model, mk_opt(opt), plan),
                               "DEFAULT_RULES")
    for name, shape in (("train", train), ("decode", decode)):
        out[f"batch_{name}"] = (model.batch_table(shape), "DEFAULT_RULES")
    cache = model.cache_table(decode.global_batch, decode.seq_len)
    out["cache"] = (cache, "DEFAULT_RULES")
    out["cache_seq"] = (cache, "DECODE_SEQ_CACHE_RULES")
    return out


LM_ARCHS = sorted(a for a in ARCHS if get_config(a).family != "stencil")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_trees_equal_the_reference(arch):
    ours = _tables(model_for, make_optimizer, train_state_table,
                   DeploymentPlan, SHAPES, get_config(arch))
    theirs = _tables(ref_model_for, ref_make_optimizer,
                     ref_train_state_table, RefPlan, REF_SHAPES,
                     ref_get_config(arch))
    assert ours.keys() == theirs.keys()
    for mesh_key, (shape, axes) in MESHES.items():
        mesh, ref_mesh = describe(shape, axes), _fake_mesh(shape, axes)
        for name, (table, rules_name) in ours.items():
            fb, rfb = [], []
            got = _port_specs(table, mesh, getattr(rules, rules_name), fb)
            want = _ref_specs(theirs[name][0], ref_mesh,
                              getattr(ref_rules, rules_name), rfb)
            assert got == want, (arch, mesh_key, name)
            assert fb == rfb, (arch, mesh_key, name)
        # the bytes the tables declare
        assert bytes_of(ours["params"][0]) == \
            ref_bytes_of(ref_shape_structs(theirs["params"][0]))


def test_lulesh_field_specs_equal_the_reference():
    for mesh_key, (shape, axes) in MESHES.items():
        for n in (13, 16, 256):
            for extra in ((), (None,)):
                logicals = extra + lulesh.FIELD_AXES
                dims = (3,) * len(extra) + (n,) * 3
                (got, fb), (want, rfb) = _both(logicals, dims, mesh_key)
                assert (tuple(got), fb) == (tuple(want), rfb)
    assert lulesh.FIELD_AXES == ref_lulesh.FIELD_AXES


def test_replicated_specs_and_shard_constraint_off_mesh():
    table = model_for(get_config("deepseek-7b-smoke")).param_table()
    assert all(s == PartitionSpec() for _, s in
               leaf_items(replicated_specs(table, MESH)))
    x = torch.ones(4, 8)
    one = mesh_for_target(get_target("local:cpu"))
    assert one.live and one.size == 1 and one.device_mesh is None
    for mesh in (None, one, describe((2, 4), ("data", "model"))):
        assert shard_constraint(x, ("act_batch", None), mesh) is x


def test_tuple_entry_placements_and_slices_on_three_axes():
    from torch.distributed.tensor import Replicate, Shard
    spec = logical_to_spec(("act_batch", "act_mlp"), (256, 4096), MESH3,
                           DEFAULT_RULES)
    assert tuple(spec) == (("pod", "data"), "model")
    assert placements(spec, MESH3) == [Shard(0), Shard(0), Shard(1)]
    # block (pod, data) row-major of 32 along rows, model of 16 along cols
    for pod, data, model in ((0, 0, 0), (1, 3, 5), (1, 15, 15)):
        rows, cols = local_slices(spec, (256, 4096), MESH3,
                                  (pod, data, model))
        i = pod * 16 + data
        assert (rows.start, rows.stop) == (8 * i, 8 * (i + 1))
        assert (cols.start, cols.stop) == (256 * model, 256 * (model + 1))
    assert placements(PartitionSpec(None, None), MESH3) == [Replicate()] * 3
    with pytest.raises(NotImplementedError, match="order"):
        placements(PartitionSpec(("data", "pod")), MESH3)


def test_multi_chip_target_without_ranks_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    tgt = get_target("local:cpu-mesh8")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_for_target(tgt)
    with pytest.raises(RuntimeError, match="init_process_group"):
        degraded_mesh(tgt)
    with pytest.raises(ValueError, match="one data slice"):
        degraded_mesh(tgt, lost_data_slices=2)


# ---------------------------------------------------------------------------
# the build's fallbacks on local:cpu-mesh8, against the reference's build

BUILD_ARCHS = ("deepseek-7b-smoke", "granite-moe-3b-a800m-smoke")
# batches of 1 and 3 do not divide the data axis (2): act_batch falls back
BUILD_SHAPES = {"train_4k": {"seq_len": 32, "global_batch": 8},
                "prefill_32k": {"seq_len": 64, "global_batch": 1},
                "decode_32k": {"seq_len": 64, "global_batch": 3}}

REF_BUILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from repro.core.appspec import AppSpec
from repro.core.build import BuildService
cases = json.loads(sys.argv[1])
out = {}
for arch, shape, over in cases:
    res = BuildService().build(AppSpec(arch=arch, shape=shape,
                                       shape_overrides=over),
                               "local:cpu-mesh8", lower=False)
    out[f"{arch}|{shape}"] = {"fallbacks": res.plan.sharding_fallbacks,
                              "notes": res.plan.notes,
                              "microbatches": res.plan.microbatches,
                              "optimizer": res.plan.optimizer}
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_builds():
    cases = [[a, s, o] for a in BUILD_ARCHS for s, o in BUILD_SHAPES.items()]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_BUILD,
                           json.dumps(cases)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT:")]
    return json.loads(line[0][len("RESULT:"):])


@pytest.mark.parametrize("arch", BUILD_ARCHS)
@pytest.mark.parametrize("shape", sorted(BUILD_SHAPES))
def test_build_fallbacks_equal_the_reference(ref_builds, arch, shape):
    want = ref_builds[f"{arch}|{shape}"]
    res = BuildService().build(AppSpec(arch=arch, shape=shape,
                                       shape_overrides=BUILD_SHAPES[shape]),
                               "local:cpu-mesh8", lower=False)
    assert res.mesh.shape == (2, 4) and not res.mesh.live
    assert res.plan.sharding_fallbacks == want["fallbacks"]
    i1 = [n for n in res.plan.notes if n.startswith("I1")]
    assert i1 == [n for n in want["notes"] if n.startswith("I1")]
    assert (res.plan.microbatches, res.plan.optimizer) == \
        (want["microbatches"], want["optimizer"])
    # the KV heads of granite's smoke config (2) do not divide model (4)
    if arch.startswith("granite") and shape == "decode_32k":
        assert i1 and any(f.startswith("kv_heads:model")
                          for f in res.plan.sharding_fallbacks)
        # the I1 rules: the cache's sequence axis over model
        assert res.specs["cache"]["k"] == PartitionSpec(
            None, None, "model", None, None)
