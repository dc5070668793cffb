"""BuildService — the EASEY client's `docker build` analogue (§2.1), port
of ``repro/core/build.py``.

    AppSpec (portable) + TargetSpec (local) --tune--> DeploymentPlan
        --lower--> the step the target runs, its kernels built for it
        --package--> deployable artifact (core/package.py)

The reference lowers its step to StableHLO (``jax.jit(...).lower``).
PyTorch runs eagerly and has no lowered program; the port's counterpart
is to build, with ``nvcc`` for ``sm_90a``, every hand-written kernel the
step launches on a target whose plan says ``kernels == "cuda"`` (so the
timed run never pays a compile), and to record a description of the
program: the step, the sha256 of each kernel source and the flags it was
built with (``"reference"`` on the CPU target, which builds nothing).

An LM's ``decode`` and ``prefill`` shapes are the serving app: their
step is the paged serving engine's, whose hand-written kernels are the
paged-decode kernel (decode only) and the RMSNorm kernel (rmsnorm
configs); the other families' (VLM, xLSTM, Zamba2, enc-dec) is the
legacy fixed-batch path's, the RMSNorm kernel alone on an rmsnorm
config and no kernel on a LayerNorm one.  As in the reference, a serve
shape's ``step_fn`` is ``build_prefill_step`` (prefill) or the
whole-batch ``build_decode_step`` (decode) on the target's mesh: on a
live mesh of ranks the step split along ``model`` (``training.steps``),
which the dry run traces as one rank's step on a described mesh
(``steps.described_serve_step``).
The ``train`` shape's step is ``training.steps.
build_train_step`` under the plan (optimizer, microbatches, remat,
accumulation dtype), returned as ``step_fn`` with its state and batch
tables; its kernel is the RMSNorm kernel (rmsnorm configs), on every
norm of the forward and of the remat recompute.

The ``###include_local_kernels###`` directive selects the target's kernel
library vs the plain PyTorch versions for LM plans, as in the reference.

Every build also binds the sharding rules to the target's mesh, as the
reference's does: the spec tree of each table (``specs``: the state and
batch of a train shape, the params, batch and cache of a serve shape,
the cache under ``DECODE_SEQ_CACHE_RULES`` where a decode's KV heads do
not divide the model axis) and every divisibility fallback in
``plan.sharding_fallbacks``.  ``mesh`` is the target's live mesh where
this process holds one of its ranks (or the target is one device), and
its description otherwise: the specs and plan are the same, and a step
refuses to run on a description.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable

from repro_torch.core.appspec import AppSpec
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.target import TargetSpec, get_target
from repro_torch.core.tuning import tune
from repro_torch.launch.mesh import describe, mesh_for_target
from repro_torch.models.params import partition_specs
from repro_torch.sharding.rules import (DECODE_SEQ_CACHE_RULES,
                                        DEFAULT_RULES,
                                        SEQUENCE_PARALLEL_RULES)

# what the source of a kernel is called in a package's program description
CSRC_IN_REPO = "src/repro_torch/kernels/csrc"


@dataclasses.dataclass
class BuildResult:
    appspec: AppSpec
    target: TargetSpec
    plan: DeploymentPlan
    step_name: str
    # what write_package stores as the program (see module docstring)
    program: dict = dataclasses.field(default_factory=dict)
    # kernel name -> built library, for the kernels built by this build
    built: dict = dataclasses.field(default_factory=dict)
    timings: dict = dataclasses.field(default_factory=dict)
    # the train shape's step (state, batch) -> (state, metrics), a
    # prefill's (params, batch) -> (logits, cache), a decode's (params,
    # cache, tokens) -> (logits, cache), the stencil's (state) -> state;
    # the declarative tables ("state", "batch", "params"; "cache" for a
    # serve shape)
    step_fn: Callable | None = None
    tables: dict = dataclasses.field(default_factory=dict)
    # the target's mesh (launch.mesh.Mesh) and the spec tree of each table
    mesh: Any = None
    specs: dict = dataclasses.field(default_factory=dict)

    @property
    def rules(self):
        return SEQUENCE_PARALLEL_RULES if self.plan.sequence_parallel \
            else DEFAULT_RULES


def _timed(fn, *args, **kw):
    """(fn's result, host seconds it took) — advisory build timings."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def program_description(step_name: str, kernels: str,
                        sources: tuple[str, ...]) -> dict:
    """The step, and for a CUDA plan each kernel source it launches with
    its sha256 and nvcc flags; ``arch`` is ``sm_90a`` or ``"reference"``
    (plain PyTorch, nothing built)."""
    if kernels != "cuda":
        return {"step": step_name, "arch": "reference", "kernels": {}}
    from repro_torch.kernels import _build
    return {"step": step_name, "arch": _build.ARCH, "kernels": {
        name: {"source": f"{CSRC_IN_REPO}/{name}.cu",
               "sha256": _build.source_sha256(name),
               "nvcc_flags": list(_build.flags(name))}
        for name in sources}}


# the LM families the port runs: the engine's, and those the legacy
# fixed-batch serve path serves (the VLM, xLSTM, the Zamba2 hybrid and
# the enc-dec)
LM_FAMILIES = ("dense", "moe", "vlm", "ssm_xlstm", "hybrid_mamba", "encdec")


def _lm_sources(cfg, kind: str) -> tuple[str, ...]:
    """The kernel sources an LM's step launches: the paged-decode kernel
    on every decode tick of the engine's families (the legacy path
    decodes over a contiguous whole-batch cache, without it), the RMSNorm
    kernel on every norm of an rmsnorm config (in training, of the
    forward and of its remat recompute)."""
    from repro_torch.serving.engine import SERVABLE_FAMILIES
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"no LM family {cfg.family!r}")
    paged = kind == "decode" and cfg.family in SERVABLE_FAMILIES
    norm = ("rmsnorm",) if cfg.norm == "rmsnorm" else ()
    return (("paged_attention",) if paged else ()) + norm


def _target_mesh(target: TargetSpec):
    """The target's live mesh where this process holds its ranks (or the
    target is one device), else its description."""
    import torch.distributed as dist
    if target.num_chips == 1 or dist.is_initialized():
        return mesh_for_target(target)
    return describe(tuple(target.mesh_shape), tuple(target.mesh_axes))


def cache_rules(cfg, axes: tuple, shape: tuple, kind: str, rules):
    """The rules a serve shape's cache rests under on a mesh of ``shape``
    over ``axes``: a decode's cache shards its sequence axis where the KV
    heads do not divide the model axis (the reference's perf iteration
    I1), else ``rules``."""
    model_size = dict(zip(axes, shape)).get("model", 1)
    if kind == "decode" and cfg.num_kv_heads and \
            cfg.num_kv_heads % model_size:
        return DECODE_SEQ_CACHE_RULES
    return rules


def _bind(result: BuildResult, cfg, shape) -> None:
    """The step's tables and their specs on the target's mesh, the train
    shape's step, and the fallbacks into the plan (the reference's build,
    table for table)."""
    from repro_torch.models.transformer import model_for
    from repro_torch.optim import make_optimizer
    from repro_torch.training.steps import (build_decode_step,
                                            build_prefill_step,
                                            build_train_step,
                                            train_state_table)
    plan, target, mesh = result.plan, result.target, result.mesh
    model = model_for(cfg, remat=plan.remat_policy)
    rules = result.rules
    fallbacks: list[str] = []

    def specs(table, rules=rules):
        return partition_specs(table, mesh, rules, fallbacks)

    batch_table = model.batch_table(shape)
    if shape.kind == "train":
        opt = make_optimizer(plan.optimizer)
        state_table = train_state_table(model, opt, plan)
        result.step_fn = build_train_step(model, opt, plan, mesh)
        result.tables = {"state": state_table, "batch": batch_table,
                         "params": model.param_table()}
        result.specs = {"state": specs(state_table),
                        "batch": specs(batch_table)}
    else:
        param_table = model.param_table()
        cache_table = model.cache_table(shape.global_batch, shape.seq_len)
        c_rules = cache_rules(cfg, target.mesh_axes, target.mesh_shape,
                              shape.kind, rules)
        if c_rules is DECODE_SEQ_CACHE_RULES:
            plan.notes.append("I1: kv cache sharded on seq axis "
                              "(kv_heads % model != 0)")
        # the reference's serve steps: the whole prompt's prefill, the
        # legacy whole-batch decode over its cache (a live mesh's step
        # splits the rows; a description's refuses to run)
        if target.num_chips == 1:
            result.step_fn = build_prefill_step(model) \
                if shape.kind == "prefill" else build_decode_step(model)
        else:
            result.step_fn = build_prefill_step(model, mesh, c_rules) \
                if shape.kind == "prefill" else build_decode_step(model, mesh)
        result.tables = {"params": param_table, "batch": batch_table,
                         "cache": cache_table}
        result.specs = {"params": specs(param_table),
                        "batch": specs(batch_table)}
        result.specs["cache"] = specs(cache_table, c_rules)
    plan.sharding_fallbacks = sorted(set(fallbacks))


class BuildService:
    """Stateless builder; all outputs are in the BuildResult."""

    def build(self, appspec: AppSpec, target: TargetSpec | str,
              overrides: dict | None = None,
              lower: bool = True) -> BuildResult:
        if isinstance(target, str):
            target = get_target(target)
        cfg = appspec.model_config
        if cfg.family == "stencil":
            return self._build_stencil(appspec, target, lower)
        shape = appspec.shape_config
        plan, tune_s = _timed(tune, cfg, shape, target, overrides)
        # directive resolution (###include_local_kernels###)
        if "###include_local_kernels###" not in appspec.directives:
            plan.kernels = "reference"
            plan.notes.append("local-kernel directive absent -> reference ops")
        step_name = f"{shape.kind}_step"
        sources = _lm_sources(cfg, shape.kind) if plan.kernels == "cuda" \
            else ()
        result = BuildResult(
            appspec=appspec, target=target, plan=plan, step_name=step_name,
            program=program_description(step_name, plan.kernels, sources),
            timings={"tune_s": tune_s}, mesh=_target_mesh(target))
        _bind(result, cfg, shape)
        if lower and sources:
            from repro_torch.kernels import _build
            _, result.timings["build_s"] = _timed(_build.build, sources)
            result.built = {n: _build.library_path(n).name for n in sources}
        return result

    def _build_stencil(self, appspec: AppSpec, target: TargetSpec,
                       lower: bool) -> BuildResult:
        """LULESH-family build: the deployable unit is one hydro step on
        the target's mesh (grid parsed from the RUN command)."""
        m = re.search(r"-s\s+(\d+)", appspec.run)
        grid = int(m.group(1)) if m else 16
        plan = DeploymentPlan(
            arch=appspec.arch, shape=f"grid{grid}", target=target.name,
            mesh_shape=target.mesh_shape, mesh_axes=target.mesh_axes,
            kernels=target.kernels, remat_policy="none")
        plan.notes.append("stencil app: fields sharded (grid_x->data, "
                          "grid_y->model); dt via global all-reduce")
        # launch/run.py chooses the kernel or the plain step from the same
        # plan.kernels; step_fn is the reference's: the plain step, on the
        # mesh (halo exchanges, dt all-reduced) past one chip
        from repro_torch.models import lulesh
        sources = ("sedov_stencil",) if plan.kernels == "cuda" else ()
        mesh = _target_mesh(target)
        cfg = lulesh.LuleshConfig(grid=grid)
        use_mesh = mesh if target.num_chips > 1 else None

        def step_fn(state):
            return lulesh.step(state, cfg, use_mesh)
        result = BuildResult(
            appspec=appspec, target=target, plan=plan,
            step_name="sedov_step",
            program=program_description("sedov_step", plan.kernels, sources),
            step_fn=step_fn, mesh=mesh)
        if lower and sources:
            from repro_torch.kernels import _build
            _, result.timings["build_s"] = _timed(_build.build, sources)
            result.built = {n: _build.library_path(n).name for n in sources}
        return result
