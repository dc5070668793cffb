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

The ``###include_local_kernels###`` directive selects the target's kernel
library vs the plain PyTorch versions for LM plans, as in the reference.
"""

from __future__ import annotations

import dataclasses
import re
import time
from repro_torch.core.appspec import AppSpec
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.target import TargetSpec, get_target
from repro_torch.core.tuning import tune

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
        if lower:
            raise NotImplementedError(
                f"building the {shape.kind} step of an LM is not ported yet "
                f"(ROADMAP slice E); lower=False gives the plan")
        return BuildResult(appspec=appspec, target=target, plan=plan,
                           step_name=f"{shape.kind}_step",
                           timings={"tune_s": tune_s})

    def _build_stencil(self, appspec: AppSpec, target: TargetSpec,
                       lower: bool) -> BuildResult:
        """LULESH-family build: the deployable unit is one fused hydro
        step on the target (grid parsed from the RUN command)."""
        m = re.search(r"-s\s+(\d+)", appspec.run)
        grid = int(m.group(1)) if m else 16
        plan = DeploymentPlan(
            arch=appspec.arch, shape=f"grid{grid}", target=target.name,
            mesh_shape=target.mesh_shape, mesh_axes=target.mesh_axes,
            kernels=target.kernels, remat_policy="none")
        plan.notes.append("stencil app: fields sharded (grid_x->data, "
                          "grid_y->model); dt via global all-reduce")
        # the step itself is chosen where it runs (launch/run.py), from
        # the same plan.kernels
        sources = ("sedov_stencil",) if plan.kernels == "cuda" else ()
        result = BuildResult(
            appspec=appspec, target=target, plan=plan,
            step_name="sedov_step",
            program=program_description("sedov_step", plan.kernels, sources))
        if lower and sources:
            from repro_torch.kernels import _build
            _, result.timings["build_s"] = _timed(_build.build, sources)
            result.built = {n: _build.library_path(n).name for n in sources}
        return result
