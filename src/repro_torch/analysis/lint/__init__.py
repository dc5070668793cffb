"""easeylint — AST-level invariant checker of the PyTorch/CUDA port
(port of ``repro/analysis/lint``).

Six rules enforce the invariants the serving stack and the kernels hold
by hand (see each rule module's docstring for the full contract):

==================  =====================================================
rule id             invariant
==================  =====================================================
wall-clock          no wall-clock escape into gated metrics/artifacts
graph-purity        CUDA-graph captures never touch host state or sync
telemetry-guard     every tracer call dominated by `is not None`
keyed-rng           serving draws are (rid, step) fold_in-keyed
refcount-pairing    page acquisitions release or hand off on all exits
smem-budget         each CUDA kernel's shared memory fits a block's
==================  =====================================================

Run ``python -m repro_torch.analysis.lint src/repro_torch``.  Suppress a
single advisory site with a justified ``# easeylint: allow[rule-id]``
pragma (``// easeylint: allow[rule-id]`` in a ``.cu`` source); whole
advisory files live in ``allow.toml`` next to this package, each entry
with a ``reason``.  Nothing here imports JAX or the JAX package; the
shared-memory rule reads its budget from ``core/target.py``.
"""

from repro_torch.analysis.lint.core import (AllowEntry, Finding, LintConfig,
                                            default_config, lint_paths,
                                            lint_source)

__all__ = ["AllowEntry", "Finding", "LintConfig", "default_config",
           "lint_paths", "lint_source"]
