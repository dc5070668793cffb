"""Rule registry: rule id -> rule class.

Each rule exposes ``id``, ``suffixes`` (the file suffixes it reads) and
``check(src, cfg) -> list[Finding]``; the runner owns reading, parsing,
pragma and allowlist suppression, exit status.
"""

from __future__ import annotations

from repro_torch.analysis.lint.rules.wall_clock import WallClockRule
from repro_torch.analysis.lint.rules.graph_purity import GraphPurityRule
from repro_torch.analysis.lint.rules.telemetry_guard import \
    TelemetryGuardRule
from repro_torch.analysis.lint.rules.keyed_rng import KeyedRngRule
from repro_torch.analysis.lint.rules.refcount import RefcountPairingRule
from repro_torch.analysis.lint.rules.smem_budget import SmemBudgetRule

ALL_RULES = {cls.id: cls for cls in (
    WallClockRule, GraphPurityRule, TelemetryGuardRule, KeyedRngRule,
    RefcountPairingRule, SmemBudgetRule)}
