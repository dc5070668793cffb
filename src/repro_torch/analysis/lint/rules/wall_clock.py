"""Rule ``wall-clock``: no wall-clock escape into gated code.

(Port of ``repro/analysis/lint/rules/wall_clock.py``, rule for rule:
the same ids, findings, messages and hints.)

Every deterministic invariant in the serving stack hangs off the
virtual-step clock; a stray ``time.time()`` / ``perf_counter`` /
``datetime.now()`` is how wall time leaks into gated metrics, checkpoint
bytes, or scheduling decisions.  The rule flags every *reference* to a
wall-clock source — calls and bare references alike, so an advisory
``clock=time.perf_counter`` default argument or a
``default_factory=time.time`` field is caught too.

Known-advisory escapes are expressed, never silent:

* code inside a function literally named ``_timed`` (the one shared
  benchmark timing idiom) is exempt;
* a ``# easeylint: allow[wall-clock]`` pragma on the line (or the line
  above) marks a single advisory site, with the justification in the
  comment;
* whole advisory files (wall-clock FOM benchmarks, build timings) live
  in ``allow.toml`` with a reason each.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.core import Finding, Source, dotted

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
# functions imported bare (`from time import perf_counter`)
_WALL_FROM = {("time", "time"), ("time", "time_ns"),
              ("time", "perf_counter"), ("time", "perf_counter_ns"),
              ("time", "monotonic"), ("time", "monotonic_ns")}

HINT = ("route timing through an injected clock/now= parameter (vstep "
        "clocks for anything gated); mark a genuinely advisory site with "
        "`# easeylint: allow[wall-clock]` or an allow.toml entry")

ALLOWED_FUNCS = {"_timed"}


class WallClockRule:
    id = "wall-clock"
    suffixes = (".py",)

    def check(self, src: Source, cfg) -> list[Finding]:
        findings: list[Finding] = []
        # names bound straight to wall-clock functions by `from X import Y`
        bare: set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if (node.module, alias.name) in _WALL_FROM:
                        bare.add(alias.asname or alias.name)

        def visit(node, in_allowed: bool):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_allowed = in_allowed or node.name in ALLOWED_FUNCS
            if not in_allowed:
                name = None
                if isinstance(node, ast.Attribute):
                    d = dotted(node)
                    if d in WALL_CLOCK:
                        name = d
                elif isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and node.id in bare:
                    name = node.id
                if name is not None:
                    findings.append(Finding(
                        self.id, src.rel, node.lineno, node.col_offset,
                        f"wall-clock source `{name}` referenced — gated "
                        f"metrics and serialized artifacts must be "
                        f"wall-clock-blind", hint=HINT))
                    return  # don't re-report `time.time` inside itself
            for child in ast.iter_child_nodes(node):
                visit(child, in_allowed)

        visit(src.tree, False)
        return findings
