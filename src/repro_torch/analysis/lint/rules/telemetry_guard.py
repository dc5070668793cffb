"""Rule ``telemetry-guard``: tracer call sites must be None-guarded.

(Port of ``repro/analysis/lint/rules/telemetry_guard.py``, rule for rule:
the same ids, findings, messages and hints.)

The telemetry contract (ROADMAP §Observability) is that every
instrumentation site is an ``if tracer is not None`` guard — pure
host-side bookkeeping that cannot move token streams and costs one
attribute load when tracing is off.  A bare ``tracer.begin(...)`` (or
``.emit(...)``) crashes every telemetry-off run the moment the code path
executes, which is exactly the drift this rule catches at review time.

A call fires when the receiver chain ends in ``tracer`` (``tracer.x()``,
``self.tracer.x()``) or the method is ``emit`` and the call is not
dominated by a None-check of the *same* receiver expression.  Recognized
guards, per function:

* ``if X is not None: ...`` (the repo idiom) — body is guarded;
* ``if X is None: return/raise/continue/break`` — the rest of the block;
* ``assert X is not None`` — the rest of the block;
* ``X is not None and X.begin(...)`` / plain-truthiness ``if X:`` —
  expression-level conjunction and truthiness both count.

The reference allowlists its ``serving/telemetry.py`` (where the tracer
is the required subject, not an optional hook); the port's passes the
rule as it is and needs no entry.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.core import Finding, Source, dotted

HINT = ("wrap the site in `if <tracer> is not None:` — instrumentation "
        "must be skippable so telemetry-off runs never touch it")


def _guard_terms(test: ast.AST) -> tuple[set[str], set[str]]:
    """(proven-not-None when true, proven-not-None when false)."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.comparators[0], ast.Constant) and \
            test.comparators[0].value is None:
        d = dotted(test.left)
        if d:
            if isinstance(test.ops[0], ast.IsNot):
                return {d}, set()
            if isinstance(test.ops[0], ast.Is):
                return set(), {d}
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        pos: set[str] = set()
        for v in test.values:
            p, _ = _guard_terms(v)
            pos |= p
        return pos, set()
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        p, n = _guard_terms(test.operand)
        return n, p
    d = dotted(test)
    if d:                       # plain truthiness: `if self.tracer:`
        return {d}, set()
    return set(), set()


def _block_exits(stmts) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


class TelemetryGuardRule:
    id = "telemetry-guard"
    suffixes = (".py",)

    def check(self, src: Source, cfg) -> list[Finding]:
        findings: list[Finding] = []

        def is_tracer_call(call: ast.Call) -> str | None:
            """Receiver dotted string when the call needs a guard."""
            if not isinstance(call.func, ast.Attribute):
                return None
            recv = dotted(call.func.value)
            if recv and (recv == "tracer" or recv.endswith(".tracer")):
                return recv
            if call.func.attr == "emit" and recv:
                return recv
            return None

        def scan_expr(node: ast.AST, guarded: frozenset):
            if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
                g = set(guarded)
                for v in node.values:
                    scan_expr(v, frozenset(g))
                    p, _ = _guard_terms(v)
                    g |= p
                return
            if isinstance(node, ast.IfExp):
                scan_expr(node.test, guarded)
                p, n = _guard_terms(node.test)
                scan_expr(node.body, guarded | p)
                scan_expr(node.orelse, guarded | n)
                return
            if isinstance(node, ast.Call):
                recv = is_tracer_call(node)
                if recv is not None and recv not in guarded:
                    findings.append(Finding(
                        self.id, src.rel, node.lineno, node.col_offset,
                        f"`{recv}.{node.func.attr}(...)` is not dominated "
                        f"by an `is not None` check of `{recv}`",
                        hint=HINT))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                scan_expr(child, guarded)

        def walk_block(stmts, guarded: frozenset):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # a nested def runs later — its body cannot inherit
                    # the lexical guard (the closure may outlive it)
                    walk_block(st.body, frozenset())
                elif isinstance(st, ast.ClassDef):
                    walk_block(st.body, guarded)
                elif isinstance(st, ast.If):
                    scan_expr(st.test, guarded)
                    pos, neg = _guard_terms(st.test)
                    walk_block(st.body, guarded | pos)
                    walk_block(st.orelse, guarded | neg)
                    if not st.orelse and neg and _block_exits(st.body):
                        guarded = guarded | neg
                elif isinstance(st, ast.Assert):
                    scan_expr(st.test, guarded)
                    pos, _ = _guard_terms(st.test)
                    guarded = guarded | pos
                elif isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
                    for field in ("test", "iter", "target"):
                        sub = getattr(st, field, None)
                        if sub is not None:
                            scan_expr(sub, guarded)
                    walk_block(st.body, guarded)
                    walk_block(st.orelse, guarded)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        scan_expr(item.context_expr, guarded)
                    walk_block(st.body, guarded)
                elif isinstance(st, ast.Try):
                    walk_block(st.body, guarded)
                    for h in st.handlers:
                        walk_block(h.body, guarded)
                    walk_block(st.orelse, guarded)
                    walk_block(st.finalbody, guarded)
                else:
                    scan_expr(st, guarded)

        walk_block(src.tree.body, frozenset())
        return findings
