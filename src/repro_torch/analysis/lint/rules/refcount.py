"""Rule ``refcount-pairing``: page acquisitions must not leak locally.

(Port of ``repro/analysis/lint/rules/refcount.py``, rule for rule:
the same ids, findings, messages and hints.)

The paged pool's refcount discipline (PRs 2/5) pairs every acquisition
— ``attach`` (+1 per shared page), ``adopt_run`` (ownership move),
``reserve_prefix`` (fresh pages) — with a ``free``/``release_page`` by
the time the holding request retires.  The pairing usually spans
functions (submit acquires, the scheduler releases at finish/preempt),
so the rule checks the *local* obligation: a function that acquires
pages for a slot and lets that slot neither escape nor be released on
some exit path is leaking pages that nothing can ever free.

Dataflow, per function (linear walk with branch-copies):

* ``<pool-ish>.attach(slot, ...)`` / ``.adopt_run(slot, ...)`` /
  ``.reserve_prefix(slot, ...)`` — receiver chain mentioning ``pool``,
  ``cache`` or ``prefix`` — marks ``slot`` as *holding*;
* ``.free(slot)`` clears it; ``.release_page(...)`` clears everything
  (page-granular releases are below slot-level tracking);
* any *escape* — the slot passed to another call, returned, yielded, or
  stored into an attribute/subscript/container — transfers ownership to
  whoever sees it and clears the obligation;
* a ``return`` (or falling off the end) while a slot is still held and
  unescaped is a finding on that exit; ``raise`` paths are exempt
  (exception cleanup is the caller's preemption/evict machinery).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.core import Finding, Source, dotted

ACQUIRE = {"attach", "adopt_run", "reserve_prefix"}
RELEASE_ONE = {"free"}
RELEASE_ALL = {"release_page"}

HINT = ("pair the acquisition with pool.free(slot)/release_page on "
        "this path, or hand the slot off (store/return it) so the "
        "scheduler's finish/preempt path owns the release")


def _pool_like(recv: str | None) -> bool:
    if not recv:
        return False
    low = recv.lower()
    return "pool" in low or "cache" in low or "prefix" in low


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


class RefcountPairingRule:
    id = "refcount-pairing"
    suffixes = (".py",)

    def check(self, src: Source, cfg) -> list[Finding]:
        if "/serving/" not in "/" + src.rel.replace("\\", "/"):
            return []
        findings: list[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.FunctionDef):
                self._check_fn(node, src, findings)
        return findings

    def _check_fn(self, fn, src: Source, findings: list[Finding]) -> None:
        # held: slot name -> (line, col, "pool.method") of the acquisition
        def process_stmt(st, held: dict) -> None:
            """Mutate *held* for one statement's acquire/release/escape."""
            acquire_nodes: list[ast.AST] = []
            release_names: set[str] = set()
            release_all = False
            acquired_here: list[tuple[str, ast.Call, str]] = []
            for call in ast.walk(st):
                if not isinstance(call, ast.Call) or \
                        not isinstance(call.func, ast.Attribute):
                    continue
                recv = dotted(call.func.value)
                attr = call.func.attr
                if attr in ACQUIRE and _pool_like(recv) and call.args and \
                        isinstance(call.args[0], ast.Name):
                    acquire_nodes.append(call)
                    acquired_here.append(
                        (call.args[0].id, call, f"{recv}.{attr}"))
                elif attr in RELEASE_ONE and call.args and \
                        isinstance(call.args[0], ast.Name):
                    release_names.add(call.args[0].id)
                    acquire_nodes.append(call)
                elif attr in RELEASE_ALL:
                    release_all = True
                    acquire_nodes.append(call)
            # escapes: held names loaded anywhere in the statement outside
            # the acquire/release calls themselves
            consumed: set[int] = set()
            for c in acquire_nodes:
                consumed.update(id(n) for n in ast.walk(c))
            escaped = {n.id for n in ast.walk(st)
                       if isinstance(n, ast.Name) and
                       isinstance(n.ctx, ast.Load) and
                       n.id in held and id(n) not in consumed}
            for name in escaped:
                held.pop(name, None)
            if release_all:
                held.clear()
            for name in release_names:
                held.pop(name, None)
            for name, call, via in acquired_here:
                held[name] = (call.lineno, call.col_offset, via)

        def leak(held: dict, line: int) -> None:
            for name, (ln, col, via) in sorted(held.items()):
                findings.append(Finding(
                    self.id, src.rel, ln, col,
                    f"`{fn.name}` acquires pages for `{name}` via "
                    f"`{via}` but the exit at line {line} neither "
                    f"releases nor hands it off", hint=HINT))

        def walk(stmts, held: dict):
            """Returns the fall-through state, or None if the block
            exits on every path."""
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue                 # analyzed on their own
                if isinstance(st, ast.Return):
                    process_stmt(st, held)   # returning the slot = escape
                    leak(held, st.lineno)
                    return None
                if isinstance(st, ast.Raise):
                    return None              # exception paths exempt
                if isinstance(st, (ast.Break, ast.Continue)):
                    return held
                if isinstance(st, ast.If):
                    process_stmt(st.test, held)
                    h1 = walk(st.body, dict(held))
                    h2 = walk(st.orelse, dict(held))
                    if h1 is None and h2 is None:
                        return None
                    merged: dict = {}
                    for h in (h1, h2):
                        if h is not None:
                            merged.update(h)
                    held.clear()
                    held.update(merged)
                    continue
                if isinstance(st, (ast.For, ast.While, ast.AsyncFor)):
                    cond = getattr(st, "iter", None) or \
                        getattr(st, "test", None)
                    if cond is not None:
                        process_stmt(cond, held)
                    h1 = walk(st.body, dict(held))
                    if h1 is not None:
                        held.update(h1)
                    h2 = walk(st.orelse, dict(held))
                    if h2 is not None:
                        held.update(h2)
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        process_stmt(item.context_expr, held)
                    h = walk(st.body, held)
                    if h is None:
                        return None
                    continue
                if isinstance(st, ast.Try):
                    h = walk(st.body, held)
                    for hd in st.handlers:
                        walk(hd.body, dict(held))
                    if h is not None and st.orelse:
                        h = walk(st.orelse, h)
                    if st.finalbody:
                        h = walk(st.finalbody, h if h is not None else held)
                    if h is None:
                        return None
                    held.clear()
                    held.update(h)
                    continue
                process_stmt(st, held)
            return held

        final = walk(fn.body, {})
        if final:
            last = fn.body[-1]
            leak(final, getattr(last, "end_lineno", last.lineno))
