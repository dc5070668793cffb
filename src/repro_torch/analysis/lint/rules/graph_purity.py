"""Rule ``graph-purity``: CUDA-graph captures stay pure host-side.

(The port's counterpart of ``repro/analysis/lint/rules/jit_purity.py``:
PyTorch runs eagerly, and its counterpart of a traced function is a
body captured under ``torch.cuda.graph``.)

The body of a ``with torch.cuda.graph(g):`` block, and a callable handed
to ``torch.cuda.make_graphed_callables``, runs once, at capture time;
replays run only the device work it recorded.  Host-side effects inside
it (mutating captured state, appending to lists, telemetry calls)
happen once and never again, and a host sync (``.item()``, ``.cpu()``,
``torch.cuda.synchronize``, ...) is illegal during a capture and fails
it.

Roots are found syntactically in each module: the body of every
``with`` block whose context is ``torch.cuda.graph(...)`` (or the name
``graph`` imported from ``torch.cuda``), and every function named in
the first argument of ``make_graphed_callables`` (one callable, a tuple
of them, or ``functools.partial(fn, ...)``).  Same-module functions a
root calls by name join the captured set transitively, as
``jit_purity.py`` finds them.  Inside a root the rule flags:

* mutating method calls (``append``/``update``/``add``/...) whose
  receiver is a *captured* name — bound outside the root and not a
  module import alias or module-level function;
* assignments (plain, augmented, or subscript/attribute stores) whose
  target's root name is captured (a write into a static tensor made
  outside the capture is recorded into the graph, and carries a pragma
  saying so);
* ``global`` / ``nonlocal`` declarations;
* any reference to a name or attribute containing ``tracer`` —
  telemetry must never enter a captured body;
* host syncs: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` (any ``.synchronize()``) and ``print``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.core import (Finding, Source, bound_names,
                                            dotted, func_defs,
                                            import_aliases, root_name)

GRAPH_CTX = {"torch.cuda.graph", "cuda.graph"}
GRAPHED_FNS = {"torch.cuda.make_graphed_callables",
               "cuda.make_graphed_callables", "make_graphed_callables"}
PARTIAL_FNS = {"functools.partial", "partial"}

MUTATORS = {"append", "extend", "insert", "add", "update", "pop",
            "popleft", "appendleft", "remove", "discard", "clear",
            "setdefault", "write"}
SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}

HINT = ("a captured body runs once, at capture time: keep host state, "
        "tracers, prints and host syncs outside torch.cuda.graph "
        "captures and graphed callables")


def _callee_names(node: ast.AST) -> list[str]:
    """Function names a make_graphed_callables operand refers to."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for elt in node.elts for n in _callee_names(elt)]
    if isinstance(node, ast.Call) and dotted(node.func) in PARTIAL_FNS \
            and node.args:
        return _callee_names(node.args[0])
    return []


def _graph_names(tree: ast.AST) -> set[str]:
    """``torch.cuda.graph`` and the local names bound to it by
    ``from torch.cuda import graph [as x]``."""
    names = set(GRAPH_CTX)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch.cuda":
            for alias in node.names:
                if alias.name == "graph":
                    names.add(alias.asname or alias.name)
    return names


def _roots(tree: ast.AST) -> tuple[list[ast.With], set[str]]:
    """(the ``with torch.cuda.graph`` blocks, the graphed function
    names)."""
    ctx_names = _graph_names(tree)
    blocks, fns = [], set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call) and
                dotted(item.context_expr.func) in ctx_names
                for item in node.items):
            blocks.append(node)
        elif isinstance(node, ast.Call) and \
                dotted(node.func) in GRAPHED_FNS and node.args:
            fns.update(_callee_names(node.args[0]))
    return blocks, fns


class GraphPurityRule:
    id = "graph-purity"
    suffixes = (".py",)

    def check(self, src: Source, cfg) -> list[Finding]:
        blocks, graphed = _roots(src.tree)
        if not blocks and not graphed:
            return []
        defs = func_defs(src.tree)
        module_aliases = import_aliases(src.tree)
        module_defs = {n.name for n in src.tree.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        findings: list[Finding] = []
        frontier = [n for n in graphed if n in defs]
        for block in blocks:
            label = f"captured body (line {block.lineno})"
            self._check_body(block.body, label, src, module_aliases,
                             module_defs, findings)
            frontier.extend(self._calls(block.body, defs))
        # transitive closure over same-module calls by name
        captured: set[str] = set()
        while frontier:
            name = frontier.pop()
            if name in captured:
                continue
            captured.add(name)
            frontier.extend(self._calls([defs[name]], defs))
        for name in sorted(captured):
            self._check_body([defs[name]], f"captured function `{name}`",
                             src, module_aliases, module_defs, findings)
        return findings

    @staticmethod
    def _calls(stmts, defs: dict) -> list[str]:
        out = []
        for st in stmts:
            for node in ast.walk(st):
                if isinstance(node, ast.Call):
                    callee = dotted(node.func)
                    if callee in defs:
                        out.append(callee)
        return out

    def _check_body(self, stmts, label: str, src: Source,
                    module_aliases: set[str], module_defs: set[str],
                    findings: list[Finding]) -> None:
        local: set[str] = set()
        for st in stmts:
            local |= bound_names(st)
        ok_roots = local | module_aliases | module_defs

        def flag(node, msg):
            findings.append(Finding(
                self.id, src.rel, node.lineno, node.col_offset,
                f"{label} {msg}", hint=HINT))

        for st in stmts:
            for node in ast.walk(st):
                self._check_node(node, ok_roots, flag)

    @staticmethod
    def _check_node(node, ok_roots: set[str], flag) -> None:
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            flag(node, f"declares {type(node).__name__.lower()} "
                       f"{', '.join(node.names)} — host-state mutation "
                       f"inside a capture")
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in MUTATORS:
                root = root_name(func.value)
                if root is not None and root not in ok_roots:
                    flag(node, f"mutates captured `{root}.{func.attr}(...)`"
                               f" — the effect runs at capture time, not "
                               f"per replay")
            elif isinstance(func, ast.Attribute) and \
                    func.attr in SYNC_METHODS:
                flag(node, f"calls `.{func.attr}()` — a host sync, "
                           f"illegal while a CUDA graph captures")
            elif isinstance(func, ast.Name) and func.id == "print":
                flag(node, "calls `print` — host output runs once, at "
                           "capture time")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    root = root_name(t)
                    if root is not None and root not in ok_roots:
                        flag(node, f"stores into captured `{root}` — "
                                   f"host-state mutation inside a capture")
        if isinstance(node, ast.Name) and "tracer" in node.id:
            flag(node, f"references `{node.id}` — telemetry must stay "
                       f"host-side, outside captured code")
        elif isinstance(node, ast.Attribute) and "tracer" in node.attr:
            flag(node, f"references `.{node.attr}` — telemetry must stay "
                       f"host-side, outside captured code")
