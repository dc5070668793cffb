"""Rule ``keyed-rng``: serving-side draws must be (rid, step)-keyed.

(The port's counterpart of ``repro/analysis/lint/rules/keyed_rng.py``,
which matches ``jax.random`` names.)

Sampling determinism across admission order, slot assignment, preemption
and speculation rests on one discipline (``serving/sampling.py``): the
key of any draw is ``fold_in(fold_in(base, rid), step)``, the port's
integer threefry, and ``gumbel(key, n)`` draws from it.  A draw from
torch's global generator, a generator seeded with a literal, or one key
used for two draws silently breaks stream identity in ways the
equivalence tests only catch when the colliding schedule happens to be
exercised.

Scope: files under ``serving/``.  Draws are torch's ``rand``, ``randn``,
``randint``, ``randperm``, ``multinomial``, ``bernoulli`` and
``normal`` (and the ``*_like`` forms), keyed by their ``generator=``;
the in-place ``Tensor.uniform_`` / ``normal_`` / ``exponential_`` /
``bernoulli_``, keyed the same way; and ``sampling.gumbel(key, n)``,
keyed by its first argument.  A key is legitimate when it is
``fold_in``-derived (the expression, or a name assigned from one), or a
function parameter (the caller's obligation — the helper pattern
``make_sampler`` uses).  Flags:

* ``manual_seed(<literal>)`` anywhere — a hard-coded seed;
* a torch draw with no ``generator=`` (torch's global generator);
* a draw whose key is neither ``fold_in``-derived nor a parameter;
* a generator made by ``torch.Generator(...).manual_seed(...)`` from a
  seed that is not ``fold_in``-derived, drawn from directly (base seeds
  exist to be folded, not drawn from);
* the same key name feeding two or more draws (unkeyed reuse).

A generator seeded from a parameter and handed to something that is not
a draw (``serving/engine.py`` seeds one for ``init_params``: weights,
not a sampling draw) is not a finding.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.core import Finding, Source, dotted

TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
               "bernoulli", "normal", "rand_like", "randn_like",
               "randint_like"}
INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "bernoulli_"}
KEYED_DRAWS = {"gumbel"}           # serving/sampling.py: (key, n)

HINT = ("derive keys as fold_in(fold_in(base, rid), step) — see "
        "serving/sampling.py; a fresh fold per draw keeps streams "
        "deterministic under preemption and speculation")


def _contains_fold_in(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d and d.split(".")[-1] == "fold_in":
                return True
    return False


def _manual_seed_arg(node: ast.AST) -> ast.AST | None:
    """The seed of the ``manual_seed(...)`` call inside ``node``, if any
    (``torch.Generator(...).manual_seed(s)``)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == "manual_seed" and sub.args:
            return sub.args[0]
    return None


def _draw(call: ast.Call, torch_names: set[str]):
    """(name, key node or None) when ``call`` is a draw, else None."""
    d = dotted(call.func)
    if d is not None:
        parts = d.split(".")
        leaf = parts[-1]
        torch_fn = (len(parts) == 2 and parts[0] == "torch") or \
            (len(parts) == 1 and leaf in torch_names)
        if torch_fn and leaf in TORCH_DRAWS:
            return d, _kw(call, "generator")
        if leaf in KEYED_DRAWS and (len(parts) == 1 or
                                    parts[-2] == "sampling"):
            key = call.args[0] if call.args else _kw(call, "key")
            return d, key
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in INPLACE_DRAWS:
        name = d or f"<tensor>.{call.func.attr}"
        return name, _kw(call, "generator")
    return None


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class KeyedRngRule:
    id = "keyed-rng"
    suffixes = (".py",)

    def check(self, src: Source, cfg) -> list[Finding]:
        if "/serving/" not in "/" + src.rel.replace("\\", "/"):
            return []
        # names bound straight to torch draws by `from torch import rand`
        torch_names: set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "torch":
                for alias in node.names:
                    if alias.name in TORCH_DRAWS:
                        torch_names.add(alias.asname or alias.name)
        findings: list[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_fn(node, src, torch_names, findings)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "manual_seed" and node.args and \
                    isinstance(node.args[0], ast.Constant):
                findings.append(Finding(
                    self.id, src.rel, node.lineno, node.col_offset,
                    f"literal manual_seed({node.args[0].value!r}) — seeds "
                    f"must be injected, never hard-coded", hint=HINT))
        return findings

    def _check_fn(self, fn, src: Source, torch_names: set[str],
                  findings: list[Finding]) -> None:
        a = fn.args
        params = {arg.arg for arg in a.posonlyargs + a.args + a.kwonlyargs}
        folded: set[str] = set()
        base_gens: set[str] = set()
        for st in ast.walk(fn):
            if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                    isinstance(st.targets[0], ast.Name):
                name = st.targets[0].id
                seed = _manual_seed_arg(st.value)
                if seed is not None:
                    if _contains_fold_in(seed):
                        folded.add(name)
                    else:
                        base_gens.add(name)
                elif _contains_fold_in(st.value):
                    folded.add(name)
        draws_per_key: dict[str, int] = {}
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            drawn = _draw(call, torch_names)
            if drawn is None:
                continue
            d, key = drawn
            if key is None:
                findings.append(Finding(
                    self.id, src.rel, call.lineno, call.col_offset,
                    f"draw `{d}` takes torch's global generator — pass a "
                    f"fold_in-keyed generator", hint=HINT))
                continue
            kname = key.id if isinstance(key, ast.Name) else None
            if kname is not None:
                draws_per_key[kname] = draws_per_key.get(kname, 0) + 1
            if kname in base_gens:
                findings.append(Finding(
                    self.id, src.rel, call.lineno, call.col_offset,
                    f"base generator `{kname}` drawn from directly — fold "
                    f"(rid, step) in first", hint=HINT))
            elif not (_contains_fold_in(key) or kname in folded or
                      kname in params):
                findings.append(Finding(
                    self.id, src.rel, call.lineno, call.col_offset,
                    f"draw `{d}` keyed by an expression that is not "
                    f"fold_in-derived", hint=HINT))
            elif kname is not None and draws_per_key[kname] > 1:
                findings.append(Finding(
                    self.id, src.rel, call.lineno, call.col_offset,
                    f"key `{kname}` reused for a second draw in the same "
                    f"function — every draw needs its own fold",
                    hint=HINT))
