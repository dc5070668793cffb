"""easeylint core: findings, pragma/allowlist suppression, the runner
(port of ``repro/analysis/lint/core.py``).

The linter enforces the port's hand-maintained invariants statically
(wall-clock-blind gated metrics, guarded telemetry, (rid, step)-keyed
sampling, refcount pairing, pure CUDA-graph captures, the CUDA kernels'
shared-memory budget).  Rules produce a shared :class:`Finding` type;
the runner reads each file once, parses a Python file once, fans it out
to every rule that takes its suffix (``.py`` by default, ``.cu`` for the
shared-memory rule), then strips findings that a pragma (same line or
the line above) or an ``allow.toml`` entry covers.  The pragma is
``# easeylint: allow[rule-id]`` in Python and ``// easeylint:
allow[rule-id]`` in CUDA C++.

Severity is two-level: ``error`` findings fail the run; ``info``
findings are advisory reports (the shared-memory rule's per-kernel
bytes) and never affect the exit status.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
from pathlib import Path

from repro_torch.analysis.lint import toml_lite

PRAGMA_RE = {
    ".py": re.compile(r"#\s*easeylint:\s*allow\[([^\]]+)\]"),
    ".cu": re.compile(r"//\s*easeylint:\s*allow\[([^\]]+)\]"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                # repo-relative, posix separators
    line: int
    col: int
    message: str
    hint: str = ""
    severity: str = "error"  # "error" | "info"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "severity": self.severity,
                "message": self.message, "hint": self.hint}

    def render(self) -> str:
        out = (f"{self.path}:{self.line}:{self.col}: "
               f"[{self.severity}] {self.rule}: {self.message}")
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass
class Source:
    """One read file, shared by every rule; ``tree`` is None for a file
    that is not Python (a ``.cu`` source has only its text and lines)."""
    rel: str                 # path as reported in findings
    text: str
    tree: ast.Module | None
    lines: list[str]


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    path: str
    reason: str


@dataclasses.dataclass
class LintConfig:
    """Parsed ``allow.toml``: site allowlist + shared-memory-rule
    parameters."""
    allow: tuple[AllowEntry, ...] = ()
    smem_target: str = "nvidia:h100"
    smem_bounds: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str | Path) -> "LintConfig":
        return cls.from_text(Path(path).read_text())

    @classmethod
    def from_text(cls, text: str) -> "LintConfig":
        data = toml_lite.loads(text)
        entries = []
        for i, raw in enumerate(data.get("allow", []), 1):
            rule, apath = raw.get("rule"), raw.get("path")
            reason = raw.get("reason", "")
            if not rule or not apath:
                raise ValueError(f"allow entry #{i} needs rule= and path=")
            if not reason.strip():
                # the allowlist is documentation as much as suppression —
                # an entry without a why is a finding waiting to rot
                raise ValueError(
                    f"allow entry #{i} ({rule} @ {apath}) needs a reason=")
            entries.append(AllowEntry(rule, apath, reason))
        smem = data.get("smem", {})
        bounds = {k: int(v) for k, v in smem.get("bounds", {}).items()}
        return cls(allow=tuple(entries),
                   smem_target=smem.get("target", "nvidia:h100"),
                   smem_bounds=bounds)


def default_config() -> LintConfig:
    return LintConfig.from_file(Path(__file__).parent / "allow.toml")


# ---------------------------------------------------------------------------
# suppression

def _path_match(finding_path: str, pattern: str) -> bool:
    fp = finding_path.replace(os.sep, "/")
    pat = pattern.replace(os.sep, "/")
    if pat.endswith("/"):                       # directory prefix
        return fp.startswith(pat) or ("/" + pat) in ("/" + fp)
    if fnmatch.fnmatch(fp, pat):
        return True
    return fp == pat or fp.endswith("/" + pat)


def pragma_rules(line: str, suffix: str = ".py") -> set[str]:
    m = PRAGMA_RE[suffix].search(line)
    if not m:
        return set()
    return {tok.strip() for tok in m.group(1).split(",") if tok.strip()}


def suppressed(finding: Finding, src: Source, cfg: LintConfig) -> bool:
    suffix = Path(src.rel).suffix
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(src.lines):
            ids = pragma_rules(src.lines[ln - 1], suffix)
            if finding.rule in ids or "*" in ids:
                return True
    return any(e.rule in (finding.rule, "*") and
               _path_match(finding.path, e.path) for e in cfg.allow)


# ---------------------------------------------------------------------------
# small AST helpers shared by the rules

def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def root_name(node: ast.AST) -> str | None:
    """Leftmost Name of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def import_aliases(tree: ast.AST) -> set[str]:
    """Every local name bound by an import (module aliases and members)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    return names


def func_defs(tree: ast.AST) -> dict:
    """name -> def node for every (possibly nested) function in the tree.
    On name collisions the first definition wins — good enough for the
    call-graph walk, which only needs *a* body to inspect."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def bound_names(fn: ast.AST) -> set[str]:
    """Names bound anywhere inside *fn* (args of it and nested defs,
    assignment/for/with/comprehension targets, local defs, imports)."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                names.add(arg.arg)
            if a.vararg:
                names.add(a.vararg.arg)
            if a.kwarg:
                names.add(a.kwarg.arg)
        elif isinstance(node, ast.Lambda):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                names.add(arg.arg)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    return names


# ---------------------------------------------------------------------------
# runner

def _rule_instances(rule_ids=None):
    from repro_torch.analysis.lint.rules import ALL_RULES
    ids = list(ALL_RULES) if rule_ids is None else list(rule_ids)
    unknown = [r for r in ids if r not in ALL_RULES]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; known: "
                         f"{sorted(ALL_RULES)}")
    return [ALL_RULES[r]() for r in ids]


def lint_source(text: str, rel: str, cfg: LintConfig | None = None,
                rule_ids=None) -> list[Finding]:
    """Lint one in-memory source blob (the test fixtures' entry point);
    the suffix of ``rel`` picks the rules that see it."""
    cfg = cfg if cfg is not None else LintConfig()
    rel = rel.replace(os.sep, "/")
    suffix = Path(rel).suffix
    rules = [r for r in _rule_instances(rule_ids) if suffix in r.suffixes]
    tree = None
    if suffix == ".py":
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            return [Finding("parse", rel, e.lineno or 1, e.offset or 0,
                            f"syntax error: {e.msg}")]
    src = Source(rel=rel, text=text, tree=tree, lines=text.splitlines())
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(src, cfg))
    # dedupe: rules that walk nested defs can visit a site twice
    findings = list(dict.fromkeys(
        f for f in findings if not suppressed(f, src, cfg)))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_files(roots, suffixes=(".py",)) -> list[Path]:
    """Every file under ``roots`` with one of ``suffixes`` (a file named
    as a root is taken whatever its suffix), skipping caches and dot
    directories."""
    files: list[Path] = []
    for root in roots:
        p = Path(root)
        if p.is_file():
            files.append(p)
            continue
        found = [f for s in suffixes for f in p.rglob(f"*{s}")]
        for f in sorted(found):
            if "__pycache__" in f.parts or \
                    any(part.startswith(".") for part in f.parts[1:]):
                continue
            files.append(f)
    return files


def lint_paths(roots, cfg: LintConfig | None = None,
               rule_ids=None) -> tuple[list[Finding], list[str]]:
    """Lint every file under *roots* that a selected rule takes (``.py``,
    and ``.cu`` for the shared-memory rule); returns (findings, the
    paths seen).  Paths are relative to the current directory when
    possible so they match the repo-root-relative allowlist entries."""
    cfg = cfg if cfg is not None else default_config()
    suffixes = sorted({s for r in _rule_instances(rule_ids)
                       for s in r.suffixes})
    cwd = Path.cwd()
    findings: list[Finding] = []
    seen: list[str] = []
    for f in iter_files(roots, suffixes):
        try:
            rel = str(f.resolve().relative_to(cwd))
        except ValueError:
            rel = str(f)
        seen.append(rel.replace(os.sep, "/"))
        findings.extend(lint_source(f.read_text(), rel, cfg, rule_ids))
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.rule))
    return findings, seen
