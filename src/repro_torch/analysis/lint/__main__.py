"""CLI: ``python -m repro_torch.analysis.lint [paths...] --format
{text,json}`` (port of ``repro/analysis/lint/__main__.py``).

Exit status 1 when any error-severity finding survives pragma/allowlist
suppression, 2 for a path that does not exist; info findings (the
shared-memory estimates) never fail the run.  JSON output is the
reference's stable schema (``version`` bumps on breaking change)::

    {"version": 1, "files": N, "rules": [...],
     "errors": E, "infos": I, "findings": [{rule, path, line, col,
                                            severity, message, hint}]}

The text report's last line counts the files seen and names the CUDA
sources among them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint.core import LintConfig, lint_paths

JSON_VERSION = 1
DEFAULT_ROOT = "src/repro_torch"


def main(argv=None) -> int:
    from repro_torch.analysis.lint.rules import ALL_RULES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="easeylint: AST invariant checker of the port "
                    "(determinism, CUDA-graph purity, telemetry guards, "
                    "keyed RNG, refcount pairing, CUDA shared-memory "
                    "budgets)")
    ap.add_argument("paths", nargs="*", default=[DEFAULT_ROOT],
                    help=f"files or directories to lint (default: "
                         f"{DEFAULT_ROOT})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--allowlist", default=None,
                    help="allow.toml path (default: the bundled one)")
    ap.add_argument("--rules", default=None,
                    help=f"comma-separated subset of {sorted(ALL_RULES)}")
    args = ap.parse_args(argv)

    cfg = LintConfig.from_file(args.allowlist) if args.allowlist else None
    rule_ids = [r.strip() for r in args.rules.split(",")] \
        if args.rules else None
    roots = args.paths or [DEFAULT_ROOT]
    missing = [p for p in roots if not Path(p).exists()]
    if missing:
        print(f"easeylint: no such path(s): {missing}", file=sys.stderr)
        return 2
    findings, seen = lint_paths(roots, cfg=cfg, rule_ids=rule_ids)
    errors = [f for f in findings if f.severity == "error"]
    infos = [f for f in findings if f.severity == "info"]

    if args.format == "json":
        out = {"version": JSON_VERSION, "files": len(seen),
               "rules": sorted(rule_ids or ALL_RULES),
               "errors": len(errors), "infos": len(infos),
               "findings": [f.to_dict() for f in findings]}
        print(json.dumps(out, indent=2, sort_keys=False))
    else:
        for f in findings:
            print(f.render())
        cu = [p for p in seen if p.endswith(".cu")]
        named = f" ({len(cu)} .cu: {', '.join(cu)})" if cu else ""
        tail = (f"easeylint: {len(seen)} files{named}, {len(errors)} "
                f"error(s), {len(infos)} advisory note(s)")
        print(tail if not errors else f"{tail} — FAIL")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
