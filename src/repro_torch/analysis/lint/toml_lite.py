"""Minimal TOML-subset parser for ``allow.toml`` (port of
``repro/analysis/lint/toml_lite.py``, the same subset and errors).

CI pins Python 3.10, which has no ``tomllib``, and the linter must not
grow a third-party dependency — so the allowlist file sticks to the
subset this parser understands and nothing more:

* ``[section]`` and dotted ``[section.sub]`` tables,
* ``[[array_of_tables]]`` entries,
* ``key = value`` pairs where value is a double-quoted string (no escape
  sequences beyond ``\\"`` and ``\\\\``), an integer, a float, or a
  boolean,
* ``#`` comments and blank lines.

Anything outside the subset raises ``TomlLiteError`` with a line number,
so a typo in the allowlist fails the lint run loudly instead of silently
allowing nothing.
"""

from __future__ import annotations

import re

_SECTION_RE = re.compile(r"^\[(\[)?\s*([A-Za-z0-9_.\-]+)\s*\]?\]\s*$")
_KV_RE = re.compile(r"^([A-Za-z0-9_\-]+)\s*=\s*(.+?)\s*$")


class TomlLiteError(ValueError):
    pass


def _parse_value(raw: str, lineno: int):
    if raw.startswith('"'):
        if not raw.endswith('"') or len(raw) < 2:
            raise TomlLiteError(f"line {lineno}: unterminated string {raw!r}")
        body = raw[1:-1]
        return body.replace('\\"', '"').replace("\\\\", "\\")
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise TomlLiteError(
            f"line {lineno}: unsupported value {raw!r} (toml_lite accepts "
            f"strings, ints, floats, booleans)") from None


def _strip_comment(line: str) -> str:
    """Drop a trailing comment, respecting double-quoted strings."""
    out, in_str = [], False
    i = 0
    while i < len(line):
        ch = line[i]
        if ch == '"' and (i == 0 or line[i - 1] != "\\"):
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
        i += 1
    return "".join(out).strip()


def loads(text: str) -> dict:
    """Parse the TOML subset into nested dicts; ``[[name]]`` becomes a
    list of dicts under ``name``."""
    root: dict = {}
    current: dict = root
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line:
            continue
        m = _SECTION_RE.match(line)
        if m:
            is_array = bool(m.group(1)) and line.startswith("[[")
            parts = m.group(2).split(".")
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise TomlLiteError(
                        f"line {lineno}: {part!r} is not a table")
            leaf = parts[-1]
            if is_array:
                arr = node.setdefault(leaf, [])
                if not isinstance(arr, list):
                    raise TomlLiteError(
                        f"line {lineno}: {leaf!r} is not an array of tables")
                current = {}
                arr.append(current)
            else:
                current = node.setdefault(leaf, {})
                if not isinstance(current, dict):
                    raise TomlLiteError(
                        f"line {lineno}: {leaf!r} redefined as a table")
            continue
        m = _KV_RE.match(line)
        if m:
            current[m.group(1)] = _parse_value(m.group(2), lineno)
            continue
        raise TomlLiteError(f"line {lineno}: cannot parse {raw!r}")
    return root
