"""Rule ``smem-budget``: each CUDA kernel's shared memory fits a block.

(The port's counterpart of ``repro/analysis/lint/rules/vmem_budget.py``,
which sums Pallas ``BlockSpec`` bytes against a TPU core's VMEM.)

For every ``__global__`` kernel of a ``.cu`` source the rule statically
sums the shared memory one block asks for:

* the **static** bytes of the ``__shared__`` variables declared in its
  body, laid out as the compiler lays them out for sm_90a: in order,
  each at its type's alignment, an array of 16 B or more at 16 B, the
  whole rounded up to the alignment (16 B or more) of the ``extern
  __shared__`` buffer where there is one, which starts right after it;
* the **dynamic** bytes its launches ask for: the third argument of a
  ``kernel<<<grid, block, smem, stream>>>`` launch (none: 0), or the
  ``cfg.dynamicSmemBytes`` assigned before ``cudaLaunchKernelEx(&cfg,
  kernel, ...)``; a launch through a local alias (``auto kern =
  kernel<...>;``) counts for the kernel.  The largest launch counts.

Sizes resolve through a small evaluator over the file: integer literals,
``constexpr`` and ``const`` integers (by C++ scope: a namespace's, a
struct's ``static constexpr`` members, a function's locals declared
before the use), one-expression ``constexpr`` (template) functions,
``sizeof`` of scalar types, casts, ``?:``, ``+ - * / % << >>``,
comparisons and ``min``/``max``.  Template parameters, and a runtime
field ``obj.name``, take the value of the bound of that name in
``[smem.bounds]`` of ``allow.toml`` — declared contracts, as
``[vmem.bounds]`` is in the reference: a launcher that admits more must
widen its bound here, consciously.  A size that resolves through none of
them is an error, as the reference's "dynamically-shaped block" is: an
unbounded size is how a kernel silently outgrows a block's shared
memory.

The budget is ``TargetSpec.smem_bytes`` of the ``[smem] target`` (the
H100's 232,448 B a block may opt in to).  Every kernel gets an ``info``
finding with its bytes at the bounds; crossing the budget is an
``error``.  Over-budget launches fail only when they run on the card,
with ``cudaErrorInvalidValue`` from the launch — this catches them at
review time.  ``reckon(text, bounds)`` gives the same figures for other
bounds (``chip_smoke.py`` holds them against each compiled
instantiation on the card).
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.analysis.lint.core import Finding, Source

# sizeof / alignment of the scalar and vector types shared arrays hold
TYPE_BYTES = {
    "char": 1, "bool": 1, "int8_t": 1, "uint8_t": 1, "signed": 4,
    "short": 2, "int16_t": 2, "uint16_t": 2, "half": 2, "__half": 2,
    "__nv_bfloat16": 2, "int": 4, "unsigned": 4, "int32_t": 4,
    "uint32_t": 4, "float": 4, "long": 8, "int64_t": 8, "uint64_t": 8,
    "size_t": 8, "double": 8, "__half2": 4, "__nv_bfloat162": 4,
    "float2": 8, "int2": 8, "uint2": 8, "float4": 16, "int4": 16,
    "uint4": 16, "double2": 16,
}
VECTOR_ALIGN = {"float2": 8, "int2": 8, "uint2": 8, "float4": 16,
                "int4": 16, "uint4": 16, "double2": 16}
_QUALIFIERS = {"const", "volatile", "static",
               "constexpr", "inline", "__device__", "__host__",
               "__forceinline__", "__restrict__", "struct"}
_CONTROL = {"if", "for", "while", "switch", "do", "else", "try", "catch",
            "return"}

HINT = ("shrink the tile, add the free dimension to [smem.bounds] in "
        "allow.toml, or raise the target budget knowingly — a launch "
        "asking for more than a block may use fails only on the card")


class _Unresolved(Exception):
    def __init__(self, why: str):
        super().__init__(why)
        self.why = why


# ---------------------------------------------------------------------------
# source scanning

def _clean(text: str) -> str:
    """``text`` with comments, string and character literals and
    preprocessor lines blanked to spaces (newlines and offsets kept)."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        two = text[i:i + 2]
        if two == "//":
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif two == "/*":
            end = text.find("*/", i + 2)
            end = n if end < 0 else end + 2
            for j in range(i, end):
                if text[j] != "\n":
                    out[j] = " "
            i = end
        elif text[i] in "\"'":
            quote, j = text[i], i + 1
            while j < n and text[j] != quote and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            for k in range(i, min(j + 1, n)):
                if text[k] != "\n":
                    out[k] = " "
            i = j + 1
        else:
            i += 1
    lines = "".join(out).split("\n")
    directive = False
    for k, line in enumerate(lines):
        if directive or line.lstrip().startswith("#"):
            directive = line.rstrip().endswith("\\")
            lines[k] = " " * len(line)
    return "\n".join(lines)


@dataclasses.dataclass(eq=False)
class _Scope:
    kind: str                       # file | namespace | struct | function | block
    name: str
    start: int                      # offset of "{" (0 for the file)
    header: str
    tparams: tuple = ()             # (name, is_type) of a template header
    params: tuple = ()              # function parameter names
    parent: "_Scope | None" = None
    end: int = 1 << 62


@dataclasses.dataclass
class _Stmt:
    start: int
    text: str
    scope: _Scope


_TEMPLATE_RE = re.compile(r"^\s*template\s*<([^<>]*)>\s*")


def _template_params(header: str) -> tuple[tuple, str]:
    m = _TEMPLATE_RE.match(header)
    if not m:
        return (), header.strip()
    params = []
    for part in m.group(1).split(","):
        words = part.split("=")[0].split()
        if words:
            params.append((words[-1], words[0] in ("typename", "class")))
    return tuple(params), header[m.end():].strip()


def _split_top(text: str, sep: str = ",") -> list[str]:
    """``text`` split at ``sep`` outside parentheses, brackets, braces and
    template angle brackets."""
    parts, depth, angle, cur = [], 0, 0, []
    for k, ch in enumerate(text):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "<" and depth == 0 and re.search(r"\w\s*$", text[:k]) \
                and text[k + 1:k + 2] not in "<=" and text[k - 1:k] != "<":
            angle += 1
        elif ch == ">" and angle and text[k - 1:k] != "-":
            angle -= 1
        if ch == sep and depth == 0 and angle == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _last_paren_group(h: str) -> tuple[int, int] | None:
    """(open, close) offsets of the last top-level ``(...)`` of ``h``."""
    close = h.rfind(")")
    if close < 0:
        return None
    depth = 0
    for k in range(close, -1, -1):
        if h[k] == ")":
            depth += 1
        elif h[k] == "(":
            depth -= 1
            if depth == 0:
                return k, close
    return None


def _classify(header: str, start: int, parent: _Scope) -> _Scope:
    tparams, h = _template_params(header)
    m = re.match(r"namespace\b\s*(\w*)", h)
    if m:
        return _Scope("namespace", m.group(1), start, header, parent=parent)
    m = re.match(r"(?:typedef\s+)?(?:struct|class|union)\s+(\w+)[^()=]*$", h)
    if m:
        return _Scope("struct", m.group(1), start, header, tparams,
                      parent=parent)
    first = re.match(r"\w+", h)
    if first and first.group(0) in _CONTROL:
        return _Scope("block", "", start, header, parent=parent)
    group = _last_paren_group(h)
    if group and re.fullmatch(r"[\s\w]*", h[group[1] + 1:]) and \
            "=" not in re.sub(r"[=!<>]=", "", h[:group[0]]):
        m = re.search(r"([A-Za-z_]\w*)\s*$", h[:group[0]])
        if m and m.group(1) not in _CONTROL:
            params = []
            for p in _split_top(h[group[0] + 1:group[1]]):
                words = re.findall(r"[A-Za-z_]\w*", p.split("=")[0])
                if len(words) > 1:
                    params.append(words[-1])
            return _Scope("function", m.group(1), start, header, tparams,
                          tuple(params), parent=parent)
    return _Scope("block", "", start, header, parent=parent)


def _scan(clean: str) -> tuple[list[_Scope], list[_Stmt]]:
    """Scopes (by ``{ }``) and statements (text between top-level ``;``,
    ``{`` and ``}``) of a cleaned source."""
    root = _Scope("file", "", 0, "")
    scopes, stmts = [root], []
    stack, depths = [root], []
    depth, last = 0, 0
    for i, ch in enumerate(clean):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "{":
            scope = _classify(clean[last:i], i, stack[-1])
            scopes.append(scope)
            stack.append(scope)
            depths.append(depth)
            depth, last = 0, i + 1
        elif ch == "}":
            if clean[last:i].strip():
                stmts.append(_Stmt(last, clean[last:i], stack[-1]))
            if len(stack) > 1:
                stack.pop().end = i
                depth = depths.pop()
            last = i + 1
        elif ch == ";" and depth == 0:
            stmts.append(_Stmt(last, clean[last:i], stack[-1]))
            last = i + 1
    return scopes, stmts


# ---------------------------------------------------------------------------
# expressions

_TOKEN_RE = re.compile(
    r"\s*(?:(0[xX][0-9a-fA-F]+|\d+\.\d*(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)"
    r"[uUlLfF]*|([A-Za-z_]\w*)|(<<|>>|<=|>=|==|!=|&&|\|\||::|->|"
    r"[-+*/%<>?:()\[\],.!~&|^]))")


def _tokens(text: str) -> list[str]:
    out, pos = [], 0
    text = text.rstrip()
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m or m.end() == pos:
            raise _Unresolved(f"cannot read `{text.strip()}`")
        out.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    return out


_BINARY = [("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
           ("<", "<=", ">", ">="), ("<<", ">>"), ("+", "-"),
           ("*", "/", "%")]
_CAST_WORDS = set(TYPE_BYTES) | {"const", "unsigned", "signed", "long",
                                 "short", "*", "uint64_t", "cuuint64_t",
                                 "cuuint32_t"}


class _Parser:
    """Recursive-descent parser of one C++ integer expression into
    nested tuples; ``templates`` names the file's templates, so that
    ``Name<`` opens template arguments rather than a comparison."""

    def __init__(self, tokens: list[str], templates: set[str]):
        self.t, self.k, self.templates = tokens, 0, templates

    def peek(self, off: int = 0) -> str | None:
        k = self.k + off
        return self.t[k] if k < len(self.t) else None

    def take(self, want: str | None = None) -> str:
        tok = self.peek()
        if tok is None or (want is not None and tok != want):
            raise _Unresolved(f"expected `{want}` in "
                              f"`{' '.join(self.t)}`")
        self.k += 1
        return tok

    def parse(self):
        node = self.expr()
        if self.peek() is not None:
            raise _Unresolved(f"cannot read `{' '.join(self.t)}`")
        return node

    def expr(self, no_gt: bool = False):
        cond = self.binary(0, no_gt)
        if self.peek() == "?":
            self.take()
            a = self.expr(no_gt)
            self.take(":")
            b = self.expr(no_gt)
            return ("cond", cond, a, b)
        return cond

    def binary(self, level: int, no_gt: bool):
        if level == len(_BINARY):
            return self.unary(no_gt)
        node = self.binary(level + 1, no_gt)
        while self.peek() in _BINARY[level] and \
                not (no_gt and self.peek() in (">", ">=", ">>")):
            op = self.take()
            node = ("bin", op, node, self.binary(level + 1, no_gt))
        return node

    def unary(self, no_gt: bool):
        tok = self.peek()
        if tok in ("-", "+", "!", "~"):
            self.take()
            return ("unary", tok, self.unary(no_gt))
        if tok == "(" and self._cast_len():
            self.k += self._cast_len()
            return self.unary(no_gt)
        return self.postfix(no_gt)

    def _cast_len(self) -> int:
        k = self.k + 1
        while self.peek(k - self.k) in _CAST_WORDS:
            k += 1
        if k > self.k + 1 and self.peek(k - self.k) == ")":
            return k - self.k + 1
        return 0

    def postfix(self, no_gt: bool):
        node = self.primary(no_gt)
        while self.peek() in (".", "->"):
            self.take()
            node = ("member", node, self.take())
        return node

    def primary(self, no_gt: bool):
        tok = self.take()
        if tok == "(":
            node = self.expr()
            self.take(")")
            return node
        if tok[0].isdigit():
            return ("num", float(tok) if re.search(r"[.eE]", tok)
                    and not tok.lower().startswith("0x") else int(tok, 0))
        if not re.match(r"[A-Za-z_]", tok):
            raise _Unresolved(f"cannot read `{' '.join(self.t)}`")
        if tok == "sizeof":
            self.take("(")
            words = []
            while self.peek() != ")":
                words.append(self.take())
            self.take(")")
            return ("sizeof", " ".join(words))
        if tok in ("static_cast", "reinterpret_cast"):
            self.take("<")
            while self.take() != ">":
                pass
            self.take("(")
            node = self.expr()
            self.take(")")
            return node
        path = [(tok, self._targs(tok))]
        while self.peek() == "::":
            self.take()
            name = self.take()
            path.append((name, self._targs(name)))
        if path[0][0] == "std" and len(path) > 1:
            path = path[1:]
        if self.peek() == "(":
            self.take()
            args = []
            while self.peek() != ")":
                args.append(self.expr())
                if self.peek() == ",":
                    self.take()
            self.take(")")
            return ("call", tuple(path), tuple(args))
        return ("name", tuple(path))

    def _targs(self, name: str):
        if name not in self.templates or self.peek() != "<":
            return None
        self.take("<")
        args = []
        while self.peek() != ">":
            args.append(self.expr(no_gt=True))
            if self.peek() == ",":
                self.take()
        self.take(">")
        return tuple(args)


# ---------------------------------------------------------------------------
# evaluation over one file

@dataclasses.dataclass
class _Decl:
    name: str
    expr: str
    scope: _Scope
    start: int


class _File:
    """A cleaned ``.cu`` source: its scopes, statements, constants,
    constexpr functions and templates, and an evaluator over them."""

    def __init__(self, text: str, bounds: dict):
        self.clean = _clean(text)
        self.bounds = dict(bounds)
        self.scopes, self.stmts = _scan(self.clean)
        self.decls: dict[str, list[_Decl]] = {}
        for st in self.stmts:
            self._collect(st)
        # one-expression constexpr functions: scope id -> returned expr
        self.returns: dict[int, str] = {}
        for fn in self.scopes:
            body = [st for st in self.stmts if st.scope is fn]
            if fn.kind == "function" and "constexpr" in fn.header and \
                    len(body) == 1 and \
                    re.match(r"\s*return\b", body[0].text):
                self.returns[id(fn)] = body[0].text.strip()[len("return"):]
        self.templates = {s.name for s in self.scopes
                          if s.tparams and s.name}
        self.used: set[str] = set()
        self._active: set = set()

    def _collect(self, st: _Stmt) -> None:
        _, text = _template_params(st.text.strip())
        m = re.match(r"((?:(?:static|inline|__device__|__host__|"
                     r"__forceinline__)\s+)*)(constexpr|const)\s+", text)
        if not m:
            return
        rest = text[m.end():]
        rest = re.sub(r"^(?:(?:const|constexpr|unsigned|signed|long|short|"
                      r"volatile|static)\s+)*", "", rest)
        m = re.match(r"[A-Za-z_][\w:]*(?:\s*<[^<>]*>)?\s+", rest)
        if not m:
            return
        for decl in _split_top(rest[m.end():]):
            d = re.match(r"\s*[*&\s]*([A-Za-z_]\w*)\s*(?:=(.*)|\{(.*)\}|"
                         r"\((.*)\))\s*$", decl, re.S)
            if d:
                expr = next(g for g in d.groups()[1:] if g is not None)
                self.decls.setdefault(d.group(1), []).append(
                    _Decl(d.group(1), expr, st.scope, st.start))

    # -- lookups -----------------------------------------------------------

    @staticmethod
    def chain(scope: _Scope):
        while scope is not None:
            yield scope
            scope = scope.parent

    def innermost(self, offset: int) -> _Scope:
        best = self.scopes[0]
        for s in self.scopes[1:]:
            if s.start <= offset <= s.end and s.start >= best.start:
                best = s
        return best

    def _find_scope(self, name: str, at: _Scope) -> _Scope:
        """The struct or namespace ``name`` seen from ``at``."""
        for outer in self.chain(at):
            for s in self.scopes:
                if s.parent is outer and s.name == name and \
                        s.kind in ("struct", "namespace"):
                    return s
        raise _Unresolved(f"unknown scope `{name}`")

    def _bound(self, name: str) -> int:
        if name not in self.bounds:
            raise _Unresolved(f"unbounded `{name}` (no [smem.bounds] "
                              f"entry)")
        self.used.add(name)
        return self.bounds[name]

    def _opened(self, s: _Scope) -> set:
        """``s`` and the unnamed namespaces inside it, whose members are
        visible in ``s``."""
        out, todo = {id(s)}, [s]
        while todo:
            outer = todo.pop()
            for c in self.scopes:
                if c.parent is outer and c.kind == "namespace" and \
                        not c.name:
                    out.add(id(c))
                    todo.append(c)
        return out

    def lookup(self, name: str, scope: _Scope, at: int, env: dict):
        for s in self.chain(scope):
            local = s.kind in ("function", "block")
            opened = {id(s)} if local else self._opened(s)
            for d in reversed(self.decls.get(name, [])):
                if id(d.scope) in opened and (not local or d.start < at):
                    return self.evaluate(d.expr, d.scope, d.start, env,
                                         key=(name, id(d.scope)))
            if id(s) in env and name in env[id(s)]:
                return env[id(s)][name]
            if any(p == name for p, _ in s.tparams):
                return self._bound(name)
        raise _Unresolved(f"unresolved name `{name}`")

    # -- evaluation --------------------------------------------------------

    def evaluate(self, text: str, scope: _Scope, at: int, env: dict,
                 key=None) -> int:
        if key is not None:
            if key in self._active:
                raise _Unresolved(f"`{key[0]}` depends on itself")
            self._active.add(key)
        try:
            node = _Parser(_tokens(text), self.templates).parse()
            return self._eval(node, scope, at, env)
        finally:
            self._active.discard(key)

    def _eval(self, node, scope, at, env):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "unary":
            v = self._eval(node[2], scope, at, env)
            return {"-": -v, "+": v, "!": int(not v), "~": ~int(v)}[node[1]]
        if kind == "cond":
            c = self._eval(node[1], scope, at, env)
            return self._eval(node[2] if c else node[3], scope, at, env)
        if kind == "bin":
            a = self._eval(node[2], scope, at, env)
            b = self._eval(node[3], scope, at, env)
            return _binop(node[1], a, b)
        if kind == "sizeof":
            words = [w for w in node[1].split() if w not in _QUALIFIERS]
            if words and all(w in TYPE_BYTES for w in words):
                return TYPE_BYTES[words[-1]]
            raise _Unresolved(f"sizeof({node[1]}) of a type the rule "
                              f"does not size")
        if kind == "member":
            return self._bound(node[2])
        if kind == "name":
            return self._name(node[1], scope, at, env)
        if kind == "call":
            return self._call(node[1], node[2], scope, at, env)
        raise _Unresolved(f"cannot evaluate {node!r}")

    def _name(self, path, scope, at, env):
        if len(path) == 1:
            return self.lookup(path[0][0], scope, at, env)
        where = scope
        for name, targs in path[:-1]:
            where = self._find_scope(name, where)
            if targs is not None:
                env = dict(env)
                env[id(where)] = self._bind(where, targs, scope, at, env)
        name = path[-1][0]
        return self.lookup(name, where, where.end, env)

    def _bind(self, target: _Scope, targs, scope, at, env) -> dict:
        values = [self._eval(a, scope, at, env) for a in targs]
        names = [p for p, _ in target.tparams]
        return dict(zip(names, values))

    def _call(self, path, args, scope, at, env):
        name = path[-1][0]
        vals = [self._eval(a, scope, at, env) for a in args]
        if name in ("min", "max") and len(path) == 1 and vals:
            return min(vals) if name == "min" else max(vals)
        fns = [s for s in self.scopes if s.kind == "function" and
               s.name == name and id(s) in self.returns]
        if not fns:
            raise _Unresolved(f"`{name}(...)` is not a one-expression "
                              f"constexpr function of the file")
        fn = fns[0]
        binding = dict(zip(fn.params, vals))
        if path[-1][1] is not None:
            binding.update(self._bind(fn, path[-1][1], scope, at, env))
        env = dict(env)
        env[id(fn)] = binding
        return self.evaluate(self.returns[id(fn)], fn, fn.end, env,
                             key=(name, id(fn)))


def _binop(op, a, b):
    if op in ("/", "%"):
        if b == 0:
            raise _Unresolved("division by zero")
        if isinstance(a, int) and isinstance(b, int):
            q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
            return q if op == "/" else a - q * b
        return a / b if op == "/" else a % b
    return {"||": lambda: int(bool(a or b)), "&&": lambda: int(bool(a and b)),
            "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
            "==": lambda: int(a == b), "!=": lambda: int(a != b),
            "<": lambda: int(a < b), "<=": lambda: int(a <= b),
            ">": lambda: int(a > b), ">=": lambda: int(a >= b),
            "<<": lambda: a << b, ">>": lambda: a >> b,
            "+": lambda: a + b, "-": lambda: a - b,
            "*": lambda: a * b}[op]()


# ---------------------------------------------------------------------------
# kernels

@dataclasses.dataclass
class KernelSmem:
    """One ``__global__`` kernel's shared memory at the given bounds
    (``None`` where a size did not resolve; ``problems`` says why)."""
    name: str
    line: int
    col: int
    static: int | None
    dynamic: int | None
    bounds_used: dict
    problems: list                  # (line, col, why)

    @property
    def total(self) -> int | None:
        if self.static is None or self.dynamic is None:
            return None
        return self.static + self.dynamic


def _line_col(text: str, offset: int) -> tuple[int, int]:
    return text.count("\n", 0, offset) + 1, \
        offset - (text.rfind("\n", 0, offset) + 1)


_SHARED_RE = re.compile(r"^\s*(?:static\s+)?(extern\s+)?__shared__\b(.*)$",
                        re.S)
_LAUNCH_RE = re.compile(r"([A-Za-z_][\w:]*)\s*(?:<[^<>]*>)?\s*<<<(.*?)>>>",
                        re.S)
_LAUNCH_EX_RE = re.compile(
    r"cudaLaunchKernelEx\s*\(\s*&?\s*(\w+)\s*,\s*([A-Za-z_][\w:]*)")
_ALIAS_RE = re.compile(r"^\s*auto\s+(\w+)\s*=\s*&?\s*([A-Za-z_][\w:]*)"
                       r"\s*(?:<[^<>]*>)?\s*$")


def _static_bytes(f: _File, kernel: _Scope,
                  problems: list) -> tuple[int | None, bool]:
    """(the static shared bytes of ``kernel``'s body, whether it declares
    an ``extern __shared__`` buffer).  Laid out as the compiler does for
    sm_90a (``ptxas -v`` and ``sharedSizeBytes`` on the card): in order,
    each variable at its type's alignment, an array of 16 B or more at
    16 B, and the whole rounded up to the dynamic buffer's alignment (at
    least 16 B) where the kernel has one, since that buffer starts right
    after it."""
    total, ok, extern_align = 0, True, 0
    for st in f.stmts:
        if not (kernel.start < st.start < kernel.end):
            continue
        m = _SHARED_RE.match(st.text)
        if not m:
            continue
        align_m = re.search(r"__align__\s*\(\s*(\d+)\s*\)", m.group(2))
        if m.group(1):
            extern_align = max(extern_align, 16,
                               int(align_m.group(1)) if align_m else 0)
            continue
        decl = re.sub(r"__align__\s*\(\s*(\d+)\s*\)", r" ", m.group(2))
        words = re.match(r"\s*((?:[A-Za-z_][\w:]*\s+)+?)([*&\s]*[A-Za-z_]\w*"
                         r"\s*(?:\[.*)?)$", decl, re.S)
        if not words:
            continue
        type_words = [w for w in words.group(1).split()
                      if w not in _QUALIFIERS]
        tname = type_words[-1] if type_words else ""
        for declarator in _split_top(words.group(2)):
            dims = re.findall(r"\[([^\]]*)\]", declarator)
            line, col = _line_col(f.clean, st.start + len(st.text) -
                                  len(st.text.lstrip()))
            if tname not in TYPE_BYTES:
                problems.append((line, col, f"__shared__ of type `{tname}`"
                                 f", which the rule does not size"))
                ok = False
                continue
            size = TYPE_BYTES[tname]
            align = int(align_m.group(1)) if align_m else \
                VECTOR_ALIGN.get(tname, size)
            try:
                for dim in dims:
                    size *= f.evaluate(dim, kernel, st.start, {})
            except _Unresolved as e:
                problems.append((line, col, f"__shared__ size "
                                 f"`{' '.join(dims)}` is not statically "
                                 f"evaluable — {e.why}"))
                ok = False
                continue
            if dims and size >= 16:
                align = max(align, 16)
            total = -(-total // align) * align + size
    if extern_align and total:
        total = -(-total // extern_align) * extern_align
    return (total if ok else None), bool(extern_align)


def _launches(f: _File) -> dict[str, list]:
    """kernel name -> [(offset, smem expression)] of its launches (the
    expression None where a ``cudaLaunchKernelEx`` config sets none)."""
    out: dict[str, list] = {}
    for st in f.stmts:
        if "<<<" not in st.text and "cudaLaunchKernelEx" not in st.text:
            continue
        fn = next((s for s in f.chain(st.scope) if s.kind == "function"),
                  None)
        if fn is None:
            continue
        aliases = {}
        for other in f.stmts:
            if fn.start < other.start < st.start:
                m = _ALIAS_RE.match(other.text)
                if m:
                    aliases[m.group(1)] = m.group(2)
        for m in _LAUNCH_RE.finditer(st.text):
            args = _split_top(m.group(2))
            smem = args[2].strip() if len(args) > 2 else "0"
            name = aliases.get(m.group(1), m.group(1)).split("::")[-1]
            out.setdefault(name, []).append(
                (st.start + m.start(), smem))
        for m in _LAUNCH_EX_RE.finditer(st.text):
            cfg_var = m.group(1)
            name = aliases.get(m.group(2), m.group(2)).split("::")[-1]
            smem = None
            for other in f.stmts:
                if fn.start < other.start < st.start:
                    a = re.match(rf"^\s*{re.escape(cfg_var)}\s*\.\s*"
                                 rf"dynamicSmemBytes\s*=(.*)$", other.text,
                                 re.S)
                    if a:
                        smem = a.group(1)
            out.setdefault(name, []).append(
                (st.start + m.start(), smem))
    return out


def reckon(text: str, bounds: dict) -> list[KernelSmem]:
    """Every ``__global__`` kernel of the CUDA source ``text`` with its
    static and dynamic shared bytes, template parameters and runtime
    fields taking ``bounds``."""
    f = _File(text, bounds)
    launches = _launches(f)
    out = []
    for k in f.scopes:
        if k.kind != "function" or \
                not re.search(r"\b__global__\b", k.header):
            continue
        f.used = set()
        problems: list = []
        line, col = _line_col(f.clean, k.start - len(k.header) +
                              k.header.find("__global__"))
        static, has_dynamic = _static_bytes(f, k, problems)
        dynamic = 0
        sites = launches.get(k.name, [])
        if has_dynamic and not sites:
            problems.append((line, col, "declares extern __shared__ but no "
                             "launch of it was found in the file"))
            dynamic = None
        for offset, smem in sites:
            ln, cl = _line_col(f.clean, offset)
            if smem is None:
                problems.append((ln, cl, "cudaLaunchKernelEx with no "
                                 "dynamicSmemBytes assigned"))
                dynamic = None
                continue
            try:
                nbytes = f.evaluate(smem, f.innermost(offset), offset, {})
            except _Unresolved as e:
                problems.append((ln, cl, f"dynamic shared size `"
                                 f"{' '.join(smem.split())}` is not "
                                 f"statically evaluable — {e.why}"))
                dynamic = None
                continue
            if dynamic is not None:
                dynamic = max(dynamic, int(nbytes))
        out.append(KernelSmem(k.name, line, col, static, dynamic,
                              {n: f.bounds[n] for n in sorted(f.used)},
                              problems))
    return out


def _budget(target_name: str) -> tuple[int, str]:
    from repro_torch.core.target import get_target
    return get_target(target_name).smem_bytes, target_name


class SmemBudgetRule:
    id = "smem-budget"
    suffixes = (".cu",)

    def check(self, src: Source, cfg) -> list[Finding]:
        if "__global__" not in src.text:
            return []
        try:
            budget, target = _budget(cfg.smem_target)
        except KeyError as e:
            return [Finding(self.id, src.rel, 1, 0,
                            f"cannot resolve the shared-memory budget: {e}",
                            hint=HINT)]
        findings: list[Finding] = []
        for k in reckon(src.text, cfg.smem_bounds):
            inst = ", ".join(f"{n}={v}" for n, v in k.bounds_used.items())
            label = f"`{k.name}`" + (f" ({inst})" if inst else "")
            for line, col, why in k.problems:
                findings.append(Finding(self.id, src.rel, line, col,
                                        f"{label}: {why}", hint=HINT))
            static = k.static or 0
            dynamic = k.dynamic or 0
            total = static + dynamic
            findings.append(Finding(
                self.id, src.rel, k.line, k.col,
                f"{label}: shared memory {total:,} B a block "
                f"({static:,} B static + {dynamic:,} B dynamic) of the "
                f"{budget:,} B a block may use on {target} "
                f"({100 * total / budget:.1f}%)"
                + ("" if k.total is not None
                   else " — LOWER BOUND, unresolved sizes above"),
                severity="info"))
            if total > budget:
                findings.append(Finding(
                    self.id, src.rel, k.line, k.col,
                    f"{label}: shared memory {total:,} B a block exceeds "
                    f"the {budget:,} B a block may use on {target} by "
                    f"{total - budget:,} B", hint=HINT))
        return findings
