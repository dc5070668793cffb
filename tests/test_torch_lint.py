"""The port's lint (``repro_torch.analysis.lint``) against the reference's
(``repro.analysis.lint``), on the CPU.

The three rules ported rule for rule (``wall-clock``,
``telemetry-guard``, ``refcount-pairing``) and the pragma and allowlist
logic must give the reference's findings — rule, path, line, col,
severity, message and hint — on the same sources: every ``.py`` of both
packages and of ``benchmarks/``, and the seeded snippets of
``tests/test_lint.py``.  ``toml_lite`` must parse both allowlists alike.
The rest are the twins of the reference's seeded-violation tests, a
failing and a passing case of each of the port's own rules
(``keyed-rng`` on torch draws, ``graph-purity`` on CUDA-graph captures,
``smem-budget`` on the ``.cu`` kernels), the port linting clean, and the
CLI.
"""

import ast
import json
from pathlib import Path

import pytest

from repro.analysis.lint import LintConfig as RefConfig
from repro.analysis.lint import lint_source as ref_lint_source
from repro.analysis.lint import toml_lite as ref_toml
from repro_torch.analysis.lint import (LintConfig, default_config, lint_paths,
                                       lint_source, toml_lite)
from repro_torch.analysis.lint.__main__ import JSON_VERSION, main as lint_main
from repro_torch.analysis.lint.rules import ALL_RULES, smem_budget
from repro_torch.core.target import get_target

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CSRC = PORT / "kernels" / "csrc"
PARITY_RULES = ["wall-clock", "telemetry-guard", "refcount-pairing"]
ALLOWLISTS = {
    "none": "",
    "reference": (REPO / "src/repro/analysis/lint/allow.toml").read_text(),
    "port": (PORT / "analysis/lint/allow.toml").read_text(),
    "adv-dir": '[[allow]]\nrule = "wall-clock"\npath = "src/repro/adv/"\n'
               'reason = "wall-clock FOM file"\n',
}


def _errors(text, rel, cfg=None, rules=None):
    return [f for f in lint_source(text, rel, cfg, rules)
            if f.severity == "error"]


def _rules_fired(text, rel, cfg=None, rules=None):
    return {f.rule for f in _errors(text, rel, cfg, rules)}


def _rel(p: Path) -> str:
    return str(p.relative_to(REPO))


def _snippets() -> list[tuple[str, str]]:
    """(rel, text) of every Python snippet seeded in tests/test_lint.py,
    each under a plain, a serving and a training path, plus the
    reference's scheduler with its seeded unguarded tracer call."""
    tree = ast.parse((REPO / "tests/test_lint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value:
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            for rel in ("src/repro/x.py", "src/repro/serving/x.py",
                        "src/repro/adv/b.py"):
                out.append((rel, node.value))
    drift = "\n\ndef _drift(self):\n    self.tracer.begin('unguarded', 0)\n"
    for pkg in ("repro", "repro_torch"):
        rel = f"src/{pkg}/serving/scheduler.py"
        out.append((rel, (REPO / rel).read_text() + drift))
    return out


SOURCES = {
    "src/repro": [(_rel(p), p.read_text())
                  for p in sorted((REPO / "src/repro").rglob("*.py"))],
    "src/repro_torch": [(_rel(p), p.read_text())
                        for p in sorted(PORT.rglob("*.py"))],
    "benchmarks": [(_rel(p), p.read_text())
                   for p in sorted((REPO / "benchmarks").rglob("*.py"))],
    "test_lint snippets": _snippets(),
}


# ---------------------------------------------------------------------------
# parity with the reference

@pytest.mark.parametrize("group", sorted(SOURCES))
def test_ported_rules_give_the_reference_findings(group):
    assert len(SOURCES[group]) > 3
    fired = 0
    for name, text in ALLOWLISTS.items():
        cfg, ref_cfg = LintConfig.from_text(text), RefConfig.from_text(text)
        for rel, src in SOURCES[group]:
            got = [f.to_dict() for f in
                   lint_source(src, rel, cfg, PARITY_RULES)]
            want = [f.to_dict() for f in
                    ref_lint_source(src, rel, ref_cfg, PARITY_RULES)]
            assert got == want, (name, rel)
            fired += len(got)
    if group == "test_lint snippets":
        assert fired > 20          # the snippets do fire


@pytest.mark.parametrize("path", ["src/repro/analysis/lint/allow.toml",
                                  "src/repro_torch/analysis/lint/allow.toml"])
def test_toml_lite_parses_both_allowlists_alike(path):
    text = (REPO / path).read_text()
    assert toml_lite.loads(text) == ref_toml.loads(text)


@pytest.mark.parametrize("junk", [
    "[ok]\nwhat even is this\n", "k = [1, 2]\n", 'a = "open\n',
    "[x]\na = 1\n[x.a]\n", "[[t]]\nb = 2\n[t]\n", "k = 1.2.3\n"])
def test_toml_lite_rejects_junk_with_the_reference_lines(junk):
    with pytest.raises(ref_toml.TomlLiteError) as want:
        ref_toml.loads(junk)
    with pytest.raises(toml_lite.TomlLiteError) as got:
        toml_lite.loads(junk)
    assert str(got.value) == str(want.value)


def test_toml_lite_subset():
    data = toml_lite.loads(
        '# comment\n[[allow]]\nrule = "wall-clock"  # trailing\n'
        'path = "a # not-a-comment.py"\nreason = "because"\n'
        '[smem]\ntarget = "nvidia:h100"\n[smem.bounds]\nDP = 256\n')
    assert data["allow"] == [{"rule": "wall-clock",
                              "path": "a # not-a-comment.py",
                              "reason": "because"}]
    assert data["smem"] == {"target": "nvidia:h100", "bounds": {"DP": 256}}


# ---------------------------------------------------------------------------
# twins of the reference's seeded-violation tests

def test_wall_clock_fires_on_call_and_reference():
    bad = ("import time\ndef f():\n    return time.time()\n"
           "def g(clock=time.perf_counter):\n    return clock()\n")
    errs = _errors(bad, "src/repro_torch/x.py", rules=["wall-clock"])
    assert {e.line for e in errs} == {3, 4}


def test_wall_clock_passing_twins():
    good = ("import time\ndef f(clock):\n    return clock()\n"
            "def _timed(fn):\n    t0 = time.perf_counter()\n"
            "    return fn(), time.perf_counter() - t0\n"
            "a = time.time()  # easeylint: allow[wall-clock] — advisory\n"
            "# easeylint: allow[wall-clock]\nb = time.time()\n")
    assert _errors(good, "src/repro_torch/x.py", rules=["wall-clock"]) == []


def test_allowlist_suppresses_by_path_and_requires_reason():
    cfg = LintConfig.from_text(ALLOWLISTS["adv-dir"])
    bad = "import time\nt = time.time()\n"
    assert _errors(bad, "src/repro/adv/b.py", cfg, ["wall-clock"]) == []
    assert len(_errors(bad, "src/repro/core/b.py", cfg, ["wall-clock"])) == 1
    with pytest.raises(ValueError, match="reason"):
        LintConfig.from_text('[[allow]]\nrule = "wall-clock"\npath = "x"\n')


def test_telemetry_guard_fires_unguarded_and_passes_guarded():
    bad = "def step(self):\n    self.tracer.begin('decode', 0)\n"
    errs = _errors(bad, "src/repro_torch/serving/x.py",
                   rules=["telemetry-guard"])
    assert len(errs) == 1 and errs[0].line == 2
    good = ("def step(self, tracer):\n    if self.tracer is not None:\n"
            "        self.tracer.begin('a', 0)\n    if tracer is None:\n"
            "        return\n    tracer.emit('b')\n")
    assert _errors(good, "src/repro_torch/serving/x.py",
                   rules=["telemetry-guard"]) == []


def test_refcount_fires_on_leak_and_passes_release():
    bad = ("def admit(pool, slot, pages, ok):\n"
           "    pool.attach(slot, pages)\n    if ok:\n"
           "        pool.free(slot)\n    return ok\n")
    assert len(_errors(bad, "src/repro_torch/serving/x.py",
                       rules=["refcount-pairing"])) == 1
    good = ("def paired(pool, slot, pages):\n    pool.attach(slot, pages)\n"
            "    pool.free(slot)\ndef handoff(pool, slot, pages):\n"
            "    pool.adopt_run(slot, pages)\n    return slot\n")
    assert _errors(good, "src/repro_torch/serving/x.py",
                   rules=["refcount-pairing"]) == []


def test_seeded_violation_fails_the_port_lint():
    rel = "src/repro_torch/serving/scheduler.py"
    text = (REPO / rel).read_text()
    assert _errors(text, rel, default_config()) == []
    seeded = text + "\n\ndef _drift(self):\n    self.tracer.begin('x', 0)\n"
    assert "telemetry-guard" in _rules_fired(seeded, rel, default_config())


# ---------------------------------------------------------------------------
# keyed-rng: torch draws under serving/

KEYED_BAD = """\
import torch
from repro_torch.serving.sampling import fold_in, gumbel
def sample(base, logits, seed):
    a = torch.rand(4)
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(4, generator=g)
    c = torch.multinomial(logits, 1, generator=object())
    k = fold_in(base, 3)
    d = gumbel(k, 8)
    e = gumbel(k, 8)
    logits.uniform_()
    torch.manual_seed(0)
    return a, b, c, d, e
"""


def test_keyed_rng_fires_on_unkeyed_torch_draws():
    errs = _errors(KEYED_BAD, "src/repro_torch/serving/x.py",
                   rules=["keyed-rng"])
    msgs = {e.line: e.message for e in errs}
    assert "global generator" in msgs[4] and "global generator" in msgs[11]
    assert "base generator `g`" in msgs[6]
    assert "not fold_in-derived" in msgs[7]
    assert "reused" in msgs[10] and 9 not in msgs
    assert "literal manual_seed(0)" in msgs[12]
    assert _errors(KEYED_BAD, "src/repro_torch/training/x.py",
                   rules=["keyed-rng"]) == []


def test_keyed_rng_passes_fold_in_keys_and_weight_generators():
    good = """\
import torch
from repro_torch.serving import sampling
def sample(base, rid, step, logits, gen):
    key = sampling.fold_in(sampling.fold_in(base, rid), step)
    g = torch.Generator().manual_seed(int(sampling.fold_in(base, rid)[0]))
    return (sampling.gumbel(key, 8), torch.rand(4, generator=gen),
            torch.rand(4, generator=g))
def weights(table, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(table, gen, device)
"""
    assert _errors(good, "src/repro_torch/serving/x.py",
                   rules=["keyed-rng"]) == []


# ---------------------------------------------------------------------------
# graph-purity: CUDA-graph captures

def test_graph_purity_fires_inside_a_capture():
    bad = """\
import torch
log = []
def helper(x):
    log.append(x)
    return x
def capture(g, x, tracer):
    with torch.cuda.graph(g):
        y = helper(x) * 2
        n = y.sum().item()
        print(n)
        tracer.emit('inside')
        torch.cuda.synchronize()
    return y
"""
    errs = _errors(bad, "src/repro_torch/serving/x.py",
                   rules=["graph-purity"])
    assert {e.line for e in errs} == {4, 9, 10, 11, 12}
    assert "captured function `helper`" in {e.line: e.message
                                            for e in errs}[4]


def test_graph_purity_graphed_callables_and_a_pure_capture():
    bad = """\
import torch
seen = {}
def fwd(x):
    seen['x'] = x.cpu()
    return x
graphed = torch.cuda.make_graphed_callables(fwd, (torch.zeros(2),))
"""
    errs = _errors(bad, "src/repro_torch/x.py", rules=["graph-purity"])
    assert {e.line for e in errs} == {4}
    assert len(errs) == 2        # the store and the host sync
    good = """\
import torch
def replay_ms(fn, n):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            out = fn()
            acc = out * 2
    return g
"""
    assert _errors(good, "src/repro_torch/x.py", rules=["graph-purity"]) == []


def test_graph_purity_chip_smoke_is_clean():
    rel = "chip_smoke.py"
    text = (REPO / rel).read_text()
    assert "torch.cuda.graph(" in text
    assert _errors(text, rel, rules=["graph-purity"]) == []


# ---------------------------------------------------------------------------
# smem-budget: the .cu kernels

KERNEL_BYTES = {
    ("flash_attention.cu", "flash_fwd_kernel"): (0, 214_016),
    ("flash_attention.cu", "flash_fwd_tc"): (0, 197_672),
    ("paged_attention.cu", "paged_scores_kernel"): (384, 0),
    ("paged_attention.cu", "paged_pv_kernel"): (400, 32_768),
    ("rmsnorm.cu", "norm_kernel"): (68, 0),
    ("sedov_stencil.cu", "sedov_step_kernel"): (0, 105_600),
}


@pytest.mark.parametrize("source,kernel", sorted(KERNEL_BYTES))
def test_smem_estimates_of_the_four_kernels(source, kernel):
    static, dynamic = KERNEL_BYTES[source, kernel]
    rel = f"src/repro_torch/kernels/csrc/{source}"
    out = lint_source((REPO / rel).read_text(), rel, default_config(),
                      ["smem-budget"])
    assert [f for f in out if f.severity == "error"] == []
    info = [f.message for f in out if f"`{kernel}`" in f.message]
    assert len(info) == 1
    assert (f"{static + dynamic:,} B a block ({static:,} B static + "
            f"{dynamic:,} B dynamic) of the 232,448 B") in info[0]


# (kernel, bounds) -> (static, dynamic) as the card reported them: the
# compiled kernels' sharedSizeBytes and their launchers' dynamic bytes
# (chip_smoke.py phase 23 on an NVIDIA H100 80GB HBM3)
CARD_BYTES = {
    ("paged_attention.cu", "paged_pv_kernel", 1, 128): (288, 2048),
    ("paged_attention.cu", "paged_pv_kernel", 4, 256): (336, 16_384),
    ("paged_attention.cu", "paged_scores_kernel", 3, 128): (304, 0),
    ("paged_attention.cu", "paged_scores_kernel", 5, 256): (336, 0),
    ("flash_attention.cu", "flash_fwd_tc", 16, 0): (0, 21_544),
    ("flash_attention.cu", "flash_fwd_tc", 192, 0): (0, 148_520),
    ("flash_attention.cu", "flash_fwd_kernel", 32, 0): (0, 41_984),
}


@pytest.mark.parametrize("source,kernel,a,b", sorted(CARD_BYTES))
def test_smem_reckoning_equals_the_card_at_other_bounds(source, kernel, a,
                                                        b):
    bounds = {"G": a, "dh": b} if "paged" in source else {"DP": a}
    got = {k.name: (k.static, k.dynamic) for k in smem_budget.reckon(
        (CSRC / source).read_text(), bounds)}
    assert got[kernel] == CARD_BYTES[source, kernel, a, b]


def _seeded_cu(dyn: str) -> str:
    return ("#include <cuda_runtime.h>\n"
            "namespace {\n"
            "constexpr int kBytes = 232449 - 16;\n"
            "__global__ void big(float* o) {\n"
            "  __shared__ float tile[4];\n"
            "  extern __shared__ unsigned char buf[];\n"
            "  o[0] = tile[0] + buf[0];\n"
            "}\n"
            "}  // namespace\n"
            "extern \"C\" int big_launch(float* o, int n, void* s) {\n"
            f"  big<<<1, 32, {dyn}, (cudaStream_t)s>>>(o);\n"
            "  return (int)cudaGetLastError();\n"
            "}\n")


def test_smem_seeded_oversized_kernel_fails():
    cfg = default_config()
    errs = _errors(_seeded_cu("kBytes"), "src/repro_torch/x.cu", cfg,
                   ["smem-budget"])
    assert len(errs) == 1 and "232,449 B a block exceeds the 232,448 B" \
        in errs[0].message and errs[0].line == 4
    assert _errors(_seeded_cu("kBytes - 1"), "src/repro_torch/x.cu", cfg,
                   ["smem-budget"]) == []
    # a justified pragma on the line above the kernel suppresses it
    text = _seeded_cu("kBytes").replace(
        "__global__", "// easeylint: allow[smem-budget] — sized by hand\n"
        "__global__")
    assert _errors(text, "src/repro_torch/x.cu", cfg, ["smem-budget"]) == []


def test_smem_unresolvable_size_is_an_error():
    errs = _errors(_seeded_cu("n * 4"), "src/repro_torch/x.cu",
                   default_config(), ["smem-budget"])
    assert len(errs) == 1 and "not statically evaluable" in errs[0].message
    assert "unresolved name `n`" in errs[0].message and errs[0].line == 11
    out = lint_source(_seeded_cu("n * 4"), "src/repro_torch/x.cu",
                      default_config(), ["smem-budget"])
    assert "LOWER BOUND" in [f for f in out if f.severity == "info"][0].message


def test_smem_budget_is_the_targets():
    cfg = default_config()
    assert cfg.smem_target == "nvidia:h100"
    assert smem_budget._budget(cfg.smem_target)[0] == \
        get_target("nvidia:h100").smem_bytes == 232_448
    assert cfg.smem_bounds == {"DP": 256, "G": 8, "dh": 256}
    bad = LintConfig(smem_target="nvidia:a100", smem_bounds={})
    errs = _errors(_seeded_cu("0"), "src/repro_torch/x.cu", bad,
                   ["smem-budget"])
    assert errs and "cannot resolve the shared-memory budget" \
        in errs[0].message


# ---------------------------------------------------------------------------
# the port lints clean; the CLI

def test_port_lints_clean_and_sees_the_kernels(monkeypatch):
    monkeypatch.chdir(REPO)
    findings, seen = lint_paths(["src/repro_torch"])
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(f.render() for f in errors)
    assert sorted(p for p in seen if p.endswith(".cu")) == [
        f"src/repro_torch/kernels/csrc/{s}" for s in sorted(
            {s for s, _ in KERNEL_BYTES})]
    infos = [f for f in findings if f.severity == "info"]
    assert len(infos) == len(KERNEL_BYTES)
    assert len(seen) > 90


def test_cli_json_schema_and_exit_codes(tmp_path, capsys, monkeypatch):
    (tmp_path / "bad.py").write_text("import time\nt = time.time()\n")
    (tmp_path / "ok.py").write_text("x = 1\n")
    rc = lint_main([str(tmp_path / "bad.py"), "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["version"] == JSON_VERSION == 1
    assert set(out) == {"version", "files", "rules", "errors", "infos",
                        "findings"}
    assert out["files"] == 1 and out["errors"] == 1
    assert out["rules"] == sorted(ALL_RULES)
    assert set(out["findings"][0]) == {"rule", "path", "line", "col",
                                       "severity", "message", "hint"}
    assert lint_main([str(tmp_path / "ok.py")]) == 0
    assert lint_main([str(tmp_path / "missing_dir")]) == 2
    capsys.readouterr()
    monkeypatch.chdir(REPO)
    assert lint_main(["src/repro_torch/kernels/csrc"]) == 0
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    assert "4 files (4 .cu: src/repro_torch/kernels/csrc/flash_attention.cu" \
        in tail and "0 error(s), 6 advisory note(s)" in tail
    with pytest.raises(ValueError, match="unknown rule"):
        lint_main([str(tmp_path / "ok.py"), "--rules", "nope"])


def test_syntax_error_is_a_finding():
    errs = _errors("def f(:\n", "src/repro_torch/x.py")
    assert len(errs) == 1 and errs[0].rule == "parse"
