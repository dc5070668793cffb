"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Module names are
compared by their top-level name whole (the port's name begins with the
JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_names(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_top_names_are_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.serving\nfrom repro.models import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_names(p) == {"repro_torch", "repro", "importlib", "jax"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not top_names(path) & BANNED


@pytest.mark.parametrize("name", ["reference.py", "counts.py",
                                  "generator.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert not top_names(HERE / name) & (BANNED | {"repro_torch"})


def test_the_run_refuses_banned_modules_by_whole_name(monkeypatch):
    import sys

    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib.xla" in run.banned_modules()
