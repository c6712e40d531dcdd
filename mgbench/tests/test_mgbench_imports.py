"""Nothing under mgbench/ imports JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import pathlib

from mgbench import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "hpcclassmultigridproject_tpu"}
PORT = "hpcclassmultigridproject_tpu_torch"


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = set(_top_names(path)) & JAX
        assert not found, f"{path.relative_to(BENCH)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in set(_top_names(path)), path.name


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, f"{PORT}_fake", object())
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX)
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", object())
    assert "jaxlib" in harness.forbidden_modules()
