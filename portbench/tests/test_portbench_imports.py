"""Nothing under portbench/ imports JAX or the JAX package, and the plain
references import nothing of the program: module names compared by their
whole top-level name, since the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deeplearningrecommendationsystem_tpu"}
PORT = "deeplearningrecommendationsystem_tpu_torch"
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def local_imports(path: Path):
    """The portbench modules ``path`` imports, as files."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names if a.name.startswith("portbench")]
        for name in names:
            parts = name.split(".")[1:]
            for cand in (HERE.joinpath(*parts).with_suffix(".py"), HERE.joinpath(*parts, "__init__.py")):
                if cand.is_file():
                    yield cand


def test_the_names_compare_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("deeplearningrecommendationsystem_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


REFERENCE_FILES = sorted((HERE / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    seen, todo = set(), [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        assert PORT not in set(top_level_imports(f)), f
        todo.extend(local_imports(f))
