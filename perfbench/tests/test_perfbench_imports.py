"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, and
the reference imports nothing of the program: every file under
``perfbench/`` parsed, each import's top-level name compared whole."""

import ast

import pytest

from conftest import HERE

BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(HERE.rglob("*.py"))


def _top_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_files_are_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_program_in_the_reference(path):
    names = set(_top_names(path))
    assert not names & BANNED, names & BANNED
    if path.relative_to(HERE).parts[0] == "reference":
        assert "repro_torch" not in names
