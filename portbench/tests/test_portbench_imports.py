"""Nothing under portbench/ imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole, so mudg_tpu_torch passes), and the plain
reference imports nothing of the program under test."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mudg_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mudg_tpu_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level > 1]


def test_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import mudg_tpu_torch.models\nfrom jax_like import x\nimport jax.numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}
