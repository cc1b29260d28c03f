"""No module of splatbench imports JAX or the JAX package, and the
reference and the objectives import nothing of the program: top-level
names compared whole."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tinysplat_tpu", "__graft_entry__"}
FILES = sorted(HERE.rglob("*.py"))


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py"))
                         + sorted((HERE / "objectives").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_takes_nothing_of_the_program(path):
    assert "tinysplat_torch" not in set(top_names(path))


def test_names_compared_whole():
    # The port's name begins with the JAX package's: a prefix test would
    # refuse it; the whole-name test does not.
    assert "tinysplat_torch" not in FORBIDDEN and "tinysplat_tpu" in FORBIDDEN
