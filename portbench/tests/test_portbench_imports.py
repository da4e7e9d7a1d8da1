"""No module under portbench/ imports JAX or the JAX package (top-level
names compared whole: libbsc_tpu_torch is the port), and the reference
imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from portbench.tests.helpers import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "libbsc_tpu"}
MODULES = sorted(p for p in (REPO / "portbench").rglob("*.py"))


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(REPO)) for p in MODULES])
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


def test_port_name_is_not_the_jax_package():
    # the comparison is by whole name: the port's prefix is the JAX one
    assert "libbsc_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "portbench" / "ref")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "libbsc_tpu_torch" not in top_names(path)
