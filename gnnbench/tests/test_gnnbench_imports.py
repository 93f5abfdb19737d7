"""No module of the benchmark loads JAX, the JAX package ``repro`` or
its ``benchmarks/``, and the plain references load nothing of the
program either. Top-level module names are compared whole:
``repro_torch`` begins with ``repro`` and is another package."""
import ast
import pathlib

import pytest

from gnnbench.harness.cell import FORBIDDEN, forbidden_modules

BASE = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BASE.rglob("*.py") if "tests" not in p.parts)


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_imported_names_are_compared_whole():
    tree = "import repro_torch.serving\nfrom repro.gnn import x\n"
    path = BASE / "tests" / "_probe.py"
    try:
        path.write_text(tree)
        assert imported(path) == {"repro_torch", "repro"}
    finally:
        path.unlink()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BASE)))
def test_no_jax_or_reference_package(path):
    assert not imported(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BASE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "warnings", "numpy", "torch"}


def test_forbidden_modules_reads_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torchx", types.ModuleType("x"))
    assert "repro_torchx" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert "jax" in forbidden_modules()
