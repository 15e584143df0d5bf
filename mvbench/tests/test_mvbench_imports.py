"""What the benchmark may load: nothing of JAX or the JAX package anywhere
under ``mvbench/`` (top-level module names compared whole: the port's name
begins with the JAX package's), nothing of the port in the reference, and
nothing read from ``benchmarks/``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reads_of_benchmarks(path):
    assert not set(imported(path)) & FORBIDDEN
    if path.parent.name == "tests":
        return
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith("benchmarks"), node.value


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        mods = set(imported(path))
        assert "repro_torch" not in mods and not mods & FORBIDDEN, path
        assert mods <= {"numpy", "torch", "typing", "mvbench", "__future__"}, \
            (path, mods)


def test_whole_name_comparison():
    from mvbench.harness import FORBIDDEN as HARNESS_FORBIDDEN
    assert set(HARNESS_FORBIDDEN) == FORBIDDEN
    # the port's top-level name is not the JAX package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN
