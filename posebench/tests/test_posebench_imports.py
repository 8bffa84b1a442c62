"""Nothing of the benchmark imports JAX, flax, optax or the JAX package, and
the reference imports nothing of the program either.

Every ``.py`` under ``posebench/`` is parsed with ``ast``; the top-level
name of each import (before the first dot) is compared whole, since the
port's name begins with the JAX package's.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dsnt_pose2d_tpu"}
PROGRAM = "dsnt_pose2d_tpu_torch"
SOURCES = sorted(ROOT.rglob("*.py"))


def imports(path: Path) -> list:
    """``(top-level name, level)`` of every import in the file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"run.py", "harness.py", "reference/model.py", "reference/steps.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax(path):
    bad = {name for name, level in imports(path) if level == 0 and name in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in imports(path):
        assert not (level == 0 and name == PROGRAM), f"{path} imports the program"
        # A relative import may reach only the reference's own modules.
        assert level <= 1, f"{path} imports from outside posebench/reference"


def test_top_level_names_compared_whole():
    import sys

    import dsnt_pose2d_tpu_torch.train.loop  # noqa: F401
    from posebench.run import forbidden_modules

    assert forbidden_modules() == []
    sys.modules["jax.numpy"] = sys
    try:
        assert forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax.numpy"]
