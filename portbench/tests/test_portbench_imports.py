"""The harness imports neither JAX nor the JAX package; the reference
imports neither of those nor the port. Module names are compared by their
top-level name, whole: ``ovo_tpu_torch`` begins with ``ovo_tpu``."""
import ast
from pathlib import Path

import pytest

from portbench.spec import HERE

JAX = {"jax", "jaxlib", "flax", "ovo_tpu"}
REFERENCE = HERE / "reference"


def _imports(path: Path):
    """(top-level name, level) of every import in a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            top = (node.module or "").split(".")[0]
            out.append((top, node.level))
    return out


def _files(root):
    return sorted(p for p in root.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _files(HERE), ids=lambda p: str(
    p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    bad = {name for name, level in _imports(path)
           if level == 0 and name in JAX}
    assert not bad, bad


@pytest.mark.parametrize("path", _files(REFERENCE), ids=lambda p: str(
    p.relative_to(REFERENCE)))
def test_reference_imports_no_program(path):
    for name, level in _imports(path):
        if level == 0:
            assert name not in JAX | {"ovo_tpu_torch", "portbench"}, name
        else:
            # a relative import stays inside the reference package
            depth = len(path.relative_to(REFERENCE).parts) - 1
            assert level - 1 <= depth, (name, level)


def test_whole_name_comparison():
    names = {"ovo_tpu_torch", "jaxlibx", "ovo_tpu"}
    assert {n for n in names if n in JAX} == {"ovo_tpu"}
