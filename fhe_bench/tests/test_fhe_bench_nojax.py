"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (oece_tpu_torch, the port, is not oece_tpu); the
reference's modules import nothing of the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "oece_tpu"}
REFERENCE = ("reference.py", "roofline.py", "keydraw.py")


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path.read_text()) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_program(name):
    assert "oece_tpu_torch" not in top_level_imports((HERE / name).read_text())


@pytest.mark.parametrize("source, bad", [
    ("import oece_tpu_torch.fhe.boot", False),
    ("from oece_tpu_torch import fhe", False),
    ("import oece_tpu.fhe", True),
    ("from oece_tpu.fhe import boot", True),
    ("import jax.numpy as jnp", True),
    ("from . import port", False),
])
def test_the_check_compares_whole_names(source, bad):
    assert bool(top_level_imports(source) & FORBIDDEN) == bad
