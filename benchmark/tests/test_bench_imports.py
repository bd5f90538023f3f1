"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name starts with the JAX package's),
and the reference imports nothing of the measured program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gs_slam_analytica_jacobian_tpu"}
PORT = "gs_slam_analytica_jacobian_tpu_torch"


def modules():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), HERE)


def top_level_imports(path):
    with open(os.path.join(HERE, path)) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in modules()
                                  if p.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)


def test_the_port_name_is_not_the_jax_package():
    assert PORT.split(".")[0] not in FORBIDDEN
