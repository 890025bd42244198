"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

from __future__ import annotations

import ast
import os

from conftest import PB

FORBIDDEN = {"jax", "jaxlib", "flax", "opentransformer_tpu"}


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub: str = ""):
    for root, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_whole_names_are_compared():
    assert "opentransformer_tpu_torch" not in FORBIDDEN
    assert "opentransformer_tpu_torch".split(".")[0] != "opentransformer_tpu"


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "opentransformer_tpu_torch" not in imported_tops(path), path
        assert imported_tops(path) <= {"__future__", "math", "numpy", "torch"}, path
