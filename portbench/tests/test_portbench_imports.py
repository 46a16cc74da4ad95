"""The import boundary: nothing under portbench/ imports JAX or the JAX
package, and the plain reference imports nothing of the program. Names
are compared whole, by their top-level part, so `halva_tpu_torch` is not
`halva_tpu`."""

from __future__ import annotations

import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "halva_tpu"}
PROGRAM = "halva_tpu_torch"


def top_names(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def modules():
    for root, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert PROGRAM not in set(top_names(os.path.join(ref, f))), f


def test_the_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import halva_tpu_torch.ops\nfrom jax import numpy\n")
    names = set(top_names(str(p)))
    assert names & FORBIDDEN == {"jax"}
    assert PROGRAM in names
