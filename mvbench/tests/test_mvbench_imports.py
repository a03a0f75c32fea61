"""Nothing under mvbench/ imports JAX or the JAX package; the reference
imports nothing of the program either. Names are compared whole, by
their top-level part: `multivolumes_tpu_torch` begins with
`multivolumes_tpu` and is another package."""

import ast
import sys

import pytest

from mvbench import harness, run
from mvbench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "multivolumes_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "multivolumes_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "math",
                     "numpy", "torch", "mvbench"}


def test_wrapped_entry_points_are_the_ports():
    for path in (HERE / "metrics").glob("*.py"):
        for line in path.read_text().splitlines():
            if line.startswith("WRAPS"):
                assert '"multivolumes_tpu_torch.' in line


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "multivolumes_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "all64.orbit", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
