"""What the benchmark imports: nothing of JAX or the JAX package
(``repro``) anywhere, top-level names compared whole; and the references
(the configurations' modules and what they use) nothing of the port."""
import ast
import sys

import pytest

from bench.cell import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))
REFERENCE = sorted((BENCH / "configs").glob("*.py")) + [
    BENCH / "plain.py", BENCH / "check.py"]


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_tops(path))
    for top in _tops(path):
        if top == "bench":
            # only the plain pieces
            src = path.read_text()
            assert "from bench import plain" in src or path.name in (
                "plain.py", "check.py")


def test_the_run_refuses_jax_in_its_process():
    from bench import run
    assert run.forbidden_modules(["jax.numpy", "torch", "repro_torch.x"]) \
        == ["jax"]
    assert run.forbidden_modules(["repro.serving", "jaxlib"]) == [
        "jaxlib", "repro"]
    assert run.forbidden_modules(["repro_torch", "jaxtyping"]) == []
    assert set(run.forbidden_modules()) <= set(sys.modules)
