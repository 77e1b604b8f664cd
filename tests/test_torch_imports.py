"""The port imports nothing of the JAX package or of JAX.

Every module of `ray_tpu_torch/` and `chip_smoke.py` is parsed with `ast`;
an import of `ray_tpu` (not `ray_tpu_torch`), `jax`, `flax` or `optax`, at
any depth of the file (a function body included), fails the test.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("ray_tpu", "jax", "flax", "optax")
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    """(line, top-level package) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_the_guard_sees_every_form():
    src = ("import jax.numpy as jnp\nfrom ray_tpu.llm import x\n"
           "def f():\n    import optax\n    from flax import linen\n"
           "from ray_tpu_torch import y\nfrom . import z\nimport jaxtyping\n")
    assert [p for _, p in _imported(ast.parse(src)) if p in FORBIDDEN] == [
        "jax", "ray_tpu", "optax", "flax"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, pkg) for line, pkg in _imported(tree) if pkg in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_covers_the_copied_modules():
    """The modules copied from framework-neutral JAX-package modules (a copy
    could bring an import of its original back) are among the guard's ids."""
    mark = next(m for m in test_no_jax_package_import.pytestmark if m.name == "parametrize")
    ids = {mark.kwargs["ids"](p) for p in mark.args[1]}
    copies = {"ray_tpu_torch/llm/generate/__init__.py", "ray_tpu_torch/llm/generate/_constraint.py",
              "ray_tpu_torch/llm/generate/_fsm.py", "ray_tpu_torch/llm/generate/_grammar.py",
              "ray_tpu_torch/llm/generate/_schema.py", "ray_tpu_torch/llm/generate/_stream.py",
              "ray_tpu_torch/llm/scheduler/scheduler.py", "ray_tpu_torch/llm/scheduler/spec.py",
              "ray_tpu_torch/llm/kvcache/manager.py", "ray_tpu_torch/llm/flight_recorder.py"}
    assert copies <= ids, sorted(copies - ids)
