"""The port imports nothing of the JAX package or of JAX.

Every module of `ray_tpu_torch/`, `chip_smoke.py` and `chip_mesh.py` is
parsed with `ast`; an import of `ray_tpu` (not `ray_tpu_torch`), `jax`,
`flax` or `optax`, at any depth of the file (a function body included),
fails the test.
"""

import ast
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("ray_tpu", "jax", "flax", "optax")
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                          ROOT / "chip_mesh.py"]


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
              "ray_tpu_torch/llm/kvcache/manager.py", "ray_tpu_torch/llm/flight_recorder.py",
              "ray_tpu_torch/llm/adapters.py"}
    assert copies <= ids, sorted(copies - ids)


def test_guard_covers_the_pd_handoff():
    """The files that define the PD handoff and the engine's and server's
    in-process surface are among the guard's files."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.llm._engine import DecodeEngine

    funcs = [DecodeEngine.prefill_detached, DecodeEngine._detached_cold,
             DecodeEngine._detached_suffix, DecodeEngine.submit_prefilled,
             DecodeEngine._exec_attach, DecodeEngine.set_tenant_weight,
             DecodeEngine.autopilot_signals, LLMServer.model_id, LLMServer.cache_stats,
             LLMServer.scheduler_stats, LLMServer.set_tenant_weight,
             LLMServer.autopilot_signals]
    files = {pathlib.Path(inspect.getsourcefile(f)).resolve() for f in funcs}
    assert files == {ROOT / "ray_tpu_torch/llm/_engine.py", ROOT / "ray_tpu_torch/llm/__init__.py"}
    assert files <= set(FILES)


def test_guard_covers_the_mesh_and_checkpoint_modules():
    """The modules of training over a mesh and of the multi-process
    checkpoint are among the guard's files."""
    mark = next(m for m in test_no_jax_package_import.pytestmark if m.name == "parametrize")
    ids = {mark.kwargs["ids"](p) for p in mark.args[1]}
    mesh_files = {"ray_tpu_torch/parallel/mesh.py", "ray_tpu_torch/parallel/spmd.py",
                  "ray_tpu_torch/parallel/optim.py", "ray_tpu_torch/checkpoint/_format.py",
                  "ray_tpu_torch/checkpoint/_restore.py", "ray_tpu_torch/checkpoint/_writer.py"}
    assert mesh_files <= ids, sorted(mesh_files - ids)


# The functions of tests/test_torch_fsdp.py that its worker processes run.
FSDP_WORKER_FUNCS = ("_local_bits", "_train_four", "_resume_two", "_worker", "_loaded_modules",
                     "_nest", "_flat", "_bits")


def test_fsdp_worker_imports_no_jax_package():
    """The worker entry of tests/test_torch_fsdp.py: its module-level
    imports and the functions the workers run import nothing forbidden,
    and run as a script (as the workers are) it loads no jax, flax, optax
    or ray_tpu module."""
    import json
    import os
    import subprocess
    import sys

    path = ROOT / "tests" / "test_torch_fsdp.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
    funcs = [node for node in tree.body
             if isinstance(node, ast.FunctionDef) and node.name in FSDP_WORKER_FUNCS]
    assert {f.name for f in funcs} == set(FSDP_WORKER_FUNCS)
    bad = [(line, pkg) for node in top + funcs for line, pkg in _imported(
        ast.Module(body=[node], type_ignores=[])) if pkg in FORBIDDEN]
    assert not bad, f"the fsdp worker imports {bad}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(path), "modules"], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_guard_covers_the_tp_module():
    """llm/tp.py (tensor-parallel serving) is among the guard's files and
    imports neither jax nor ray_tpu, and the engine that drives it is too."""
    from ray_tpu_torch.llm import tp
    from ray_tpu_torch.llm._engine import DecodeEngine

    path = pathlib.Path(inspect.getsourcefile(tp)).resolve()
    assert path == ROOT / "ray_tpu_torch/llm/tp.py" and path in FILES
    assert pathlib.Path(inspect.getsourcefile(DecodeEngine._follow)).resolve() in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [pkg for _, pkg in _imported(tree) if pkg in FORBIDDEN]
