"""ray_tpu_torch.checkpoint against ray_tpu.checkpoint, on the CPU.

Both packages write one on-disk format, so a checkpoint crosses between them
bit for bit in either direction, bfloat16 leaves included (numpy has no
bfloat16 without ml_dtypes: the port writes their raw 2-byte values, as
numpy writes ml_dtypes' bfloat16, and JAX's restore views them back; had
the port written uint16, JAX would cast the integers numerically and the
bitwise checks here would fail). A JAX train state (test-tiny, flash route,
optax.adamw with a bfloat16 first moment) saved after two steps
resumes in the port, whose third step matches JAX's third to 1e-5 (the
tolerance of `test_torch_train.py`'s steps). The serving warm start reads
the same weights from a sharded checkpoint as from params.pkl.
"""

import asyncio
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import checkpoint as jckpt
from ray_tpu.models import transformer as jtr
from ray_tpu_torch import checkpoint as tckpt
from ray_tpu_torch.llm import LLMConfig, LLMServer, load_model
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.parallel import optim as toptim
from ray_tpu_torch.parallel import spmd as tspmd

TOL = dict(atol=1e-5, rtol=1e-5)


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, as unsigned integers of its width."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_flat(val, prefix + (str(i),)))
        return out
    return {} if tree is None else {"/".join(prefix): tree}


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 6), dtype=np.float32),
            rng.standard_normal((3, 5), dtype=np.float32),  # cast to bf16 below
            rng.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32))


def test_jax_save_restores_in_port_bitwise(tmp_path):
    f32, b, i32 = _values(0)
    tree = {"f32": jnp.asarray(f32), "bf16": jnp.asarray(b, jnp.bfloat16),
            "nested": {"i32": jnp.asarray(i32), "step": jnp.asarray(7, jnp.int32)},
            "pair": (jnp.asarray(f32[0]), None)}
    jckpt.save(str(tmp_path), tree)
    got = tckpt.restore(str(tmp_path))
    assert isinstance(got["pair"], tuple) and got["pair"][1] is None
    assert got["f32"].dtype == np.float32 and got["nested"]["i32"].dtype == np.int32
    assert got["bf16"].dtype == torch.bfloat16 and tuple(got["bf16"].shape) == (3, 5)
    flat_ref, flat = _flat(tree), _flat(got)
    assert set(flat) == set(flat_ref)
    for key, ref in flat_ref.items():
        np.testing.assert_array_equal(_bits(flat[key]), _bits(np.asarray(ref)), err_msg=key)
    on_device = tckpt.restore(str(tmp_path), device="cpu")
    assert isinstance(on_device["f32"], torch.Tensor)
    assert torch.equal(on_device["bf16"], got["bf16"])
    leaf = tckpt.restore_leaf(str(tmp_path), "nested/i32")
    np.testing.assert_array_equal(leaf, i32)


def test_port_save_restores_in_jax_bitwise(tmp_path):
    f32, b, i32 = _values(1)
    tree = {"f32": torch.from_numpy(f32), "bf16": torch.from_numpy(b).to(torch.bfloat16),
            "nested": {"i32": torch.from_numpy(i32), "step": np.asarray(3, np.int32)},
            "pair": (torch.from_numpy(f32[1]), None)}
    tckpt.save(str(tmp_path), tree)
    assert tckpt.is_committed(str(tmp_path)) and not tckpt.is_partial(str(tmp_path))
    got = jckpt.restore(str(tmp_path))
    assert str(got["bf16"].dtype) == "bfloat16" and got["nested"]["i32"].dtype == np.int32
    flat_ref, flat = _flat(tree), _flat(got)
    assert set(flat) == set(flat_ref)
    for key, ref in flat_ref.items():
        np.testing.assert_array_equal(_bits(flat[key]), _bits(ref), err_msg=key)
    # And back: the port reads its own save bit for bit.
    again = tckpt.restore(str(tmp_path))
    assert torch.equal(again["bf16"], tree["bf16"])


def test_uncommitted_directory_is_refused(tmp_path):
    path = str(tmp_path / "partial")
    tckpt.write_process_shards(path, {"w": torch.ones(3)})
    assert tckpt.is_sharded(path) and tckpt.is_partial(path)
    with pytest.raises(FileNotFoundError, match="never committed"):
        tckpt.restore(path)
    with pytest.raises(FileNotFoundError, match="never committed"):
        load_model(LLMConfig(model_id="test-tiny", checkpoint_path=path, device="cpu"))
    tckpt.commit(path)
    assert torch.equal(tckpt.restore(path, device="cpu")["w"], torch.ones(3))


def test_async_writer_snapshot_ignores_later_in_place_updates(tmp_path):
    """save returns once the snapshot is taken: tensors updated in place
    right after (as the port's optimizer does) leave the checkpoint as it
    was, and saves commit in order."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mu = torch.linspace(-1, 1, 5).to(torch.bfloat16)
    before = (w.clone(), mu.clone())
    writer = tckpt.AsyncCheckpointWriter()
    try:
        writer.save(str(tmp_path / "a"), {"w": w, "mu": mu})
        w.add_(1.0)
        mu.mul_(3.0)
        writer.save(str(tmp_path / "b"), {"w": w, "mu": mu})
        assert writer.wait_until_finished(timeout=60)
    finally:
        writer.shutdown()
    a, b = (tckpt.restore(str(tmp_path / n), device="cpu") for n in "ab")
    assert torch.equal(a["w"], before[0]) and torch.equal(a["mu"], before[1])
    assert torch.equal(b["w"], w) and torch.equal(b["mu"], mu)


def test_async_writer_reports_a_failed_save_on_the_next_call(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = tckpt.AsyncCheckpointWriter()
    try:
        writer.save(str(blocker / "ckpt"), {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="failed"):
            writer.wait_until_finished(timeout=60)
        with pytest.raises(RuntimeError, match="previous async checkpoint save failed"):
            writer.save(str(tmp_path / "next"), {"w": torch.ones(2)})
    finally:
        writer.shutdown()


def test_jax_train_state_resumes_in_port(tmp_path):
    """Two JAX adamw steps, a JAX save of {"step", "params", "opt_state"},
    then the third step in both packages: loss, grad_norm and params to
    1e-5. The port's own save of the restored state has JAX's tree and
    leaves bit for bit."""
    over = dict(attention="flash", remat=False)
    jmodel = jtr.Transformer(jtr.get_config("test-tiny", **over))
    jopt = optax.adamw(1e-3, mu_dtype=jnp.bfloat16)
    B, S = 2, 32
    rng = np.random.default_rng(11)
    tokens, targets = rng.integers(0, 256, (B, S)), rng.integers(0, 256, (B, S))
    jt, jy = jnp.asarray(tokens, jnp.int32), jnp.asarray(targets, jnp.int32)
    # Weights from a seed in flax's tree layout (the port's init_params keeps
    # it), so JAX's init is not compiled.
    cfg = ttr.get_config("test-tiny", **over)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          ttr.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jtr.cross_entropy_loss(jmodel.apply({"params": p}, jt), jy))(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    opt_state = jax.jit(jopt.init)(params)
    for _ in range(2):
        params, opt_state, _, _ = jstep(params, opt_state)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jpath, {"step": jnp.asarray(2, jnp.int32), "params": params,
                       "opt_state": opt_state})
    params, opt_state, jloss, jnorm = jstep(params, opt_state)

    model = ttr.Transformer(cfg, device="cpu")
    topt = toptim.adamw(1e-3, mu_dtype=torch.bfloat16)
    state = tspmd.state_from_tree(model, cfg, topt, tckpt.restore(jpath))
    assert state.step == 2 and state.opt_state.count == 2
    tckpt.save(tpath, tspmd.state_tree(state))
    assert tckpt.load_manifest(tpath)["tree"] == tckpt.load_manifest(jpath)["tree"]
    ours, saved = _flat(jckpt.restore(tpath)), _flat(jckpt.restore(jpath))
    assert set(ours) == set(saved)
    for key, ref in saved.items():
        assert ours[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(_bits(ours[key]), _bits(ref), err_msg=key)

    step_fn, _ = tspmd.build_train_step(model, topt)
    state, tm = step_fn(state, {"tokens": torch.from_numpy(tokens),
                                "targets": torch.from_numpy(targets)})
    assert tm["step"] == 3
    np.testing.assert_allclose(tm["loss"].item(), float(jloss), **TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jnorm), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, params))
    for key, p in _flat(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[key], **TOL, err_msg=key)


def _serve(engine, prompts, max_tokens):
    """Greedy tokens of each prompt, submitted together; the engine shut down."""
    outs = {i: [] for i in range(len(prompts))}
    done = threading.Event()
    finished = set()

    def cb_for(i):
        def cb(token, last):
            outs[i].append(token)
            if last:
                finished.add(i)
                if len(finished) == len(prompts):
                    done.set()
        return cb

    for i, p in enumerate(prompts):
        engine.submit(p, SamplingParams(max_tokens=max_tokens), cb_for(i))
    try:
        assert done.wait(timeout=120), "engine did not finish"
    finally:
        engine.shutdown()
    return [outs[i] for i in range(len(prompts))]


def test_sharded_warm_start_serves_like_params_pkl(tmp_path, monkeypatch):
    cfg = ttr.get_config("test-tiny")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(lambda t: t.numpy(), params), f)
    sharded = str(tmp_path / "sharded")
    tckpt.save(sharded, {"params": params, "step": np.asarray(0, np.int32)})
    pcfg, from_pkl = load_model(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                          device="cpu"))
    _, from_ckpt = load_model(LLMConfig(model_id="test-tiny", checkpoint_path=sharded,
                                        device="cpu"))
    assert _flat(from_pkl).keys() == _flat(from_ckpt).keys()
    for key, val in _flat(from_pkl).items():
        assert torch.equal(val, _flat(from_ckpt)[key]), key
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, n).tolist() for n in (9, 21)]

    async def generate(server):
        try:
            return await asyncio.gather(*(server.generate(p, max_tokens=5) for p in prompts))
        finally:
            await server.shutdown()

    served = []
    for path in (str(tmp_path), sharded):
        server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=path,
                                     num_slots=2, max_seq=64, device="cpu"))
        served.append([r["token_ids"] for r in asyncio.run(generate(server))])
    assert served[0] == served[1] and all(len(t) == 5 for t in served[0])
    engine = DecodeEngine.from_sharded_checkpoint(pcfg, sharded, num_slots=2, max_seq=64,
                                                  device="cpu")
    assert _serve(engine, prompts, 5) == served[0]
    # tp > 1 is collective over a process group (tests/test_torch_tp.py);
    # without one it raises before reading anything.
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        DecodeEngine.from_sharded_checkpoint(pcfg, sharded, tp=2, device="cpu")
