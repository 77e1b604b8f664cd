"""ray_tpu_torch's training path against ray_tpu's, on the CPU in f32.

The same numpy weights and batches go through both packages: the losses
(`cross_entropy_loss`, `fused_cross_entropy_loss`), the optimizer (`adamw`
against `optax.adamw`), the Transformer's loss and gradients with the flash
route and remat, and `build_train_step` over three steps. On the CPU the
port's flash route runs K1's and K2's plain versions; JAX runs its XLA
attention and backward there.

Tolerances: the losses and the model's gradients are the same f32
arithmetic in other summation orders, so 1e-5. The optimizer's update is
elementwise and agrees to a few f32 ulps: 1e-6 relative on the params. Over
three train steps the per-step loss and grad_norm agree to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import optim as toptim
from ray_tpu_torch.parallel import spmd as tspmd

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, unbox(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    return {"/".join(prefix): tree}


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("fused,contract_dim,masked", [
    (False, None, False), (False, None, True),
    (True, 1, False), (True, 1, True), (True, 0, False), (True, 0, True),
])
def test_cross_entropy_losses_match_jax(fused, contract_dim, masked):
    rng = np.random.default_rng(3)
    B, S, E, V = 2, 24, 16, 40
    hidden = rng.standard_normal((B, S, E), dtype=np.float32)
    table = rng.standard_normal((E, V) if contract_dim == 0 else (V, E), dtype=np.float32)
    targets = rng.integers(0, V, (B, S))
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    if fused:
        def jloss(h, w):
            return jtr.fused_cross_entropy_loss(
                h, w, jnp.asarray(targets, jnp.int32), jm, chunk=8,
                contract_dim=contract_dim, compute_dtype=jnp.float32)

        def tloss(h, w):
            return ttr.fused_cross_entropy_loss(
                h, w, torch.from_numpy(targets), tm, chunk=8,
                contract_dim=contract_dim, compute_dtype=torch.float32)
    else:
        def jloss(h, w):
            return jtr.cross_entropy_loss(h @ w.T, jnp.asarray(targets, jnp.int32), jm)

        def tloss(h, w):
            return ttr.cross_entropy_loss(h @ w.T, torch.from_numpy(targets), tm)

    jval, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    h, w = (torch.from_numpy(a).requires_grad_() for a in (hidden, table))
    val = tloss(h, w)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgh), **TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgw), **TOL)


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("kwargs", [
    {"learning_rate": 1e-3},
    {"learning_rate": 3e-4, "weight_decay": 0.01, "mu_dtype": "bfloat16"},
], ids=["optax-defaults", "bench-bf16-mu"])
def test_adamw_matches_optax(kwargs):
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 8), dtype=np.float32),
              "b": {"c": rng.standard_normal((8,), dtype=np.float32),
                    "d": rng.standard_normal((3, 2, 5), dtype=np.float32)}}
    jkw = dict(kwargs, mu_dtype=getattr(jnp, kwargs["mu_dtype"])) if "mu_dtype" in kwargs else kwargs
    tkw = dict(kwargs, mu_dtype=getattr(torch, kwargs["mu_dtype"])) if "mu_dtype" in kwargs else kwargs
    jopt = optax.adamw(**jkw)
    topt = toptim.adamw(**tkw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, params))
    tstate = topt.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), params)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update_(jax.tree.map(torch.from_numpy, grads), tstate, tp)
        for key, val in _flat(tp).items():
            np.testing.assert_allclose(val.numpy(), np.asarray(_flat(jp)[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    jmu = _flat(jstate[0].mu)
    for key, val in _flat(tstate.mu).items():
        assert str(val.dtype).split(".")[-1] == str(jmu[key].dtype)
        np.testing.assert_allclose(val.float().numpy(), np.asarray(jmu[key], np.float32),
                                   rtol=1e-2 if "mu_dtype" in kwargs else 1e-6, err_msg=key)
    assert tstate.count == int(jstate[0].count) == 3


# ------------------------------------------------------------------ model

def _jax_model(seed, **overrides):
    jcfg = jtr.get_config("test-tiny", **overrides)
    model = jtr.Transformer(jcfg)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return model, unbox(variables["params"])


def _batch(B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, S)), rng.integers(0, 256, (B, S))


def _port_grads(cfg, tree, tokens, targets, fused=False):
    model = ttr.Transformer(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu")
    tt, ty = torch.from_numpy(tokens), torch.from_numpy(targets)
    if fused:
        loss = ttr.fused_cross_entropy_loss(model(tt, return_hidden=True), model.lm_head, ty,
                                            contract_dim=0, compute_dtype=torch.float32)
    else:
        loss = ttr.cross_entropy_loss(model(tt), ty)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in _flat(model.param_tree(trainable=True)).items()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain-ce", "fused-ce"])
def test_model_loss_and_grads_match_jax(fused):
    """test-tiny with the flash route and remat: JAX's loss and gradients."""
    over = dict(attention="flash", remat=True)
    jmodel, jparams = _jax_model(4, **over)
    tokens, targets = _batch()
    jt, jy = jnp.asarray(tokens, jnp.int32), jnp.asarray(targets, jnp.int32)

    def jloss(p):
        if fused:
            hidden = jmodel.apply({"params": p}, jt, return_hidden=True)
            return jtr.fused_cross_entropy_loss(hidden, p["lm_head"]["kernel"], jy,
                                                contract_dim=0, compute_dtype=jnp.float32)
        return jtr.cross_entropy_loss(jmodel.apply({"params": p}, jt), jy)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    cfg = ttr.get_config("test-tiny", **over)
    loss, grads = _port_grads(cfg, _np_tree(jparams), tokens, targets, fused)
    np.testing.assert_allclose(loss, float(jval), **TOL)
    jflat = _flat(_np_tree(jgrads))
    assert set(grads) == set(jflat)
    for key, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), jflat[key], **TOL, err_msg=key)


def test_remat_on_and_off_give_the_same_grads():
    _, jparams = _jax_model(6)
    tree = _np_tree(jparams)
    tokens, targets = _batch(seed=2)
    ref_loss, ref = _port_grads(ttr.get_config("test-tiny", attention="flash", remat=False),
                                tree, tokens, targets)
    loss, grads = _port_grads(ttr.get_config("test-tiny", attention="flash", remat=True),
                              tree, tokens, targets)
    assert loss == ref_loss
    for key, grad in grads.items():
        torch.testing.assert_close(grad, ref[key], atol=0, rtol=0, msg=key)


def test_train_steps_match_jax():
    """Three build_train_step steps from the same init and batch, with
    optax.adamw(1e-3) as tests/test_jax_stack.py trains: per-step loss and
    grad_norm, the step count, and the params after the last step."""
    jcfg = jtr.get_config("test-tiny", attention="flash", remat=True)
    jmodel = jtr.Transformer(jcfg)
    mesh = jmesh.create_mesh({"dp": 1})
    jopt = optax.adamw(1e-3)
    B, S = 2, 32
    jstate, _ = jspmd.init_state(jmodel, jcfg, jopt, mesh, sample_shape=(B, S))
    jstep, jplace = jspmd.build_train_step(jmodel, jopt, mesh)
    tokens, targets = _batch(B, S, seed=7)
    jbatch = {"tokens": jax.device_put(jnp.asarray(tokens, jnp.int32), jplace["tokens"]),
              "targets": jax.device_put(jnp.asarray(targets, jnp.int32), jplace["targets"])}

    cfg = ttr.get_config("test-tiny", attention="flash", remat=True)
    model = ttr.Transformer(cfg, device="cpu")
    topt = toptim.adamw(1e-3)
    tstate, _ = tspmd.init_state(model, cfg, topt,
                                 params=params_from_jax(_np_tree(jstate.params), cfg, "cpu"))
    tstep, tplace = tspmd.build_train_step(model, topt)
    tbatch = {"tokens": torch.from_numpy(tokens).to(tplace["tokens"]),
              "targets": torch.from_numpy(targets).to(tplace["targets"])}
    losses = []
    with mesh:
        for _ in range(3):
            jstate, jm = jstep(jstate, jbatch)
            tstate, tm = tstep(tstate, tbatch)
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
            np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                       rtol=1e-5)
            assert tm["step"] == int(jm["step"])
            losses.append(tm["loss"].item())
    assert losses[-1] < losses[0]
    jflat = _flat(_np_tree(jstate.params))
    for key, p in _flat(tstate.params).items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    logits = tspmd.eval_logits_fn(model)(tstate.params, tbatch["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jspmd.eval_logits_fn(jmodel)(
        jstate.params, jbatch["tokens"])), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch,fused", [((953, 2048), False), ((954, 2048), True)],
                         ids=["below-2e9", "above-2e9"])
def test_fused_ce_switch_matches_jax(batch, fused):
    """test-tiny's vocab (256) puts the 2e9-byte logits line between 953 and
    954 rows of 2048 tokens. JAX decides while tracing, so its step is traced
    on abstract inputs (nothing of that size is allocated); the fused branch
    is the only one with a scan in test-tiny's step."""
    jcfg = jtr.get_config("test-tiny")
    jmodel = jtr.Transformer(jcfg)
    mesh = jmesh.create_mesh({"dp": 1})
    jopt = optax.adamw(1e-3)
    jstate, _ = jspmd.init_state(jmodel, jcfg, jopt, mesh, sample_shape=(1, 8))
    jstep, _ = jspmd.build_train_step(jmodel, jopt, mesh, with_grad_norm=False)
    abstract = {k: jax.ShapeDtypeStruct(batch, jnp.int32) for k in ("tokens", "targets")}
    with mesh:
        jaxpr = str(jax.make_jaxpr(jstep)(jstate, abstract))
    assert ("scan" in jaxpr) == fused
    model = ttr.Transformer(ttr.get_config("test-tiny"), device="cpu")
    assert tspmd.fused_ce_enabled(model, batch) == fused
    assert not tspmd.fused_ce_enabled(model, batch, loss_fn=ttr.cross_entropy_loss)
    assert tspmd.fused_ce_enabled(model, (1, 8), fused_ce=True)


def test_multi_device_mesh_and_kept_state_raise():
    """The port's mesh with tp=2 is built (over a fake two-rank process
    group: no processes) and training on it raises, naming ROADMAP item
    [7d]; a step that keeps the old state is not ported."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.parallel import mesh as tmesh

    model = ttr.Transformer(ttr.get_config("test-tiny"), device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = tmesh.create_mesh({"tp": 2}, device="cpu")
        with pytest.raises(NotImplementedError, match=r"tp=2 is ROADMAP Queue 1 item \[7d\]"):
            tspmd.build_train_step(model, toptim.adamw(1e-3), mesh=mesh)
    finally:
        dist.destroy_process_group()
    with pytest.raises(NotImplementedError, match="in place"):
        tspmd.build_train_step(model, toptim.adamw(1e-3), donate=False)


@pytest.mark.cuda
def test_head_matmul_f32_matches_f32_matmul_on_card():
    """The tied head's bf16-operand, f32-result GEMM (cuBLAS on the card; the
    CPU takes an f32 matmul instead) forward and backward against f32
    matmuls of the same bf16-rounded operands and cotangent: the products
    are exact in f32, so only the summation order differs (1e-4 relative on
    the f32 results, 4e-3, one bf16 ulp, on the bf16 activation grad)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16-operand f32-result GEMM runs only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, K, N = 256, 512, 1000
    a = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    table = (torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5).requires_grad_()
    cot = torch.randn(rows, N, generator=gen, device="cuda")
    out = ttr._matmul_f32(a, table.T)
    out.backward(cot)
    a32, w32 = a.detach().float(), table.detach().T.to(torch.bfloat16).float()
    c32 = cot.to(torch.bfloat16).float()

    def rel(got, ref):
        return float((got.float() - ref).norm() / ref.norm())

    assert out.dtype == table.grad.dtype == torch.float32 and a.grad.dtype == torch.bfloat16
    assert rel(out, a32 @ w32) <= 1e-4
    assert rel(table.grad, (a32.T @ c32).T) <= 1e-4
    assert rel(a.grad, (c32 @ w32.T).to(torch.bfloat16).float()) <= 4e-3
