"""ray_tpu_torch's remat policies and fused-qkv route against ray_tpu's, on
the CPU in f32 (test-tiny, flash route).

Each remat policy keeps what JAX's `remat_block` keeps; the values do not
depend on the policy, so loss and gradients agree with JAX's under the same
policy to 1e-5 (the same f32 arithmetic in other summation orders). What the
policy changes is which ops rerun: the port's `flash_fwd`/`flash_bwd` ops
must run per step exactly as often as JAX's traced gradient holds its two
`pallas_call`s (traced with `_use_pallas` patched to True, never run): K1
twice per layer and K2 once, except under "selective", which keeps the flash
residuals and so runs K1 once. What each policy keeps is counted as the
ops its backward pass does not rerun. The fused-qkv model is held against JAX's
fused model through `params_from_jax` from both param layouts: logits to
1e-4 (as `test_torch_transformer.py`), gradients to 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import transformer as jtr
from ray_tpu.ops import attention as jattn
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import DecodeEngine
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    return {"/".join(prefix): tree}


def _np_tree(tree):
    return jax.tree.map(np.asarray, unbox(tree))


def _jax_model(seed, **overrides):
    """JAX's test-tiny model and weights from a seed in its param layout
    (drawn by the port's init_params, which keeps flax's tree, and stacked
    into `layers` for a scanned model), as jnp arrays."""
    jcfg = jtr.get_config("test-tiny", attention="flash", remat=True, **overrides)
    tcfg = ttr.get_config("test-tiny", fused_qkv=jcfg.fused_qkv)
    tree = {k: (v.numpy() if isinstance(v, torch.Tensor) else jax.tree.map(
        lambda t: t.numpy(), v)) for k, v in ttr.init_params(
            tcfg, torch.Generator().manual_seed(seed), "cpu").items()}
    if jcfg.scan_layers:
        layers = [tree.pop(f"layer_{i}") for i in range(jcfg.n_layers)]
        tree["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return jtr.Transformer(jcfg), jax.tree.map(jnp.asarray, tree)


def _batch(B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, S)), rng.integers(0, 256, (B, S))


def _pallas_calls(jaxpr) -> dict:
    """pallas_calls run by a jaxpr, through the jaxprs nested in its
    equations (a scan's body once per iteration; not a kernel's body): K1
    has two outputs (out, lse), K2 three (dq, dk, dv)."""
    counts = {"flash_fwd": 0, "flash_bwd": 0}

    def walk(jx, times):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                counts["flash_fwd" if len(eqn.outvars) == 2 else "flash_bwd"] += times
                continue
            inner = times * (eqn.params["length"] if eqn.primitive.name == "scan" else 1)
            for param in eqn.params.values():
                for sub in param if isinstance(param, (list, tuple)) else (param,):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr, inner)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub, inner)

    walk(jaxpr, 1)
    return counts


def _jax_loss_grads(jmodel, jparams, tokens, targets):
    """JAX's loss and gradients, and the pallas_calls of its traced gradient."""
    jt, jy = jnp.asarray(tokens, jnp.int32), jnp.asarray(targets, jnp.int32)

    def loss(p):
        return jtr.cross_entropy_loss(jmodel.apply({"params": p}, jt), jy)

    val, grads = jax.jit(jax.value_and_grad(loss))(jparams)
    with mock.patch.object(jattn, "_use_pallas", lambda: True):
        calls = _pallas_calls(jax.make_jaxpr(jax.grad(loss))(jparams).jaxpr)
    return float(val), _np_tree(grads), calls


def _port_loss_grads(cfg, tree, tokens, targets):
    """The port's loss and gradients, and its flash op runs in that step."""
    model = ttr.Transformer(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu")
    tattn.CALLS.update(flash_fwd=0, flash_bwd=0)
    loss = ttr.cross_entropy_loss(model(torch.from_numpy(tokens)), torch.from_numpy(targets))
    loss.backward()
    calls = dict(tattn.CALLS)
    grads = {k: p.grad for k, p in _flat(model.param_tree(trainable=True)).items()}
    return loss.item(), grads, calls


def _assert_grads_match(grads, jgrads, cfg):
    """jgrads (JAX's layout, scanned or not) through params_from_jax, leaf by leaf."""
    jflat = _flat(params_from_jax(jgrads, cfg, "cpu"))
    assert set(grads) == set(jflat)
    for key, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), jflat[key].numpy(), **TOL, err_msg=key)


@pytest.fixture(scope="module")
def unfused_params():
    """test-tiny params in JAX's layout, shared by the policy cases; the
    fixture also pays once the imports torch.utils.checkpoint makes on its
    first non-reentrant call."""
    params = _jax_model(4)[1]
    cfg = ttr.get_config("test-tiny", attention="flash", remat=True)
    _port_loss_grads(cfg, _np_tree(params), *_batch(B=1, S=8))
    return params


@pytest.mark.parametrize("policy", ["full", "attn", "dots", "selective"])
def test_remat_policy_matches_jax(policy, unfused_params):
    jmodel = jtr.Transformer(jtr.get_config("test-tiny", attention="flash", remat=True,
                                            remat_policy=policy))
    tokens, targets = _batch()
    jval, jgrads, jcalls = _jax_loss_grads(jmodel, unfused_params, tokens, targets)
    cfg = ttr.get_config("test-tiny", attention="flash", remat=True, remat_policy=policy)
    loss, grads, calls = _port_loss_grads(cfg, _np_tree(unfused_params), tokens, targets)
    np.testing.assert_allclose(loss, jval, **TOL)
    _assert_grads_match(grads, jgrads, cfg)
    L = cfg.n_layers
    assert jcalls == {"flash_fwd": (1 if policy == "selective" else 2) * L, "flash_bwd": L}
    assert calls == jcalls


@pytest.mark.parametrize("scan_layers,policy", [(False, "full"), (True, "selective")],
                         ids=["unscanned-full", "scanned-selective"])
def test_fused_qkv_matches_jax(scan_layers, policy, monkeypatch):
    over = dict(fused_qkv=True, scan_layers=scan_layers, remat_policy=policy)
    jmodel, jparams = _jax_model(5, **over)
    tree = _np_tree(jparams)
    assert ("layers" in tree) == scan_layers
    assert "qkv" in (tree["layers"] if scan_layers else tree["layer_0"])["attn"]
    tokens, targets = _batch(seed=1)
    cfg = ttr.get_config("test-tiny", attention="flash", remat=True, **over)
    model = ttr.Transformer(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jax.jit(jmodel.apply)({"params": jparams},
                                                jnp.asarray(tokens, jnp.int32))),
        atol=1e-4, rtol=1e-4)

    layouts = []
    real_fwd, real_bwd = tattn.flash_forward, tattn.flash_backward
    monkeypatch.setattr(tattn, "flash_forward", lambda *a, **kw: (
        layouts.append(("fwd", kw["layout"])), real_fwd(*a, **kw))[1])
    monkeypatch.setattr(tattn, "flash_backward", lambda *a, **kw: (
        layouts.append(("bwd", kw["layout"])), real_bwd(*a, **kw))[1])
    jval, jgrads, jcalls = _jax_loss_grads(jmodel, jparams, tokens, targets)
    loss, grads, calls = _port_loss_grads(cfg, tree, tokens, targets)
    np.testing.assert_allclose(loss, jval, **TOL)
    _assert_grads_match(grads, jgrads, cfg)
    assert calls == jcalls
    # JAX's fused branch leaves the bhsd route: K1 and K2 run in bshd.
    assert layouts and set(layouts) == {("fwd", "bshd"), ("bwd", "bshd")}


def test_fused_model_matches_unfused_weights_concatenated():
    """A fused model whose qkv and gate_up are the unfused model's matrices
    concatenated computes the same loss, and its gradients split back are the
    unfused gradients."""
    cfg = ttr.get_config("test-tiny", attention="flash", remat=True)
    fcfg = ttr.get_config("test-tiny", attention="flash", remat=True, fused_qkv=True)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    fused = {k: v for k, v in params.items() if not k.startswith("layer_")}
    for i in range(cfg.n_layers):
        layer = params[f"layer_{i}"]
        a, m = layer["attn"], layer["mlp"]
        fused[f"layer_{i}"] = dict(layer, attn={
            "qkv": {"kernel": torch.cat([a[n]["kernel"] for n in "qkv"], dim=1)},
            "o": a["o"]}, mlp={
            "gate_up": {"kernel": torch.cat([m["gate"]["kernel"], m["up"]["kernel"]], 1)},
            "down": m["down"]})
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=2))
    out = []
    for c, p in ((cfg, params), (fcfg, fused)):
        model = ttr.Transformer(c, p, device="cpu")
        loss = ttr.cross_entropy_loss(model(tokens), targets)
        loss.backward()
        out.append((loss.item(), _flat(model.param_tree(trainable=True))))
    (loss, g), (floss, fg) = out
    np.testing.assert_allclose(floss, loss, **TOL)
    H, Hkv, F = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim
    for i in range(cfg.n_layers):
        pre = f"layer_{i}/"
        q, k, v = fg[pre + "attn/qkv/kernel"].grad.split([H, Hkv, Hkv], dim=1)
        gate, up = fg[pre + "mlp/gate_up/kernel"].grad.split([F, F], dim=1)
        for name, got in (("attn/q", q), ("attn/k", k), ("attn/v", v),
                          ("mlp/gate", gate), ("mlp/up", up)):
            torch.testing.assert_close(got, g[pre + name + "/kernel"].grad, **TOL)


def test_engine_refuses_a_fused_model():
    """JAX's engine reads layer["q"] and cannot serve a fused model either;
    the port says so instead of failing on a missing key."""
    cfg = ttr.get_config("test-tiny", fused_qkv=True)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="fused_qkv"):
        DecodeEngine(cfg, params, decode_loop=False, device="cpu")


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ttr.Transformer(ttr.get_config("test-tiny", remat=True, remat_policy="everything"),
                        device="cpu")


class _CountOp(TorchDispatchMode):
    """Counts the runs of one op dispatched under it (a selective-checkpoint
    replay of a kept output does not run the op, so it is not counted)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


def _policy_model(policy):
    cfg = ttr.get_config("test-tiny", attention="flash", remat=True, remat_policy=policy)
    return cfg, ttr.Transformer(cfg, ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"), device="cpu")


def test_dots_policy_keeps_every_matmul_output():
    """Under "dots" the backward pass's recompute replays the block's
    matmuls from their kept outputs; under "full" it reruns six of them (q,
    k, v, o, gate, up: the recompute stops before the down projection, whose
    output no gradient needs). Counted as the aten.mm calls the backward
    pass dispatches."""
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=3))
    counts = {}
    for policy in ("full", "dots"):
        cfg, model = _policy_model(policy)
        loss = ttr.cross_entropy_loss(model(tokens), targets)
        with _CountOp(torch.ops.aten.mm.default) as mode:
            loss.backward()
        counts[policy] = mode.n
    assert counts["dots"] == counts["full"] - 6 * cfg.n_layers, counts


# Tags per block on the flash route: "attn_out" under attn; under selective
# "save" on the post-rope q, k, v, mlp_norm's output and down's output (the
# flash output is kept as `flash_fwd`'s, JAX's "flash_residuals", and not
# tagged again).
@pytest.mark.parametrize("policy,tags", [("full", 0), ("attn", 1), ("dots", 0),
                                         ("selective", 5)])
def test_policy_keeps_its_checkpoint_names(policy, tags):
    """Each name a policy keeps is tagged once per block in the forward pass
    and replayed from the kept tensor in the backward pass: the tag op runs
    0 times there. Were the names not kept, the recompute would run the tags
    again."""
    cfg, model = _policy_model(policy)
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=3))
    op = torch.ops.ray_tpu_torch.checkpoint_name.default
    with _CountOp(op) as fwd:
        loss = ttr.cross_entropy_loss(model(tokens), targets)
    with _CountOp(op) as bwd:
        loss.backward()
    assert (fwd.n, bwd.n) == (tags * cfg.n_layers, 0)
