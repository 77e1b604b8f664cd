"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention, on the CPU.

The same numpy inputs (fixed seed) go through both packages in f32. On the
CPU the port's K1 and K2 wrappers take their plain versions,
`flash_forward_reference` and `flash_backward_reference`; the JAX side runs
the Pallas kernels in interpret mode (`_flash_forward(..., interpret=True)`,
`_flash_backward(..., interpret=True)`) or its reference path. Tolerances as
tests/test_jax_stack.py holds the Pallas kernels: 2e-5 forward, 5e-4
backward. The kernels themselves run only on the GPU (`cuda`-marked tests
below; `python3 chip_smoke.py` holds them at the serving and training
shapes). A GPU machine without JAX runs those alone:
`python3 -m pytest --noconftest -m cuda tests/test_torch_attention.py`.
"""

import ast
import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops import attention as jattn
except ImportError:  # a GPU machine without JAX: only the `cuda` tests run there
    jax = jnp = jattn = None

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=5e-4, rtol=5e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(B, S, T, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


CASES = [(S, Hkv, D, causal) for S in (64, 256) for Hkv in (4, 2) for D in (16, 64)
         for causal in (True, False)]


@pytest.mark.parametrize("S,Hkv,D,causal", CASES)
def test_flash_forward_reference_matches_jax(S, Hkv, D, causal):
    B, H = 2, 4
    q, k, v = _qkv(B, S, S, H, Hkv, D, seed=S + Hkv + D)
    scale = D ** -0.5
    out, lse = tattn.flash_forward(*_t(q, k, v), causal=causal, scale=scale)
    ref_out, ref_lse = jattn._attention_with_lse(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), H // Hkv, axis=2),
        jnp.repeat(jnp.asarray(v), H // Hkv, axis=2), causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    if S == 64 and Hkv == 2:
        # The Pallas kernel itself, interpreted (a few cases: it is slow).
        kk = jnp.repeat(jnp.asarray(k), H // Hkv, axis=2)
        vv = jnp.repeat(jnp.asarray(v), H // Hkv, axis=2)
        p_out, p_lse = jattn._flash_forward(
            jnp.asarray(q), kk, vv, causal=causal, scale=scale, block_q=32,
            block_k=32, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(p_out), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse), **TOL)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_flash_forward_bhsd_layout_matches_jax_pallas(Hkv):
    B, S, H, D = 2, 64, 4, 16
    q, k, v = _qkv(B, S, S, H, Hkv, D, seed=3)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    out, lse = tattn.flash_forward(*_t(tr(q), tr(k), tr(v)), causal=True,
                                   scale=D ** -0.5, layout="bhsd")
    kk = jnp.repeat(jnp.asarray(tr(k)), H // Hkv, axis=1)
    vv = jnp.repeat(jnp.asarray(tr(v)), H // Hkv, axis=1)
    p_out, p_lse = jattn._flash_forward(
        jnp.asarray(tr(q)), kk, vv, causal=True, scale=D ** -0.5, block_q=32,
        block_k=32, interpret=True, layout="bhsd")
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse), **TOL)


@pytest.mark.parametrize("S", [64, 256])
def test_reference_attention_with_positions_matches_jax(S):
    B, H, Hkv, D = 2, 4, 2, 16
    T = S + 16
    q, k, v = _qkv(B, S, T, H, Hkv, D, seed=S)
    pos_q = np.arange(16, 16 + S, dtype=np.int32)
    pos_kv = np.arange(T, dtype=np.int32)
    out, lse = tattn._attention_with_lse(
        *_t(q, k, v), causal=True, scale=None,
        positions_q=torch.from_numpy(pos_q), positions_kv=torch.from_numpy(pos_kv))
    ref_out, ref_lse = jattn._attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, scale=None,
        positions_q=jnp.asarray(pos_q), positions_kv=jnp.asarray(pos_kv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(tattn.reference_attention(*_t(q, k, v)).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_flash_attention_entry_points_match_jax(Hkv):
    B, S, H, D = 2, 64, 4, 16
    q, k, v = _qkv(B, S, S, H, Hkv, D, seed=11)
    out = tattn.flash_attention(*_t(q, k, v))
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    out_b = tattn.flash_attention_bhsd(*_t(tr(q), tr(k), tr(v)), False)
    ref_b = jattn.flash_attention_bhsd(jnp.asarray(tr(q)), jnp.asarray(tr(k)),
                                       jnp.asarray(tr(v)), False)
    np.testing.assert_allclose(out_b.numpy(), np.asarray(ref_b), **TOL)


BWD_CASES = [(S, Hkv, D, layout, causal) for S in (64, 128) for Hkv in (4, 2)
             for D in (32, 64) for layout in ("bshd", "bhsd") for causal in (True, False)]


@pytest.mark.parametrize("S,Hkv,D,layout,causal", BWD_CASES)
def test_flash_backward_reference_matches_jax_pallas(S, Hkv, D, layout, causal):
    """K2's plain twin against the Pallas backward, interpreted. JAX's kernel
    takes kv expanded to H heads and returns per-query-head dk/dv; they are
    summed over the repeat axis here, as `_flash_bwd_rule` does after it."""
    B, H = 1, 4
    rep = H // Hkv
    q, k, v = _qkv(B, S, S, H, Hkv, D, seed=S + 3 * Hkv + D)
    g = np.random.default_rng(S + D).standard_normal(q.shape, dtype=np.float32)
    if layout == "bhsd":
        q, k, v, g = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, g))
    h_ax = 2 if layout == "bshd" else 1
    scale = D ** -0.5
    out, lse = tattn.flash_forward(*_t(q, k, v), causal=causal, scale=scale, layout=layout)
    dq, dk, dv = tattn.flash_backward(*_t(q, k, v), out, lse, torch.from_numpy(g),
                                      causal=causal, scale=scale, layout=layout)
    jq, jdk, jdv = jattn._flash_backward(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=h_ax),
        jnp.repeat(jnp.asarray(v), rep, axis=h_ax), jnp.asarray(out.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(g), causal=causal, scale=scale,
        block_q=64, block_k=64, interpret=True, layout=layout)

    def fold(a):  # [.., H, ..] -> sum over each kv head's query heads
        a = np.asarray(a)
        shape = a.shape[:h_ax] + (Hkv, rep) + a.shape[h_ax + 1:]
        return a.reshape(shape).sum(h_ax + 1)

    np.testing.assert_allclose(dq.numpy(), np.asarray(jq), **BWD_TOL)
    np.testing.assert_allclose(dk.numpy(), fold(jdk), **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), fold(jdv), **BWD_TOL)


@pytest.mark.parametrize("Hkv", [4, 2])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_attention_grads_match_jax(Hkv, layout):
    """Autograd through the port's entry points (K1 forward, K2 backward)
    against jax.grad of JAX's custom_vjp entry points."""
    B, S, H, D = 2, 64, 4, 16
    q, k, v = _qkv(B, S, S, H, Hkv, D, seed=21 + Hkv)
    g = np.random.default_rng(22).standard_normal(q.shape, dtype=np.float32)
    tfn, jfn = tattn.flash_attention, jattn.flash_attention
    if layout == "bhsd":
        q, k, v, g = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, g))
        tfn, jfn = tattn.flash_attention_bhsd, jattn.flash_attention_bhsd
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tfn(tq, tk, tv) * torch.from_numpy(g)).sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **BWD_TOL)


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


_BANNED = ("jax", "flax", "optax", "ray_tpu")


def _banned_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names if n.split(".")[0] in _BANNED]
    return bad


def test_port_imports_nothing_of_jax_or_ray_tpu():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 5
    offenders = {p: b for p in paths if (b := _banned_imports(p))}
    assert not offenders, offenders


# Edge cases of the kernels' tiling (64-row q and k tiles, 32 at D = 128 in
# parts of K2, 16 rows per warp): S and T off every tile size, one and
# sixteen rows, S != T both ways, no mask, both layouts, D 64 and 128, GQA
# 32/8 and MHA. (B, S, T, H, Hkv, D, causal, layout).
KERNEL_EDGE_CASES = [
    (1, 100, 100, 8, 2, 64, True, "bshd"),
    (1, 17, 17, 32, 8, 64, True, "bhsd"),
    (2, 100, 100, 8, 8, 128, True, "bshd"),
    (1, 130, 130, 32, 8, 128, False, "bhsd"),
    (1, 200, 200, 12, 12, 64, False, "bshd"),
    (1, 200, 200, 32, 8, 128, True, "bhsd"),
    (1, 1, 1, 32, 8, 128, True, "bshd"),
    (2, 16, 16, 32, 8, 64, True, "bhsd"),
    (1, 1, 130, 8, 8, 64, False, "bhsd"),
    (1, 17, 200, 32, 8, 128, True, "bshd"),
    (1, 200, 17, 12, 12, 64, True, "bhsd"),
    (1, 130, 100, 32, 8, 64, False, "bshd"),
]


def _kernel_inputs(B, S, T, H, Hkv, D, layout, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "bshd":
        qs, ks = (B, S, H, D), (B, T, Hkv, D)
    else:
        qs, ks = (B, H, S, D), (B, Hkv, T, D)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
            for shape in (qs, ks, ks, qs)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,layout", KERNEL_EDGE_CASES)
def test_flash_kernel_matches_reference_on_card(B, S, T, H, Hkv, D, causal, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    q, k, v, _ = _kernel_inputs(B, S, T, H, Hkv, D, layout, seed=S + T + D)
    scale = D ** -0.5
    before = tattn.LAUNCHES["flash_fwd"]
    out, lse = tattn.flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)
    assert tattn.LAUNCHES["flash_fwd"] == before + 1
    ref_out, ref_lse = tattn.flash_forward_reference(q, k, v, causal=causal, scale=scale,
                                                     layout=layout)
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    # chip_smoke.py's limits, with their reasons there.
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    with pytest.raises(TypeError):
        tattn.flash_forward(q.float(), k.float(), v.float(), causal=True, scale=1.0,
                            layout=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,layout", KERNEL_EDGE_CASES)
def test_flash_backward_kernel_matches_reference_on_card(B, S, T, H, Hkv, D, causal, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    q, k, v, go = _kernel_inputs(B, S, T, H, Hkv, D, layout, seed=1 + S + T + D)
    scale = D ** -0.5
    out, lse = tattn.flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)
    before = tattn.LAUNCHES["flash_bwd"]
    grads = tattn.flash_backward(q, k, v, out, lse, go, causal=causal, scale=scale,
                                 layout=layout)
    assert tattn.LAUNCHES["flash_bwd"] == before + 1
    refs = tattn.flash_backward_reference(q, k, v, out, lse, go, causal=causal,
                                          scale=scale, layout=layout)
    again = tattn.flash_backward(q, k, v, out, lse, go, causal=causal, scale=scale,
                                 layout=layout)
    for got, ref, rerun in zip(grads, refs, again):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        # chip_smoke.py's limits, with their reasons there.
        torch.testing.assert_close(got.float(), ref.float(), atol=4e-3, rtol=2e-2)
        # With one key per row (S = T = 1) dq and dk are 0 up to rounding and
        # their ratio is noise; the per-element limit above holds them.
        if float(ref.float().norm()) >= 1.0:
            assert float((got.float() - ref.float()).norm() / ref.float().norm()) <= 1e-2
        assert torch.equal(got, rerun)  # no atomics: a rerun repeats bit for bit
    with pytest.raises(TypeError):
        tattn.flash_backward(q.float(), k.float(), v.float(), out.float(), lse, go.float(),
                             causal=True, scale=1.0, layout=layout)


# The custom ops' registration: schema, autograd and fake (meta) kernels.
_OPCHECK_CPU = ("test_schema", "test_autograd_registration", "test_faketensor")


def _op_inputs(layout, device, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    B, H, Hkv, S, D = 2, 4, 2, 80, 64
    qs, ks = ((B, S, H, D), (B, S, Hkv, D)) if layout == "bshd" else ((B, H, S, D), (B, Hkv, S, D))
    return [torch.randn(s, generator=g, device=device, dtype=dtype) for s in (qs, ks, ks, qs)]


def _opcheck(layout, device, dtype, test_utils):
    q, k, v, go = _op_inputs(layout, device, dtype)
    scale = q.shape[-1] ** -0.5
    kw = {} if test_utils is None else {"test_utils": test_utils}
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_fwd,
                          (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
                           True, scale, layout), **kw)
    out, lse = tattn.flash_forward(q.detach(), k.detach(), v.detach(), causal=True,
                                   scale=scale, layout=layout)
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_bwd,
                          (q.detach(), k.detach(), v.detach(), out, lse, go, True, scale,
                           layout), **kw)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_custom_ops_registration(layout):
    """The plain versions behind the ops on the CPU (f32); opcheck's AOT
    dispatch check, slow to start, runs in the card's test below."""
    _opcheck(layout, "cpu", torch.float32, _OPCHECK_CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_custom_ops_registration_on_card(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 and K2 kernels have no CPU mode")
    _opcheck(layout, "cuda", torch.bfloat16, None)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,k1_per_layer", [("full", 2), ("attn", 2), ("dots", 2),
                                                 ("selective", 1)])
def test_remat_policy_kernel_launches_on_card(policy, k1_per_layer):
    """A 2-layer bf16 model (head_dim 64) takes one step's gradient under
    each remat policy: K2 launches once per layer, K1 twice (its forward
    reruns in the backward pass) except under "selective", which keeps its
    outputs; the gradients are the "full" policy's (the embedding's summed
    with atomics, so 1e-5 relative rather than bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 and K2 kernels have no CPU mode")
    from ray_tpu_torch.models import transformer as ttr

    def grads(pol):
        cfg = ttr.ModelConfig(vocab_size=512, hidden=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, mlp_dim=512, max_seq=256, remat=True,
                              remat_policy=pol, tie_embeddings=True)
        model = ttr.Transformer(cfg, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.randint(0, 512, (2, 192), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
        tattn.LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        loss = ttr.cross_entropy_loss(model(tokens), tokens)
        loss.backward()
        torch.cuda.synchronize()
        return dict(tattn.LAUNCHES), {n: p.grad for n, p in model.named_parameters()}

    launches, got = grads(policy)
    assert launches == {"flash_fwd": 2 * k1_per_layer, "flash_bwd": 2}
    _, ref = grads("full")
    for name, g in got.items():
        rel = float((g.float() - ref[name].float()).norm() / ref[name].float().norm())
        assert rel <= 1e-5, (name, rel)
