"""ray_tpu_torch's Transformer against ray_tpu's, on the CPU in f32.

The JAX model is initialized from a seed; its param tree goes through
`params_from_jax` (both the unscanned `layer_{i}` layout and the scanned
`layers` stacks) and both models score the same numpy tokens. Logits agree
to 1e-4: the two run the same f32 arithmetic in different summation orders,
and logits of this size (|logit| < ~5) carry ~1e-6 of f32 rounding per op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import Transformer, get_config, init_params

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_model(attention, scan_layers=False, seed=0):
    jcfg = jget_config("test-tiny", attention=attention, scan_layers=scan_layers)
    model = JTransformer(jcfg)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return model, variables


def _tokens(B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S), dtype=np.int64)


@pytest.mark.parametrize("attention", ["flash", "reference"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_logits_match_jax(attention, scan_layers):
    jmodel, variables = _jax_model(attention, scan_layers, seed=1)
    tokens = _tokens()
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(tokens, jnp.int32)))
    cfg = get_config("test-tiny", attention=attention)
    tree = jax.tree.map(np.asarray, unbox(variables["params"]))
    assert ("layers" in tree) == scan_layers
    model = Transformer(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and logits.shape == (2, 24, 256)
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


def test_kv_cache_route_matches_jax():
    """Prefill 8 tokens into per-layer caches, then one decode step."""
    jmodel, variables = _jax_model("reference", seed=2)
    jcfg = jmodel.cfg
    cfg = get_config("test-tiny")
    T, prompt = 16, _tokens(B=1, S=8, seed=3)
    shape = (1, T, jcfg.n_kv_heads, jcfg.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape), 0) for _ in range(jcfg.n_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape), 0) for _ in range(cfg.n_layers)]
    model = Transformer(cfg, params_from_jax(jax.tree.map(np.asarray, unbox(
        variables["params"])), cfg, "cpu"), device="cpu")
    pos = np.arange(8)[None]
    nxt = np.array([[7]])
    with torch.no_grad():
        for toks, p in ((prompt, pos), (nxt, pos[:, -1:] + 1)):
            jl, jcaches = jmodel.apply(variables, jnp.asarray(toks, jnp.int32),
                                       jnp.asarray(p, jnp.int32), kv_caches=jcaches)
            tl, tcaches = model(torch.from_numpy(toks), torch.from_numpy(p),
                                kv_caches=tcaches)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcaches[0][2] == 9
    np.testing.assert_allclose(tcaches[1][0].numpy(), np.asarray(jcaches[1][0]), **TOL)


def test_random_init_is_seeded_and_shaped():
    cfg = get_config("test-tiny")
    a = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a["layer_1"]["attn"]["o"]["kernel"], b["layer_1"]["attn"]["o"]["kernel"])
    assert a["layer_0"]["attn"]["q"]["kernel"].shape == (64, 4, 16)
    assert a["final_norm"]["scale"].dtype == torch.float32
    model = Transformer(cfg, a, device="cpu")
    tree = model.param_tree()
    assert tree["lm_head"]["kernel"].data_ptr() == model.lm_head.data_ptr()
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()


@pytest.mark.parametrize("overrides,match", [
    ({"attention": "ring"}, "item 7"), ({"attention": "ulysses"}, "item 7"),
    ({"moe_experts": 4}, "item 7"),
], ids=["ring", "ulysses", "moe"])
def test_later_slice_routes_raise(overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        Transformer(get_config("test-tiny", **overrides), device="cpu")
