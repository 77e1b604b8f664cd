"""ray_tpu_torch's DecodeEngine and LLMServer against ray_tpu's, on the CPU.

test-tiny in f32, the same JAX-initialized weights in both packages (the
port's through `params_from_jax`). On the CPU the port's offset-0 prefill
chunk runs K1's plain version; the JAX engine runs its plain masked
attention there. The two are the same function, so logits and KV rows agree
to 1e-5 and greedy decoding is token-identical.
"""

import asyncio
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import LLMConfig, LLMServer
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, jax params, numpy tree) of test-tiny from PRNGKey(1) — a
    seed whose greedy continuations are not degenerate."""
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _port_engine(tree, **kw):
    cfg = get_config("test-tiny")
    return DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu", **kw)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).tolist()


def test_prefill_chunks_match_jax(weights):
    """A 42-token prompt in slot 1: the offset-0 chunk (K1's route) and the
    following chunk at offset 32 give JAX's last-row logits and KV rows."""
    jcfg, params, tree = weights
    T, slot, prompt = 64, 1, _prompt(42, seed=0)
    jeng = JEngine(jcfg, params, num_slots=2, max_seq=T, decode_loop=False,
                   prefix_cache=False)
    teng = _port_engine(tree, num_slots=2, max_seq=T, decode_loop=False)
    try:
        jcaches = jeng._caches
        for offset, bucket in ((0, 32), (32, 16)):
            chunk = prompt[offset:offset + bucket]
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(chunk)] = chunk
            jlast, jcaches = jeng._prefill_at(
                params, None, jnp.asarray(padded), jcaches, jnp.int32(slot),
                jnp.int32(offset), jnp.int32(len(prompt)), jnp.int32(0))
            with torch.no_grad():
                tlast = teng._prefill_at(torch.from_numpy(padded.astype(np.int64)),
                                         slot, offset, len(prompt))
            if offset + bucket >= len(prompt):
                np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
            for (jk, jv), (tk, tv) in zip(jcaches, teng._caches):
                rows = slice(0, offset + bucket)
                np.testing.assert_allclose(tk[:, rows].numpy(), np.asarray(jk)[:, rows], **TOL)
                np.testing.assert_allclose(tv[:, rows].numpy(), np.asarray(jv)[:, rows], **TOL)
                assert not tk[0].any()  # slot 0 untouched
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_decode_write_gate_leaves_other_slots_untouched(weights):
    _, _, tree = weights
    teng = _port_engine(tree, num_slots=2, max_seq=32, decode_loop=False)
    with torch.no_grad():
        teng._prefill_at(torch.tensor([_prompt(16, seed=1)]), 0, 0, 16)
        teng._prefill_at(torch.tensor([_prompt(16, seed=2)]), 1, 0, 16)
        before = [(k.clone(), v.clone()) for k, v in teng._caches]
        teng._decode_step(torch.tensor([3, 4]), torch.tensor([16, 5]),
                          torch.tensor([True, False]))
    for (k0, v0), (k1, v1) in zip(before, teng._caches):
        assert torch.equal(k1[1], k0[1]) and torch.equal(v1[1], v0[1])
        assert not torch.equal(k1[0, 16], k0[0, 16])  # slot 0 wrote its row
        assert torch.equal(k1[0, :16], k0[0, :16])


def _run(engine, prompts, sampling):
    outs = {i: [] for i in range(len(prompts))}
    finished_ids = set()
    all_done = threading.Event()

    def cb_for(i):
        def cb(token, finished):  # runs on the stepper thread
            outs[i].append(token)
            if finished:
                finished_ids.add(i)
                if len(finished_ids) == len(prompts):
                    all_done.set()
        return cb

    for i, p in enumerate(prompts):
        engine.submit(p, sampling, cb_for(i))
    try:
        assert all_done.wait(timeout=120), "engine did not finish"
    finally:
        engine.shutdown()
    return [outs[i] for i in range(len(prompts))]


@pytest.mark.parametrize("multi_step", [1, 8])
def test_greedy_decode_token_identical_to_jax(weights, multi_step):
    """Two concurrent prompts, one longer than the 32-token budget (chunked
    prefill interleaved with the other's decode)."""
    jcfg, params, tree = weights
    prompts = [_prompt(50, seed=3), _prompt(12, seed=4)]
    kw = dict(num_slots=2, max_seq=96, token_budget=32, multi_step=multi_step)
    ref = _run(JEngine(jcfg, params, prefix_cache=False, **kw), prompts,
               JSampling(max_tokens=12))
    teng = _port_engine(tree, **kw)
    out = _run(teng, prompts, SamplingParams(max_tokens=12))
    assert all(len(set(r)) > 2 for r in ref), ref  # not a degenerate chain
    assert out == ref
    stats = teng.scheduler_stats()
    assert stats["prefill_chunks"] >= 3 and stats["interleaved_iterations"] >= 1


def test_llm_server_generate(weights, tmp_path):
    _, _, tree = weights
    with open(os.path.join(tmp_path, "params.pkl"), "wb") as f:
        pickle.dump(tree, f)
    server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                 num_slots=2, max_seq=64, device="cpu"))
    prompt = _prompt(20, seed=5)

    async def both():
        return await asyncio.gather(server.generate(prompt, max_tokens=6),
                                    server.generate("hi", max_tokens=3))

    try:
        res, res2 = asyncio.run(both())
    finally:
        asyncio.run(server.shutdown())
    assert res["usage"] == {"prompt_tokens": 20, "completion_tokens": 6,
                            "total_tokens": 26}
    assert res2["usage"]["prompt_tokens"] == 2 and len(res2["token_ids"]) == 3
    assert 0 <= res["ttft_s"] <= res["latency_s"]
    assert res["text"] == bytes(res["token_ids"]).decode("utf-8", errors="replace")
    ref = _run(_port_engine(tree, num_slots=2, max_seq=64), [prompt],
               SamplingParams(max_tokens=6))
    assert res["token_ids"] == ref[0]


@pytest.mark.parametrize("kw", [pytest.param({"tp": 2, "spec_config": {"draft_layers": 1}},
                                             id="kw3")])
def test_later_slice_features_raise(weights, kw):
    """A TP engine with a model draft ([7e]) raises before it needs a
    process group (tensor-parallel serving itself is tests/test_torch_tp.py)."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*\[7e\]"):
        _port_engine(weights[2], decode_loop=False, **kw)
