"""ray_tpu_torch's speculative decoding against ray_tpu's, on the CPU.

The cases of `tests/test_llm_scheduler.py`'s spec section and
`tests/test_llm_generate.py`'s guided verify, on test-tiny in f32 with the
same JAX-initialized weights: each draft (ngram on repeated traffic, the
self-draft, an early-exit head) emits the plain engine's greedy tokens, and
the port's `scheduler_stats()["spec"]` equals JAX's engine's after the same
requests; several slots verify in one batched forward; a prefix-cache hit
stays spec-eligible; guided spec decoding equals guided plain decoding. A
model draft's whole-prompt prefill runs K1's wrapper (its plain version
here) once per draft layer and writes the rows the target wrote. Engines
run without a stepper thread (`decode_loop=False`) and are stepped by hand
as the stepper runs a plan; the JAX engines are built once per module.
"""

import asyncio
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import ByteTokenizer as JByteTokenizer
from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm.generate import compile_constraint as jcompile
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import ByteTokenizer, LLMConfig, LLMServer
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.generate import compile_constraint
from ray_tpu_torch.llm.kvcache import PrefixCacheManager
from ray_tpu_torch.llm.scheduler.spec import ModelDraft, NGramDraft, early_exit_draft
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config
from ray_tpu_torch.ops import attention as tattn

SPEC = {"ngram": {"method": "ngram", "num_spec_tokens": 8},
        "self": {"num_spec_tokens": 4},
        "early": {"draft_layers": 1, "num_spec_tokens": 4}}
KW = dict(num_slots=4, max_seq=128, decode_loop=False, multi_step=1, prefix_cache=False)
PROMPTS = [[5, 9, 17, 3], [8, 2, 44, 7, 19, 21, 6], [33, 11, 90]]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_engine(weights):
    """JAX engine per spec_config name (None = plain), built once."""
    jcfg, params, _ = weights
    built = {}

    def get(name):
        if name not in built:
            built[name] = JEngine(jcfg, params, spec_config=SPEC.get(name), **KW)
        return built[name]

    yield get
    for eng in built.values():
        eng.shutdown()


def _port_engine(tree, name=None, **kw):
    cfg = get_config("test-tiny")
    return DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
                        spec_config=SPEC.get(name), **{**KW, **kw})


def _step(engine):
    """One iteration of the stepper's loop: cancels, then the plan's chunks,
    verify round and decode round (the draft proposes inside next_plan)."""
    engine._process_cancels()
    with torch.inference_mode():
        plan = engine._sched.next_plan(draft=engine._draft)
        for chunk in plan.chunks:
            engine._exec_chunk(chunk)
        if plan.spec_slots:
            engine._spec_round(plan)
        if plan.decode_slots:
            if plan.multi_step > 1:
                engine._multi_round(plan.decode_slots, plan.multi_step)
            else:
                engine._decode_round(plan.decode_slots)
            if engine._draft is not None:
                for i in plan.decode_slots:
                    engine._draft.on_plain_decode(i)


def _run(engine, prompts, n, sampling_cls, constraint=None):
    """Greedy tokens of prompts submitted together."""
    outs = [[] for _ in prompts]
    for out, p in zip(outs, prompts):
        engine.submit(list(p), sampling_cls(max_tokens=n), lambda t, f, out=out: out.append(t),
                      constraint=constraint)
    for _ in range(400):
        if not any(s.active for s in engine._sched.slots) and engine._sched.queue_depth() == 0 \
                and not engine._sched.stats()["prefilling"]:
            return outs
        _step(engine)
    raise AssertionError("requests did not finish in 400 iterations")


def _spec_stats(engine):
    return engine.scheduler_stats()["spec"]


def test_ngram_repeat_traffic_matches_plain_and_jax_counters(weights, jax_engine):
    """The first request fills the continuation store, the repeat is
    proposed from it and accepted; both equal the plain engine's tokens,
    and every counter equals JAX's after the same two requests."""
    tree = weights[2]
    prompt = [5, 9, 17, 3, 42, 8, 7, 21]
    plain = _run(_port_engine(tree), [prompt], 24, SamplingParams)[0]
    teng, jeng = _port_engine(tree, "ngram"), jax_engine("ngram")
    first = _run(teng, [prompt], 24, SamplingParams)[0]
    accepted_first = _spec_stats(teng)["accepted_tokens"]
    repeat = _run(teng, [prompt], 24, SamplingParams)[0]
    ref = [_run(jeng, [prompt], 24, JSampling)[0] for _ in range(2)]
    assert first == repeat == plain == ref[0] == ref[1]
    got, want = _spec_stats(teng), _spec_stats(jeng)
    assert got == want
    assert set(got) == {"rounds", "proposed_tokens", "accepted_tokens", "emitted_tokens",
                        "accept_rate", "draft"}
    assert got["accepted_tokens"] > accepted_first and 0 < got["accept_rate"] <= 1
    assert got["draft"]["kind"] == "ngram" and isinstance(teng._draft, NGramDraft)


def test_self_draft_batched_verify_accepts_everything(weights, jax_engine):
    """Three slots speculate together through one batched gated verify per
    round; each stream equals the plain engine's, the self-draft accepts
    every proposal, and the counters equal JAX's."""
    tree = weights[2]
    plain = _run(_port_engine(tree), PROMPTS, 12, SamplingParams)
    teng, jeng = _port_engine(tree, "self"), jax_engine("self")
    got = _run(teng, PROMPTS, 12, SamplingParams)
    ref = _run(jeng, PROMPTS, 12, JSampling)
    assert got == plain == ref
    stats = _spec_stats(teng)
    assert stats == _spec_stats(jeng)
    assert stats["accepted_tokens"] == stats["proposed_tokens"] > 0
    assert teng.scheduler_stats()["spec_rounds"] == stats["rounds"]


def test_early_exit_draft_shares_target_tensors(weights, jax_engine):
    tree = weights[2]
    cfg = get_config("test-tiny")
    params = params_from_jax(tree, cfg, "cpu")
    d_cfg, d_params = early_exit_draft(cfg, params, 1)
    assert d_cfg.n_layers == 1 and set(d_params) == {"embedding", "final_norm", "layer_0",
                                                      "lm_head"}
    for key in d_params:
        assert d_params[key] is params[key]  # the same objects: no copy
    assert d_params["embedding"].data_ptr() == params["embedding"].data_ptr()
    with pytest.raises(ValueError, match="draft_layers"):
        early_exit_draft(cfg, params, cfg.n_layers)

    teng, jeng = _port_engine(tree, "early"), jax_engine("early")
    assert teng._draft.params["layer_0"] is teng.params["layer_0"]
    prompt = [5, 9, 17, 3]
    got = _run(teng, [prompt], 16, SamplingParams)
    assert got == _run(_port_engine(tree), [prompt], 16, SamplingParams)
    assert got == _run(jeng, [prompt], 16, JSampling)
    stats = _spec_stats(teng)
    assert stats == _spec_stats(jeng) and stats["rounds"] > 0
    assert stats["draft"]["draft_layers"] == 1


def test_external_draft_model_moves_to_the_engine_and_matches_plain(weights):
    """draft_cfg/draft_params plug another model (here test-tiny from
    another seed, handed over as its param tree): the engine keeps it as
    the draft's weights, and the output is the plain engine's."""
    cfg = get_config("test-tiny")
    other = JTransformer(jget_config("test-tiny")).init(jax.random.PRNGKey(7),
                                                        jnp.zeros((1, 8), jnp.int32))
    d_params = params_from_jax(jax.tree.map(np.asarray, unbox(other["params"])), cfg, "cpu")
    teng = DecodeEngine(cfg, params_from_jax(weights[2], cfg, "cpu"), device="cpu", **KW,
                        spec_config={"draft_cfg": cfg, "draft_params": d_params,
                                     "num_spec_tokens": 3})
    assert teng._draft.params["embedding"] is d_params["embedding"]
    got = _run(teng, PROMPTS[:2], 10, SamplingParams)
    assert got == _run(_port_engine(weights[2]), PROMPTS[:2], 10, SamplingParams)
    stats = _spec_stats(teng)
    assert stats["rounds"] > 0 and stats["draft"] == {"kind": "model", "k": 3,
                                                      "draft_layers": 2, "ready_slots": 0}


def test_spec_stays_eligible_after_prefix_cache_hit(weights):
    """A slot admitted through a prefix-cache hit (rows [0, 32) attached)
    still speculates: the draft prefills its own cache on the whole
    prompt."""
    tree = weights[2]
    prompt = np.random.default_rng(13).integers(0, 256, 40).tolist()
    expect = _run(_port_engine(tree), [prompt], 10, SamplingParams)[0]
    teng = _port_engine(tree, "self", prefix_cache=PrefixCacheManager(16, 8 << 20))
    cold = _run(teng, [prompt], 10, SamplingParams)[0]
    rounds_cold = _spec_stats(teng)["rounds"]
    warm = _run(teng, [prompt], 10, SamplingParams)[0]
    assert teng.last_prefill["offset"] == 32  # the hit really happened
    assert _spec_stats(teng)["rounds"] > rounds_cold > 0
    assert cold == warm == expect


def test_guided_spec_verify_matches_plain_guided(weights, jax_engine):
    """The verify's per-position masks compose as the host sampling row's:
    guided spec decoding equals guided plain decoding (and JAX's guided
    spec decoding), with proposals really verified."""
    tree = weights[2]
    spec = "[0-9]{6}"
    tc = compile_constraint(spec, ByteTokenizer(), 256)
    want = _run(_port_engine(tree), [b"n="], 12, SamplingParams, tc)[0]
    teng = _port_engine(tree, "self")
    masks = []
    verify = teng._spec_verify_batched

    def logged(tokens, lens, gate, constraint_mask):
        masks.append(constraint_mask)
        return verify(tokens, lens, gate, constraint_mask)

    teng._spec_verify_batched = logged
    got = _run(teng, [b"n="], 12, SamplingParams, tc)[0]
    ref = _run(jax_engine("self"), [b"n="], 12, JSampling,
               jcompile(spec, JByteTokenizer(), 256))[0]
    assert got == want == ref and len(got) == 6
    assert _spec_stats(teng)["proposed_tokens"] > 0
    assert masks and all(m is not None and m.shape == (4, 5, 256) for m in masks)
    assert teng._sched.slots[0].constraint is None  # released at the finish


def test_unguided_verify_adds_no_mask_and_matches_jax_argmax(weights, jax_engine):
    """_spec_verify_batched on the same pool state as JAX's: equal argmax
    [B, k+1] with a mask on one slot, the gate keeping slot 1's rows, and
    no mask passed for unguided rounds."""
    jcfg, params, tree = weights
    teng, jeng = _port_engine(tree), jax_engine(None)
    rng = np.random.default_rng(5)
    T = 128
    kv = [rng.standard_normal((4, T, 2, 16)).astype(np.float32) for _ in range(4)]
    with torch.no_grad():
        for i, (ck, cv) in enumerate(teng._caches):
            ck.copy_(torch.from_numpy(kv[2 * i]))
            cv.copy_(torch.from_numpy(kv[2 * i + 1]))
    jcaches = [(jnp.asarray(kv[2 * i]), jnp.asarray(kv[2 * i + 1])) for i in range(2)]
    tokens = rng.integers(0, 256, (4, 5))
    lens = np.array([10, 20, 30, 40])
    gate = np.array([True, False, True, True])
    cmask = np.zeros((4, 5, 256), np.float32)
    cmask[2, :, 100:] = -1e30
    got = teng._spec_verify_batched(torch.from_numpy(tokens), torch.from_numpy(lens),
                                    torch.from_numpy(gate), torch.from_numpy(cmask))
    ref, jcaches = jax.jit(jeng._spec_verify_batched)(
        params, None, jnp.zeros((4,), jnp.int32), jnp.asarray(tokens, jnp.int32), jcaches,
        jnp.asarray(lens, jnp.int32), jnp.asarray(gate), jnp.asarray(cmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[2] < 100).all()
    for (tk, tv), (jk, jv) in zip(teng._caches, jcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    assert torch.equal(teng._caches[0][0][1], torch.from_numpy(kv[0][1]))  # gate off
    unmasked = teng._spec_verify_batched(torch.from_numpy(tokens), torch.from_numpy(lens),
                                         torch.from_numpy(gate), None)
    assert torch.equal(unmasked[[0, 1, 3]], got[[0, 1, 3]])


@pytest.mark.parametrize("name, layers", [("self", 2), ("early", 1)])
def test_draft_prefill_runs_the_flash_op_once_per_draft_layer(weights, name, layers):
    """An admission runs K1's wrapper once per target layer (the engine's
    offset-0 chunk) and once per draft layer (the draft's whole-prompt
    prefill); the draft's rows [0, prompt) are the target's bit for bit
    (the same weights, the same route)."""
    teng = _port_engine(weights[2], name)
    assert isinstance(teng._draft, ModelDraft)
    prompt = list(range(3, 23))
    tattn.CALLS.update(flash_fwd=0, flash_bwd=0)
    teng.submit(prompt, SamplingParams(max_tokens=2), lambda t, f: None)
    _step(teng)  # one chunk: the whole prompt, then the draft's prefill
    assert tattn.CALLS == {"flash_fwd": 2 + layers, "flash_bwd": 0}
    for (tk, tv), (dk, dv) in zip(teng._caches, teng._draft.caches):
        assert torch.equal(dk[0, :20], tk[0, :20]) and torch.equal(dv[0, :20], tv[0, :20])
    tattn.CALLS.update(flash_fwd=0, flash_bwd=0)
    with torch.inference_mode():
        teng._draft.on_admit(1, prompt)
    assert tattn.CALLS["flash_fwd"] == layers
    assert teng._draft.stats()["ready_slots"] == 2


def test_llm_server_with_spec_config_and_lora_still_raises(weights, tmp_path):
    """LLMConfig.spec_config reaches the engine behind LLMServer: a repeat
    of a greedy request is proposed by the ngram draft and accepted, with
    the stepper thread's phase order (multi-step on). LoRA still raises."""
    with open(os.path.join(tmp_path, "params.pkl"), "wb") as f:
        pickle.dump(weights[2], f)
    server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                 num_slots=2, max_seq=128, device="cpu",
                                 spec_config={"method": "ngram", "num_spec_tokens": 6}))

    async def twice():
        return [await server.generate("repeat me", max_tokens=20) for _ in range(2)]

    try:
        first, second = asyncio.run(twice())
        stats = server._engine.scheduler_stats()["spec"]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            server._engine.submit([1], SamplingParams(), lambda t, f: None, lora="a")
    finally:
        asyncio.run(server.shutdown())
    expect = _run(_port_engine(weights[2]), [list(b"repeat me")], 20, SamplingParams)[0]
    assert first["token_ids"] == second["token_ids"] == expect
    assert stats["accepted_tokens"] > 0 and stats["draft"]["k"] == 6
