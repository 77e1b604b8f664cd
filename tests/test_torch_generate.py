"""ray_tpu_torch's guided decoding against ray_tpu's, on the CPU.

The copied constraint compiler must give JAX's masks along a walk of every
spec of `tests/test_llm_generate.py` (regex, JSON schema, grammar, an
unbounded quantifier under budget steering). The engines (test-tiny, f32,
the same JAX-initialized weights, `decode_loop=False`, stepped by hand as
the stepper runs a plan) must emit the same guided greedy tokens, each
output valid under its spec; a constraint that allows every byte must leave
greedy decoding as it was. Every constraint state is released on finish,
cancel (queued, prefilling, decoding), shutdown and stepper death.
"""

import asyncio
import json
import os
import pickle
import re

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
from ray_tpu_torch.llm.generate import (
    ConstraintCompiler,
    compile_constraint,
    grammar_to_regex,
)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
          "required": ["ok", "n"]}
RULES = {"root": "<word>(,<word>){0,2}", "word": "[a-z]{2,4}"}
SPECS = {"regex": "[0-9]{4}", "schema": {"json_schema": SCHEMA},
         "grammar": {"grammar": RULES}, "unbounded": "a{1,50}b", "any": "(.|\n)*"}
VOCAB = 256  # test-tiny's logits width


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _port_engine(tree, **kw):
    cfg = get_config("test-tiny")
    kw = {"num_slots": 2, "max_seq": 128, "decode_loop": False, "multi_step": 1,
          "prefix_cache": False, **kw}
    return DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(weights):
    """One JAX and one port engine for the module, requests run one after
    another (the JAX engine's compiles are the module's main cost)."""
    jcfg, params, tree = weights
    jeng = JEngine(jcfg, params, num_slots=2, max_seq=128, decode_loop=False,
                   multi_step=1, prefix_cache=False)
    teng = _port_engine(tree)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _step(engine):
    """One iteration of the stepper's loop: cancels, then the plan's chunks,
    verify round and decode round."""
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


def _run(engine, prompt, sampling, constraint=None):
    out, done = [], []
    engine.submit(list(prompt), sampling, lambda t, f: (out.append(t), f and done.append(1)),
                  constraint=constraint)
    for _ in range(300):
        if done:
            return [t for t in out if t >= 0]
        _step(engine)
    raise AssertionError("request did not finish in 300 iterations")


def _both(engines, spec, prompt, max_tokens):
    """(JAX's tokens, the port's) for one guided greedy request."""
    jeng, teng = engines
    jc = None if spec is None else jcompile(spec, JByteTokenizer(), VOCAB)
    tc = None if spec is None else compile_constraint(spec, ByteTokenizer(), VOCAB)
    return (_run(jeng, prompt, JSampling(max_tokens=max_tokens), jc),
            _run(teng, prompt, SamplingParams(max_tokens=max_tokens), tc))


@pytest.mark.parametrize("name", list(SPECS))
def test_compiled_masks_match_jax_along_a_walk(name):
    """Both compilers over ByteTokenizer: equal masks (with and without a
    stop token and a budget), proposal_masks, min_tokens_to_finish and
    completion flags at every state of a seeded walk through legal tokens."""
    spec = SPECS[name]
    jstate = jcompile(spec, JByteTokenizer(), VOCAB).begin("walk")
    tstate = compile_constraint(spec, ByteTokenizer(), VOCAB).begin("walk")
    rng = np.random.default_rng(3)
    for step in range(40):
        for stop, budget in ((None, None), (255, None), (255, 40 - step), (None, 3)):
            np.testing.assert_array_equal(tstate.mask(stop, budget=budget),
                                          jstate.mask(stop, budget=budget))
        assert tstate.min_tokens_to_finish() == jstate.min_tokens_to_finish()
        assert (tstate.is_complete(), tstate.is_accepting()) == (
            jstate.is_complete(), jstate.is_accepting())
        legal = np.flatnonzero(jstate.mask(None) == 0)
        if tstate.is_complete() or len(legal) == 0:
            break
        proposal = rng.choice(np.arange(VOCAB), 4).tolist()
        proposal[:2] = rng.choice(legal, 2).tolist()  # legal first, then anything
        for got, ref in zip(tstate.proposal_masks(proposal, 255, length=5, budget=9),
                            jstate.proposal_masks(proposal, 255, length=5, budget=9)):
            np.testing.assert_array_equal(got, ref)
        token = int(rng.choice(legal))
        assert tstate.allows(token) and jstate.allows(token)
        assert tstate.advance(token) == jstate.advance(token) is True
    assert step > 2


@pytest.mark.parametrize("name, prompt, max_tokens", [
    ("regex", b"ab", 16), ("schema", b"x", 48), ("grammar", b"q", 24),
    ("unbounded", b"go", 3), ("schema", b"x", 20),
], ids=["regex", "schema", "grammar", "budget-regex", "budget-schema"])
def test_guided_greedy_tokens_match_jax(engines, name, prompt, max_tokens):
    """Guided greedy tokens equal JAX's and are valid under the spec; the
    budget cases (max_tokens too small for the greedy path) end on a full
    match through budget steering."""
    ref, got = _both(engines, SPECS[name], prompt, max_tokens)
    assert got == ref
    text = ByteTokenizer().decode(got)
    if name == "schema":
        obj = json.loads(text)
        assert set(obj) == {"ok", "n"}
        assert isinstance(obj["ok"], bool) and isinstance(obj["n"], int)
    elif name == "grammar":
        assert re.fullmatch(grammar_to_regex(RULES), text), text
    else:
        assert re.fullmatch(SPECS[name], text), text
    if name == "regex":
        assert len(got) == 4  # the accepting dead-end finished the slot


def test_guided_identity_when_argmax_always_legal(engines):
    """A constraint that allows every byte adds 0 to every legal logit:
    guided greedy is token-identical to unconstrained greedy (and JAX's)."""
    ref, plain = _both(engines, None, b"hello", 8)
    jguided, guided = _both(engines, SPECS["any"], b"hello", 8)
    assert plain == ref == guided == jguided
    assert len(set(plain)) > 2  # not a degenerate chain


def test_constraint_vocab_mismatch_raises_and_compiler_caches(weights):
    teng = _port_engine(weights[2])
    try:
        bad = compile_constraint("[0-9]+", ByteTokenizer(), VOCAB + 64)
        with pytest.raises(ValueError, match="vocab"):
            teng.submit([1, 2], SamplingParams(max_tokens=4), lambda t, f: None,
                        constraint=bad)
        assert teng._sched.queue_depth() == 0
    finally:
        teng.shutdown()
    comp = ConstraintCompiler(ByteTokenizer(), VOCAB, capacity=2)
    a1 = comp.get({"regex": "[0-9]+"})
    assert comp.get({"regex": "[0-9]+"}) is a1  # an LRU hit skips the DFA build
    comp.get({"regex": "[a-z]+"})
    comp.get({"regex": "[A-Z]+"})  # evicts the oldest entry
    assert comp.get({"regex": "[0-9]+"}) is not a1
    assert ConstraintCompiler(ByteTokenizer(), VOCAB)._capacity == 32  # the config row


class _Tracked:
    """A compiled constraint that keeps every state it begins."""

    def __init__(self, spec):
        self._c = compile_constraint(spec, ByteTokenizer(), VOCAB)
        self.vocab = self._c.vocab
        self.states = []

    def begin(self, request_id=""):
        self.states.append(self._c.begin(request_id))
        return self.states[-1]


def _submit(engine, rid, constraint, prompt=(1, 2, 3), max_tokens=40):
    events = []
    engine.submit(list(prompt), SamplingParams(max_tokens=max_tokens),
                  lambda t, f: events.append((t, f)), request_id=rid,
                  constraint=constraint)
    return events


def test_constraint_state_released_on_every_end_of_life_path(weights):
    """finish, cancel while queued, cancel mid-prefill (a 40-token prompt
    in 16-token chunks), cancel while decoding, and shutdown of an active
    slot and of a queued request: every state is released once, each
    cancelled caller sees (-1, True) and its record retires as cancelled."""
    teng = _port_engine(weights[2], token_budget=16)
    c = _Tracked("[0-9]{64}")
    try:
        done = _run(teng, [5, 6], SamplingParams(max_tokens=3), c)
        assert len(done) == 3 and c.states[-1].released  # finish (max_tokens)

        queued = _submit(teng, "queued", c)
        assert not c.states[-1].released
        teng.cancel("queued")
        assert c.states[-1].released and queued == [(-1, True)]

        prefilling = _submit(teng, "prefilling", c, prompt=range(1, 41))
        _step(teng)  # admits, runs the first 16-token chunk
        assert teng._sched.stats()["prefilling"] == 1
        teng.cancel("prefilling")
        _step(teng)
        assert c.states[-1].released and prefilling == [(-1, True)]

        decoding = _submit(teng, "decoding", c)
        while not decoding:
            _step(teng)
        assert not c.states[-1].released
        teng.cancel("decoding")
        _step(teng)
        assert c.states[-1].released and decoding[-1] == (-1, True)
        assert not any(s.active for s in teng._sched.slots)
        assert teng.recorder_stats()["cancelled"] == 3

        active = _submit(teng, "active", c)
        while not active:
            _step(teng)
        waiting = _submit(teng, "waiting", c)
        open_states = c.states[-2:]
        assert not any(s.released for s in open_states)
    finally:
        teng.shutdown()
    assert all(s.released for s in c.states)
    assert active[-1] == (-1, True) and waiting == [(-1, True)]
    assert teng.recorder_stats()["live"] == 0


def test_constraint_state_released_when_the_stepper_dies(weights):
    """A decode round that raises kills the stepper loop: the active slot's
    state and the queued request's are released, both callers see
    (-1, True), and no record stays live."""
    teng = _port_engine(weights[2], num_slots=1)
    c = _Tracked("[0-9]{64}")
    try:
        active = _submit(teng, "active", c)
        while not active:
            _step(teng)
        waiting = _submit(teng, "waiting", c)

        def broken(decode_slots):
            raise RuntimeError("injected")

        teng._decode_round = broken
        with pytest.raises(RuntimeError, match="injected"):
            teng._loop()  # the stepper thread's body, run here
        assert len(c.states) == 2 and all(s.released for s in c.states)
        assert active[-1] == (-1, True) and waiting == [(-1, True)]
        assert teng.recorder_stats()["live"] == 0
        with pytest.raises(RuntimeError, match="stepper died"):
            _submit(teng, "after", c)
    finally:
        teng.shutdown()


def test_llm_server_generate_guided(weights, engines, tmp_path):
    """LLMServer.generate(guided=...) compiles through its ConstraintCompiler
    and serves JAX's guided tokens (the server's engine multi-steps and
    caches prefixes by default; neither changes a guided request)."""
    with open(os.path.join(tmp_path, "params.pkl"), "wb") as f:
        pickle.dump(weights[2], f)
    server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                 num_slots=2, max_seq=128, device="cpu"))
    guided = {"regex": "[a-z]{2,5}( [a-z]{2,5}){1,3}"}

    async def both():
        return await asyncio.gather(server.generate("say: ", max_tokens=24, guided=guided),
                                    server.generate("say: ", max_tokens=6))

    try:
        res, plain = asyncio.run(both())
    finally:
        asyncio.run(server.shutdown())
    ref, _ = _both(engines, guided, b"say: ", 24)
    assert res["token_ids"] == ref
    assert re.fullmatch(guided["regex"], res["text"]), res["text"]
    assert len(plain["token_ids"]) == 6
    assert server._constraints.get(guided) is server._constraints.get(dict(guided))
