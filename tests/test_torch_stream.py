"""ray_tpu_torch's token streams against ray_tpu's engine, on the CPU.

A streamed request is token-identical to a blocking one (the port's and
JAX's); `get(timeout)` on a drained stream raises `StreamClosed`; closing a
live stream cancels the request, frees its slot in the next scheduler
iteration and retires its record as cancelled, with its constraint state
released; a consumer that stops reading is shed at the buffer cap.
`LLMServer.generate_stream` yields `generate`'s text, and closing it after
3 tokens frees the slot. Engines are test-tiny in f32 on the same
JAX-initialized weights, stepped by hand (`decode_loop=False`) except
behind the server.
"""

import asyncio
import os
import pickle
import time

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
from ray_tpu_torch._config import CONFIG
from ray_tpu_torch.llm import ByteTokenizer, LLMConfig, LLMServer
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.generate import StreamClosed, TokenStream, compile_constraint
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _port_engine(tree, **kw):
    cfg = get_config("test-tiny")
    kw = {"num_slots": 2, "max_seq": 128, "decode_loop": False, "prefix_cache": False, **kw}
    return DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu", **kw)


def _step(engine):
    """One iteration of the stepper's loop: cancels, chunks, decode."""
    engine._process_cancels()
    with torch.inference_mode():
        plan = engine._sched.next_plan()
        for chunk in plan.chunks:
            engine._exec_chunk(chunk)
        if plan.decode_slots:
            if plan.multi_step > 1:
                engine._multi_round(plan.decode_slots, plan.multi_step)
            else:
                engine._decode_round(plan.decode_slots)


def _blocking(engine, prompt, sampling):
    out, done = [], []
    engine.submit(prompt, sampling, lambda t, f: (out.append(t), f and done.append(1)))
    while not done:
        _step(engine)
    return out


def _drive(engine, stream, limit=200):
    for _ in range(limit):
        if stream.finished:
            return
        _step(engine)
    raise AssertionError("stream did not finish")


def test_open_stream_matches_blocking_and_jax(weights):
    jcfg, params, tree = weights
    prompt = list(b"hi there")
    jeng = JEngine(jcfg, params, num_slots=2, max_seq=128, decode_loop=False,
                   prefix_cache=False)
    teng = _port_engine(tree)
    try:
        ref = _blocking(jeng, prompt, JSampling(max_tokens=8))
        blocking = _blocking(teng, prompt, SamplingParams(max_tokens=8))
        stream = teng.open_stream(prompt, SamplingParams(max_tokens=8))
        _drive(teng, stream)
        streamed = list(stream)  # iteration closes the stream at the end
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert streamed == blocking == ref
    assert len(set(ref)) > 2


def test_get_timeout_raises_stream_closed(weights):
    teng = _port_engine(weights[2])
    try:
        stream = teng.open_stream(list(b"x"), SamplingParams(max_tokens=2))
        try:
            with pytest.raises(StreamClosed):
                stream.get(timeout=0.05)  # nothing stepped yet
            _drive(teng, stream)
            got = [stream.get(timeout=0.1), stream.get(timeout=0.1)]
            assert [f for _, f in got] == [False, True]
            with pytest.raises(StreamClosed):
                stream.get(timeout=0.05)  # drained: nothing further arrives
        finally:
            stream.close()
        with pytest.raises(RuntimeError, match="on_token"):
            TokenStream(teng, "relay", on_token=lambda t, f: None).get(timeout=0.01)
    finally:
        teng.shutdown()


def test_mid_stream_close_cancels_and_frees_slot(weights):
    """close() on a live guided stream: the next iteration frees the slot,
    releases the constraint state and retires the record as cancelled."""
    teng = _port_engine(weights[2])
    constraint = compile_constraint("[0-9]{100}", ByteTokenizer(), 256)
    try:
        stream = teng.open_stream(list(b"stream"), SamplingParams(max_tokens=100),
                                  request_id="disconnect-me", constraint=constraint)
        while stream._q.qsize() < 3:
            _step(teng)
        toks = [stream.get(timeout=0.1)[0] for _ in range(3)]
        assert all(48 <= t <= 57 for t in toks)  # digits: the mask held
        state = teng._sched.slots[0].constraint
        stream.close()
        assert teng._sched.slots[0].active  # the cancel waits for the stepper
        _step(teng)
        assert not any(s.active for s in teng._sched.slots)
        assert state.released and teng._sched.slots[0].constraint is None
        assert stream.get(timeout=0.1) == (-1, True)
        st = teng.recorder_stats()
        assert st["cancelled"] == 1 and st["live"] == 0
        stream.close()  # idempotent
    finally:
        teng.shutdown()


def test_stalled_consumer_shed_at_buffer_cap(weights):
    teng = _port_engine(weights[2], multi_step=1)
    try:
        stream = teng.open_stream(list(b"y"), SamplingParams(max_tokens=100), buffer_cap=4)
        assert stream._buffer_cap == 4
        _drive(teng, stream)
        delivered = list(stream)
        assert 4 < len(delivered) < 100  # the 5th buffered token shed the request
        assert teng.recorder_stats()["cancelled"] == 1
        assert not any(s.active for s in teng._sched.slots)
        default = TokenStream(teng, "default")
        assert default._buffer_cap == CONFIG.llm_stream_buffer_tokens == 4096
        default.close()
    finally:
        teng.shutdown()


def test_generate_stream_matches_generate_and_close_frees_slot(weights, tmp_path):
    with open(os.path.join(tmp_path, "params.pkl"), "wb") as f:
        pickle.dump(weights[2], f)
    server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                 num_slots=2, max_seq=128, device="cpu"))
    eng = server._engine

    async def scenario():
        whole = await server.generate("hi", max_tokens=8)
        streamed = "".join([d async for d in server.generate_stream("hi", max_tokens=8)])
        gen = server.generate_stream("hello", max_tokens=100, request_id="closed")
        parts = [await gen.__anext__() for _ in range(3)]
        t0 = time.perf_counter()
        await gen.aclose()  # the client went away
        while any(s.active for s in eng._sched.slots) and time.perf_counter() - t0 < 30:
            await asyncio.sleep(0.005)
        return whole, streamed, parts

    try:
        whole, streamed, parts = asyncio.run(scenario())
    finally:
        asyncio.run(server.shutdown())
    assert streamed == whole["text"] and len(whole["token_ids"]) == 8
    assert len(parts) == 3 and all(parts)
    assert not any(s.active for s in eng._sched.slots)
    assert eng.recorder_stats()["cancelled"] == 1 and eng.recorder_stats()["live"] == 0
