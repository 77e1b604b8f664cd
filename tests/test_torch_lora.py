"""ray_tpu_torch's multi-LoRA serving against ray_tpu's, on the CPU.

The adapter caches get the same register/acquire/release calls and must
agree on every error (type and text), slot, `stats()` (apart from
`install_programs`, which the eager port cannot count) and table row (0
tolerance in f32). The delta and one attention layer with a LoRA layer agree
with JAX's at 1e-5 on both of the port's routes (K1's plain twin at offset
0, the masked route elsewhere). Engines (test-tiny, f32, the same
JAX-initialized weights, random adapters made with numpy) are stepped by
hand as the stepper runs a plan and give JAX's greedy tokens for a mixed
batch with chunked prefill and multi-step decode, an ngram-speculated
adapter request, prefix-cache traffic namespaced by adapter, 6 adapters
paged through 2 device slots and a request held back while every slot is
pinned. Pins are released on every end of a request, and `LLMServer`
serves through `load_lora`/`generate(lora=)`. The JAX engines are built
once per module.
"""

import asyncio
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import adapters as jadapters
from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm._engine import _attn_cached as jattn_cached
from ray_tpu.llm._engine import _lora_delta as jlora_delta
from ray_tpu.llm.kvcache import PrefixCacheManager as JManager
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import LLMConfig, LLMServer, UnknownAdapterError, adapters
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams, _attn_cached, _lora_delta
from ray_tpu_torch.llm.kvcache import PrefixCacheManager
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

TOL = dict(atol=1e-5, rtol=1e-5)
LORA = {"max_loras": 8, "rank": 4}
# Chunked prefill (one chunk of at most 32 tokens per iteration) and
# multi-step decode once nothing is prefilling or queued.
KW = dict(num_slots=3, max_seq=64, decode_loop=False, multi_step=4, token_budget=32,
          prefix_cache=False)
NAMES = [f"a{i}" for i in range(6)]
CACHE_BYTES = 64 * 2 * 2 * 16 * 2 * 16 * 4  # 64 blocks of test-tiny's f32 KV


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _adapter(cfg, seed, rank=4):
    """Random q/v factors on every layer, strong enough to move the argmax."""
    r = np.random.default_rng(seed)
    return {li: {"q_A": r.normal(size=(cfg.hidden, rank)).astype(np.float32),
                 "q_B": r.normal(size=(rank, cfg.n_heads * cfg.head_dim)).astype(np.float32),
                 "v_A": r.normal(size=(cfg.hidden, rank)).astype(np.float32),
                 "v_B": r.normal(size=(rank, cfg.n_kv_heads * cfg.head_dim)).astype(np.float32)}
            for li in range(cfg.n_layers)}


def _register(engine, cfg, names=NAMES):
    for i, name in enumerate(names):
        engine.add_lora(name, _adapter(cfg, 100 + i), alpha=2.0 + i)


@pytest.fixture(scope="module")
def jax_engine(weights):
    """JAX engine per name, built once with every adapter registered:
    "plain" (an unbounded table), "ngram" (with the ngram draft) and
    "cache" (with a prefix cache)."""
    jcfg, params, _ = weights
    extra = {"plain": {}, "ngram": {"spec_config": {"method": "ngram", "num_spec_tokens": 4}},
             "cache": {"prefix_cache": JManager(16, CACHE_BYTES)}}
    built = {}

    def get(name):
        if name not in built:
            built[name] = JEngine(jcfg, params, lora_config=LORA, **{**KW, **extra[name]})
            _register(built[name], jcfg)
        return built[name]

    yield get
    for eng in built.values():
        eng.shutdown()


def _port_engine(tree, lora_config=LORA, register=True, **kw):
    cfg = get_config("test-tiny")
    eng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
                       lora_config=lora_config, **{**KW, **kw})
    if register:
        _register(eng, cfg)
    return eng


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


def _serve(engine, reqs, n, sampling_cls, on_step=None):
    """Greedy tokens of (prompt, lora) requests submitted together."""
    outs, done = [[] for _ in reqs], []
    for out, (p, lora) in zip(outs, reqs):
        engine.submit(list(p), sampling_cls(max_tokens=n),
                      lambda t, f, out=out: (out.append(t), f and done.append(1)), lora=lora)
    for _ in range(400):
        if len(done) == len(reqs):
            return outs
        _step(engine)
        if on_step is not None:
            on_step(engine)
    raise AssertionError("requests did not finish in 400 iterations")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).tolist()


# -- the adapter cache ----------------------------------------------------------

CACHE_KW = dict(n_layers=2, hidden=8, q_out=8, v_out=4, rank=2, max_adapters=4, cache_slots=2)


def _factors(seed, rank=2, layers=(0, 1), keys=("q_A", "q_B", "v_A", "v_B")):
    r = np.random.default_rng(seed)
    shapes = {"q_A": (8, rank), "q_B": (rank, 8), "v_A": (8, rank), "v_B": (rank, 4)}
    return {li: {k: r.normal(size=shapes[k]).astype(np.float32) for k in keys} for li in layers}


def _cache_pair():
    return (jadapters.AdapterCache(dtype=jnp.float32, name="jax", **CACHE_KW),
            adapters.AdapterCache(dtype=torch.float32, name="port", device="cpu", **CACHE_KW))


BAD_REGISTERS = {
    "layer": {5: {"q_A": np.zeros((8, 2), np.float32)}},
    "dim": {0: {"q_A": np.zeros((9, 2), np.float32)}},
    "ndim": {0: {"q_A": np.zeros((8,), np.float32)}},
    "rank_mixed": {0: {"q_A": np.zeros((8, 2), np.float32), "q_B": np.zeros((1, 8), np.float32)}},
    "rank_bucket": {0: {"q_A": np.zeros((8, 4), np.float32)}},
    "capacity": None,  # a fifth adapter in a registry of 4
}


@pytest.mark.parametrize("case", list(BAD_REGISTERS))
def test_register_errors_match_jax(case):
    errors = []
    for cache in _cache_pair():
        if case == "capacity":
            for i in range(4):
                cache.register(f"ok{i}", _factors(i))
        with pytest.raises(ValueError) as err:
            cache.register("bad", BAD_REGISTERS[case] or _factors(9))
        errors.append(err.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])


def _stats(cache):
    s = dict(cache.stats())
    s.pop("install_programs")
    return s


def _rows_equal(jcache, tcache):
    for key, table in tcache.tables().items():
        ref = np.asarray(jcache.tables()[key])
        assert table.dtype == torch.float32 and table.shape == ref.shape, key
        np.testing.assert_array_equal(table.numpy(), ref, err_msg=key)


def test_cache_sequence_matches_jax():
    """register/acquire/try_acquire/release through 2 slots: the same uids,
    slots, errors, stats and residency, and after every page-in the same
    table rows, exactly."""
    logs = []
    jcache, tcache = _cache_pair()
    for cache, full_error in ((jcache, jadapters.AdapterCacheFullError),
                              (tcache, adapters.AdapterCacheFullError)):
        log = []
        log.append([cache.register(n, _factors(i, rank=1 + i % 2, layers=(i % 2,)), 1.5 + i)
                    for i, n in enumerate(("a", "b", "c"))])
        log.append(cache.register("a", _factors(7)))  # known name: its uid, no change
        ha, hb = cache.acquire("a"), cache.acquire(cache.uid_of("b"))
        log.append((ha.slot, hb.slot, cache.try_acquire("c"), _stats(cache)))
        with pytest.raises(full_error) as full:
            cache.acquire("c")
        log.append(str(full.value))
        ha.release()
        hc = cache.acquire("c")  # evicts the unpinned "a"
        log.append((hc.slot, cache.is_resident(cache.uid_of("a")), cache.resident_adapters(),
                    _stats(cache)))
        hb.release()
        hb.release()  # a second release does not unpin twice
        ha2, ha3 = cache.acquire("a"), cache.acquire("a")  # evicts "b", then a hit
        log.append((ha2.slot, ha3.slot, _stats(cache)))
        with cache.acquire(0) as base:
            log.append((base.slot, base.uid))
        for h in (hc, ha2, ha3):
            h.release()
        log.append(_stats(cache))
        with pytest.raises(KeyError) as unknown:
            cache.acquire("ghost")
        log.append((type(unknown.value).__name__, str(unknown.value)))
        logs.append(log)
    assert hb.released and ha2.released and not tcache.acquire(0).released
    assert logs[0] == logs[1]
    assert logs[1][-2]["pinned"] == 0 and logs[1][-2]["evictions"] == 2
    _rows_equal(jcache, tcache)


def test_page_in_rows_match_jax_after_each_install():
    jcache, tcache = _cache_pair()
    for cache in (jcache, tcache):
        for i in range(4):
            cache.register(f"x{i}", _factors(20 + i), alpha=4.0)
    for name in ("x0", "x1", "x2", "x3", "x1", "x0"):
        for cache in (jcache, tcache):
            cache.acquire(name).release()
        _rows_equal(jcache, tcache)
    assert _stats(jcache) == _stats(tcache)
    assert tcache.stats()["install_programs"] is None


# -- the math -------------------------------------------------------------------


def test_lora_delta_matches_jax():
    r = np.random.default_rng(0)
    x, A, B = (r.normal(size=s).astype(np.float32) for s in ((3, 5, 8), (3, 8, 4), (3, 4, 6)))
    scale = np.array([0.0, 0.5, 2.0], np.float32)
    ref = jlora_delta(*(jnp.asarray(a) for a in (x, A, B, scale)))
    got = _lora_delta(*(torch.from_numpy(a) for a in (x, A, B, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not got[0].any()  # the base row's delta is exactly zero


@pytest.mark.parametrize("route", ["masked", "k1"])
def test_attn_cached_with_lora_matches_jax(weights, route):
    """One attention layer, three slots on adapter rows [2, 0, 1] of a
    3-row table: the output and the KV rows it writes equal JAX's. "k1" is
    the offset-0 chunk (kv_mask None, K1's plain twin); JAX computes it
    with its causal mask over the chunk's own rows."""
    jcfg, params, tree = weights
    cfg = get_config("test-tiny")
    tlayer = params_from_jax(tree, cfg, "cpu")["layer_0"]["attn"]
    r = np.random.default_rng(3)
    B, S, T, M = 3, 6, 16, cfg.hidden
    q_out, v_out = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    table = {"q_A": r.normal(size=(3, M, 4)), "q_B": r.normal(size=(3, 4, q_out)),
             "v_A": r.normal(size=(3, M, 4)), "v_B": r.normal(size=(3, 4, v_out)),
             "scale": np.array([0.0, 0.5, 1.5])}
    table = {k: v.astype(np.float32) for k, v in table.items()}
    for k in ("q_A", "q_B", "v_A", "v_B"):
        table[k][0] = 0
    ids = np.array([2, 0, 1])
    x = r.normal(size=(B, S, M)).astype(np.float32)
    cache = r.normal(size=(2, B, T, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    lens = np.zeros(B, np.int64) if route == "k1" else np.array([3, 0, 7])
    pos = lens[:, None] + np.arange(S)[None]
    mask = np.arange(T)[None, None] <= pos[:, :, None]
    jout, jk, jv = jattn_cached(
        params["layer_0"]["attn"], jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cache[0]),
        jnp.asarray(cache[1]), jnp.asarray(lens), jnp.asarray(mask), jcfg,
        lora_layer={k: jnp.asarray(v) for k, v in table.items()}, adapter_ids=jnp.asarray(ids))
    ck, cv = torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy())
    tout = _attn_cached(tlayer, torch.from_numpy(x), torch.from_numpy(pos), ck, cv,
                        torch.from_numpy(lens), None if route == "k1" else torch.from_numpy(mask),
                        cfg, lora_layer={k: torch.from_numpy(v) for k, v in table.items()},
                        adapter_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jv), **TOL)
    plain = _attn_cached(tlayer, torch.from_numpy(x), torch.from_numpy(pos),
                         torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy()),
                         torch.from_numpy(lens), None if route == "k1" else torch.from_numpy(mask),
                         cfg)
    assert torch.equal(plain[1], tout[1])  # row 0 adds exactly nothing
    assert not torch.allclose(plain[0], tout[0])


# -- the engine -----------------------------------------------------------------


def test_mixed_batch_matches_jax(weights, jax_engine):
    """Base + two adapters in one batch, one prompt longer than a chunk (32
    + 8 tokens), decode and multi-step: JAX's tokens; the same prompt under
    an adapter differs from the base's; the engine without lora_config
    serves the base request's tokens."""
    long, short = _prompt(40, 1), _prompt(7, 2)
    reqs = [(long, ""), (short, "a0"), (long, "a1")]
    teng = _port_engine(weights[2])
    multi = []
    run_multi = teng._multi_round
    teng._multi_round = lambda slots, n: (multi.append(n), run_multi(slots, n))
    jeng = jax_engine("plain")
    chunks = jeng.scheduler_stats()["prefill_chunks"]
    got = _serve(teng, reqs, 10, SamplingParams)
    ref = _serve(jeng, reqs, 10, JSampling)
    assert got == ref and got[0] != got[2]
    chunks = jeng.scheduler_stats()["prefill_chunks"] - chunks
    assert multi and teng.scheduler_stats()["prefill_chunks"] == chunks > len(reqs)
    bare = _port_engine(weights[2], lora_config=None, register=False)
    assert _serve(bare, [(long, "")], 10, SamplingParams) == [got[0]]
    assert bare.adapter_stats() is None and "adapters" not in bare.scheduler_stats()
    stats = teng.scheduler_stats()["adapters"]
    assert stats["pinned"] == 0 and stats["misses"] == 2 and stats["page_ins"] == 2


def test_ngram_spec_on_an_adapter_request_matches_jax(weights, jax_engine):
    """An adapter request and its repeat through the ngram draft: the
    repeat's proposals are verified under the adapter and accepted; the
    tokens equal the plain engine's and JAX's, and the spec counters equal
    JAX's ngram engine's."""
    prompt = _prompt(12, 3)
    teng = _port_engine(weights[2], spec_config={"method": "ngram", "num_spec_tokens": 4})
    got = [_serve(teng, [(prompt, "a2")], 16, SamplingParams)[0] for _ in range(2)]
    jeng = jax_engine("ngram")
    before = dict(jeng._spec_counters)
    ref = [_serve(jeng, [(prompt, "a2")], 16, JSampling)[0] for _ in range(2)]
    plain = _serve(jax_engine("plain"), [(prompt, "a2")], 16, JSampling)[0]
    assert got[0] == got[1] == ref[0] == ref[1] == plain
    spec = teng.scheduler_stats()["spec"]
    assert spec["accepted_tokens"] > 0
    assert {k: spec[k] for k in before} == {k: jeng._spec_counters[k] - before[k]
                                            for k in before}


def test_prefix_cache_is_namespaced_by_adapter(weights, jax_engine):
    """The same 40-token prompt under a0 and under a1 shares no cached
    block; a repeat under a0 hits at 32. Tokens, last_prefill and the
    counters' increments equal JAX's."""
    prompt = _prompt(40, 4)
    teng = _port_engine(weights[2], prefix_cache=PrefixCacheManager(16, CACHE_BYTES))
    jeng = jax_engine("cache")
    keys = ("hits", "misses", "hit_tokens", "inserted_blocks")
    jbefore = {k: jeng.prefix_cache_stats()[k] for k in keys}
    for lora in ("a0", "a1", "a0"):
        got = _serve(teng, [(prompt, lora)], 6, SamplingParams)
        assert got == _serve(jeng, [(prompt, lora)], 6, JSampling), lora
        assert teng.last_prefill == jeng.last_prefill, lora
    stats = teng.prefix_cache_stats()
    assert {k: stats[k] for k in keys} == {
        k: jeng.prefix_cache_stats()[k] - jbefore[k] for k in keys}
    assert (stats["hits"], stats["misses"], stats["hit_tokens"]) == (1, 2, 32)
    assert teng.last_prefill["offset"] == 32
    # The engine's lease and insert name the adapter's namespace too.
    uid = teng._adapter_index("a0")
    lease = teng.lease_prefix(prompt, lora="a0")
    assert lease.matched_tokens == 32 and teng.lease_prefix(prompt, lora="a2") is None
    kv = lease.kv()
    lease.release()
    assert teng.insert_prefix(prompt[:32], kv, lora="a2") == 2
    with teng._prefix_cache.lookup(prompt, namespace=teng._adapter_index("a2")) as hit:
        assert hit.matched_tokens == 32 and uid != teng._adapter_index("a2")


def test_paging_through_two_slots_matches_unbounded_table(weights, jax_engine):
    """6 adapters through 2 device slots, three requests at a time (pages
    in, evictions and waits for a pin while other slots decode), then a hot
    pair twice: the tokens of an engine whose table holds all 6, and JAX's.
    The base request rides along unchanged."""
    reqs = [(_prompt(5 + 3 * i, 10 + i), name) for i, name in enumerate(NAMES)]
    reqs += [(_prompt(9, 30), ""), (reqs[4][0], "a4"), (reqs[5][0], "a5")] * 2
    paged = _port_engine(weights[2], lora_config={**LORA, "cache_slots": 2})
    unbounded = _port_engine(weights[2])
    got = [_serve(paged, reqs[i:i + 3], 6, SamplingParams) for i in range(0, len(reqs), 3)]
    want = [_serve(unbounded, reqs[i:i + 3], 6, SamplingParams) for i in range(0, len(reqs), 3)]
    ref = [_serve(jax_engine("plain"), reqs[i:i + 3], 6, JSampling)
           for i in range(0, len(reqs), 3)]
    assert got == want == ref
    stats = paged.adapter_stats()
    assert stats["slots"] == 2 and stats["resident"] == 2 and stats["pinned"] == 0
    assert stats["evictions"] >= 4 and stats["hits"] > 0 and stats["rejected_full"] > 0
    assert sorted(stats["resident_adapters"]) == ["a4", "a5"]
    assert unbounded.adapter_stats()["evictions"] == 0


def test_request_waits_while_every_slot_is_pinned(weights, jax_engine):
    """One device slot, two adapters' requests submitted together: the
    second stays queued (a free engine slot, no pin) until the first
    finishes, then is served; both give JAX's tokens."""
    prompt = _prompt(6, 5)
    teng = _port_engine(weights[2], lora_config={**LORA, "cache_slots": 1})
    held = []

    def watch(engine):
        active = sum(sl.active for sl in engine._sched.slots)
        held.append((engine._sched.queue_depth(), active, engine.adapter_stats()["pinned"]))

    got = _serve(teng, [(prompt, "a0"), (prompt, "a1")], 6, SamplingParams, on_step=watch)
    assert got == _serve(jax_engine("plain"), [(prompt, "a0"), (prompt, "a1")], 6, JSampling)
    assert (1, 1, 1) in held  # queued beside a free slot while the pin is held
    stats = teng.adapter_stats()
    assert stats["rejected_full"] > 0 and stats["evictions"] == 1 and stats["pinned"] == 0


def test_unknown_adapter_is_typed_at_submit(weights):
    teng = _port_engine(weights[2], register=False)
    bare = _port_engine(weights[2], lora_config=None, register=False)
    with pytest.raises(UnknownAdapterError, match="not registered") as err:
        teng.submit([1, 2], SamplingParams(), lambda t, f: None, lora="ghost")
    assert isinstance(err.value, KeyError) and not str(err.value).startswith("'")
    with pytest.raises(UnknownAdapterError, match="not registered"):
        teng.open_stream([1, 2], SamplingParams(), lora="ghost")
    with pytest.raises(UnknownAdapterError, match="without"):
        bare.submit([1], SamplingParams(), lambda t, f: None, lora="x")
    with pytest.raises(ValueError, match="without lora_config"):
        bare.add_lora("x", {})
    assert teng._sched.queue_depth() == 0 and teng._recorder.stats()["live"] == 0


@pytest.mark.parametrize("end", ["finish", "cancel_prefilling", "cancel_decoding",
                                 "shutdown"])
def test_pins_are_released_on_every_end(weights, end):
    """Three adapter requests on 2 device slots (one waits for a pin); the
    end under test applies to the first: its pin is released exactly once
    and, once every request has ended, no pin is left."""
    teng = _port_engine(weights[2], lora_config={**LORA, "cache_slots": 2})
    ends = []
    for i, name in enumerate(("a0", "a1", "a2")):
        teng.submit(_prompt(40 if i == 0 else 6, 40 + i), SamplingParams(max_tokens=5),
                    lambda t, f: f and ends.append(1), lora=name, request_id=f"r{i}")
    _step(teng)  # admits r0 and r1; r0 prefills its first chunk
    handle = next(r for r in teng._sched._prefilling if r.rid == "r0").adapter_handle
    if end == "cancel_prefilling":
        teng.cancel("r0")
    for _ in range(2 if end == "cancel_decoding" else 0):
        _step(teng)
    if end == "cancel_decoding":
        assert any(s.active and s.rid == "r0" for s in teng._sched.slots)
        teng.cancel("r0")
    if end == "shutdown":
        _step(teng)
        teng.shutdown()
    else:
        for _ in range(100):
            if len(ends) == 3:
                break
            _step(teng)
    assert handle.released and len(ends) == 3
    stats = teng.adapter_stats()
    assert stats["pinned"] == 0
    assert all(s.adapter_handle is None for s in teng._sched.slots)
    teng.shutdown()


def test_llm_server_load_lora_and_generate(weights, tmp_path):
    """LLMServer(lora_config) with load_lora: generate(lora=) and
    generate_stream(lora=) give the hand-stepped engine's tokens (stepper
    thread, multi-step on), and adapter_stats reports the page-in."""
    tree = weights[2]
    with open(os.path.join(tmp_path, "params.pkl"), "wb") as f:
        pickle.dump(tree, f)
    cfg = get_config("test-tiny")
    server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=str(tmp_path),
                                 num_slots=3, max_seq=64, device="cpu", lora_config=LORA))

    async def go():
        assert await server.load_lora("a3", _adapter(cfg, 103), alpha=5.0) == 1
        res = await server.generate("lora me", max_tokens=8, lora="a3")
        text = "".join([d async for d in server.generate_stream("lora me", max_tokens=8,
                                                                lora="a3")])
        for _ in range(200):  # the stepper unpins just after the last callback
            stats = await server.adapter_stats()
            if stats["pinned"] == 0:
                break
            await asyncio.sleep(0.01)
        return res, text, stats

    try:
        res, text, stats = asyncio.run(go())
    finally:
        asyncio.run(server.shutdown())
    eng = _port_engine(tree, register=False)
    eng.add_lora("a3", _adapter(cfg, 103), alpha=5.0)
    assert res["token_ids"] == _serve(eng, [(list(b"lora me"), "a3")], 8, SamplingParams)[0]
    assert text == res["text"] and res["timing"]["tokens"] == 8
    assert stats is not None and stats["page_ins"] == 1 and stats["pinned"] == 0
    assert stats["resident_adapters"] == ["a3"]
