"""ray_tpu_torch's in-process PD handoff against ray_tpu's, on the CPU.

PD is prefill/decode disaggregation: one engine prefills a prompt without
holding a decode slot (`prefill_detached`), a second admits the request from
the transferred KV rows and first logits (`submit_prefilled`, attached by
its stepper in `_exec_attach`). The engines (test-tiny, f32, the same
JAX-initialized weights, `decode_loop=False`, stepped by hand as the stepper
runs a plan) must give: a pair's greedy tokens equal to one engine's and to
JAX's pair and mono engine (the case of `tests/test_llm.py`); detached
logits and KV rows [0, prompt_len) equal to JAX's at 1e-5, with and without
a LoRA adapter, cold and on a prefix-cache hit (suffix-only, equal to the
cold rows); a guided first sample through the attach equal to a local
guided admission; JAX's errors, headroom clip, flight-recorder spans and
cache counters. The adapter pin must cover the detached forward and its
read-back. The engine's and server's remaining in-process surface
(`set_tenant_weight`, `autopilot_signals`, `model_id`, `cache_stats`,
`scheduler_stats`) is held against JAX's engine.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import ByteTokenizer as JByteTokenizer
from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm.generate import compile_constraint as jcompile
from ray_tpu.llm.kvcache import PrefixCacheManager as JManager
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import ByteTokenizer, LLMConfig, LLMServer
from ray_tpu_torch.llm import _engine as engine_mod
from ray_tpu_torch.llm import adapters
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.generate import compile_constraint
from ray_tpu_torch.llm.kvcache import PrefixCacheManager
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
T = 64
LORA = {"max_loras": 2, "rank": 4}
KW = dict(max_seq=T, decode_loop=False, multi_step=1, prefix_cache=False)
CACHE_BYTES = 16 * 2 * 2 * 16 * 2 * 16 * 4  # 16 blocks of test-tiny's f32 KV
RNG = np.random.default_rng(21)
PROMPTS = [RNG.integers(1, 256, n).tolist() for n in (6, 23, 40)]


@pytest.fixture(scope="module")
def weights():
    """test-tiny's flax param tree drawn with numpy from a seed, in the
    shapes `Transformer.init` gives (traced, not run: its compile is slower
    than every engine of this file): matrices normal / sqrt(fan-in), norm
    scales 1 + normal / 10. Returns (cfg, JAX's tree, numpy tree)."""
    jcfg = jget_config("test-tiny")
    shapes = unbox(jax.eval_shape(JTransformer(jcfg).init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1 + z / 10
        fan_in = np.prod(leaf.shape[:2]) if len(path) > 1 and path[-2].key == "o" else leaf.shape[0]
        return z / np.float32(np.sqrt(fan_in))

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jcfg, jax.tree.map(jnp.asarray, tree), tree


def _rows_close(got, ref):
    """KV rows in f32: 1e-5 of the rows' scale. An adapter of unit-normal
    factors grows v to |42| at test-tiny, and f32 rounding grows with it
    (3e-5 there, 3e-6 at the base model's |3.5|)."""
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()))


def _adapter(cfg, seed, rank=4):
    r = np.random.default_rng(seed)
    return {li: {"q_A": r.normal(size=(cfg.hidden, rank)).astype(np.float32),
                 "q_B": r.normal(size=(rank, cfg.n_heads * cfg.head_dim)).astype(np.float32),
                 "v_A": r.normal(size=(cfg.hidden, rank)).astype(np.float32),
                 "v_B": r.normal(size=(rank, cfg.n_kv_heads * cfg.head_dim)).astype(np.float32)}
            for li in range(cfg.n_layers)}


@pytest.fixture(scope="module")
def jax_engine(weights):
    """JAX engines built once per module, by name: "mono" and "dec" (2
    slots), "pre" (1 slot, the adapter "a0" registered) and "cache" (a
    prefix cache of 16 blocks)."""
    jcfg, params, _ = weights
    extra = {"mono": {"num_slots": 2}, "dec": {"num_slots": 2},
             "pre": {"num_slots": 1, "lora_config": LORA},
             "cache": {"num_slots": 1, "prefix_cache": JManager(16, CACHE_BYTES)}}
    built = {}

    def get(name):
        if name not in built:
            built[name] = JEngine(jcfg, params, **{**KW, **extra[name]})
            if name == "pre":
                built[name].add_lora("a0", _adapter(jcfg, 100), alpha=2.0)
        return built[name]

    yield get
    for eng in built.values():
        eng.shutdown()


def _port(tree, **kw):
    cfg = get_config("test-tiny")
    eng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
                       **{**KW, "num_slots": 2, **kw})
    if eng._adapters is not None:
        eng.add_lora("a0", _adapter(cfg, 100), alpha=2.0)
    return eng


def _step(engine):
    """One iteration of the stepper's loop: the plan's chunks (a transferred
    prefix's attach among them), then the decode round."""
    with torch.inference_mode():
        plan = engine._sched.next_plan(draft=engine._draft)
        for chunk in plan.chunks:
            engine._exec_chunk(chunk)
        if plan.spec_slots:
            engine._spec_round(plan)
        if plan.decode_slots:
            engine._decode_round(plan.decode_slots)
            if engine._draft is not None:
                for i in plan.decode_slots:
                    engine._draft.on_plain_decode(i)


def _drain(engine, outs):
    """Step until every request of outs (token lists, -1 at the end of a
    finished one's callbacks is kept out) has finished."""
    for _ in range(300):
        if all(done for _, done in outs):
            return [toks for toks, _ in outs]
        _step(engine)
    raise AssertionError("requests did not finish in 300 iterations")


def _collector():
    toks, done = [], []
    return (toks, done), lambda t, f: (t >= 0 and toks.append(t), f and done.append(1))


def _mono(engine, prompt, n, sampling=SamplingParams, constraint=None):
    out, cb = _collector()
    engine.submit(prompt, sampling(max_tokens=n), cb, constraint=constraint)
    return _drain(engine, [out])[0]


def _pair(pre, dec, prompts, n, sampling=SamplingParams, kv_form=None, **kw):
    """Every prompt prefilled on pre, then all submitted to dec at once."""
    outs = []
    for p in prompts:
        first, kv, plen = pre.prefill_detached(p)
        assert plen == len(p)
        if kv_form is not None:
            kv = kv_form(kv)
        out, cb = _collector()
        dec.submit_prefilled(kv, plen, first, sampling(max_tokens=n), cb, **kw)
        outs.append(out)
    return _drain(dec, outs)


@pytest.mark.parametrize("kv_form", ["tensor", "numpy"])
def test_pair_tokens_equal_mono_and_jax(weights, jax_engine, kv_form):
    """Three prompts (buckets 16, 32, 64) through a prefill engine and a
    2-slot decode engine (the third request waits for a slot): the greedy
    tokens equal one engine's, JAX's pair's and JAX's mono engine's, with
    the transferred rows as a host tensor or as numpy."""
    tree = weights[2]
    pre, dec, mono = _port(tree, num_slots=1), _port(tree), _port(tree)
    form = (lambda kv: kv.numpy()) if kv_form == "numpy" else None
    try:
        want = [_mono(mono, p, 6) for p in PROMPTS]
        got = _pair(pre, dec, PROMPTS, 6, kv_form=form)
        jmono, jdec = jax_engine("mono"), jax_engine("dec")
        jwant = [_mono(jmono, p, 6, JSampling) for p in PROMPTS]
        jgot = _pair(jax_engine("pre"), jdec, PROMPTS, 6, JSampling)
        assert got == want == jgot == jwant
        assert all(len(t) == 6 for t in got)
        assert len({t for toks in got for t in toks}) > 6  # not a degenerate chain
        assert pre._sched.stats()["admitted"] == 0  # no slot was taken
        assert dec._sched.stats()["prefill_chunks"] == 0  # attach only
        assert not any(s.active for s in dec._sched.slots)
    finally:
        for e in (pre, dec, mono):
            e.shutdown()


@pytest.mark.parametrize("lora", ["", "a0"], ids=["base", "lora"])
def test_detached_logits_and_rows_match_jax(weights, jax_engine, lora):
    """The cold detached prefill against JAX's from the same weights (and
    adapter): K1's wrapper once per layer, first logits at 1e-5, KV rows
    [0, prompt_len) at 1e-5 of their scale (`_rows_close`), the same
    prompt_len and last_prefill. The port returns exactly prompt_len rows;
    JAX's are padded to the bucket."""
    pre = _port(weights[2], num_slots=1, lora_config=LORA)
    jpre = jax_engine("pre")
    try:
        for p in (PROMPTS[0], PROMPTS[2]):
            tattn.CALLS.update(flash_fwd=0, flash_bwd=0)
            first, kv, plen = pre.prefill_detached(p, lora=lora)
            assert tattn.CALLS == {"flash_fwd": 2, "flash_bwd": 0}  # K1 in each layer
            jfirst, jkv, jplen = jpre.prefill_detached(p, lora=lora)
            assert plen == jplen == len(p)
            assert isinstance(first, np.ndarray) and first.dtype == np.float32
            assert tuple(kv.shape) == (2, 2, plen, 2, 16)
            np.testing.assert_allclose(first, jfirst, **TOL)
            _rows_close(kv.numpy(), np.asarray(jkv)[:, :, :plen])
            assert pre.last_prefill == jpre.last_prefill == {
                "offset": 0, "prompt_len": plen, "detached": True, "tier": "host"}
        assert pre.adapter_stats()["pinned"] == 0
    finally:
        pre.shutdown()


def test_suffix_on_a_hit_equals_cold_rows_and_jax(weights, jax_engine):
    """A cold 45-token prompt fills the cache with 2 blocks; a prompt with
    the same 40-token prefix then hits at 32 and prefills only its suffix
    (the prefix padded to bucket 32, the suffix in bucket 32) through the
    masked route, without K1. Its logits
    and rows equal an uncached engine's cold prefill at 1e-5 and JAX's hit,
    with the same last_prefill and cache counters."""
    tree = weights[2]
    cached = _port(tree, num_slots=1, prefix_cache=PrefixCacheManager(16, CACHE_BYTES))
    cold = _port(tree, num_slots=1)
    jcached = jax_engine("cache")
    prefix = RNG.integers(1, 256, 40).tolist()
    a, b = prefix + [7, 8, 9, 10, 11], prefix + list(range(30, 39))
    keys = ("hits", "misses", "hit_tokens", "inserted_blocks", "bytes_resident",
            "leases_active")
    try:
        for p, k1 in ((a, 2), (b, 0)):
            tattn.CALLS.update(flash_fwd=0, flash_bwd=0)
            first, kv, plen = cached.prefill_detached(p)
            assert tattn.CALLS["flash_fwd"] == k1  # the suffix takes the masked route
            jfirst, jkv, _ = jcached.prefill_detached(p)
            np.testing.assert_allclose(first, jfirst, **TOL)
            np.testing.assert_allclose(kv.numpy(), np.asarray(jkv)[:, :, :plen], **TOL)
            assert cached.last_prefill == jcached.last_prefill
            ts, js = cached.prefix_cache_stats(), jcached.prefix_cache_stats()
            assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert cached.last_prefill == {"offset": 32, "prompt_len": len(b), "detached": True,
                                       "tier": "host"}
        assert ts["hits"] == 1 and ts["inserted_blocks"] == 3 and ts["leases_active"] == 0
        cfirst, ckv, _ = cold.prefill_detached(b)
        np.testing.assert_allclose(first, cfirst, **TOL)
        np.testing.assert_allclose(kv.numpy(), ckv.numpy(), **TOL)
        assert cold.last_prefill["offset"] == 0
    finally:
        cached.shutdown()
        cold.shutdown()


def test_guided_first_sample_through_the_attach(weights, jax_engine):
    """A regex request decoded from a transferred prefix gets the start-state
    mask on its first sample: its tokens equal a local guided admission's
    and JAX's pair's, the text matches, and the constraint state is
    released."""
    tree = weights[2]
    pre, dec, mono = _port(tree, num_slots=1), _port(tree), _port(tree)
    prompt = list(b"ab")
    states = []
    tc = compile_constraint("[0-9]{4}", ByteTokenizer(), 256)

    class Tracked:
        vocab = tc.vocab

        def begin(self, rid=""):
            states.append(tc.begin(rid))
            return states[-1]

    try:
        local = _mono(mono, prompt, 16, constraint=tc)
        got = _pair(pre, dec, [prompt], 16, constraint=Tracked())[0]
        jc = jcompile("[0-9]{4}", JByteTokenizer(), 256)
        jgot = _pair(jax_engine("pre"), jax_engine("dec"), [prompt], 16, JSampling,
                     constraint=jc)[0]
        unguided = _mono(mono, prompt, 4)
        assert got == local == jgot
        assert bytes(got).decode().isdigit() and len(got) == 4
        assert unguided[0] != got[0]  # the mask moved the first sample
        assert len(states) == 1 and states[0].released
    finally:
        for e in (pre, dec, mono):
            e.shutdown()


def test_errors_and_headroom_clip_match_jax(weights, jax_engine):
    """prefill_detached refuses a prompt of max_seq tokens and submit_prefilled
    a prefix of max_seq rows (ValueError, as JAX's); a 60-row prefix clips
    max_tokens 10 to the 3 rows left, giving JAX's 3 tokens."""
    tree = weights[2]
    pre, dec = _port(tree, num_slots=1), _port(tree)
    jpre, jdec = jax_engine("pre"), jax_engine("dec")
    cb = lambda t, f: None  # noqa: E731
    try:
        for p, d, sampling in ((pre, dec, SamplingParams), (jpre, jdec, JSampling)):
            with pytest.raises(ValueError, match="max_seq"):
                p.prefill_detached(list(range(1, T + 1)))
            first, kv, plen = p.prefill_detached(list(range(1, T)))  # T - 1 fits
            assert plen == T - 1
            with pytest.raises(ValueError, match="max_seq"):
                d.submit_prefilled(kv, T, first, sampling(max_tokens=4), cb)
        prompt = RNG.integers(1, 256, 60).tolist()
        got = _pair(pre, dec, [prompt], 10)[0]
        jgot = _pair(jpre, jdec, [prompt], 10, JSampling)[0]
        assert got == jgot and len(got) == 3
    finally:
        pre.shutdown()
        dec.shutdown()


def test_spans_cache_feed_and_timing_match_jax(weights):
    """The prefill engine's record holds a `prefill-detached` span; the decode
    engine's a `pd-transfer` span of the given seconds, a `pd-attach` span
    (prompt_len, bucket, on_device) and `decode`, with JAX's phase names and
    counts. With token_ids the attached rows feed the decode engine's cache
    (2 blocks, as JAX's), and that prompt submitted locally then hits."""
    jcfg, params, tree = weights
    prompt = PROMPTS[2]
    phases = {}
    for side in ("jax", "port"):
        if side == "jax":
            kw = {**KW, "num_slots": 2}
            pre = JEngine(jcfg, params, **kw)
            dec = JEngine(jcfg, params, **{**kw, "prefix_cache": JManager(16, CACHE_BYTES)})
            sampling = JSampling
        else:
            pre = _port(tree)
            dec = _port(tree, prefix_cache=PrefixCacheManager(16, CACHE_BYTES))
            sampling = SamplingParams
        try:
            first, kv, plen = pre.prefill_detached(prompt, request_id="pf-0")
            out, cb = _collector()
            dec.submit_prefilled(kv, plen, first, sampling(max_tokens=4), cb,
                                 token_ids=prompt, request_id="pd-0", transfer_s=0.25)
            _drain(dec, [out])
            pf, pd = pre.request_timing("pf-0"), dec.request_timing("pd-0")
            phases[side] = ({k: v["count"] for k, v in pf["phases"].items()},
                            {k: v["count"] for k, v in pd["phases"].items()})
            assert pd["phases"]["pd-transfer"]["seconds"] == pytest.approx(0.25, abs=0.05)
            assert dec.prefix_cache_stats()["inserted_blocks"] == 2
            local = _mono(dec, prompt + [5], 2, sampling)
            assert dec.prefix_cache_stats()["hits"] == 1 and len(local) == 2
            if side == "port":
                attrs = next(a for name, _, _, a in dec._recorder.lookup("pd-0")["events"]
                             if name == "pd-attach")
                assert attrs == {"prompt_len": 40, "bucket": 64, "on_device": True}
        finally:
            pre.shutdown()
            dec.shutdown()
    assert phases["port"] == phases["jax"]
    assert phases["port"][0] == {"prefill-detached": 1}
    assert {"pd-transfer", "pd-attach", "decode"} <= set(phases["port"][1])


def test_adapter_pin_covers_the_forward_and_read_back(weights, monkeypatch):
    """A detached prefill under an adapter pins it (paging it in) for the
    whole forward and until both results are host copies, then releases it
    once; a failing forward releases it too and drops the record. Were the
    pin released before the read-back, the pinned count seen there would
    be 0."""
    pre = _port(weights[2], num_slots=1, lora_config={**LORA, "cache_slots": 1})
    seen = []
    forward, to_host, release = (engine_mod._forward_cached, engine_mod._to_host,
                                 adapters.AdapterHandle.release)

    def pinned():
        return pre.adapter_stats()["pinned"]

    monkeypatch.setattr(engine_mod, "_forward_cached",
                        lambda *a, **k: (seen.append(("forward", pinned())), forward(*a, **k))[1])
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda t: (seen.append(("read-back", pinned())), to_host(t))[1])
    monkeypatch.setattr(adapters.AdapterHandle, "release",
                        lambda h: (seen.append(("release", pinned())), release(h))[1])
    try:
        pre.prefill_detached(PROMPTS[1], lora="a0")
        assert seen == [("forward", 1), ("read-back", 1), ("read-back", 1), ("release", 1)]
        stats = pre.adapter_stats()
        assert stats["pinned"] == 0 and stats["page_ins"] == 1
        seen.clear()

        def broken(*a, **k):
            raise RuntimeError("injected")

        monkeypatch.setattr(engine_mod, "_forward_cached", broken)
        with pytest.raises(RuntimeError, match="injected"):
            pre.prefill_detached(PROMPTS[1], lora="a0", request_id="bad")
        assert seen == [("release", 1)] and pinned() == 0
        assert pre.recorder_stats()["dropped"] == 1
    finally:
        pre.shutdown()


def test_tenant_weights_and_autopilot_signals_match_jax(weights):
    """set_tenant_weight reaches the scheduler and autopilot_signals gives
    JAX's dict after the same calls on fresh engines: two tenants and the
    batch tenant queued (the batch tenant left out of the signals), one
    weight reshared, the batch floor not reshareable."""
    jcfg, params, tree = weights
    sigs = []
    for eng, sampling in ((JEngine(jcfg, params, **{**KW, "num_slots": 2}), JSampling),
                          (_port(tree), SamplingParams)):
        try:
            eng.set_tenant_weight("t1", 3.0)
            eng.set_tenant_weight("batch", 9.0)
            for i, tenant in enumerate(("t1", "t2", "batch", "t1")):
                eng.submit([1, 2, 3], sampling(max_tokens=2), lambda t, f: None,
                           tenant=tenant, request_id=f"r{i}")
            sigs.append(eng.autopilot_signals())
            tenants = eng.scheduler_stats()["tenants"]
            assert (tenants["t1"]["weight"], tenants["t2"]["weight"]) == (3.0, 1.0)
            assert tenants["batch"]["weight"] < 1e-3
        finally:
            eng.shutdown()
    assert sigs[1] == sigs[0]
    assert sigs[1]["queued"] == 3 and sigs[1]["tenant_weights"] == {"t1": 3.0, "t2": 1.0}


def test_server_surface():
    """LLMServer's model_id, cache_stats, scheduler_stats, set_tenant_weight
    and autopilot_signals answer from its engine."""
    server = LLMServer(LLMConfig(model_id="test-tiny", num_slots=2, max_seq=T, device="cpu"))

    async def drive():
        assert await server.set_tenant_weight("t1", 2.5) == 2.5
        out = await server.generate([1, 2, 3], max_tokens=2, tenant="t1")
        return (out, await server.model_id(), await server.cache_stats(),
                await server.scheduler_stats(), await server.autopilot_signals())

    try:
        out, model_id, cache, sched, signals = asyncio.run(drive())
    finally:
        asyncio.run(server.shutdown())
    assert model_id == "test-tiny" and len(out["token_ids"]) == 2
    assert cache == server._engine.prefix_cache_stats() and cache["misses"] == 1
    assert sched["admitted"] == 1 and "prefix_cache" in sched and "recorder" in sched
    assert signals["tenant_weights"]["t1"] == 2.5
    assert set(signals) == {"role", "queued", "running", "burn_rate", "tenant_burn",
                            "tenant_weights"}
