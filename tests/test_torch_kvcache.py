"""ray_tpu_torch's paged KV prefix cache against ray_tpu's, on the CPU.

The managers get the same call sequences (those of
`tests/test_llm_kvcache.py`: dedup, LRU that refuses ref-held blocks,
leaf-first unwind, namespaces) and must agree on every return value, every
`stats()` and every leased KV array, in f32 and in bf16 (one capacity then
holds the same blocks in both). The engines (test-tiny, f32, the same
JAX-initialized weights) are stepped by hand through one request sequence —
a cold prompt, a hit, a miss, an eviction, a hit on what survived — and
must agree on greedy tokens, `last_prefill`, the cache counters and the hit
slot's KV rows (1e-5).
"""

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm.kvcache import PrefixCacheManager as JManager
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.kvcache import PrefixCacheManager, RadixIndex
from ray_tpu_torch.llm.kvcache.manager import host_kv
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

TOL = dict(atol=1e-5, rtol=1e-5)
BS, LAYERS, HEADS, DIM = 4, 2, 2, 3


def _np(kv):
    """A leased KV array as numpy, bf16 as its 2-byte pattern."""
    if isinstance(kv, torch.Tensor):
        if kv.dtype == torch.bfloat16:
            return kv.view(torch.int16).numpy().view(np.uint16)
        return kv.numpy()
    kv = np.asarray(kv)
    return kv.view(np.uint16) if kv.dtype == ml_dtypes.bfloat16 else kv


def _kv_for(tokens, dtype):
    """Per-token KV rows [L, 2, len(tokens), H, D], so block content is
    checkable; numpy, as both managers take it."""
    return np.stack([np.full((LAYERS, 2, HEADS, DIM), t, np.float32) for t in tokens],
                    axis=2).astype(dtype)


def _dedup(mgr, kv, log):
    prefix = [1, 2, 3, 4, 5, 6, 7, 8]
    a, b = prefix + [10, 11, 12, 13], prefix + [20, 21, 22, 23]
    log(mgr.insert(a, kv(a)), mgr.insert(b, kv(b)), mgr.stats())
    for prompt in (a + [99], a):
        lease = mgr.lookup(prompt)
        log(lease.matched_tokens, _np(lease.kv()), mgr.stats()["leases_active"])
        lease.release()
    log(mgr.insert(a, kv(a)), mgr.stats())


def _lru_refuses_ref_held(mgr, kv, log):
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]
    log(mgr.insert(a, kv(a)))
    lease = mgr.lookup(a + [99])
    log(lease.matched_tokens, mgr.insert(b, kv(b)), mgr.stats())
    check = mgr.lookup(a + [99])
    log(check.matched_tokens, _np(check.kv()))
    check.release()
    lease.release()
    c = [30, 31, 32, 33, 34, 35, 36, 37]
    log(mgr.insert(c, kv(c)), mgr.stats(), mgr.lookup(b + [99]))


def _leaf_first_unwind(mgr, kv, log):
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]
    log(mgr.insert(a, kv(a)), mgr.insert(b, kv(b)), mgr.stats(),
        mgr.lookup(a + [99]))


def _namespaces(mgr, kv, log):
    tokens = [1, 2, 3, 4, 5, 6, 7, 8]
    mgr.insert(tokens, kv(tokens), namespace=0)
    log(mgr.lookup(tokens + [9], namespace=1))
    with mgr.lookup(tokens + [9], namespace=0) as lease:
        log(lease.matched_tokens, _np(lease.kv()))
    lease = mgr.lease_prefix(tokens, namespace=0)  # no len-1 cap
    log(lease.matched_tokens, mgr.stats())
    lease.release()
    log(mgr.stats())


# (sequence, capacity in blocks) — the cases of tests/test_llm_kvcache.py.
SEQUENCES = {"dedup": (_dedup, 16), "lru_refuses_ref_held": (_lru_refuses_ref_held, 3),
             "leaf_first_unwind": (_leaf_first_unwind, 2), "namespaces": (_namespaces, 8)}


class _ReadsMissing(PrefixCacheManager):
    """The port's manager with every insert() routed through
    insert_missing(), as the engine inserts, logging the blocks it reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reads = []

    def insert(self, token_ids, kv, namespace=0):
        kv = host_kv(kv)

        def read_blocks(first, stop):
            self.reads.append((first, stop))
            return [kv[:, :, i * BS:(i + 1) * BS].clone(memory_format=torch.contiguous_format)
                    for i in range(first, stop)]

        block_nbytes = kv[:, :, :BS].numel() * kv.element_size()
        return self.insert_missing(token_ids, read_blocks, block_nbytes, namespace)


# The blocks insert_missing reads in each sequence: only those the tree
# lacks and the capacity holds (in lru_refuses_ref_held one of b's two, since
# a's two are leased; in dedup the last insert reads none).
READS = {"dedup": [(0, 3), (2, 3)], "lru_refuses_ref_held": [(0, 2), (0, 1), (0, 2)],
         "leaf_first_unwind": [(0, 2), (0, 2)], "namespaces": [(0, 2)]}


@pytest.mark.parametrize("route", ["insert", "insert_missing"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_manager_matches_jax(name, dtype, route):
    seq, blocks = SEQUENCES[name]
    block_bytes = LAYERS * 2 * BS * HEADS * DIM * np.dtype(dtype).itemsize
    port = PrefixCacheManager if route == "insert" else _ReadsMissing
    logs, managers = [], []
    for cls in (JManager, port):
        log = []
        managers.append(cls(BS, blocks * block_bytes, name=name))
        seq(managers[-1], lambda tokens: _kv_for(tokens, dtype), lambda *xs: log.extend(xs))
        logs.append(log)
    ref, got = logs
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r
    # the sequences hold what test_llm_kvcache.py asserts of JAX's manager
    if name == "dedup":
        assert ref[:2] == [3, 1] and ref[-2] == 0
    elif name == "lru_refuses_ref_held":
        assert ref[-3] == 2 and ref[-2]["evicted_blocks"] == 2 and ref[-1] is None
        assert ref[2] == 1 and ref[3]["rejected_blocks"] == 1
    if route == "insert_missing":
        assert managers[1].reads == READS[name]


def test_insert_takes_a_cpu_tensor_and_refuses_other_devices():
    tokens = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    mgr = PrefixCacheManager(BS, 1 << 20)
    kv = torch.from_numpy(_kv_for(tokens, np.float32))
    assert mgr.insert(tokens, kv) == 2
    with mgr.lookup(tokens) as lease:
        assert torch.equal(lease.kv(), kv[:, :, :8])
    with pytest.raises(ValueError, match="host"):
        mgr.insert(tokens, kv.to("meta"))
    assert RadixIndex(BS).chunks(tokens) == [(1, 2, 3, 4), (5, 6, 7, 8)]


# -- engines -------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _block_bytes(cfg):
    return cfg.n_layers * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4  # f32


def _run(engine, prompt, max_tokens, step):
    """Greedy tokens of one prompt on an engine without a stepper thread:
    scheduler iterations run here until the request finishes."""
    out, done = [], []
    engine.submit(prompt, step.sampling(max_tokens=max_tokens),
                  lambda t, f: (out.append(t), f and done.append(1)))
    for _ in range(200):
        if done:
            return out
        step(engine)
    raise AssertionError("request did not finish in 200 iterations")


class _Step:
    """One scheduler iteration of a decode_loop=False engine: the chunks,
    then the decode phase (multi_step=1), as the stepper's loop runs it."""

    def __init__(self, sampling):
        self.sampling = sampling

    def __call__(self, engine):
        plan = engine._sched.next_plan()
        with torch.inference_mode():
            for chunk in plan.chunks:
                engine._exec_chunk(chunk)
            if plan.decode_slots:
                engine._decode_round(plan.decode_slots)


def test_engine_cache_matches_jax(weights):
    """cold -> hit -> miss that evicts -> hit on the surviving prefix, in a
    cache of 5 blocks: the same tokens, last_prefill, counters and KV rows."""
    jcfg, params, tree = weights
    cfg = get_config("test-tiny")
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 256, 40).tolist()  # 2 whole blocks + 8 tokens
    prompts = [prefix + rng.integers(1, 256, 5).tolist(),   # cold: inserts 2
               prefix + rng.integers(1, 256, 9).tolist(),   # hit at 32, inserts 1
               rng.integers(1, 256, 50).tolist(),           # miss, 3 blocks: evicts 1
               prefix + rng.integers(1, 256, 3).tolist()]   # hit at 32 again
    kw = dict(num_slots=2, max_seq=96, multi_step=1, decode_loop=False)
    cap = 5 * _block_bytes(cfg)
    jeng = JEngine(jcfg, params, prefix_cache=JManager(16, cap), **kw)
    teng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
                        prefix_cache=PrefixCacheManager(16, cap), **kw)
    keys = ("hits", "misses", "hit_tokens", "inserted_blocks", "evicted_blocks",
            "bytes_resident", "leases_active")
    try:
        for i, p in enumerate(prompts):
            ref = _run(jeng, p, 5, _Step(JSampling))
            got = _run(teng, p, 5, _Step(SamplingParams))
            assert got == ref, i
            assert teng.last_prefill == jeng.last_prefill, i
            js, ts = jeng.prefix_cache_stats(), teng.prefix_cache_stats()
            assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}, i
            if i in (1, 3):  # the hit's slot (0: one request at a time)
                assert teng.last_attach == jeng.last_attach == {
                    "tier": "host", "cached_tokens": 32}
                for (jk, jv), (tk, tv) in zip(jeng._caches, teng._caches):
                    np.testing.assert_allclose(tk[0, :len(p)].numpy(),
                                               np.asarray(jk)[0, :len(p)], **TOL)
                    np.testing.assert_allclose(tv[0, :len(p)].numpy(),
                                               np.asarray(jv)[0, :len(p)], **TOL)
        assert ts["evicted_blocks"] == 1 and ts["hits"] == 2 and ts["misses"] == 2
        assert teng.last_prefill["offset"] == 32
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_engine_reads_back_only_what_it_inserts(weights):
    """A cache of 3 blocks: a 5-block cold prompt (JAX inserts 3 and rejects
    2), a hit on those 3 whose new block has no room (rejected), then a miss
    that evicts 2. The same tokens and counters, rejected_blocks included,
    while the port reads back only the rows it inserts."""
    jcfg, params, tree = weights
    cfg = get_config("test-tiny")
    rng = np.random.default_rng(13)
    cold = rng.integers(1, 256, 83).tolist()
    prompts = [cold, cold[:48] + rng.integers(1, 256, 20).tolist(),
               rng.integers(1, 256, 40).tolist()]
    kw = dict(num_slots=2, max_seq=96, multi_step=1, decode_loop=False)
    cap = 3 * _block_bytes(cfg)
    jeng = JEngine(jcfg, params, prefix_cache=JManager(16, cap), **kw)
    teng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
                        prefix_cache=PrefixCacheManager(16, cap), **kw)
    reads, read_kv_blocks = [], teng._read_kv_blocks

    def logged(slot, first, stop):
        reads.append((first, stop))
        blocks = read_kv_blocks(slot, first, stop)
        assert all(b.is_contiguous() and b.untyped_storage().nbytes() == b.nbytes
                   for b in blocks)  # owned, as the pool accounts them
        return blocks

    teng._read_kv_blocks = logged
    keys = ("hits", "misses", "hit_tokens", "inserted_blocks", "evicted_blocks",
            "rejected_blocks", "bytes_resident", "blocks_resident", "leases_active")
    try:
        for i, p in enumerate(prompts):
            assert _run(teng, p, 3, _Step(SamplingParams)) == _run(jeng, p, 3, _Step(JSampling))
            js, ts = jeng.prefix_cache_stats(), teng.prefix_cache_stats()
            assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}, i
        assert (ts["inserted_blocks"], ts["rejected_blocks"], ts["evicted_blocks"]) == (5, 3, 2)
        assert reads == [(0, 3), (0, 2)]
    finally:
        jeng.shutdown()
        teng.shutdown()


def _generate(engine, prompt, n):
    out, done = [], threading.Event()

    def cb(tok, fin):
        out.append(tok)
        if fin:
            done.set()

    engine.submit(prompt, SamplingParams(max_tokens=n), cb)
    assert done.wait(30), engine.error
    return out


def test_default_engine_builds_the_flags_cache_and_cached_greedy_matches_uncached(weights):
    """DecodeEngine() builds a cache of llm_prefix_cache_bytes in blocks of
    llm_kv_block_size, as JAX's does; warm hits (suffix-only prefill) emit
    the uncached engine's greedy tokens (multi-step decode, stepper
    thread)."""
    jcfg, params, tree = weights
    cfg = get_config("test-tiny")
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 256, 40).tolist()
    prompts = [prefix + rng.integers(0, 256, k).tolist() for k in (5, 9, 2)]
    tparams = params_from_jax(tree, cfg, "cpu")
    plain = DecodeEngine(cfg, tparams, num_slots=2, max_seq=128, device="cpu",
                         prefix_cache=False)
    cached = DecodeEngine(cfg, tparams, num_slots=2, max_seq=128, device="cpu")
    jdefault = JEngine(jcfg, params, num_slots=2, max_seq=128, decode_loop=False)
    try:
        assert plain.prefix_cache_stats() is None
        js, ts = jdefault.prefix_cache_stats(), cached.prefix_cache_stats()
        assert ts == {**js, "hit_rate": ts["hit_rate"]}
        assert (ts["capacity_bytes"], ts["block_size"]) == (32 << 20, 16)
        expected = [_generate(plain, p, 6) for p in prompts]
        got = [_generate(cached, p, 6) for p in prompts]
        assert got == expected
        assert cached.last_prefill["offset"] == 32
        stats = cached.scheduler_stats()["prefix_cache"]
        assert stats["hits"] == 2 and stats["hit_tokens"] == 64
        assert stats["leases_active"] == 0
    finally:
        plain.shutdown()
        cached.shutdown()
        jdefault.shutdown()


def test_lease_released_when_attach_raises(weights):
    """A hit whose leased rows cannot be read kills the stepper; the lease is
    released (the finally in _exec_chunk), the caller is failed, and the
    dead engine refuses new work."""
    _, _, tree = weights
    cfg = get_config("test-tiny")
    mgr = PrefixCacheManager(16, 8 << 20)
    engine = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=2,
                          max_seq=128, device="cpu", prefix_cache=mgr)
    prompt = np.random.default_rng(5).integers(0, 256, 40).tolist()
    try:
        assert _generate(engine, prompt, 4)  # warm the cache
        real_get = mgr._pool.get
        mgr._pool.get = lambda bid: (_ for _ in ()).throw(RuntimeError("injected"))
        tokens, done = [], threading.Event()

        def cb(tok, fin):
            tokens.append(tok)
            if fin:
                done.set()

        try:
            engine.submit(prompt + [7], SamplingParams(max_tokens=4), cb)
            assert done.wait(30), "callback never fired after attach failure"
        finally:
            mgr._pool.get = real_get
        assert tokens[-1] == -1
        assert mgr.stats()["leases_active"] == 0
        assert engine._recorder.stats()["live"] == 0
        with pytest.raises(RuntimeError, match="stepper died"):
            engine.submit([1, 2, 3], SamplingParams(max_tokens=2), cb)
    finally:
        engine.shutdown()


def test_shutdown_releases_queued_leases(weights):
    """A hit admitted but never stepped holds its lease until shutdown, which
    releases it and fails the caller once."""
    _, _, tree = weights
    cfg = get_config("test-tiny")
    mgr = PrefixCacheManager(16, 8 << 20)
    engine = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=1,
                          max_seq=64, device="cpu", prefix_cache=mgr, decode_loop=False)
    prompt = list(range(1, 34))
    mgr.insert(prompt, torch.zeros(cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim))
    results = []
    engine.submit(prompt, SamplingParams(max_tokens=2),
                  lambda tok, fin: results.append((tok, fin)))
    engine._sched.next_plan()  # admission: the lookup leases 2 blocks
    assert mgr.stats()["leases_active"] == 1
    engine.shutdown()
    assert results == [(-1, True)]
    assert mgr.stats()["leases_active"] == 0
    assert engine.recorder_stats()["dropped"] == 1
    engine.shutdown()  # idempotent
    assert results == [(-1, True)]


def test_lease_and_insert_prefix(weights):
    _, _, tree = weights
    cfg = get_config("test-tiny")
    engine = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=1,
                          max_seq=64, device="cpu", decode_loop=False)
    try:
        tokens = list(range(1, 33))
        kv = np.random.default_rng(0).standard_normal(
            (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        assert engine.insert_prefix(tokens, kv) == 2
        lease = engine.lease_prefix(tokens)
        try:
            assert lease.matched_tokens == 32  # full coverage: no len-1 cap
            np.testing.assert_array_equal(lease.kv().numpy(), kv)
        finally:
            lease.release()
        assert engine.lease_prefix([9, 9, 9]) is None
        assert engine.prefix_cache_stats()["exports"] == 1
    finally:
        engine.shutdown()
