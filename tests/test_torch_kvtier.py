"""ray_tpu_torch's tiered prefix cache against ray_tpu's, on the CPU.

The tiers (`llm/kvcache/tiers.py`): a device hot tier above the host pool
and a disk spill tier below it. The spill store keeps JAX's atomic commit,
byte cap, content key and f32 file bytes (either package reads the other's
f32 spill), sweeps torn spills and reports a corrupt entry as a miss. Both
tiered managers, fed the call sequences of `tests/test_llm_kvtier.py`, must
agree on every lease tier, every leased row and every tier counter; a bf16
chain whose tail was spilled comes back bit for bit (JAX's store cannot
stitch it). A port engine and a JAX engine (test-tiny, f32, the same
weights, stepped by hand) run cold, host, device, evict-to-disk and disk
hits with the same tokens, the same tiers and an uncached engine's tokens.
Spills are asynchronous: every wait is a bounded poll of the spill counter.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm.kvcache.tiers import DiskSpillStore as JStore
from ray_tpu.llm.kvcache.tiers import TieredPrefixCacheManager as JTiered
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import _engine as engine_mod
from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.kvcache import (
    DiskSpillStore,
    PrefixCacheManager,
    TieredPrefixCacheManager,
)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

SHAPE = (2, 2, 2, 3)  # [L, 2, Hkv, D] of the managers' blocks (block size 4)
BLOCK_BYTES = 2 * 2 * 4 * 2 * 3 * 4  # f32


def _kv_for(tokens, dtype=np.float32):
    """Per-token rows [L, 2, len(tokens), Hkv, D], so block content is
    checkable; numpy, as both managers take it."""
    return np.stack([np.full(SHAPE, t, np.float32) for t in tokens], axis=2).astype(dtype)


def _np(kv):
    return kv.numpy() if isinstance(kv, torch.Tensor) else np.asarray(kv)


def _wait_spills(mgr, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while mgr.stats()["tiers"]["spills"] < n:
        if time.monotonic() > deadline:
            pytest.fail(f"{n} spills not written within {timeout} s: {mgr.stats()['tiers']}")
        time.sleep(0.01)


# -- the spill store -------------------------------------------------------------


def test_store_commit_is_atomic_and_abort_invisible(tmp_path):
    store = DiskSpillStore(str(tmp_path))
    kv = torch.arange(2 * 2 * 4 * 2 * 3, dtype=torch.float32).reshape(2, 2, 4, 2, 3)
    key = store.key(7, [1, 2, 3, 4])
    assert store.get(key) is None
    assert store.put(key, kv)
    assert torch.equal(store.get(key), kv)
    assert not store.put(key, kv)  # content addressing: a re-spill is a no-op
    f = store.open_spill(store.key(7, [9, 9, 9, 9]))
    f.write(b"partial garbage")
    f.close()
    assert store.get(store.key(7, [9, 9, 9, 9])) is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_store_byte_cap_unlinks_oldest(tmp_path):
    kv = torch.ones((2, 2, 4, 2, 3))
    store = DiskSpillStore(str(tmp_path), capacity_bytes=3 * (kv.nbytes + 256))
    keys = [store.key(0, [i, i, i, i]) for i in range(6)]
    for i, key in enumerate(keys):
        store.put(key, kv)
        os.utime(store._path(key), (i, i))  # deterministic LRU order
        store._evict_over_cap()
    live = [k for k in keys if store.contains(k)]
    assert len(live) <= 3
    assert keys[-1] in live and keys[0] not in live


def test_key_and_spill_files_cross_read(tmp_path):
    """The same key as JAX's; an f32 block spilled by either store is read by
    the other bit for bit (the files are byte-identical); a bf16 block JAX
    spilled is read back as bf16 by the port."""
    for ns, tokens in ((0, [1, 2, 3, 4]), (-3, list(range(16))), (2**40, [2**33, 5])):
        assert DiskSpillStore.key(ns, tokens) == JStore.key(ns, tokens)
    kv = np.random.default_rng(0).standard_normal((2, 2, 4, 2, 3)).astype(np.float32)
    port, ref = DiskSpillStore(str(tmp_path / "port")), JStore(str(tmp_path / "jax"))
    key = port.key(1, [5, 6, 7, 8])
    assert port.put(key, torch.from_numpy(kv)) and ref.put(key, kv)
    with open(port._path(key), "rb") as a, open(ref._path(key), "rb") as b:
        assert a.read() == b.read()
    swapped_port, swapped_ref = DiskSpillStore(ref.root), JStore(port.root)
    np.testing.assert_array_equal(swapped_port.get(key).numpy(), kv)
    np.testing.assert_array_equal(swapped_ref.get(key), kv)
    bf16 = kv.astype(ml_dtypes.bfloat16)
    bkey = port.key(1, [9, 9, 9, 9])
    assert ref.put(bkey, bf16)
    got = swapped_port.get(bkey)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), bf16.view(np.int16))


def test_torn_spill_swept_and_corrupt_entry_is_a_miss(tmp_path):
    """A writer killed between write and commit leaves a `*.tmp` orphan: the
    next open sweeps it and the entry is a miss. A truncated `.npy` (a torn
    hardware write) is a miss too, and get unlinks it; committed entries
    still load."""
    first = DiskSpillStore(str(tmp_path))
    kv = torch.ones((2, 2, 4, 2, 3))
    good, torn, bad = (first.key(0, t) for t in ([1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9]))
    assert first.put(good, kv) and first.put(bad, kv)
    with open(first._path(torn) + ".4242.tmp", "wb") as f:
        f.write(b"partial spill bytes, never committed")
    with open(first._path(bad), "r+b") as f:
        f.truncate(100)
    store = DiskSpillStore(str(tmp_path))  # restart: sweeps tmp orphans
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert torch.equal(store.get(good), kv)
    assert store.get(torn) is None
    assert store.get(bad) is None and not store.contains(bad)


# -- the managers against JAX's ------------------------------------------------------


def _roundtrip(mgr, kv, log):
    """tests/test_llm_kvtier.py:129: host hit (promotes), device hit, evict
    to disk, disk hit."""
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]
    log(mgr.insert(a, kv(a)))
    with mgr.lookup(a + [99]) as lease:
        log(lease.tier, _np(lease.kv()))
    with mgr.lookup(a + [99]) as lease:
        log(lease.tier, _np(mgr.device_kv(lease)))
    log(mgr.insert(b, kv(b)))
    _wait_spills(mgr, 1)
    with mgr.lookup(a + [99]) as lease:
        log(lease.tier, _np(lease.kv()))
    _wait_spills(mgr, 2)  # the promotion evicted b's tail


def _leased(mgr, kv, log):
    """tests/test_llm_kvtier.py:157: a leased chain is never evicted or
    spilled; released, the same pressure spills."""
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]
    log(mgr.insert(a, kv(a)))
    lease = mgr.lookup(a + [99])
    log(lease.matched_tokens, lease.tier, mgr.insert(b, kv(b)), mgr.stats())
    log(_np(lease.kv()))
    lease.release()
    c = [30, 31, 32, 33, 34, 35, 36, 37]
    log(mgr.insert(c, kv(c)))
    _wait_spills(mgr, 2)


def test_device_tier_defaults_to_cuda():
    """Without to_device the hot tier copies onto the current CUDA device,
    as JAX's device_put onto the default device: without a GPU it raises,
    as the port's entry points do."""
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only contract")
    with pytest.raises(RuntimeError, match="no GPU"):
        TieredPrefixCacheManager(4, 1 << 20, device_bytes=1 << 20)
    assert TieredPrefixCacheManager(4, 1 << 20)._to_device is None  # no hot tier


@pytest.mark.parametrize("name", ["roundtrip", "leased"])
def test_manager_matches_jax(name, tmp_path):
    seq = {"roundtrip": _roundtrip, "leased": _leased}[name]
    kw = dict(device_bytes=8 * BLOCK_BYTES if name == "roundtrip" else 4 * BLOCK_BYTES,
              spill_bytes=64 * BLOCK_BYTES)
    ref = JTiered(4, 3 * BLOCK_BYTES, spill_dir=str(tmp_path / "jax"), **kw)
    port = TieredPrefixCacheManager(4, 3 * BLOCK_BYTES, spill_dir=str(tmp_path / "port"),
                                    to_device=torch.clone, **kw)
    logs = ([], [])
    try:
        for mgr, out in zip((ref, port), logs):
            seq(mgr, _kv_for, lambda *a, out=out: out.append(a))
        for i, (r, g) in enumerate(zip(*logs)):
            for x, y in zip(r, g):
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(y, x, err_msg=str(i))
                else:
                    assert y == x, i
        js, ts = ref.stats(), port.stats()
        assert ts == {**js, "hit_rate": ts["hit_rate"]}
    finally:
        ref.close()
        port.close()
    tiers = ts["tiers"]
    if name == "roundtrip":  # what test_llm_kvtier.py asserts of JAX's manager
        assert [g[0] for g in logs[1][1:]] == ["host", "device", 2, "disk"]
        assert tiers["hits_device"] == 1 and tiers["hits_disk"] == 1
        assert tiers["promotions_host"] >= 1 and tiers["promotions_device"] >= 2
    else:
        assert logs[1][1][:3] == (8, "host", 1)
        assert logs[1][1][3]["evicted_blocks"] == 0
        assert logs[1][1][3]["tiers"]["spills"] == 0


def test_bf16_spilled_tail_promotes_back_bit_for_bit(tmp_path):
    """A bf16 chain with its head resident and its tail on disk (the case
    JAX's manager raises on: its store loads a bf16 block as void) comes
    back as bf16 with its exact bits, and serves a disk hit."""
    rng = np.random.default_rng(3)
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]
    rows = {t: rng.standard_normal(SHAPE).astype(np.float32) for t in a + b}

    def kv(tokens):
        arr = np.stack([rows[t] for t in tokens], axis=2)
        return torch.from_numpy(arr).to(torch.bfloat16)

    mgr = TieredPrefixCacheManager(4, 3 * BLOCK_BYTES // 2, spill_dir=str(tmp_path))
    try:
        assert mgr.insert(a, kv(a)) == 2
        assert mgr.insert(b, kv(b)) == 2  # spills a's tail
        _wait_spills(mgr, 1)
        assert mgr.stats()["blocks_resident"] == 3  # a's head stays
        with mgr.lookup(a + [99]) as lease:
            assert lease.tier == "disk" and lease.matched_tokens == 8
            got = lease.kv()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), kv(a).view(torch.int16))
        assert mgr.stats()["tiers"]["promotions_host"] == 1
    finally:
        mgr.close()


def test_insert_stages_copies_outside_manager_lock(tmp_path, monkeypatch):
    """An insert's block copies run with the manager lock NOT held, so a big
    insert cannot stall a concurrent lookup for the length of the copy."""
    mgr = TieredPrefixCacheManager(4, 64 * BLOCK_BYTES, device_bytes=8 * BLOCK_BYTES,
                                   to_device=torch.clone, spill_dir=str(tmp_path))
    locked_during_copy, staging = [], threading.Event()
    orig = PrefixCacheManager._stage_block

    def probe(self, kv, i):
        locked_during_copy.append(self._lock.locked())
        staging.set()
        time.sleep(0.05)  # a "big" copy: 0.2 s for 4 blocks
        return orig(self, kv, i)

    monkeypatch.setattr(PrefixCacheManager, "_stage_block", probe)
    warm = [100, 101, 102, 103]
    assert mgr.insert(warm, _kv_for(warm)) == 1
    staging.clear()
    locked_during_copy.clear()
    a = list(range(16))
    t = threading.Thread(target=lambda: mgr.insert(a, _kv_for(a)))
    t.start()
    try:
        assert staging.wait(10)
        t0 = time.monotonic()
        lease = mgr.lookup(warm + [99])  # must NOT wait out the staging
        lookup_s = time.monotonic() - t0
        assert lease is not None
        lease.release()
    finally:
        t.join(10)
        mgr.close()
    assert not t.is_alive()
    assert locked_during_copy and not any(locked_during_copy)
    assert lookup_s < 0.1, f"lookup stalled {lookup_s:.3f}s behind insert staging"


# -- engines -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """test-tiny's flax param tree drawn with numpy from a seed, in the
    shapes `Transformer.init` gives (traced, not run: its compile is slower
    than every engine of this file). Returns (cfg, JAX's tree, numpy tree)."""
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


def _engine_block_bytes(cfg):
    return cfg.n_layers * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4  # f32


def _step(engine):
    """One scheduler iteration of a decode_loop=False engine: the chunks,
    then the decode phase (multi_step=1), as the stepper's loop runs it."""
    with torch.inference_mode():
        plan = engine._sched.next_plan()
        for chunk in plan.chunks:
            engine._exec_chunk(chunk)
        if plan.decode_slots:
            engine._decode_round(plan.decode_slots)


def _run(engine, prompt, n, sampling, rid):
    out, done = [], []
    engine.submit(prompt, sampling(max_tokens=n),
                  lambda t, f: (t >= 0 and out.append(t), f and done.append(1)),
                  request_id=rid)
    for _ in range(200):
        if done:
            return out
        _step(engine)
    raise AssertionError(f"{rid} did not finish in 200 iterations")


def _tier_config(**flags):
    return dataclasses.replace(engine_mod.CONFIG, **flags)


def _attach_tiers(engine):
    return [attrs["tier"] for r in engine._recorder.records()
            for (name, _t0, _t1, attrs) in r["events"] if name == "cache-attach"]


def test_engine_tiers_match_jax_and_uncached(weights, tmp_path, monkeypatch):
    """tests/test_llm_kvtier.py:264's sequence on a cache of 2 blocks (a
    4-block device tier, a spill directory), the port's built from the
    flags: cold, host hit (promotes), device hit, a cold prompt that evicts
    and spills the first, disk hit. Every step's tokens equal JAX's and an
    uncached engine's; the attaches' tiers, spans and tier counters equal
    JAX's."""
    jcfg, params, tree = weights
    cfg = get_config("test-tiny")
    bb = _engine_block_bytes(cfg)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 40).tolist()
    p_a = prefix + [5, 6, 7]
    other = rng.integers(0, cfg.vocab_size, 40).tolist()
    kw = dict(num_slots=2, max_seq=128, multi_step=1, decode_loop=False)
    jmgr = JTiered(16, 2 * bb, name="equiv-tier", device_bytes=4 * bb,
                   spill_dir=str(tmp_path / "jax"))
    jeng = JEngine(jcfg, params, prefix_cache=jmgr, **kw)
    monkeypatch.setattr(engine_mod, "CONFIG", _tier_config(
        llm_prefix_cache_bytes=2 * bb, llm_kv_block_size=16, llm_kv_device_bytes=4 * bb,
        llm_kv_spill_dir=str(tmp_path / "port")))
    tparams = params_from_jax(tree, cfg, "cpu")
    teng = DecodeEngine(cfg, tparams, device="cpu", **kw)
    plain = DecodeEngine(cfg, tparams, device="cpu", prefix_cache=False, **kw)
    tmgr = teng._prefix_cache
    assert isinstance(tmgr, TieredPrefixCacheManager)
    steps = [("cold", p_a, None), ("host", p_a, "host"), ("device", p_a, "device"),
             ("other", other, None), ("disk", p_a, "disk")]
    try:
        for rid, prompt, tier in steps:
            if rid == "disk":  # p_a's two blocks were spilled by "other"
                _wait_spills(jmgr, 2)
                _wait_spills(tmgr, 2)
            ref = _run(jeng, prompt, 6, JSampling, rid)
            got = _run(teng, prompt, 6, SamplingParams, rid)
            assert got == ref == _run(plain, prompt, 6, SamplingParams, rid), rid
            if tier is not None:
                assert teng.last_attach == jeng.last_attach == {"tier": tier,
                                                                "cached_tokens": 32}
            assert teng.last_prefill == jeng.last_prefill, rid
        assert _attach_tiers(teng) == _attach_tiers(jeng) == ["host", "device", "disk"]
        _wait_spills(jmgr, 4)  # the disk promotion evicted other's blocks
        _wait_spills(tmgr, 4)
        js, ts = jeng.prefix_cache_stats(), teng.prefix_cache_stats()
        assert ts["tiers"] == js["tiers"]
        assert ts["tiers"]["hits_device"] == 1 and ts["tiers"]["hits_disk"] == 1
        assert teng.scheduler_stats()["prefix_cache"]["tiers"] == ts["tiers"]
        assert ts["leases_active"] == 0
    finally:
        jeng.shutdown()
        teng.shutdown()
        plain.shutdown()


@pytest.mark.parametrize("flags", ["device", "spill"])
def test_flags_build_the_tiered_cache(weights, tmp_path, monkeypatch, flags):
    """prefix_cache=None builds the tiered manager when either tier flag is
    set, with the engine's own to_device (the cache dtype on its device) and
    the flags' budgets."""
    _, _, tree = weights
    cfg = get_config("test-tiny")
    set_flags = ({"llm_kv_device_bytes": 3 << 20} if flags == "device"
                 else {"llm_kv_spill_dir": str(tmp_path), "llm_kv_spill_bytes": 5 << 20})
    monkeypatch.setattr(engine_mod, "CONFIG", _tier_config(**set_flags))
    eng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=1, max_seq=64,
                       device="cpu", decode_loop=False)
    try:
        mgr = eng._prefix_cache
        assert isinstance(mgr, TieredPrefixCacheManager)
        assert (mgr.block_size, mgr.stats()["capacity_bytes"]) == (16, 32 << 20)
        if flags == "device":
            assert mgr._device.capacity_bytes == 3 << 20 and mgr._disk is None
            assert mgr._to_device == eng._kv_block_to_device
            block = torch.zeros((2, 2, 16, 2, 16), dtype=torch.float64)
            assert eng._kv_block_to_device(block).dtype == cfg.dtype
        else:
            assert mgr._device is None
            assert mgr._disk.stats() == {"bytes_resident": 0, "capacity_bytes": 5 << 20,
                                         "root": str(tmp_path)}
        assert set(eng.prefix_cache_stats()["tiers"]) == set(
            JTiered(16, 1 << 20).stats()["tiers"])
    finally:
        eng.shutdown()


def test_insert_prefix_counts_remote_and_shutdown_writes_queued_spills(
        weights, tmp_path, monkeypatch):
    """insert_prefix lands as a remote insert; spills still queued when the
    engine shuts down are written before the spill worker stops."""
    _, _, tree = weights
    cfg = get_config("test-tiny")
    bb = _engine_block_bytes(cfg)
    monkeypatch.setattr(engine_mod, "CONFIG", _tier_config(
        llm_prefix_cache_bytes=2 * bb, llm_kv_spill_dir=str(tmp_path)))
    eng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=1, max_seq=64,
                       device="cpu", decode_loop=False)
    mgr = eng._prefix_cache
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    a, b = (rng.integers(0, 256, 32).tolist() for _ in range(2))
    gate = threading.Event()
    put = mgr._disk.put
    monkeypatch.setattr(mgr._disk, "put", lambda key, kv: gate.wait(10) and put(key, kv))
    assert eng.insert_prefix(a, rng.standard_normal(shape).astype(np.float32)) == 2
    assert eng.insert_prefix(b, rng.standard_normal(shape).astype(np.float32)) == 2
    tiers = mgr.stats()["tiers"]
    assert (tiers["remote_inserts"], tiers["remote_insert_tokens"]) == (2, 64)
    assert tiers["spills"] == 0 and tiers["spill_queued"] >= 1  # a's blocks wait
    worker = mgr._spill_thread
    gate.set()
    eng.shutdown()
    assert not worker.is_alive() and mgr._spill_thread is None
    tiers = mgr.stats()["tiers"]
    assert (tiers["spills"], tiers["spill_queued"]) == (2, 0)
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".npy")]) == 2


def test_device_lease_whose_copies_dropped_attaches_from_host(weights, monkeypatch):
    """A lease stamped "device" whose device copies are dropped before the
    attach (LRU pressure, eviction) is served from its host blocks and
    reported as a host attach, as JAX's engine reports it."""
    _, _, tree = weights
    cfg = get_config("test-tiny")
    monkeypatch.setattr(engine_mod, "CONFIG", _tier_config(llm_kv_device_bytes=8 << 20))
    eng = DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), num_slots=1, max_seq=64,
                       device="cpu", decode_loop=False)
    mgr = eng._prefix_cache
    tokens = np.random.default_rng(4).integers(0, 256, 33).tolist()
    rows = np.random.default_rng(5).standard_normal(
        (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    try:
        assert eng.insert_prefix(tokens[:32], rows) == 2
        mgr.lookup(tokens).release()  # a host hit: promotes both blocks
        with mgr.lookup(tokens) as lease:
            assert lease.tier == "device"
            kv, tier = eng._leased_kv(lease)
            assert tier == "device" and np.array_equal(kv.numpy(), rows)
            with mgr._lock:
                for bid in lease.block_ids:
                    mgr._device.drop(bid)
            kv, tier = eng._leased_kv(lease)
            assert tier == "host" and np.array_equal(kv.numpy(), rows)
    finally:
        eng.shutdown()
