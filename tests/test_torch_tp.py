"""ray_tpu_torch's tensor-parallel serving (`llm/tp.py`, `DecodeEngine(...,
tp=N)`) on gloo process groups, against ray_tpu's one-device engine and its
`param_spec`, on the CPU.

Two launches serve the whole file, started together: two worker processes
and four. The workers are this file run as a script (`python
tests/test_torch_tp.py worker <world> <rank> <dir>`); they import torch,
numpy and ray_tpu_torch only, rendezvous through a `FileStore` in the run's
directory, and are killed if a launch outlives LAUNCH_S. The JAX side runs
in the pytest process meanwhile: ray_tpu's tp=1 engine on every case the
ranks serve, which each rank 0's results are held against (a tp=1 engine of
the port beside them is a second witness). Every model is test-tiny in f32 with numpy
weights from a seed: "m4" (n_kv_heads=4), "m2" (n_kv_heads=2: at tp=4 the
kv heads replicate while q splits) and "m6" (hidden 96, 6 heads over 3 kv
heads: at tp=2 a rank's 3 query heads straddle two kv groups).

- Two ranks: m4 at tp=2 with the ngram draft on `tests/test_llm_tp.py`'s
  sweep prompts, and a prefill's logits; m6 against tp=1; 6 LoRA adapters
  through 2 slots against tp=1; a prefix-cache hit; the tiered prefix
  cache built from the flags and passed as an instance; `from_sharded_
  checkpoint(tp=2)` from a checkpoint JAX saved; `load_model` at tp=2; the
  [7e] refusals; a follower that raises.
- Four ranks: m4 at tp=4 with the ngram draft, per-rank bytes; m2 at tp=4
  against tp=1, its prefix-cache hit and the tiered prefix cache (kv heads
  replicated: every rank's hot-tier slice is the whole block).

The tiered cases replay `tests/test_llm_kvtier.py:264`'s sequence (cold,
host hit, device hit, a prompt whose insert spills the first, disk hit) on
a host pool of 2 blocks, a device tier of 4 and a spill directory, against
ray_tpu's tp=1 engine with the same manager; after every step rank 0 reads
every rank's hot-tier slices (`_hot_report`, an announced operation, so it
runs after every earlier one on each rank).
Each rank records its leaves' local shapes, its engines' shutdowns (twice)
and the modules it loaded.
"""

import fcntl
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAUNCH_S = 90
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
PROMPTS = [[5, 9, 17, 3], [8, 2, 44, 7, 19, 21, 6], [5, 9, 17, 3]]  # test_llm_tp.py's sweep
SPEC = {"method": "ngram", "num_spec_tokens": 4}
ENGINE = {"num_slots": 2, "max_seq": 64}
MODELS = {"m4": {"n_kv_heads": 4}, "m2": {}, "m6": {"hidden": 96, "n_heads": 6, "n_kv_heads": 3}}
PREFILL_PROMPT = np.random.default_rng(3).integers(1, 256, 42).tolist()
PREFILL_CHUNKS = ((0, 32), (32, 16))  # (offset, bucket), as test_torch_engine.py's
PREFIX_PROMPT = np.random.default_rng(4).integers(1, 256, 40).tolist()
LORA = {"max_loras": 8, "rank": 4, "cache_slots": 2}
LORA_PROMPT = [7, 21, 3, 9]
FOLLOWER_DEADLINE_S = 15.0
_TIER_RNG = np.random.default_rng(11)  # test_llm_kvtier.py's prompts
TIER_A = _TIER_RNG.integers(0, 256, 40).tolist() + [5, 6, 7]
TIER_B = _TIER_RNG.integers(0, 256, 40).tolist()
TIER_STEPS = (("cold", TIER_A), ("host", TIER_A), ("device", TIER_A), ("other", TIER_B),
              ("disk", TIER_A))
# (world, tag, model): m4's kv heads split at tp=2, m2's replicate at tp=4.
TIER_CASES = [(2, "tiers", "m4"), (2, "tiers_instance", "m4"), (4, "tiers", "m2")]
TIER_EVENTS = ("scatter_host", "_attach_kv", "_attach_hot", "_promote_hot")
SPILL_WAIT_S = 10.0


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (str(key),)))
        return out
    return {"/".join(prefix): tree}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return tree


def _weights(name: str) -> dict:
    """The flax param tree of MODELS[name] drawn with numpy from a seed, by
    path: matrices normal / sqrt(fan-in), norm scales 1 + normal / 10."""
    from ray_tpu_torch.models.transformer import get_config, param_shapes

    cfg = get_config("test-tiny", **MODELS[name])
    rng = np.random.default_rng(sorted(MODELS).index(name) + 1)
    out = {}
    for path, shape, init in param_shapes(cfg):
        z = rng.standard_normal(shape).astype(np.float32)
        fan_in = np.prod(shape[:2]) if path[-2:-1] == ("o",) else shape[0]
        out["/".join(path)] = 1 + z / 10 if init is None else z / np.float32(np.sqrt(fan_in))
    return out


def _tier_block_bytes(n_layers, n_kv_heads, head_dim) -> int:
    return n_layers * 2 * 16 * n_kv_heads * head_dim * 4  # a 16-row f32 block


def _wait_spills(stats, n: int) -> None:
    """Poll a tiered manager's stats until n spills are written (bounded)."""
    deadline = time.monotonic() + SPILL_WAIT_S
    while stats()["tiers"]["spills"] < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{n} spills not written: {stats()['tiers']}")
        time.sleep(0.005)


def _adapters(hidden, q_out, v_out) -> dict:
    rng = np.random.default_rng(7)

    def one(scale):
        return {0: {"q_A": rng.normal(size=(hidden, 4)).astype(np.float32) * scale,
                    "q_B": rng.normal(size=(4, q_out)).astype(np.float32),
                    "v_A": rng.normal(size=(hidden, 4)).astype(np.float32) * scale,
                    "v_B": rng.normal(size=(4, v_out)).astype(np.float32)}}

    return {f"a{i}": one(1.0 + i) for i in range(6)}


# ------------------------------------------------------------------ workers

def _generate(eng, prompt, n=12, lora=""):
    from ray_tpu_torch.llm._engine import SamplingParams

    acc, done = [], threading.Event()

    def cb(tok, fin):
        acc.append(tok)
        if fin:
            done.set()

    eng.submit(prompt, SamplingParams(max_tokens=n), cb, lora=lora)
    if not done.wait(30):
        raise TimeoutError(f"no answer to {prompt}: {acc}")
    return acc


class _Worker:
    def __init__(self, world: int, rank: int, root: pathlib.Path):
        import torch

        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.models.transformer import get_config

        self.world, self.rank, self.root = world, rank, root
        self.leader = rank == 0
        self.res: dict = {"rank": rank, "world": world, "shapes": {}, "shutdown": {}}
        inputs = np.load(root / "inputs.npz")
        self.cfg, self.params = {}, {}
        for name in MODELS:
            cfg = get_config("test-tiny", **MODELS[name])
            flat = {k.split(":", 1)[1]: inputs[k] for k in inputs.files if k.startswith(name + ":")}
            self.cfg[name] = cfg
            self.params[name] = params_from_jax(_nest(flat), cfg, "cpu")
        self.torch = torch

    def engine(self, name, tp=None, **kw):
        from ray_tpu_torch.llm._engine import DecodeEngine

        return DecodeEngine(self.cfg[name], self.params[name], tp=tp or self.world,
                            device="cpu", **{**ENGINE, **kw})

    def built(self, tag, eng):
        """The engine's local leaf shapes, read on every rank before rank 0
        may go on (its shutdown frees them)."""
        self.res["shapes"][tag] = {k: list(v.shape) for k, v in _flat(eng.params).items()}
        self.barrier()
        return eng

    def record(self, tag, eng):
        """The engine's shutdown, twice: pool and weights freed, the
        follower's thread ended, the groups destroyed."""
        pool = eng._kv_pool
        eng.shutdown()
        eng.shutdown()
        self.res["shutdown"][tag] = {
            "freed": pool.freed and pool.caches is None and eng.params is None
            and eng._caches == [],
            "thread_alive": eng._thread is not None and eng._thread.is_alive(),
            "groups_closed": eng._tp.group is None and eng._tp.ctl is None,
            "watcher_alive": eng._tp._watcher.is_alive()}

    def barrier(self):
        import torch.distributed as dist

        dist.barrier()


def _sweep(w: _Worker, name: str, tag: str) -> None:
    """The ngram sweep at tp=world, then the prefill chunks' logits; the
    K1 wrapper's runs on each rank."""
    from ray_tpu_torch.ops.attention import CALLS

    calls = CALLS["flash_fwd"]
    eng = w.built(tag, w.engine(name, spec_config=SPEC))
    if w.leader:
        w.res[tag] = {"tokens": [_generate(eng, p) for p in PROMPTS],
                      "spec_rounds": eng.scheduler_stats()["spec"]["rounds"]}
        with w.torch.inference_mode():
            rows = []
            for offset, bucket in PREFILL_CHUNKS:
                padded = np.zeros((1, bucket), np.int64)
                chunk = PREFILL_PROMPT[offset:offset + bucket]
                padded[0, :len(chunk)] = chunk
                rows.append(eng._op("_prefill_at", padded, 1, offset, len(PREFILL_PROMPT), 0)
                            .tolist())
            w.res[tag]["prefill_rows"] = rows
        errors = {}
        for what, call in (("prefill_detached", lambda: eng.prefill_detached([1, 2, 3])),
                           ("submit_prefilled", lambda: eng.submit_prefilled(
                               None, 3, None, None, None))):
            try:
                call()
            except NotImplementedError as e:
                errors[what] = str(e)
        w.res[tag]["refused"] = errors
    else:
        try:
            eng.submit([1, 2], None, None)
        except RuntimeError as e:
            w.res["follower_submit"] = str(e)
    if name == "m4" and w.world == 4:
        from ray_tpu_torch.llm.tp import per_device_byte_map

        w.res["bytes"] = per_device_byte_map([eng.params, eng._caches],
                                             group=_default_group())
    w.record(tag, eng)
    w.res["k1_calls"] = CALLS["flash_fwd"] - calls


def _default_group():
    import torch.distributed as dist

    return dist.group.WORLD


def _against_tp1(w: _Worker, name: str, tag: str, **kw) -> None:
    """tp=world tokens and, on rank 0, a tp=1 engine's."""
    eng = w.built(tag, w.engine(name, **kw))
    if w.leader:
        ref = w.engine(name, tp=1, **kw)
        try:
            w.res[tag] = {"tokens": [_generate(eng, p) for p in PROMPTS],
                          "tp1": [_generate(ref, p) for p in PROMPTS]}
        finally:
            ref.shutdown()
    w.record(tag, eng)


def _lora(w: _Worker) -> None:
    cfg = w.cfg["m4"]
    weights = _adapters(cfg.hidden, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim)
    eng = w.built("lora", w.engine("m4", lora_config=LORA))
    if w.leader:
        ref = w.engine("m4", tp=1, lora_config=LORA)
        try:
            out = {}
            for tag, e in (("tp", eng), ("tp1", ref)):
                for name, layers in weights.items():
                    e.add_lora(name, layers, alpha=4.0)
                out[tag] = [_generate(e, LORA_PROMPT, n=6, lora=name)
                            for _ in range(2) for name in weights]
                out[tag + "_stats"] = {k: v for k, v in e.adapter_stats().items()
                                       if k in ("evictions", "page_ins", "pinned")}
            w.res["lora"] = out
        finally:
            ref.shutdown()
    w.record("lora", eng)


def _prefix(w: _Worker, name: str, tag: str) -> None:
    """A cold request fills rank 0's cache (16-token blocks), its rows are
    dumped by every rank, then the same prompt hits; a tp=1 engine beside."""
    from ray_tpu_torch.llm.kvcache import PrefixCacheManager

    cap = 1 << 20
    eng = w.built(tag, w.engine(name, prefix_cache=PrefixCacheManager(16, cap)))
    out = {}
    if w.leader:
        out["cold"] = _generate(eng, PREFIX_PROMPT, n=8)
    w.barrier()  # the cold request is done: every rank's rows are still in place
    rows = np.stack([np.stack([ck[:, :32].numpy(), cv[:, :32].numpy()])
                     for ck, cv in eng._caches])  # [L, 2, B, 32, Hkv_local, D]
    np.save(w.root / f"rows_{tag}_{w.world}_{w.rank}.npy", rows)
    w.barrier()
    if w.leader:
        out["hit"] = _generate(eng, PREFIX_PROMPT, n=8)
        stats = eng.prefix_cache_stats()
        out["stats"] = {k: stats[k] for k in ("hits", "hit_tokens", "inserted_blocks")}
        lease = eng.lease_prefix(PREFIX_PROMPT)
        np.save(w.root / f"blocks_{tag}_{w.world}.npy", lease.kv().numpy())
        lease.release()
        ref = w.engine(name, tp=1, prefix_cache=PrefixCacheManager(16, cap))
        try:
            out["tp1"] = [_generate(ref, PREFIX_PROMPT, n=8) for _ in range(2)]
            lease = ref.lease_prefix(PREFIX_PROMPT)
            np.save(w.root / f"blocks_{tag}_{w.world}_tp1.npy", lease.kv().numpy())
            lease.release()
        finally:
            ref.shutdown()
        w.res[tag] = out
    w.record(tag, eng)


class _EventLog:
    """Each call this process makes to the methods of TIER_EVENTS (the
    host-row scatter, both attaches, the promotion) and to `_hot_report`,
    whose entries carry the K1 wrapper's runs so far and cut the log into
    the sequence's steps."""

    def __init__(self):
        from ray_tpu_torch.llm._engine import DecodeEngine
        from ray_tpu_torch.llm.tp import TPShard
        from ray_tpu_torch.ops.attention import CALLS

        self.events = [["start", CALLS["flash_fwd"]]]
        self._saved = []
        owners = {"scatter_host": TPShard, "_hot_report": DecodeEngine}
        for name in (*TIER_EVENTS, "_hot_report"):
            cls = owners.get(name, DecodeEngine)
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._logged(name, fn, CALLS))

    def _logged(self, name, fn, calls):
        def call(*args, **kwargs):
            self.events.append([name, calls["flash_fwd"]])
            return fn(*args, **kwargs)
        return call

    def close(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _tiers(w: _Worker, name: str, tag: str, instance: bool = False) -> None:
    """TIER_STEPS at tp=world on a cache of 2 blocks (device tier 4, a
    spill directory per rank, so a follower's would show): built from the
    flags, or (instance) rank 0 passing its own manager and the followers
    none. After every step rank 0 reads every rank's slices beside its
    tier's ids and host blocks."""
    import dataclasses

    import torch

    from ray_tpu_torch.llm import _engine as engine_mod
    from ray_tpu_torch.llm.kvcache import TieredPrefixCacheManager

    cfg = w.cfg[name]
    bb = _tier_block_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    spill = w.root / f"spill_{tag}_{w.world}_{w.rank}"
    saved, kw = engine_mod.CONFIG, {}
    if not instance:
        engine_mod.CONFIG = dataclasses.replace(
            saved, llm_prefix_cache_bytes=2 * bb, llm_kv_block_size=16,
            llm_kv_device_bytes=4 * bb, llm_kv_spill_dir=str(spill))
    elif w.leader:
        kw["prefix_cache"] = TieredPrefixCacheManager(
            16, 2 * bb, name=tag, device_bytes=4 * bb, to_device=torch.clone,
            spill_dir=str(spill))
    try:
        eng = w.built(tag, w.engine(name, **kw))
    finally:
        engine_mod.CONFIG = saved
    log = _EventLog()
    w.barrier()  # every rank logs before rank 0's first request
    out = {"spill_dir": spill.exists(), "cache": type(eng._prefix_cache).__name__,
           "spill_threads": sorted(t.name for t in threading.enumerate()
                                   if t.name.startswith("kv-spill"))}
    try:
        if w.leader:
            cache, steps = eng._prefix_cache, []
            for step, prompt in TIER_STEPS:
                if step == "disk":  # the first prompt's two blocks were spilled by "other"
                    _wait_spills(cache.stats, 2)
                tokens = _generate(eng, prompt, n=6)
                report = eng._op("_hot_report", True)
                with cache._lock:
                    tier_ids = list(cache._device._blocks)
                    hosts = {bid: cache._pool._blocks[bid].kv.numpy() for bid in tier_ids}
                # Rank r's kv-head slice of each host block (all of it where
                # the kv heads replicate).
                want = [{bid: np.split(kv, w.world, axis=3)[r] if eng._tp.kv_split else kv
                         for bid, kv in hosts.items()} for r in range(w.world)]
                steps.append({
                    "step": step, "tokens": tokens, "last_attach": eng.last_attach,
                    "tier_ids": sorted(tier_ids),
                    "ids": [sorted(mine) for mine in report],
                    "shapes": [sorted({tuple(shape) for shape, _, _ in mine.values()})
                               for mine in report],
                    "bits": [all(np.array_equal(rows.numpy(), want[r][bid])
                                 for bid, (_, _, rows) in mine.items() if bid in hosts)
                             for r, mine in enumerate(report)]})
            _wait_spills(cache.stats, 4)  # the disk promotion evicted other's blocks
            out.update(steps=steps, tiers=cache.stats()["tiers"],
                       leases_active=cache.stats()["leases_active"])
            worker = cache._spill_thread
        w.record(tag, eng)  # a follower's returns once rank 0 stopped the engine
    finally:
        log.close()
    out["events"] = log.events
    out["slices_after_shutdown"] = len(eng._hot_slices)
    if w.leader:
        out["spill_worker_stopped"] = worker is not None and not worker.is_alive() \
            and cache._spill_thread is None
        out["tier_after_shutdown"] = len(cache._device)
    w.res[tag] = out


def _tier_oom(w: _Worker) -> None:
    """A device tier at tp=2 whose rank 1 runs out of device memory on
    every promotion copy: TIER_A cold, then twice from the host pool. Every
    rank skips every copy, no rank fails, and the hits are host hits."""
    import dataclasses

    import torch

    from ray_tpu_torch.llm import _engine as engine_mod

    cfg = w.cfg["m4"]
    bb = _tier_block_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    saved = engine_mod.CONFIG
    engine_mod.CONFIG = dataclasses.replace(saved, llm_prefix_cache_bytes=2 * bb,
                                            llm_kv_block_size=16, llm_kv_device_bytes=4 * bb)
    try:
        eng = w.engine("m4")
    finally:
        engine_mod.CONFIG = saved
    if w.rank == 1:
        def oom(_host):
            raise torch.cuda.OutOfMemoryError("injected out of memory")

        eng._kv_block_to_device = oom
    w.barrier()
    out = {}
    if w.leader:
        out["tokens"], out["tiers_seen"], out["ids"] = [], [], []
        for _ in range(3):
            out["tokens"].append(_generate(eng, TIER_A, n=6))
            out["tiers_seen"].append((eng.last_attach or {}).get("tier"))
            out["ids"].append([sorted(mine) for mine in eng._op("_hot_report")])
        out["tiers"] = eng.prefix_cache_stats()["tiers"]
        out["error"] = repr(eng.error)
    out["thread_alive"] = eng._thread.is_alive()
    w.barrier()
    w.record("tier_oom", eng)
    w.res["tier_oom"] = out


def _tier_dropped_lease(w: _Worker) -> None:
    """A lease stamped "device" whose copies rank 0's tier drops before the
    attach (as LRU pressure or an eviction would): the attach is a host
    attach of the same rows, and the drop reaches every rank on the way
    out."""
    import dataclasses

    import torch

    from ray_tpu_torch.llm import _engine as engine_mod

    cfg = w.cfg["m4"]
    bb = _tier_block_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    saved = engine_mod.CONFIG
    engine_mod.CONFIG = dataclasses.replace(saved, llm_prefix_cache_bytes=2 * bb,
                                            llm_kv_block_size=16, llm_kv_device_bytes=4 * bb)
    try:
        eng = w.engine("m4")
    finally:
        engine_mod.CONFIG = saved
    if w.leader:
        cache, out = eng._prefix_cache, {}
        _generate(eng, TIER_A, n=2)
        _generate(eng, TIER_A, n=2)  # a host hit: both blocks promoted
        lease = cache.lookup(TIER_A)
        try:
            out["stamp"] = lease.tier
            with cache._lock:
                for bid in lease.block_ids:
                    cache._device.drop(bid)
            with torch.inference_mode():
                out["tier"] = eng._attach_lease(1, lease)
                rows = eng._op("_read_kv_blocks", 1, 0, len(lease.block_ids))
            out["rows_equal"] = torch.equal(torch.cat(rows, dim=2), lease.kv())
        finally:
            lease.release()
        out["ids"] = [sorted(mine) for mine in eng._op("_hot_report")]
        w.res["tier_dropped_lease"] = out
    w.record("tier_dropped_lease", eng)


def _checkpoint(w: _Worker) -> None:
    from ray_tpu_torch.checkpoint import _restore
    from ray_tpu_torch.llm._engine import DecodeEngine

    regions = []
    read = _restore._LeafReader.read_numpy

    def logged(reader, region=None):
        regions.append([reader._key, None if region is None else [list(r) for r in region]])
        return read(reader, region)

    _restore._LeafReader.read_numpy = logged
    try:
        eng = DecodeEngine.from_sharded_checkpoint(w.cfg["m4"], str(w.root / "jax_ckpt"),
                                                   tp=w.world, device="cpu", **ENGINE)
    finally:
        _restore._LeafReader.read_numpy = read
    w.res["ckpt_regions"] = regions
    w.built("ckpt", eng)
    if w.leader:
        w.res["ckpt"] = [_generate(eng, p) for p in PROMPTS]
    w.record("ckpt", eng)


def _load(w: _Worker) -> None:
    """load_model at tp=world, from random weights (drawn leaf by leaf) and
    from a params.pkl: each rank's tree is its block of the whole tree a
    tp=1 load gives."""
    import pickle

    from ray_tpu_torch.llm import LLMConfig, load_model
    from ray_tpu_torch.llm.tp import shard_decode_params

    pkl = w.root / "pkl"
    if w.leader:
        pkl.mkdir()
        inputs = np.load(w.root / "inputs.npz")
        tree = _nest({k.split(":", 1)[1]: inputs[k] for k in inputs.files if k.startswith("m4:")})
        (pkl / "params.pkl").write_bytes(pickle.dumps({"params": tree}))
    w.barrier()
    out = {}
    for what, kw in (("random", {"model_id": "test-tiny", "seed": 3}),
                     ("params_pkl", {"model_config": w.cfg["m4"], "checkpoint_path": str(pkl)})):
        cfg, whole = load_model(LLMConfig(device="cpu", **kw))
        _, local = load_model(LLMConfig(device="cpu", tp=w.world, **kw))
        want = _flat(shard_decode_params(whole, w.world, w.rank, cfg))
        got = _flat(local)
        out[what] = {"same_paths": set(got) == set(want),
                     "equal": all(w.torch.equal(got[k], want[k]) for k in want if k in got),
                     "split": sum(got[k].shape != _flat(whole)[k].shape for k in want if k in got)}
    w.res["load_model"] = out


def _refusals(w: _Worker) -> None:
    """The model drafts raise on every rank before any group is made."""
    out = {}
    cases = {"draft_layers": {"spec_config": {"draft_layers": 1}},
             "draft_cfg": {"spec_config": {"draft_cfg": w.cfg["m4"]}},
             "self_draft": {"spec_config": {"num_spec_tokens": 2}}}
    for what, kw in cases.items():
        try:
            w.engine("m4", **kw)
        except NotImplementedError as e:
            out[what] = str(e)
    w.res["refused_7e"] = out


def _follower_fails(w: _Worker) -> None:
    """Rank 1 raises in the decode step; rank 0's request ends (-1, True)
    and the engine's error names rank 1's."""
    from ray_tpu_torch.llm._engine import SamplingParams

    eng = w.engine("m4")
    if w.rank == 1:
        def boom(*args):
            raise ValueError("injected follower fault")

        eng._decode_logits = boom
    w.barrier()
    if w.leader:
        got, done = [], threading.Event()

        def cb(tok, fin):
            got.append(tok)
            if fin:
                done.set()

        t0 = time.monotonic()
        eng.submit(PROMPTS[1], SamplingParams(max_tokens=8), cb)
        ended = done.wait(FOLLOWER_DEADLINE_S)
        w.res["follower_fault"] = {"ended": ended, "seconds": time.monotonic() - t0,
                                   "tokens": got, "error": repr(eng.error)}
        try:
            eng.submit([1], SamplingParams(max_tokens=1), lambda t, f: None)
        except RuntimeError as e:
            w.res["follower_fault"]["submit_after"] = f"{e} / {e.__cause__!r}"
    eng.shutdown()
    eng.shutdown()
    w.res["follower_fault_shutdown"] = {"thread_alive": eng._thread is not None
                                        and eng._thread.is_alive(),
                                        "watcher_alive": eng._tp._watcher.is_alive(),
                                        "freed": eng._kv_pool.freed}


def _worker(world: int, rank: int, root: pathlib.Path) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(str(root / f"store{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=LAUNCH_S))
    try:
        deadline = time.monotonic() + LAUNCH_S - 20
        while not (root / "inputs.npz").exists():
            if time.monotonic() > deadline:
                raise TimeoutError("the run's inputs were never written")
            time.sleep(0.05)
        w = _Worker(world, rank, root)
        if world == 2:
            _sweep(w, "m4", "sweep")
            _against_tp1(w, "m6", "straddle")
            _lora(w)
            _prefix(w, "m4", "prefix")
            _tiers(w, "m4", "tiers")
            _tiers(w, "m4", "tiers_instance", instance=True)
            _tier_oom(w)
            _tier_dropped_lease(w)
            _checkpoint(w)
            _load(w)
            _refusals(w)
            _follower_fails(w)
        else:
            _sweep(w, "m4", "sweep")
            _against_tp1(w, "m2", "replicated_kv", spec_config=SPEC)
            _prefix(w, "m2", "prefix")
            _tiers(w, "m2", "tiers")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    w.res["forbidden_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    (root / f"result_{world}_{rank}.json").write_text(json.dumps(w.res))
    return 0


# ------------------------------------------------------------------ the run

def _jax_save(weights: dict, root: pathlib.Path) -> None:
    """m4's params saved by ray_tpu.checkpoint, as {"params": ...}."""
    import jax.numpy as jnp

    from ray_tpu import checkpoint as jckpt

    jckpt.save(str(root / "jax_ckpt"),
               {"params": _nest({k: jnp.asarray(v) for k, v in weights["m4"].items()})})


def _jgen(eng, prompt, n=12, lora=""):
    from ray_tpu.llm._engine import SamplingParams as JSampling

    acc, done = [], threading.Event()
    eng.submit(prompt, JSampling(max_tokens=n), lambda t, f: (acc.append(t), f and done.set()),
               lora=lora)
    assert done.wait(120), acc
    return acc


def _jax_engine(weights: dict, name: str, **kw):
    import jax.numpy as jnp

    from ray_tpu.llm._engine import DecodeEngine as JEngine
    from ray_tpu.models.transformer import get_config as jget_config

    jcfg = jget_config("test-tiny", scan_layers=False, remat=False, **MODELS[name])
    params = _nest({k: jnp.asarray(v) for k, v in weights[name].items()})
    return JEngine(jcfg, params, **{**ENGINE, **kw}), params


def _jax_served(weights: dict, name: str) -> dict:
    """m4 or m2 with the ngram draft and a 16-token-block prefix cache: the
    sweep's tokens, then PREFIX_PROMPT cold and on its hit, and the blocks
    it inserted (the sweep's prompts are shorter than a block and insert
    none). m6 without either: the sweep's tokens."""
    from ray_tpu.llm.kvcache import PrefixCacheManager as JPrefixCache

    if name == "m6":
        eng, _ = _jax_engine(weights, name)
    else:
        eng, _ = _jax_engine(weights, name, spec_config=SPEC,
                             prefix_cache=JPrefixCache(16, 1 << 20))
    try:
        out = {"tokens": [_jgen(eng, p) for p in PROMPTS]}
        if name != "m6":
            out["prefix"] = [_jgen(eng, PREFIX_PROMPT, n=8) for _ in range(2)]
            lease = eng.lease_prefix(PREFIX_PROMPT)
            out["blocks"] = np.array(lease.kv())
            lease.release()
        return out
    finally:
        eng.shutdown()


def _jax_lora(weights: dict) -> dict:
    """m4's LoRA churn: 6 adapters through 2 device slots, twice over."""
    hidden, heads, dim = weights["m4"]["layer_0/attn/q/kernel"].shape
    adapters = _adapters(hidden, heads * dim, weights["m4"]["layer_0/attn/v/kernel"].shape[1] * dim)
    eng, _ = _jax_engine(weights, "m4", lora_config=LORA)
    try:
        for name, layers in adapters.items():
            eng.add_lora(name, layers, alpha=4.0)
        return {"tokens": [_jgen(eng, LORA_PROMPT, n=6, lora=name)
                           for _ in range(2) for name in adapters],
                "evictions": eng.adapter_stats()["evictions"]}
    finally:
        eng.shutdown()


def _jax_prefill_rows(weights: dict) -> list:
    """m4's prefill chunks' logits rows."""
    import jax.numpy as jnp

    eng, params = _jax_engine(weights, "m4", decode_loop=False, prefix_cache=False)
    try:
        caches, rows = eng._caches, []
        for offset, bucket in PREFILL_CHUNKS:
            padded = np.zeros((1, bucket), np.int32)
            chunk = PREFILL_PROMPT[offset:offset + bucket]
            padded[0, :len(chunk)] = chunk
            last, caches = eng._prefill_at(params, None, jnp.asarray(padded), caches,
                                           jnp.int32(1), jnp.int32(offset),
                                           jnp.int32(len(PREFILL_PROMPT)), jnp.int32(0))
            rows.append(np.asarray(last))
        return rows
    finally:
        eng.shutdown()


def _jax_tiers(weights: dict, name: str, root: pathlib.Path) -> dict:
    """TIER_STEPS on ray_tpu's tp=1 engine with test_llm_kvtier.py's
    manager (2 host blocks, a 4-block device tier, a spill directory): each
    step's tokens and last_attach, then the tier counters once every spill
    is written."""
    from ray_tpu.llm.kvcache import TieredPrefixCacheManager as JTiered

    flat = weights[name]
    _, n_kv, dim = flat["layer_0/attn/k/kernel"].shape
    bb = _tier_block_bytes(sum(k.endswith("attn/k/kernel") for k in flat), n_kv, dim)
    mgr = JTiered(16, 2 * bb, name=f"jax-tiers-{name}", device_bytes=4 * bb,
                  spill_dir=str(root / f"jax_spill_{name}"))
    eng, _ = _jax_engine(weights, name, prefix_cache=mgr)
    try:
        steps = []
        for step, prompt in TIER_STEPS:
            if step == "disk":
                _wait_spills(mgr.stats, 2)
            steps.append({"tokens": _jgen(eng, prompt, n=6), "last_attach": eng.last_attach})
        _wait_spills(mgr.stats, 4)
        return {"steps": steps, "tiers": mgr.stats()["tiers"]}
    finally:
        eng.shutdown()


def _jax_side(weights: dict, root: pathlib.Path) -> dict:
    """ray_tpu's tp=1 engine on every case the ranks serve, one engine per
    case, the engines in threads of their own (the modules imported first,
    here: a circular import is not safe across threads)."""
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu.llm._engine  # noqa: F401
    import ray_tpu.llm.kvcache  # noqa: F401
    import ray_tpu.models.transformer  # noqa: F401

    with ThreadPoolExecutor(7) as pool:
        jobs = {name: pool.submit(_jax_served, weights, name) for name in ("m4", "m2", "m6")}
        jobs["lora"] = pool.submit(_jax_lora, weights)
        jobs["prefill_rows"] = pool.submit(_jax_prefill_rows, weights)
        for name in ("m4", "m2"):
            jobs[f"tiers_{name}"] = pool.submit(_jax_tiers, weights, name, root)
        return {key: job.result() for key, job in jobs.items()}


def _launch(world: int, root: pathlib.Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(root / f"log_{world}_{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "worker", str(world), str(rank), str(root)],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _reap(procs: list, deadline: float) -> list:
    """Wait for every worker until `deadline`, then kill what is left:
    [(return code or None when killed)]."""
    codes = []
    try:
        for proc, _ in procs:
            try:
                codes.append(proc.wait(timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return codes


def _make_run(root: pathlib.Path) -> dict:
    """Start both launches, write their inputs (the workers wait for
    inputs.npz; the JAX checkpoint is saved first), then run the JAX side."""
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    launches = {2: _launch(2, root), 4: _launch(4, root)}
    try:
        weights = {name: _weights(name) for name in MODELS}
        _jax_save(weights, root)
        np.savez(root / "inputs.tmp.npz", **{f"{name}:{k}": v for name, flat in weights.items()
                                             for k, v in flat.items()})
        os.replace(root / "inputs.tmp.npz", root / "inputs.npz")
        jax_side = _jax_side(weights, root)
    finally:
        codes = {world: _reap(procs, t0 + LAUNCH_S) for world, procs in launches.items()}
    results = {world: [json.loads((root / f"result_{world}_{r}.json").read_text())
                       if (root / f"result_{world}_{r}.json").exists() else None
                       for r in range(world)] for world in (2, 4)}
    logs = {world: [(root / f"log_{world}_{r}.txt").read_text()[-3000:] for r in range(world)]
            for world in (2, 4)}
    return {"root": root, "codes": codes, "results": results, "logs": logs,
            "seconds": time.monotonic() - t0, "jax": jax_side, "weights": weights}


_RUN: dict = {}


def _run(tmp_path_factory, request) -> dict:
    """The launches' results, made once per session: under xdist the first
    worker makes them in the session's shared directory, under a lock, and
    the others load them."""
    if _RUN:
        return _RUN
    import pickle

    base = tmp_path_factory.getbasetemp()
    shared = base.parent if hasattr(request.config, "workerinput") else base
    root = shared / "torch_tp_run"
    with open(shared / "torch_tp_run.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "torch_tp_run.pkl"
        if done.exists():
            run = pickle.loads(done.read_bytes())
        else:
            run = _make_run(root)
            done.write_bytes(pickle.dumps(run))
    _RUN.update(run)
    return _RUN


# ------------------------------------------------------------------ tests


@pytest.fixture
def run(tmp_path_factory, request):
    out = _run(tmp_path_factory, request)
    assert out["codes"] == {2: [0] * 2, 4: [0] * 4}, (out["codes"], out["logs"])
    return out


def _leader(run, world):
    return run["results"][world][0]


def test_launches_finish_in_time_and_load_no_jax(run):
    assert run["seconds"] < LAUNCH_S
    for world in (2, 4):
        for res in run["results"][world]:
            assert res["forbidden_modules"] == [], res["forbidden_modules"]


@pytest.mark.parametrize("world", [2, 4])
def test_greedy_tokens_equal_jax_tp1_with_ngram_spec(run, world):
    """(a) tp=2 and tp=4 serve JAX's tp=1 greedy tokens on the sweep prompts
    through the ngram draft's verify rounds."""
    sweep = _leader(run, world)["sweep"]
    assert sweep["tokens"] == run["jax"]["m4"]["tokens"]
    assert sweep["spec_rounds"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_k1_runs_once_per_layer_per_rank(run, world):
    """Each offset-0 chunk (the 3 sweep prompts' and the prefill's first)
    runs the K1 wrapper once per layer on every rank, on its own heads."""
    for res in run["results"][world]:
        assert res["k1_calls"] == 2 * (len(PROMPTS) + 1), res["rank"]


def test_prefill_logits_match_jax(run):
    """(b) The offset-0 chunk (K1's route) and the offset-32 chunk (the
    masked route) of a 42-token prompt at tp=2: the gathered logits row
    within 1e-5 of JAX's."""
    got = _leader(run, 2)["sweep"]["prefill_rows"]
    for row, ref in zip(got, run["jax"]["prefill_rows"]):
        np.testing.assert_allclose(np.asarray(row, np.float32), ref, atol=1e-5, rtol=1e-5)


def _jax_spec_dim(path, shape, tp):
    """The dimension JAX's param_spec names "tp" on a mesh of `tp` devices
    (a stand-in with the mesh's `.shape`), or None."""
    from ray_tpu.llm.tp import param_spec

    class Mesh:
        pass

    mesh = Mesh()
    mesh.shape = {"tp": tp}
    spec = param_spec(tuple(path.split("/")), shape, mesh)
    named = [i for i, part in enumerate(tuple(spec)) if part == "tp"]
    return named[0] if named else None


@pytest.mark.parametrize("world,tag,model", [(2, "sweep", "m4"), (4, "sweep", "m4"),
                                             (4, "replicated_kv", "m2"), (2, "straddle", "m6")])
def test_local_shapes_are_jax_param_spec_slices(run, world, tag, model):
    """(c) Every leaf on every rank has the shape of its slice under JAX's
    param_spec, replication included (m2 at tp=4: k and v whole)."""
    full = run["weights"][model]
    split = 0
    for res in run["results"][world]:
        shapes = res["shapes"][tag]
        assert set(shapes) == set(full)
        for path, arr in full.items():
            dim = _jax_spec_dim(path, arr.shape, world)
            want = list(arr.shape)
            if dim is not None:
                want[dim] //= world
                split += 1
            assert shapes[path] == want, (path, res["rank"])
    assert split
    if model == "m2":
        assert run["results"][4][0]["shapes"][tag]["layer_0/attn/k/kernel"] == [64, 2, 16]


def test_per_rank_bytes_under_half_at_tp4(run):
    """(d) Each rank's weights and KV at tp=4 (n_kv_heads=4) are under half
    of tp=1's whole tree and pool."""
    per_rank = {int(k): v for k, v in _leader(run, 4)["bytes"].items()}
    weights = sum(v.nbytes for v in run["weights"]["m4"].values())
    kv = 2 * 2 * ENGINE["num_slots"] * ENGINE["max_seq"] * 4 * 16 * 4  # L, k/v, B, T, Hkv, D, f32
    assert sorted(per_rank) == [0, 1, 2, 3]
    assert max(per_rank.values()) < (weights + kv) / 2, (per_rank, weights + kv)


@pytest.mark.parametrize("tag", ["straddle", "replicated_kv"])
def test_gqa_over_split_heads_token_identical_to_tp1(run, tag):
    """(e) m6 at tp=2 (each rank's 3 heads straddle two kv groups: one kv
    head gathered per query head) and m2 at tp=4 with the ngram draft (q
    split, kv replicated: a slice of the kv heads) serve JAX's tp=1 tokens,
    and the port's own tp=1 engine's."""
    world, model = (2, "m6") if tag == "straddle" else (4, "m2")
    res = _leader(run, world)[tag]
    assert res["tokens"] == run["jax"][model]["tokens"]
    assert res["tp1"] == res["tokens"]


def test_lora_churn_token_identical_to_tp1(run):
    """(f) 6 adapters through 2 device slots at tp=2, twice over: JAX's
    tp=1 tokens (and the port's tp=1 engine's), as many evictions as JAX's,
    distinct adapters really distinct."""
    lora, ref = _leader(run, 2)["lora"], run["jax"]["lora"]
    assert lora["tp"] == ref["tokens"]
    assert lora["tp1"] == lora["tp"]
    assert len({tuple(t) for t in lora["tp"][:6]}) > 1
    assert lora["tp_stats"]["evictions"] == ref["evictions"] > 0
    assert lora["tp_stats"] == lora["tp1_stats"]


@pytest.mark.parametrize("world,tag", [(2, "prefix"), (4, "prefix")])
def test_prefix_hit_serves_cold_tokens(run, world, tag):
    """(g) A hit at offset 32 serves the cold tokens, JAX's tp=1 tokens cold
    and on its hit (and the port's tp=1 engine's); the host blocks rank 0
    inserted are bit for bit the ranks' rows joined on the kv-head axis (m4
    at tp=2: split; m2 at tp=4: rank 0's own), and within 1e-5 of the blocks
    JAX's engine inserted (and of the port's tp=1 engine's)."""
    res = _leader(run, world)[tag]
    ref = run["jax"]["m4" if world == 2 else "m2"]
    assert res["hit"] == res["cold"] == ref["prefix"][0] == ref["prefix"][1]
    assert res["tp1"] == ref["prefix"]
    assert res["stats"]["hits"] == 1 and res["stats"]["hit_tokens"] == 32
    root = pathlib.Path(run["root"])
    blocks = np.load(root / f"blocks_{tag}_{world}.npy")  # [L, 2, 32, Hkv, D]
    parts = [np.load(root / f"rows_{tag}_{world}_{r}.npy") for r in range(world)]
    split = parts[0].shape[4] != blocks.shape[3]
    rows = np.concatenate(parts, axis=4) if split else parts[0]
    slot = [b for b in range(rows.shape[2]) if rows[:, :, b].any()]
    assert len(slot) == 1
    assert np.array_equal(rows[:, :, slot[0]], blocks)
    assert split == (world == 2)
    assert blocks.shape == ref["blocks"].shape
    np.testing.assert_allclose(blocks, ref["blocks"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(blocks, np.load(root / f"blocks_{tag}_{world}_tp1.npy"), atol=1e-5,
                               rtol=1e-5)


def test_from_sharded_checkpoint_reads_own_regions(run):
    """(h) from_sharded_checkpoint(tp=2) of a checkpoint JAX saved serves
    JAX's tokens, and each rank reads only its slice of each split leaf."""
    assert _leader(run, 2)["ckpt"] == run["jax"]["m4"]["tokens"]
    full = run["weights"]["m4"]
    for res in run["results"][2]:
        r = res["rank"]
        reads = {key: region for key, region in res["ckpt_regions"]}
        assert set(reads) == {f"params/{k}" for k in full}
        for path, arr in full.items():
            dim = _jax_spec_dim(path, arr.shape, 2)
            want = [[0, n] for n in arr.shape]
            if dim is not None:
                n = arr.shape[dim] // 2
                want[dim] = [r * n, (r + 1) * n]
            assert reads[f"params/{path}"] == want, (path, r)


@pytest.mark.parametrize("what", ["random", "params_pkl"])
def test_load_model_gives_rank_shards(run, what):
    """load_model(LLMConfig(tp=2)) gives each rank its block of tp=1's tree,
    from random weights drawn leaf by leaf and from a params.pkl."""
    for res in run["results"][2]:
        got = res["load_model"][what]
        assert got["same_paths"] and got["equal"], (what, res["rank"])
        assert got["split"] > 0


def test_shutdown_twice_frees_every_rank(run):
    """(i) Every engine's shutdown, called twice on every rank: its pool and
    weights dropped, the follower thread and the failure watcher ended, the
    groups destroyed."""
    for world in (2, 4):
        for res in run["results"][world]:
            assert res["shutdown"], res["rank"]
            for tag, state in res["shutdown"].items():
                assert state == {"freed": True, "thread_alive": False, "groups_closed": True,
                                 "watcher_alive": False}, (world, res["rank"], tag)


def test_follower_error_fails_rank0_requests(run):
    """(j) A follower that raises fails rank 0's request within the deadline
    (it ends with -1) with the follower's error, and no later submit is
    taken; both ranks' shutdowns return."""
    fault = _leader(run, 2)["follower_fault"]
    assert fault["ended"] and fault["seconds"] < FOLLOWER_DEADLINE_S
    assert fault["tokens"][-1] == -1
    assert "injected follower fault" in fault["error"] and "rank 1" in fault["error"]
    assert "stepper died" in fault["submit_after"]
    for res in run["results"][2]:
        assert res["follower_fault_shutdown"]["thread_alive"] is False
        assert res["follower_fault_shutdown"]["watcher_alive"] is False


@pytest.mark.parametrize("what", ["draft_layers", "draft_cfg", "self_draft", "prefill_detached",
                                  "submit_prefilled"])
def test_7e_paths_raise(run, what):
    """(k) The PD handoff and model drafts raise NotImplementedError naming
    [7e] on a TP engine (the constructors on every rank, before any group
    is made); the ngram draft runs."""
    for res in run["results"][2]:
        refused = dict(res["refused_7e"])
        if res["rank"] == 0:
            refused.update(res["sweep"]["refused"])
        elif what in ("prefill_detached", "submit_prefilled"):
            continue
        assert "[7e]" in refused[what], (what, res["rank"])


TIER_IDS = ["tp2-flags", "tp2-instance", "tp4-flags"]


def _tier_run(run, world, tag, model):
    """(rank 0's record, every rank's, JAX's tp=1 record) of one tier case."""
    ranks = [res[tag] for res in run["results"][world]]
    return ranks[0], ranks, run["jax"][f"tiers_{model}"]


def _steps(events: list) -> list:
    """A rank's event log cut at its `_hot_report` entries: per step, the
    names logged and the K1 wrapper's runs."""
    out, names, k1 = [], [], events[0][1]
    for name, calls in events[1:]:
        if name == "_hot_report":
            out.append({"names": names, "k1": calls - k1})
            names, k1 = [], calls
        else:
            names.append(name)
    return out


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_tiers_tokens_and_attach_tiers_equal_jax(run, world, tag, model):
    """(l) Cold, host hit, device hit, the evicting prompt and the disk hit
    serve JAX's tp=1 tokens, and each step's last_attach (the tier that
    served the hit, 32 cached tokens) is JAX's."""
    lead, _, ref = _tier_run(run, world, tag, model)
    assert [s["step"] for s in lead["steps"]] == [s for s, _ in TIER_STEPS]
    for got, want in zip(lead["steps"], ref["steps"]):
        assert got["tokens"] == want["tokens"], got["step"]
        assert got["last_attach"] == want["last_attach"], got["step"]
    by_step = {s["step"]: s for s in lead["steps"]}
    for step in ("host", "device", "disk"):
        assert by_step[step]["last_attach"] == {"tier": step, "cached_tokens": 32}
        assert by_step[step]["tokens"] == by_step["cold"]["tokens"]


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_tier_counters_equal_jax(run, world, tag, model):
    """(l) Rank 0's tier counters, device bytes (whole blocks) included,
    are JAX's tp=1 engine's once every spill is written; no lease is left."""
    lead, _, ref = _tier_run(run, world, tag, model)
    assert lead["tiers"] == ref["tiers"]
    assert {k: lead["tiers"][k] for k in ("hits_device", "hits_host", "hits_disk")} == \
        {"hits_device": 1, "hits_host": 1, "hits_disk": 1}
    assert lead["tiers"]["promotions_device"] > 0 and lead["tiers"]["spills"] == 4
    assert lead["leases_active"] == 0


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_every_rank_holds_rank0_tier_ids_after_every_step(run, world, tag, model):
    """(m) After every step each rank's slices are exactly the blocks rank
    0's hot tier holds: the promotions reached every rank, and so did the
    drops the eviction made under the manager's lock."""
    lead, _, _ = _tier_run(run, world, tag, model)
    for step in lead["steps"]:
        assert len(step["ids"]) == world
        assert all(ids == step["tier_ids"] for ids in step["ids"]), step["step"]
    by_step = {s["step"]: s for s in lead["steps"]}
    assert len(by_step["device"]["tier_ids"]) == 2
    assert not set(by_step["device"]["tier_ids"]) & set(by_step["other"]["tier_ids"])


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_slices_are_kv_head_slices_bit_for_bit(run, world, tag, model):
    """(m) Each rank's slice is [L, 2, 16, Hkv / tp, D] (the whole block
    where the kv heads replicate: m2 at tp=4) and equals its kv-head slice
    of rank 0's host block bit for bit."""
    lead, _, _ = _tier_run(run, world, tag, model)
    flat = run["weights"][model]
    _, n_kv, dim = flat["layer_0/attn/k/kernel"].shape
    local = n_kv // world if n_kv % world == 0 else n_kv
    for step in lead["steps"]:
        for shapes in step["shapes"]:
            assert shapes in ([], [[2, 2, 16, local, dim]]), step["step"]
        assert all(step["bits"]), step["step"]
    assert (local == n_kv) == (model == "m2")


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_device_hit_reads_own_slices_and_k1_only_cold(run, world, tag, model):
    """(n) On the device hit every rank attaches from its own slices once,
    with no host-row scatter and no host attach; K1 runs once per layer on
    every rank on the two cold requests and never on a hit."""
    _, ranks, _ = _tier_run(run, world, tag, model)
    for r, res in enumerate(ranks):
        steps = dict(zip([s for s, _ in TIER_STEPS], _steps(res["events"])))
        assert steps["device"]["names"] == ["_attach_hot"], r
        for step in ("host", "disk"):
            assert "_attach_hot" in steps[step]["names"] or "_attach_kv" in steps[step]["names"]
        assert {s: v["k1"] for s, v in steps.items()} == {
            "cold": 2, "host": 0, "device": 0, "other": 2, "disk": 0}, r


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_followers_build_no_cache_spill_store_or_thread(run, world, tag, model):
    """(o) Only rank 0 has a tiered manager, a spill directory and a spill
    worker; the followers, given the same flags (or none beside rank 0's
    instance), build no cache at all."""
    _, ranks, _ = _tier_run(run, world, tag, model)
    assert ranks[0]["cache"] == "TieredPrefixCacheManager" and ranks[0]["spill_dir"]
    for res in ranks[1:]:
        assert res["cache"] == "NoneType"
        assert res["spill_dir"] is False and res["spill_threads"] == []


@pytest.mark.parametrize("world,tag,model", TIER_CASES, ids=TIER_IDS)
def test_tier_shutdown_frees_slices_and_stops_spill_worker(run, world, tag, model):
    """(o) After shutdown no rank holds a slice, rank 0's tier holds no
    copy and its spill worker has stopped; every rank's pool and weights
    are freed."""
    lead, ranks, _ = _tier_run(run, world, tag, model)
    assert lead["spill_worker_stopped"] and lead["tier_after_shutdown"] == 0
    assert all(res["slices_after_shutdown"] == 0 for res in ranks)
    for res in run["results"][world]:
        assert res["shutdown"][tag]["freed"], res["rank"]


def test_follower_oom_in_promotion_skips_on_every_rank(run):
    """(o) A follower's device out-of-memory in a promotion is every rank's:
    no rank keeps a slice, no rank fails, the hits are served from the host
    pool with JAX's cold tokens, and no promotion is counted."""
    lead = _leader(run, 2)["tier_oom"]
    cold = run["jax"]["tiers_m4"]["steps"][0]["tokens"]
    assert lead["tokens"] == [cold] * 3
    assert lead["tiers_seen"] == [None, "host", "host"]
    assert lead["ids"] == [[[], []]] * 3
    assert lead["error"] == "None"
    assert (lead["tiers"]["hits_host"], lead["tiers"]["promotions_device"],
            lead["tiers"]["device_blocks"]) == (2, 0, 0)
    for res in run["results"][2]:
        assert res["tier_oom"]["thread_alive"], res["rank"]
        assert res["shutdown"]["tier_oom"]["freed"], res["rank"]


def test_device_lease_whose_copies_dropped_attaches_from_host_tp2(run):
    """(o) A lease stamped "device" whose copies went before the attach is
    served by the host pool (reported "host", as on one device), every
    rank's rows are the host rows, and no rank keeps a dropped slice."""
    out = _leader(run, 2)["tier_dropped_lease"]
    assert out["stamp"] == "device" and out["tier"] == "host"
    assert out["rows_equal"]
    assert out["ids"] == [[], []]


def test_follower_public_calls_raise(run):
    for world in (2, 4):
        for res in run["results"][world][1:]:
            assert "follower" in res["follower_submit"]


def test_tp_without_process_group_raises(monkeypatch):
    """tp > 1 where torch.distributed is not initialised raises at once (as
    this process sees it, whatever an earlier test left)."""
    import torch.distributed as dist

    from ray_tpu_torch.llm._engine import DecodeEngine
    from ray_tpu_torch.models.transformer import get_config, init_params

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    cfg = get_config("test-tiny")
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        DecodeEngine(cfg, init_params(cfg, device="cpu"), tp=2, device="cpu", **ENGINE)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_spec_is_jax_rule(model, tp):
    """The port's param_spec names JAX's dimension on every leaf, and
    shard_decode_params cuts rank r's block of it (a local tree passes
    through with cfg)."""
    from ray_tpu_torch.llm.tp import param_spec, shard_decode_params
    from ray_tpu_torch.models.transformer import get_config

    full = _weights(model)
    cfg = get_config("test-tiny", **MODELS[model])
    for path, arr in full.items():
        assert param_spec(tuple(path.split("/")), arr.shape, tp) == \
            _jax_spec_dim(path, arr.shape, tp), path
    tree = _nest(full)
    for rank in (0, tp - 1):
        local = _flat(shard_decode_params(tree, tp, rank, cfg))
        again = _flat(shard_decode_params(_nest(local), tp, rank, cfg))
        for path, arr in full.items():
            dim = param_spec(tuple(path.split("/")), arr.shape, tp)
            want = arr if dim is None else np.split(arr, tp, axis=dim)[rank]
            assert np.array_equal(local[path], want) and np.array_equal(again[path], want)


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        sys.exit(_worker(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4])))
    sys.exit(f"usage: {sys.argv[0]} worker <world> <rank> <dir>")
