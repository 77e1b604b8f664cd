"""Tiered prefix-KV store: device-hot / host-warm / disk-cold.

A copy of `ray_tpu/llm/kvcache/tiers.py` over the port's host pool
(manager.py). The flat `PrefixCacheManager` is one host-RAM pool with
byte-cap eviction: evicted prefixes are recomputed from scratch and every
hit pays a host->device attach. This module turns it into a three-level
hierarchy:

  device hot tier   `DeviceHotTier` — device copies (CUDA tensors in the
                    cache dtype, made by the engine-supplied `to_device`) of
                    the hottest host blocks under `llm_kv_device_bytes`, so
                    a warm attach consumes a device-resident prefix with
                    ZERO host->device copies.
  host warm tier    the ref-counted `KVBlockPool` + radix index — still the
                    source of truth for resident chains; every lease pins
                    host blocks exactly as before.
  disk cold tier    `DiskSpillStore` — host eviction SPILLS the victim block
                    to a content-addressed local file instead of discarding
                    it (async, off the manager lock, atomic
                    tmp+fsync+rename commit: a torn spill is invisible, a
                    crash mid-spill is simply a miss on restart), and
                    lookups promote spilled chains back through the host
                    pool.

Tier mechanics follow the manager's synchronization contract: the tier
structures are passive (no locks of their own), every tier mutation happens
under the ONE manager lock, and nothing under the lock blocks, touches a
device, or does IO — `to_device` copies and disk reads/writes all run
outside it (spills on a dedicated `kv-spill-*` worker thread).

Where the reference differs: a spill file holds the block in its own dtype.
f32 (and every dtype numpy names) is written by `np.save`, so the bytes are
JAX's; bfloat16 is written as its raw 2-byte values under numpy's void type
`V2` (what numpy writes for ml_dtypes' bfloat16) and read back as bfloat16,
where JAX's store reads its own bf16 file back as void and cannot stitch
it. The promotion copy raises past a device out-of-memory only (JAX's
swallows every error). No `llm_kv_tier_*` metrics are pushed; `stats()`
reports the same counters as plain ints.

On a tensor-parallel engine (one process per GPU) the manager is rank 0's,
and its hot tier is the book of every rank's copies: `share_device_tier`
swaps `to_device` for a copy that gives every rank its kv-head slice of the
block, and from then on the tier logs each id it drops (LRU, eviction, a
copy orphaned by an eviction during the copy) for the engine to pass on
(`take_dropped`). JAX's single process places the block sharded instead.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.kvcache.manager import PrefixCacheManager, PrefixLease

class SpillFile:
    """Writer handle for ONE atomic spill commit.

    Bytes stream into a tmp file; `commit()` does flush + fsync + rename,
    after which (and only after which) the entry is visible to readers.
    `close()` without a commit ABORTS — the tmp file is unlinked and the
    store never saw the entry. A process killed mid-write leaves only a
    `*.tmp` orphan, which the next store open sweeps; torn spills are
    invisible by construction."""

    __slots__ = ("path", "_tmp", "_f", "_store")

    def __init__(self, store: "DiskSpillStore", path: str, tmp: str):
        self._store = store
        self.path = path
        self._tmp = tmp
        self._f = open(tmp, "wb")

    def write(self, data) -> int:
        """File-like write (np.save streams through this)."""
        return self._f.write(data)

    def commit(self):
        """fsync + atomic rename: the entry becomes visible, durably."""
        f, self._f = self._f, None
        if f is None:
            return
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(self._tmp, self.path)
        self._store._note_committed(self.path)

    def close(self):
        """Abort an uncommitted spill (idempotent; no-op after commit)."""
        f, self._f = self._f, None
        if f is None:
            return
        f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass  # already swept; the abort only has to make it invisible

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_numpy(kv: torch.Tensor) -> np.ndarray:
    """A host block as the array its spill file holds: bfloat16 as raw
    2-byte values (`V2`), every other dtype as itself."""
    if kv.dtype == torch.bfloat16:
        return kv.view(torch.int16).numpy().view("V2")
    return kv.numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A loaded spill file as a CPU tensor in the dtype it was spilled in: a
    2-byte void array is bfloat16, the cache dtype numpy cannot name."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class DiskSpillStore:
    """Content-addressed block files under one local directory.

    The key is a digest of (namespace, exact token chain) — the same
    identity the radix tree encodes — so a spilled block can be found by ANY
    process that knows the tokens (restart-safe, and shareable across
    engines pointed at one directory). LRU is mtime-based: `get()` touches,
    the byte cap unlinks oldest-first. Thread contract: every method is
    self-contained filesystem work guarded by an internal lock for the byte
    accounting; callers never invoke it under the manager lock."""

    def __init__(self, root: str, capacity_bytes: int = 0):
        self.root = root
        self.capacity_bytes = max(0, int(capacity_bytes))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.bytes_resident = 0
        # Torn spills from a crashed writer are invisible (never renamed);
        # sweep their tmp orphans and take stock of committed entries.
        for name in os.listdir(root):
            path = os.path.join(root, name)
            if name.endswith(".tmp"):
                try:
                    os.unlink(path)
                except OSError:
                    pass  # concurrent sweep; invisibility is all that matters
            elif name.endswith(".npy"):
                try:
                    self.bytes_resident += os.path.getsize(path)
                except OSError:
                    pass  # raced an eviction; accounting catches up on use

    @staticmethod
    def key(namespace: int, token_ids: Sequence[int]) -> str:
        h = hashlib.sha1()
        h.update(int(namespace).to_bytes(8, "little", signed=True))
        h.update(np.asarray(token_ids, np.int64).tobytes())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.npy")

    def open_spill(self, key: str) -> Optional[SpillFile]:
        """Writer handle for one entry, or None when it is already
        committed (content addressing: same chain => same bytes, so a
        re-spill after promote-then-re-evict is a no-op)."""
        path = self._path(key)
        if os.path.exists(path):
            return None
        return SpillFile(self, path, f"{path}.{os.getpid()}.tmp")

    def put(self, key: str, kv: torch.Tensor) -> bool:
        """Spill one block (no-op when present). Returns True if written."""
        f = self.open_spill(key)
        if f is None:
            return False
        try:
            np.save(f, _to_numpy(kv), allow_pickle=False)
            f.commit()
            return True
        finally:
            f.close()  # no-op after commit; aborts (unlinks tmp) on error

    def get(self, key: str) -> Optional[torch.Tensor]:
        """Load one committed block as a CPU tensor in its spilled dtype;
        None on miss. A corrupt entry (partial hardware write, foreign file)
        is unlinked and reported as a miss — the chain simply re-prefills."""
        path = self._path(key)
        try:
            kv = _from_numpy(np.load(path, allow_pickle=False))
        except FileNotFoundError:
            return None
        except Exception:
            try:
                os.unlink(path)
            except OSError:
                pass  # miss either way; the entry must just stop mattering
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass  # raced an eviction: the loaded bytes are still valid
        return kv

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def _note_committed(self, path: str):
        with self._lock:
            try:
                self.bytes_resident += os.path.getsize(path)
            except OSError:
                return
        self._evict_over_cap()

    def _evict_over_cap(self):
        """Unlink oldest committed entries until under the byte cap."""
        if not self.capacity_bytes:
            return
        with self._lock:
            if self.bytes_resident <= self.capacity_bytes:
                return
            entries = []
            for name in os.listdir(self.root):
                if not name.endswith(".npy"):
                    continue
                path = os.path.join(self.root, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, path))
            entries.sort()
            for _mtime, size, path in entries:
                if self.bytes_resident <= self.capacity_bytes:
                    break
                try:
                    os.unlink(path)
                    self.bytes_resident -= size
                except OSError:
                    pass  # raced another evictor; totals re-sync on commit

    def stats(self) -> dict:
        with self._lock:
            return {
                "bytes_resident": self.bytes_resident,
                "capacity_bytes": self.capacity_bytes,
                "root": self.root,
            }


class DeviceHotTier:
    """Device copies of the hottest host blocks, byte-budgeted, LRU.

    Passive structure in the manager's lock discipline: every mutation runs
    under the manager lock; the `to_device` copy that PRODUCES a device copy
    runs outside it. A device copy is redundant by construction — the host
    block stays authoritative — so dropping one (budget pressure, host
    eviction) is always safe."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.bytes_resident = 0
        self._blocks: "OrderedDict[int, tuple]" = OrderedDict()  # bid -> (dev, nbytes)
        # The ids dropped since the last `take_dropped`, when other ranks
        # hold copies of the blocks too (None: nobody else does).
        self.dropped: Optional[List[int]] = None

    def __len__(self) -> int:
        return len(self._blocks)

    def get(self, block_id: int):
        entry = self._blocks.get(block_id)
        return None if entry is None else entry[0]

    def touch(self, block_id: int):
        if block_id in self._blocks:
            self._blocks.move_to_end(block_id)

    def put(self, block_id: int, dev, nbytes: int) -> int:
        """Adopt a device copy; LRU-drops others past the budget. Returns
        copies dropped (device->host demotions)."""
        if block_id in self._blocks:
            self._blocks.move_to_end(block_id)
            return 0
        self._blocks[block_id] = (dev, nbytes)
        self.bytes_resident += nbytes
        dropped = 0
        while self.bytes_resident > self.capacity_bytes and len(self._blocks) > 1:
            bid = next(iter(self._blocks))
            self.drop(bid)
            dropped += 1
        return dropped

    def drop(self, block_id: int):
        entry = self._blocks.pop(block_id, None)
        if entry is not None:
            self.bytes_resident -= entry[1]
            self.note_dropped(block_id)

    def note_dropped(self, block_id: int):
        """Log a dropped id for the other ranks' copies (no-op without)."""
        if self.dropped is not None:
            self.dropped.append(block_id)


class TieredPrefixCacheManager(PrefixCacheManager):
    """`PrefixCacheManager` with a device hot tier above the host pool and
    an async disk spill tier below it.

    Lookup resolution: disk promotion first (spilled chain tails re-enter
    the host pool), then the ordinary host match/lease; leases whose whole
    chain holds device copies are stamped `tier="device"` and the engine
    attaches them without any host->device copy (`device_kv`). Host hits
    promote their chain toward the device tier for the NEXT hit
    (promote-on-hit). Host eviction spills victims to disk instead of
    discarding (spill-on-evict) on the `kv-spill-*` worker thread.

    to_device(host_block) makes one block's device copy. The engine passes
    its own (its device and stream, the cache dtype); by default a device
    tier copies onto the current CUDA device, as JAX's `device_put` onto the
    default device, and raises without a GPU.
    """

    def __init__(self, block_size: int, capacity_bytes: int, *, name: str = "",
                 device_bytes: int = 0,
                 to_device: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 spill_dir: str = "", spill_bytes: int = 0):
        super().__init__(block_size, capacity_bytes, name=name)
        if device_bytes > 0 and to_device is None:
            device = resolve_device()
            to_device = lambda host: host.to(device)  # noqa: E731
        self._device = DeviceHotTier(device_bytes) if device_bytes > 0 else None
        self._to_device = to_device
        # copy(block_id, host): a tensor-parallel engine's promotion
        # (`share_device_tier`); None copies with to_device.
        self._copy: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None
        self._disk = DiskSpillStore(spill_dir, spill_bytes) if spill_dir else None
        self._tiers = {
            "hits_device": 0, "hits_host": 0, "hits_disk": 0,
            "promotions_device": 0, "promotions_host": 0,
            "demotions_device": 0,
            "spills": 0, "spill_bytes": 0, "spill_drops": 0,
            "remote_inserts": 0, "remote_insert_tokens": 0,
        }
        # Async spill plumbing: bounded queue + lazy worker. A full queue
        # DROPS the spill (counted) — back-pressuring eviction on disk IO
        # would put the disk on the serving path.
        self._spill_q: "queue.Queue" = queue.Queue(maxsize=64)
        self._spill_thread: Optional[threading.Thread] = None
        self._closed = False

    # -- lookup across tiers ------------------------------------------------
    def lookup(self, token_ids: Sequence[int], namespace: int = 0
               ) -> Optional[PrefixLease]:
        token_ids = list(token_ids)
        promoted_from_disk = 0
        if self._disk is not None:
            promoted_from_disk = self._promote_from_disk(token_ids, namespace)
        lease = super().lookup(token_ids, namespace)
        if lease is None:
            return None
        missing: List[int] = []
        with self._lock:
            if self._device is not None:
                missing = [b for b in lease.block_ids
                           if self._device.get(b) is None]
                for bid in lease.block_ids:
                    self._device.touch(bid)
            if promoted_from_disk:
                lease.tier = "disk"
                self._tiers["hits_disk"] += 1
            elif self._device is not None and not missing:
                lease.tier = "device"
                self._tiers["hits_device"] += 1
            else:
                self._tiers["hits_host"] += 1
        if self._device is not None and missing:
            # Promote-on-hit toward the device tier, OUTSIDE the lock (the
            # copy must never ride it); the copy serves the NEXT hit on
            # this chain with a zero-H2D attach.
            self._promote_to_device(missing)
        return lease

    def device_kv(self, lease: PrefixLease) -> Optional[torch.Tensor]:
        """The leased chain as ONE device-resident tensor, or None unless
        EVERY block holds a device copy (a partial stitch would pay the H2D
        it exists to avoid). Safe outside the lock: the lease pins the host
        blocks, and device copies are never written — a concurrent LRU drop
        only unmaps OUR dict entry, not the fetched references. The
        concatenation runs on the caller's current stream."""
        if self._device is None:
            return None
        with self._lock:
            devs = [self._device.get(bid) for bid in lease.block_ids]
            if not devs or any(d is None for d in devs):
                return None
            for bid in lease.block_ids:
                self._device.touch(bid)
        return devs[0] if len(devs) == 1 else torch.cat(devs, dim=2)

    def _promote_to_device(self, block_ids: List[int]):
        for bid in block_ids:
            with self._lock:
                block = self._pool._blocks.get(bid)
                if block is None or self._device.get(bid) is not None:
                    continue
                host = block.kv
            try:
                # Outside the lock: a real copy.
                dev = self._to_device(host) if self._copy is None else self._copy(bid, host)
            except torch.cuda.OutOfMemoryError:
                return  # device under pressure: the host tier still serves
            with self._lock:
                if self._pool._blocks.get(bid) is None:
                    # Evicted while we copied: drop the orphan (and the
                    # other ranks' copies of it).
                    self._device.note_dropped(bid)
                    continue
                # The host block's bytes: on the CPU `to_device` may hand
                # back the host tensor itself, which the tier still counts.
                dropped = self._device.put(bid, dev, host.nbytes)
                self._tiers["promotions_device"] += 1
                self._tiers["demotions_device"] += dropped

    def share_device_tier(self, copy: Callable[[int, torch.Tensor], torch.Tensor]) -> None:
        """Make the hot tier rank 0's book of a tensor-parallel engine's
        copies. `copy(block_id, host)` replaces `to_device`: it gives every
        rank its slice of the block and returns rank 0's, or raises
        `torch.cuda.OutOfMemoryError` on every rank's behalf (the promotion
        then stops, as on one device). The tier keeps its ids, LRU order and
        bytes (each block's whole `nbytes`, as on one device) and logs every
        id it drops from here on; the engine passes them to the other ranks
        (`take_dropped`), since drops happen under the lock, where no
        collective may run."""
        if self._device is None:
            raise ValueError("this manager has no device tier to share")
        with self._lock:
            if len(self._device):
                raise ValueError("share the device tier before it holds a copy")
            self._copy = copy
            self._device.dropped = []

    def take_dropped(self) -> List[int]:
        """The ids the shared hot tier dropped since the last call, in order
        ([] when the tier is not shared)."""
        if self._device is None or self._device.dropped is None:
            return []
        with self._lock:
            out, self._device.dropped = self._device.dropped, []
        return out

    def release_device_tier(self) -> None:
        """Drop every device copy (a tensor-parallel engine's shutdown, which
        frees every rank's slices)."""
        if self._device is not None:
            with self._lock:
                for bid in list(self._device._blocks):
                    self._device.drop(bid)

    # -- disk tier ----------------------------------------------------------
    def _promote_from_disk(self, token_ids: List[int], namespace: int) -> int:
        """Extend the in-memory chain with committed spill entries: read the
        files (outside any lock), then re-insert through the ordinary insert
        path (which dedups, evicts to fit, and re-links the radix chain).
        Returns blocks promoted."""
        bs = self.block_size
        usable = len(token_ids) - 1  # same cap as lookup: one token prefills
        with self._lock:
            nodes = self._radix.match(token_ids, namespace)
            start = len(nodes)
            head_ids = [n.block_id for n in nodes]
            # Pin the matched head: the promoted tail re-inserts as one
            # chain, and the head's rows must still exist to stage it.
            self._pool.incref(head_ids)
        promoted: List[torch.Tensor] = []
        try:
            i = start
            while (i + 1) * bs <= usable:
                kv = self._disk.get(
                    self._disk.key(namespace, token_ids[: (i + 1) * bs])
                )
                if kv is None or kv.shape[2] != bs:
                    break
                promoted.append(kv)
                i += 1
            if not promoted:
                return 0
            head = [self._pool.get(bid) for bid in head_ids]
        finally:
            with self._lock:
                self._pool.decref(head_ids)
        chain_kv = torch.cat(head + promoted, dim=2)
        n_tokens = chain_kv.shape[2]
        added = self.insert(token_ids[:n_tokens], chain_kv, namespace)
        with self._lock:
            self._tiers["promotions_host"] += added
        return added

    def _spill_worker(self):
        while True:
            item = self._spill_q.get()
            if item is None:
                return
            key, kv = item
            try:
                if self._disk.put(key, kv):
                    with self._lock:
                        self._tiers["spills"] += 1
                        self._tiers["spill_bytes"] += kv.nbytes
            except Exception:
                pass  # a failing spill is a future miss, never a crash

    def _enqueue_spill(self, key: str, kv: torch.Tensor):
        """Caller holds the manager lock: queue-put only, no IO."""
        if self._closed:
            return
        if self._spill_thread is None:
            self._spill_thread = threading.Thread(
                target=self._spill_worker, daemon=True,
                name=f"kv-spill-{self.name}",
            )
            self._spill_thread.start()
        try:
            self._spill_q.put_nowait((key, kv))
        except queue.Full:
            self._tiers["spill_drops"] += 1

    # -- eviction: spill instead of discard ----------------------------------
    def _evict_to_fit(self, incoming_bytes: int) -> bool:
        """Base LRU leaf-first eviction, with two tier hooks per victim
        (caller holds the lock): its device copy drops, and its bytes are
        queued for the disk tier instead of vanishing. The queued reference
        keeps the tensor alive after pool.free — the spill worker writes it
        out of band."""
        evicted = 0
        while self._pool.over_capacity(incoming_bytes):
            victims = [
                leaf for leaf in self._radix.leaves()
                if self._pool.evictable(leaf.block_id)
            ]
            if not victims:
                break
            victim = min(victims, key=lambda n: self._pool.last_used(n.block_id))
            if self._device is not None:
                self._device.drop(victim.block_id)
            if self._disk is not None:
                ns, tokens = self._radix.chain_of(victim)
                self._enqueue_spill(
                    self._disk.key(ns, tokens), self._pool.get(victim.block_id)
                )
            self._radix.remove_leaf(victim)
            self._pool.free(victim.block_id)
            evicted += 1
        if evicted:
            self._counters["evicted_blocks"] += evicted
        return not self._pool.over_capacity(incoming_bytes)

    # -- cluster prefix plane landing point ----------------------------------
    def insert_remote(self, token_ids: Sequence[int], kv, namespace: int = 0) -> int:
        """Insert a prefix fetched from a PEER replica's cache: ordinary
        insert plus remote-tier accounting, so the fleet view can tell
        recomputed prefixes from fetched ones."""
        added = self.insert(token_ids, kv, namespace)
        with self._lock:
            self._tiers["remote_inserts"] += 1
            self._tiers["remote_insert_tokens"] += added * self.block_size
        return added

    # -- report path ---------------------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            tiers = dict(self._tiers)
            tiers["device_blocks"] = 0 if self._device is None else len(self._device)
            tiers["device_bytes"] = (
                0 if self._device is None else self._device.bytes_resident
            )
            tiers["spill_queued"] = self._spill_q.qsize()
        if self._disk is not None:
            tiers["disk_bytes"] = self._disk.stats()["bytes_resident"]
        else:
            tiers["disk_bytes"] = 0
        out["tiers"] = tiers
        return out

    def close(self):
        """Stop the spill worker (engine shutdown path). Queued spills are
        flushed first — an evicted-but-unwritten block would otherwise be
        lost to every tier."""
        self._closed = True
        thread = self._spill_thread
        if thread is not None:
            self._spill_q.put(None)
            thread.join(timeout=10)
            self._spill_thread = None


__all__ = ["DeviceHotTier", "DiskSpillStore", "SpillFile",
           "TieredPrefixCacheManager"]
