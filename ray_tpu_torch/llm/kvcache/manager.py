"""PrefixCacheManager: the lock-owning front of the paged KV prefix cache.

A copy of `ray_tpu/llm/kvcache/manager.py`. Three things differ: blocks are
CPU torch tensors (block_pool.py), the `llm_prefix_cache_*` metrics are
gone — `stats()` reports the same counters as plain ints — and
`insert_missing` lets the engine read back from the device only the blocks
an insert can add, with insert()'s counters.

Combines the ref-counted block pool and the radix prefix index under ONE
manager lock (coarse-grained, the discipline SGLang's radix cache uses under
its scheduler lock): every pool/radix mutation happens inside `self._lock`,
and neither structure carries a lock of its own, so there is no lock-order
graph to get wrong. Nothing under the lock blocks, awaits, or dispatches to
a device — lookups and inserts are pure host bookkeeping plus host copies.

Leases: `lookup()` pins the matched chain (refcounts) and hands back a
`PrefixLease`; the engine attaches the lease's KV, prefills only the suffix,
and releases the lease once the attach landed. Eviction (LRU, leaf-first,
whole unreferenced chain tails) can therefore never free rows a request is
about to attach.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.llm.kvcache.block_pool import KVBlockPool
from ray_tpu_torch.llm.kvcache.radix import RadixIndex


def host_kv(kv: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """A KV array as a CPU tensor without copying: numpy (bfloat16 arrays of
    ml_dtypes are viewed through their 2-byte pattern) or a CPU tensor. A
    device tensor is refused: the pool holds host rows only."""
    if isinstance(kv, torch.Tensor):
        if kv.device.type != "cpu":
            raise ValueError(f"prefix-cache KV must be on the host, not {kv.device}")
        return kv
    kv = np.asarray(kv)
    if kv.dtype.name == "bfloat16":
        return torch.from_numpy(kv.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(kv)


class PrefixLease:
    """A pinned cached prefix: block chain + token count, released after attach."""

    __slots__ = ("_manager", "block_ids", "matched_tokens", "namespace",
                 "tier", "_released")

    def __init__(self, manager: "PrefixCacheManager", block_ids: List[int],
                 matched_tokens: int, namespace: int):
        self._manager = manager
        self.block_ids = block_ids
        self.matched_tokens = matched_tokens
        self.namespace = namespace
        # Which tier served this hit: always "host" (the port has the host
        # pool only); the engine's cache-attach flight event carries it.
        self.tier = "host"
        self._released = False

    def kv(self) -> torch.Tensor:
        """[L, 2, matched_tokens, Hkv, D] — a new tensor, the concatenation
        of the leased blocks (it owns its memory: the blocks may be evicted
        once the lease is released). Safe outside the manager lock: the
        lease's refcounts pin every block."""
        blocks = [self._manager._pool.get(bid) for bid in self.block_ids]
        return torch.cat(blocks, dim=2)

    def release(self):
        if not self._released:
            self._released = True
            self._manager._release(self.block_ids)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class PrefixCacheManager:
    """Block-granular KV prefix reuse for one engine (one model + layout)."""

    def __init__(self, block_size: int, capacity_bytes: int, name: str = ""):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive (0 disables the "
                             "cache at the engine level; don't build a manager)")
        self.block_size = int(block_size)
        self.name = name or f"pool-{id(self):x}"
        self._pool = KVBlockPool(capacity_bytes, block_size)
        self._radix = RadixIndex(block_size)
        self._lock = threading.Lock()
        self._counters = {
            "lookups": 0, "hits": 0, "misses": 0, "hit_tokens": 0,
            "inserted_blocks": 0, "evicted_blocks": 0, "rejected_blocks": 0,
            # Full-coverage leases handed out by lease_prefix (exports, not
            # serving hits).
            "exports": 0,
            # Leases pinned right now. With the iteration-level scheduler a
            # lease can span plan->attach across an engine iteration, so the
            # live count is real observability (a stuck lease pins its chain
            # against eviction).
            "leases_active": 0,
        }

    # -- lookup / lease ----------------------------------------------------
    def lookup(self, token_ids: Sequence[int], namespace: int = 0
               ) -> Optional[PrefixLease]:
        """Lease the longest cached whole-block prefix of token_ids, capped at
        len(token_ids) - 1 tokens: the engine must prefill at least one real
        token to produce last-position logits for sampling."""
        token_ids = list(token_ids)
        with self._lock:
            self._counters["lookups"] += 1
            nodes = self._radix.match(token_ids, namespace)
            while nodes and len(nodes) * self.block_size > len(token_ids) - 1:
                nodes.pop()
            if not nodes:
                self._counters["misses"] += 1
                return None
            block_ids = [n.block_id for n in nodes]
            self._pool.incref(block_ids)
            self._pool.touch(block_ids)
            matched = len(block_ids) * self.block_size
            self._counters["hits"] += 1
            self._counters["hit_tokens"] += matched
            self._counters["leases_active"] += 1
        return PrefixLease(self, block_ids, matched, namespace)

    def lease_prefix(self, token_ids: Sequence[int], namespace: int = 0
                     ) -> Optional[PrefixLease]:
        """Full-coverage lease of the longest cached whole-block prefix —
        the export path: no len-1 cap (nothing prefills here; the caller
        wants every cached row), and the hit/miss counters are untouched (an
        export is not serving traffic). The lease pins its chain until it is
        released — release it in a finally."""
        token_ids = list(token_ids)
        with self._lock:
            nodes = self._radix.match(token_ids, namespace)
            if not nodes:
                return None
            block_ids = [n.block_id for n in nodes]
            self._pool.incref(block_ids)
            self._pool.touch(block_ids)
            self._counters["exports"] += 1
            self._counters["leases_active"] += 1
        return PrefixLease(self, block_ids,
                           len(block_ids) * self.block_size, namespace)

    def _release(self, block_ids: List[int]):
        with self._lock:
            self._pool.decref(block_ids)
            self._counters["leases_active"] -= 1

    # -- insert ------------------------------------------------------------
    def _stage_block(self, kv: torch.Tensor, i: int) -> torch.Tensor:
        """Copy chunk i's rows out of the caller's kv into an owned block
        tensor. ALWAYS runs with the manager lock NOT held: for a multi-MB
        prompt this memcpy is the dominant cost of insert, and holding the
        lock across it stalls every concurrent lookup."""
        bs = self.block_size
        return kv[:, :, i * bs : (i + 1) * bs].clone(
            memory_format=torch.contiguous_format)

    def insert(self, token_ids: Sequence[int],
               kv: Union[np.ndarray, torch.Tensor], namespace: int = 0) -> int:
        """Insert the KV rows of token_ids' whole blocks. kv is
        [L, 2, P, Hkv, D] on the host (numpy or a CPU tensor) with P >= the
        whole-block token count; rows beyond it are ignored (padded buckets
        pass through unsliced). Existing chain prefixes dedup against the
        tree; new blocks are copied into the pool (the copies staged OUTSIDE
        the manager lock), evicting LRU unreferenced chain tails to fit.
        Returns blocks added."""
        token_ids = list(token_ids)
        chunks = self._radix.chunks(token_ids)
        if not chunks:
            return 0
        kv = host_kv(kv)
        if kv.shape[2] < len(chunks) * self.block_size:
            raise ValueError(
                f"kv has {kv.shape[2]} rows < {len(chunks)} blocks of "
                f"{self.block_size}"
            )
        # Peek the dedup point, then stage the new blocks' copies unlocked.
        with self._lock:
            n_peek = len(self._radix.match(token_ids, namespace))
        staged: Dict[int, torch.Tensor] = {
            i: self._stage_block(kv, i) for i in range(n_peek, len(chunks))
        }
        return self._link(token_ids, chunks, staged, namespace,
                          restage=lambda i: self._stage_block(kv, i))

    def insert_missing(self, token_ids: Sequence[int],
                       read_blocks: Callable[[int, int], List[torch.Tensor]],
                       block_nbytes: int, namespace: int = 0) -> int:
        """insert() for a caller whose rows are costly to read (the engine's
        device cache): only the blocks the tree lacks AND the capacity can
        hold are read. read_blocks(first, stop) returns token_ids' blocks
        [first, stop) on the host, one [L, 2, block_size, Hkv, D] tensor of
        block_nbytes each, which the pool keeps as they are: each must own
        its memory (no view of a larger tensor). The room is what remains of
        the capacity once every evictable block is gone: the ref-held blocks
        (leased chains and the dedup'd prefix this insert pins) stay. The
        blocks not read count as rejected, so the counters equal insert()'s
        for the same calls. Returns blocks added."""
        token_ids = list(token_ids)
        chunks = self._radix.chunks(token_ids)
        if not chunks:
            return 0
        with self._lock:
            existing = [n.block_id for n in self._radix.match(token_ids, namespace)]
            free = self._pool.capacity_bytes - self._pool.held_bytes(existing)
            first = len(existing)
            stop = first + max(0, min(len(chunks) - first, free // block_nbytes))
        staged: Dict[int, torch.Tensor] = {}
        if stop > first:
            staged = dict(zip(range(first, stop), read_blocks(first, stop)))
        return self._link(token_ids, chunks, staged, namespace, restage=None)

    def _link(self, token_ids: List[int], chunks: list,
              staged: Dict[int, torch.Tensor], namespace: int,
              restage: Optional[Callable[[int], torch.Tensor]]) -> int:
        """The locked half of an insert: dedup against the tree as it is
        now, put the staged blocks that fit, link them under the chain."""
        with self._lock:
            existing = self._radix.match(token_ids, namespace)
            # match() is uncapped here; it can cover every chunk (full dedup).
            n_existing = len(existing)
            prot = [n.block_id for n in existing]
            # Pin the dedup'd prefix for the duration of the insert: eviction
            # freeing an ancestor mid-insert would orphan the new tail blocks
            # (their chain could never be attached to the tree).
            self._pool.incref(prot)
            self._pool.touch(prot)
            new_ids: List[Optional[int]] = []
            try:
                for i in range(n_existing, len(chunks)):
                    # Rare race: the chain SHRANK between peek and lock
                    # (eviction freed part of it), so blocks below the peek
                    # point weren't staged — insert() copies them here; the
                    # gap is at most the few blocks eviction took.
                    # insert_missing() has no rows for them and drops the
                    # tail, as it does past what the capacity holds.
                    block = staged.get(i)
                    if block is None and restage is not None:
                        block = restage(i)
                    if block is None or not self._evict_to_fit(block.nbytes):
                        # Everything evictable is gone and ref-held blocks fill
                        # the budget: drop the chain tail rather than overshoot.
                        self._counters["rejected_blocks"] += len(chunks) - i
                        break
                    new_ids.append(self._pool.put_owned(block))
                if new_ids:
                    self._radix.insert(
                        chunks, [None] * n_existing + new_ids, namespace
                    )
                    self._counters["inserted_blocks"] += len(new_ids)
            finally:
                self._pool.decref(prot)
        return len(new_ids)

    # -- eviction ----------------------------------------------------------
    def _evict_to_fit(self, incoming_bytes: int) -> bool:
        """LRU leaf-first eviction until incoming_bytes fits. Caller holds the
        lock. Interior blocks free once their subtree is gone, so an
        unreferenced chain unwinds tail-to-head across iterations."""
        evicted = 0
        while self._pool.over_capacity(incoming_bytes):
            victims = [
                leaf for leaf in self._radix.leaves()
                if self._pool.evictable(leaf.block_id)
            ]
            if not victims:
                break
            victim = min(victims, key=lambda n: self._pool.last_used(n.block_id))
            self._radix.remove_leaf(victim)
            self._pool.free(victim.block_id)
            evicted += 1
        if evicted:
            self._counters["evicted_blocks"] += evicted
        return not self._pool.over_capacity(incoming_bytes)

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["blocks_resident"] = len(self._pool)
            out["bytes_resident"] = self._pool.bytes_resident
            out["capacity_bytes"] = self._pool.capacity_bytes
            out["block_size"] = self.block_size
            lookups = max(1, out["lookups"])
            out["hit_rate"] = out["hits"] / lookups
        return out
