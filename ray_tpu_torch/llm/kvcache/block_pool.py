"""Ref-counted host-side KV block pool with LRU accounting.

A copy of `ray_tpu/llm/kvcache/block_pool.py` with CPU torch tensors in
place of numpy arrays, plus `held_bytes`, which sizes the manager's
`insert_missing` read. One block is a tensor of shape [L, 2, block_size,
Hkv, D] in the engine's cache dtype (bf16 on the card, whose numpy has no
bfloat16), so a block's `nbytes` equal those of JAX's block of the same shape
and dtype, and one capacity evicts the same blocks in both packages. Blocks
are position-dependent (RoPE is applied before cache writes), which is
exactly why they are only ever reused for true token-id *prefixes* — the
radix index guarantees that.

Synchronization contract: the pool is a passive structure with NO internal
lock. Every caller goes through `PrefixCacheManager`, which serializes pool
and radix mutations under one manager lock (coarse-grained, the SGLang
radix-cache discipline).
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import torch


class KVBlock:
    __slots__ = ("block_id", "kv", "refs", "last_used")

    def __init__(self, block_id: int, kv: torch.Tensor):
        self.block_id = block_id
        self.kv = kv
        self.refs = 0        # active request leases; >0 pins against eviction
        self.last_used = 0   # logical LRU clock tick, set by the pool


class KVBlockPool:
    """Fixed-token-size KV blocks with refcounts and byte accounting.

    Eviction policy lives in the manager (it needs the radix structure to
    evict whole unreferenced chains leaf-first); the pool enforces the
    mechanics: a ref-held block can never be freed.
    """

    def __init__(self, capacity_bytes: int, block_size: int):
        self.capacity_bytes = int(capacity_bytes)
        self.block_size = int(block_size)
        self.bytes_resident = 0
        self._blocks: Dict[int, KVBlock] = {}
        self._ids = itertools.count()
        self._clock = itertools.count(1)

    def __len__(self) -> int:
        return len(self._blocks)

    def put_owned(self, kv: torch.Tensor) -> int:
        """Store one block the caller already copied/owns (no second copy).
        The manager's insert path stages its copies OUTSIDE the manager lock
        and hands the owned tensors in here, so the lock never covers a bulk
        memcpy."""
        if kv.shape[2] != self.block_size:
            raise ValueError(
                f"block rows {kv.shape[2]} != pool block_size {self.block_size}"
            )
        block = KVBlock(next(self._ids), kv)
        block.last_used = next(self._clock)
        self._blocks[block.block_id] = block
        self.bytes_resident += block.kv.nbytes
        return block.block_id

    def get(self, block_id: int) -> torch.Tensor:
        return self._blocks[block_id].kv

    def incref(self, block_ids: List[int]):
        for bid in block_ids:
            self._blocks[bid].refs += 1

    def decref(self, block_ids: List[int]):
        for bid in block_ids:
            block = self._blocks[bid]
            if block.refs <= 0:
                raise RuntimeError(f"kv block {bid} released more than leased")
            block.refs -= 1

    def touch(self, block_ids: List[int]):
        tick = next(self._clock)
        for bid in block_ids:
            self._blocks[bid].last_used = tick

    def last_used(self, block_id: int) -> int:
        return self._blocks[block_id].last_used

    def evictable(self, block_id: int) -> bool:
        block = self._blocks.get(block_id)
        return block is not None and block.refs == 0

    def free(self, block_id: int) -> int:
        """Drop an unreferenced block; returns the bytes reclaimed."""
        block = self._blocks[block_id]
        if block.refs > 0:
            raise RuntimeError(f"kv block {block_id} is ref-held; cannot free")
        del self._blocks[block_id]
        self.bytes_resident -= block.kv.nbytes
        return block.kv.nbytes

    def held_bytes(self, also: List[int] = ()) -> int:
        """Bytes of the blocks no eviction can free now: the ref-held ones and
        `also` (blocks the caller is about to pin). Every other block can go:
        a lease pins its whole chain from the root, so no unreferenced block
        sits above a referenced one, and leaf-first eviction reaches it."""
        also = set(also)
        return sum(b.kv.nbytes for bid, b in self._blocks.items()
                   if b.refs > 0 or bid in also)

    def over_capacity(self, incoming_bytes: int = 0) -> bool:
        return self.bytes_resident + incoming_bytes > self.capacity_bytes
