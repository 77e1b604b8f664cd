"""Paged KV prefix cache for the LLM serve plane.

The port of `ray_tpu/llm/kvcache/`: KV blocks live HOST-side in a
ref-counted pool (`block_pool.py`), a radix/trie index over token-id chunks
maps prefixes to block chains (`radix.py`), and `PrefixCacheManager`
(`manager.py`) leases the longest cached prefix to the engine's attach path
so only the prompt suffix pays prefill FLOPs (design parity: vLLM's
PagedAttention block tables and SGLang's RadixAttention tree). `tiers.py`
grows the flat pool into a device/host/disk hierarchy
(`TieredPrefixCacheManager`): device-resident hot blocks attach with zero
H2D copies, and host eviction spills to local disk instead of discarding.
"""

from ray_tpu_torch.llm.kvcache.block_pool import KVBlockPool
from ray_tpu_torch.llm.kvcache.manager import PrefixCacheManager, PrefixLease
from ray_tpu_torch.llm.kvcache.radix import RadixIndex, RadixNode
from ray_tpu_torch.llm.kvcache.tiers import (
    DeviceHotTier,
    DiskSpillStore,
    TieredPrefixCacheManager,
)

__all__ = [
    "KVBlockPool",
    "PrefixCacheManager",
    "PrefixLease",
    "RadixIndex",
    "RadixNode",
    "DeviceHotTier",
    "DiskSpillStore",
    "TieredPrefixCacheManager",
]
