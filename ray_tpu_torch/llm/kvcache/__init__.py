"""Paged KV prefix cache for the LLM serve plane.

The port of `ray_tpu/llm/kvcache/` without its tiers: KV blocks live
HOST-side in a ref-counted pool (`block_pool.py`), a radix/trie index over
token-id chunks maps prefixes to block chains (`radix.py`), and
`PrefixCacheManager` (`manager.py`) leases the longest cached prefix to the
engine's attach path so only the prompt suffix pays prefill FLOPs (design
parity: vLLM's PagedAttention block tables and SGLang's RadixAttention
tree). The device and disk tiers (`ray_tpu/llm/kvcache/tiers.py`) are not
ported (ROADMAP.md, Queue 1 item 7).
"""

from ray_tpu_torch.llm.kvcache.block_pool import KVBlockPool
from ray_tpu_torch.llm.kvcache.manager import PrefixCacheManager, PrefixLease
from ray_tpu_torch.llm.kvcache.radix import RadixIndex, RadixNode

__all__ = [
    "KVBlockPool",
    "PrefixCacheManager",
    "PrefixLease",
    "RadixIndex",
    "RadixNode",
]
