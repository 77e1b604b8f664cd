"""Radix/trie prefix index over fixed-size token-id chunks.

Nodes are one KV block each: the edge key is the tuple of `block_size` token
ids the block covers, so a root-to-node path spells a token prefix in whole
blocks and carries the pool block ids to rebuild its KV (SGLang's
RadixAttention tree, quantized to the block granularity vLLM's pool uses —
fixed-size chunks mean no node splitting, which keeps eviction leaf-local).

A copy of `ray_tpu/llm/kvcache/radix.py` (pure Python; the port imports
nothing of ray_tpu).

Synchronization contract: no internal lock — `PrefixCacheManager` serializes
every call under its single manager lock (see block_pool.py). Methods never
block or call out, so nothing can deadlock or suspend while the manager lock
is held.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Chunk = Tuple[int, ...]


class RadixNode:
    __slots__ = ("key", "block_id", "parent", "children", "namespace")

    def __init__(self, key: Optional[Chunk], block_id: Optional[int],
                 parent: Optional["RadixNode"]):
        self.key = key            # None only at the root
        self.block_id = block_id  # None only at the root
        self.parent = parent
        self.children: Dict[Chunk, RadixNode] = {}
        self.namespace = 0        # meaningful only at roots (set by _root)

    def is_leaf(self) -> bool:
        return not self.children


class RadixIndex:
    """Prefix tree per namespace (namespace = LoRA adapter index: KV rows
    depend on the adapter's k/v deltas, so chains must never cross adapters)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._roots: Dict[int, RadixNode] = {}
        self.num_nodes = 0

    def chunks(self, token_ids: Sequence[int]) -> List[Chunk]:
        """Full blocks only; the tail partial chunk never enters the index."""
        bs = self.block_size
        return [
            tuple(token_ids[i : i + bs])
            for i in range(0, len(token_ids) - len(token_ids) % bs, bs)
        ]

    def _root(self, namespace: int) -> RadixNode:
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = RadixNode(None, None, None)
            root.namespace = namespace
        return root

    def chain_of(self, node: RadixNode) -> Tuple[int, List[int]]:
        """(namespace, token ids root..node) — the identity of the prefix a
        node's block caches; the spill tier's content address is derived
        from exactly this (tiers.py)."""
        chunks: List[Chunk] = []
        n = node
        while n.parent is not None:
            chunks.append(n.key)
            n = n.parent
        tokens: List[int] = []
        for chunk in reversed(chunks):
            tokens.extend(chunk)
        return n.namespace, tokens

    def match(self, token_ids: Sequence[int], namespace: int = 0) -> List[RadixNode]:
        """Longest chain of nodes covering a whole-block prefix of token_ids."""
        node = self._roots.get(namespace)
        out: List[RadixNode] = []
        if node is None:
            return out
        for chunk in self.chunks(token_ids):
            child = node.children.get(chunk)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def insert(self, chunks: Iterable[Chunk], block_ids: Sequence[Optional[int]],
               namespace: int = 0) -> Tuple[List[RadixNode], List[RadixNode]]:
        """Walk/extend the tree along `chunks`. block_ids[i] is consumed only
        when chunk i creates a new node (None = caller had no block to offer,
        stop extending there). Returns (reused_nodes, created_nodes)."""
        node = self._root(namespace)
        reused: List[RadixNode] = []
        created: List[RadixNode] = []
        for chunk, bid in zip(chunks, block_ids):
            child = node.children.get(chunk)
            if child is None:
                if bid is None:
                    break
                child = RadixNode(chunk, bid, node)
                node.children[chunk] = child
                self.num_nodes += 1
                created.append(child)
            else:
                reused.append(child)
            node = child
        return reused, created

    def remove_leaf(self, node: RadixNode):
        if node.children:
            raise RuntimeError("cannot remove an interior radix node")
        if node.parent is None:
            raise RuntimeError("cannot remove a radix root")
        del node.parent.children[node.key]
        node.parent = None
        self.num_nodes -= 1

    def leaves(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                else:
                    out.append(node)
        return out
