"""Tensor-parallel serving: the split rules and one rank's share of the engine.

Twin of `ray_tpu/llm/tp.py`. JAX drives the whole mesh from one process and
GSPMD inserts the collectives; here each GPU has a process of its own
(`torch.distributed`, NCCL on the card, gloo on the CPU) and the engine's
forward calls the collectives itself. The rules are Megatron's, as JAX's
`param_spec` states them: q, k and v split by head (column-parallel), o
splits its head-contracted input (row-parallel); gate and up split the mlp
dimension, down contracts it back; the embedding splits its vocab rows and
lm_head its vocab columns; the per-slot KV pool splits on the kv-head axis.
Any dimension the degree does not divide is replicated instead.

A split here is a dimension index, not a PartitionSpec: `param_spec` returns
the dimension of a leaf that the "tp" axis cuts, or None. `TPShard` holds
what one rank of a tensor-parallel `DecodeEngine` needs: which dimensions
split, its slices of heads, kv heads and vocab, the engine's own two process
groups (one for the forward's collectives, one gloo group carrying rank 0's
announcements and the host-side KV rows), and the collectives themselves.

Numerics: the row-parallel partial products are taken in f32, summed over
the group in f32 and rounded once to the activation dtype; the embedding's
masked lookup is exact (one rank holds each row); the head's logits are the
same per column, so the vocab-split argmax is the whole row's first maximum.

Not ported: `mesh_signature`, `replicated`, `mesh_zeros` and
`single_device_shardings` (the port compiles no programs and places no
jax arrays), and `adapter_table_shardings`: a rank's columns of the LoRA B
factors follow the split of q and v themselves (`TPShard.q_cols`,
`v_cols`), not the divisibility of their widths.
"""

from __future__ import annotations

import datetime
import math
import threading
import uuid
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Seconds a collective of a TP engine's groups may wait before it raises:
# a rank that died without a word (its process killed) fails the others'
# operations after this long, never hangs them. A rank that fails in its
# own code reports it (`TPShard.report_failure`), and the others stop at
# once.
GROUP_TIMEOUT_S = 300.0
# How often each rank's watcher reads the store for a failure report.
WATCH_S = 0.1
# An idle rank 0 announces a no-op this often, so the followers' waits for
# the next operation stay inside GROUP_TIMEOUT_S.
PING_S = 10.0


def build_tp_mesh(tp, device=None):
    """``tp`` -> a DeviceMesh over the "tp" axis (`parallel.mesh.
    create_mesh`), or None for tp <= 1, the single-device engine. An int is
    the degree; a mapping passes its axes through. Needs torch.distributed
    initialised with the tp ranks (every rank of the job is one of them)."""
    if tp is None:
        return None
    axes = {k: int(v) for k, v in tp.items()} if isinstance(tp, Mapping) else {"tp": int(tp)}
    if all(v <= 1 for v in axes.values()):
        return None
    from ray_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(axes, device=device)


def tp_degree(mesh) -> int:
    """The size of the "tp" axis: of a DeviceMesh, of anything whose
    `.shape` maps axis names to sizes (JAX's Mesh), a mapping, or an int."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    if isinstance(mesh, Mapping):
        return int(mesh.get("tp", 1))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return int(mesh.mesh.shape[list(names).index("tp")]) if "tp" in names else 1
    return int(mesh.shape.get("tp", 1))


def tp_device_count(tp) -> int:
    """Devices one TP engine takes, without building a mesh (deployment
    code scales a replica's resources by it)."""
    if tp is None:
        return 1
    if isinstance(tp, Mapping):
        return max(1, math.prod(int(v) for v in tp.values())) if tp else 1
    return max(1, int(tp))


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> Optional[int]:
    """The dimension of one decode-engine parameter leaf that the "tp" axis
    splits, or None (replicated). Keyed on the leaf's tree path
    (layer_i/attn/{q,k,v,o}/kernel, layer_i/mlp/{gate,up,down}/kernel,
    embedding, lm_head/kernel); a dimension the degree does not divide, and
    every other leaf, replicates. JAX's rules, its PartitionSpec's one named
    dimension."""
    tp = tp_degree(mesh)

    def axis(i: int) -> Optional[int]:
        return None if tp <= 1 or shape[i] % tp else i

    parts = tuple(path)
    if len(parts) >= 3 and parts[-3] == "attn":
        if parts[-2] in ("q", "k", "v"):
            return axis(1)          # [hidden, heads, head_dim]: split heads
        if parts[-2] == "o":
            return axis(0)          # [heads, head_dim, hidden]: row-parallel
    if len(parts) >= 3 and parts[-3] == "mlp":
        if parts[-2] in ("gate", "up"):
            return axis(1)          # [hidden, mlp]: column-parallel
        if parts[-2] == "down":
            return axis(0)          # [mlp, hidden]: row-parallel
    if parts[-1] == "embedding":
        return axis(0)              # [vocab, hidden]: split the vocab rows
    if len(parts) >= 2 and parts[-2] == "lm_head":
        return axis(1)              # [hidden, vocab]: split the logits
    return None


def _full_shapes(cfg) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    from ray_tpu_torch.models.transformer import param_shapes

    return {path: shape for path, shape, _ in param_shapes(cfg)}


def shard_leaf(path: Tuple[str, ...], leaf, mesh, rank: int, shape=None):
    """Rank `rank`'s block of one parameter leaf (a numpy array or a torch
    tensor at the full shape `shape`, its own by default) along the
    dimension `param_spec` splits, copied so the whole leaf can be dropped;
    a replicated leaf as it is. A leaf already at rank `rank`'s shape passes
    through; one at neither shape raises."""
    tp = tp_degree(mesh)
    shape = tuple(leaf.shape) if shape is None else tuple(shape)
    dim = param_spec(path, shape, tp)
    if dim is None:
        return leaf
    n = shape[dim] // tp
    if tuple(leaf.shape) != shape:
        want = shape[:dim] + (n,) + shape[dim + 1:]
        if tuple(leaf.shape) != want:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)} is neither "
                             f"the full {shape} nor rank {rank}'s {want} at tp={tp}")
        return leaf
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(dim, rank * n, n).clone()
    index = [slice(None)] * len(shape)
    index[dim] = slice(rank * n, (rank + 1) * n)
    return np.array(np.asarray(leaf)[tuple(index)])


def shard_decode_params(params, mesh, rank: int, cfg=None):
    """Rank `rank`'s local tree sliced from a full tree (numpy arrays or
    torch tensors, the flax layout), leaf by leaf (`shard_leaf`). With `cfg`
    a leaf already at its local shape passes through (a tree restored
    region by region, `checkpoint_shardings`). It composes with
    `models/convert.params_from_jax` either way round."""
    full = _full_shapes(cfg) if cfg is not None else {}

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return shard_leaf(path, tree, mesh, rank, full.get(path))

    return walk(params, ())


def kv_cache_sharding(mesh, n_kv_heads: int) -> Optional[int]:
    """The split dimension of one per-slot cache layer [B, T, Hkv, D]: the
    kv-head axis, or None when the degree does not divide it."""
    tp = tp_degree(mesh)
    return 2 if tp > 1 and n_kv_heads % tp == 0 else None


def kv_prefix_sharding(mesh, n_kv_heads: int) -> Optional[int]:
    """The split dimension of a KV prefix [L, 2, P, Hkv, D] (the prefix
    cache's attach and read-back layout)."""
    tp = tp_degree(mesh)
    return 3 if tp > 1 and n_kv_heads % tp == 0 else None


def checkpoint_shardings(path: str, mesh) -> Dict[str, tuple]:
    """Manifest leaf key -> DTensor placements on `mesh` for `checkpoint.
    restore(path, mesh=mesh, placements=...)`: each rank reads only the
    file regions of its own slice of every leaf (`_restore.local_region`).
    A leading "params" segment (a train-state save) is ignored for the
    rules."""
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.checkpoint import load_manifest

    names = list(mesh.mesh_dim_names)
    out: Dict[str, tuple] = {}
    for key, spec in load_manifest(path)["leaves"].items():
        parts = tuple(p for p in key.split("/") if p)
        if parts and parts[0] == "params":
            parts = parts[1:]
        dim = param_spec(parts, tuple(int(d) for d in spec["shape"]), mesh)
        placements = [Replicate()] * len(names)
        if dim is not None:
            placements[names.index("tp")] = Shard(dim)
        out[key] = tuple(placements)
    return out


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _local_bytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def per_device_byte_map(tree_or_leaf, group=None) -> Dict[str, int]:
    """Bytes each rank holds of a tree of tensors (its local shards), keyed
    by the rank in `group` as a string; without a group, this process's
    bytes under its own rank ("0" without torch.distributed). Collective
    over `group`."""
    mine = _local_bytes(tree_or_leaf)
    if group is None:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        return {str(rank): mine}
    import torch.distributed as dist

    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    return {str(r): int(b) for r, b in enumerate(got)}


def per_device_bytes(tree_or_leaf, group=None) -> int:
    """The most bytes any rank of `group` holds of a tree of tensors (the
    per-GPU memory a TP engine's weights or KV need); collective over
    `group`, this process's own bytes without one."""
    return max(per_device_byte_map(tree_or_leaf, group).values(), default=0)


class ShardedKVPool:
    """One rank's per-slot KV pool: every layer's (k, v) caches at this
    rank's kv-head slice, [B, T, Hkv / tp, D] (all Hkv heads where tp does
    not divide them). `free()` drops the pool's references; it is
    idempotent, and the owning engine's shutdown calls it."""

    def __init__(self, *, n_layers: int, shape, dtype, device, tp: int, n_kv_heads: int,
                 name: str = ""):
        self.name = name or f"kvpool-{id(self):x}"
        self.split = kv_cache_sharding(tp, n_kv_heads)
        shape = list(shape)
        if self.split is not None:
            shape[self.split] //= tp
        self.shape = tuple(shape)
        self.n_layers = int(n_layers)
        self.caches = [(torch.zeros(self.shape, dtype=dtype, device=device),
                        torch.zeros(self.shape, dtype=dtype, device=device))
                       for _ in range(self.n_layers)]
        self.total_bytes = 2 * self.n_layers * math.prod(self.shape) * dtype.itemsize
        self.freed = False

    def free(self):
        if not self.freed:
            self.freed = True
            self.caches = None


class TPShard:
    """One rank's share of a tensor-parallel engine: the splits, its slices
    and the engine's process groups.

    Built collectively by the tp ranks (each creates the engine's two
    groups in the same order). `group` runs the forward's collectives over
    the engine's backend (NCCL for a CUDA device, gloo for the CPU); `ctl`
    is a gloo group for what travels between hosts: rank 0's announcements
    (`announce`/`receive`), the prefix cache's KV rows (`scatter_host`,
    `gather_host`), the ranks' agreement on an outcome (`agree`) and the
    stop handshake. Both wait at most `timeout_s`.

    A rank that fails reports it in the job's store (`report_failure`) and
    closes its groups. Over gloo that fails the others' pending operations
    at once. Over NCCL it does not (a collective waits on the card for a
    peer that will never come), so each rank runs a watcher thread that
    reads the store and aborts this rank's NCCL communicators when a report
    appears; the aborted collective ends with undefined outputs, which
    rank 0's `check` refuses before anything reads them.
    """

    def __init__(self, cfg, tp: int, device: torch.device, *,
                 timeout_s: float = GROUP_TIMEOUT_S):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"tp={tp} needs torch.distributed initialised on every rank of the tp "
                f"group: call init_process_group(backend, init_method=..., "
                f"world_size={tp}, rank=...) in each process first")
        world = dist.get_world_size()
        if world != tp:
            raise ValueError(f"a tp={tp} engine takes every rank of the job; the job has "
                             f"{world}")
        if device.type == "cuda" and device.index != torch.cuda.current_device():
            raise ValueError(f"rank {dist.get_rank()} serves on {device} but its current "
                             f"CUDA device is {torch.cuda.current_device()}: call "
                             f"torch.cuda.set_device first")
        self.tp = tp
        self.device = device
        timeout = datetime.timedelta(seconds=timeout_s)
        ranks = list(range(tp))
        self.group = dist.new_group(ranks, backend="nccl" if device.type == "cuda" else "gloo",
                                    timeout=timeout)
        self.ctl = dist.new_group(ranks, backend="gloo", timeout=timeout)
        self.rank = dist.get_rank(self.group)
        self.leader = self.rank == 0
        self._src = dist.get_global_rank(self.group, 0)
        # A name the ranks share, for the failure reports in the store.
        self.name = self.broadcast(uuid.uuid4().hex if self.leader else None)

        H, Hkv, F, V = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim, cfg.vocab_size
        r = self.rank
        self.q_split = H % tp == 0
        self.kv_split = kv_cache_sharding(tp, Hkv) is not None
        self.mlp_split = F % tp == 0
        self.vocab_split = V % tp == 0
        self.heads = H // tp if self.q_split else H
        self.kv_heads = Hkv // tp if self.kv_split else Hkv
        D = cfg.head_dim
        # The LoRA B factors' columns follow the projections they add into.
        self.q_cols = slice(r * self.heads * D, (r + 1) * self.heads * D) if self.q_split \
            else slice(0, H * D)
        self.v_cols = slice(r * self.kv_heads * D, (r + 1) * self.kv_heads * D) \
            if self.kv_split else slice(0, Hkv * D)
        self.vocab = (r * V // tp, (r + 1) * V // tp) if self.vocab_split else (0, V)
        self.kv_select = self._kv_select(H, Hkv, r)
        self.nccl = device.type == "cuda"
        self.failed = False  # a rank's failure report was seen
        self._closed = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name=f"tp-watch-{self.name[:8]}-r{r}")
        self._watcher.start()

    def _kv_select(self, H: int, Hkv: int, r: int):
        """The local cache's kv heads that this rank's query heads read,
        when q splits but kv does not: query head h reads kv head h // (H /
        Hkv). A slice where the local heads read a run of kv heads in equal
        groups (the local rule h // rep then holds on it), else an index
        with one kv head per query head (the heads straddle kv groups
        unevenly). None where the local rule holds on the whole cache."""
        if not self.q_split or self.kv_split:
            return None
        rep = H // Hkv
        idx = [(r * self.heads + j) // rep for j in range(self.heads)]
        lo, n = idx[0], idx[-1] - idx[0] + 1
        if self.heads % n == 0 and idx == [lo + j // (self.heads // n)
                                           for j in range(self.heads)]:
            return slice(lo, lo + n)
        return torch.tensor(idx, device=self.device)

    # -- the forward's collectives (group) ---------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def gather_vocab(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Logits over this rank's vocab slice [..., V / tp] -> the whole
        rows [..., V] on rank 0 (None on the others). A replicated head's
        logits are whole already."""
        if not self.vocab_split:
            return t if self.leader else None
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.tp)] if self.leader else None
        dist.gather(t, parts, dst=self._src, group=self.group)
        return torch.cat(parts, dim=-1) if self.leader else None

    def argmax(self, t: torch.Tensor) -> torch.Tensor:
        """The argmax over the whole vocab of logits split over the ranks,
        on every rank: each rank's first maximum and its global id, then the
        first rank holding the largest: the whole row's first maximum, as
        torch.argmax gives it."""
        if not self.vocab_split:
            return torch.argmax(t, dim=-1)
        import torch.distributed as dist

        val, idx = t.max(dim=-1)
        idx = idx + self.vocab[0]
        vals = [torch.empty_like(val) for _ in range(self.tp)]
        idxs = [torch.empty_like(idx) for _ in range(self.tp)]
        dist.all_gather(vals, val.contiguous(), group=self.group)
        dist.all_gather(idxs, idx.contiguous(), group=self.group)
        best = torch.argmax(torch.stack(vals), dim=0, keepdim=True)
        return torch.stack(idxs).gather(0, best)[0]

    # -- host traffic (ctl) -------------------------------------------------
    def broadcast(self, obj):
        """Rank 0's host object, on every rank."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self._src, group=self.ctl)
        return box[0]

    def announce(self, name: str, args) -> None:
        """Rank 0: hand the next operation and its host arguments to every
        follower, in order."""
        import torch.distributed as dist

        dist.broadcast_object_list([name, args], src=self._src, group=self.ctl)

    def receive(self):
        """A follower: (name, args) of rank 0's next operation."""
        import torch.distributed as dist

        box = [None, None]
        dist.broadcast_object_list(box, src=self._src, group=self.ctl)
        return box[0], box[1]

    def scatter_host(self, parts):
        """Rank 0 passes one host object per rank; each rank gets its own."""
        import torch.distributed as dist

        out = [None]
        dist.scatter_object_list(out, parts, src=self._src, group=self.ctl)
        return out[0]

    def gather_host(self, obj):
        """Every rank's host object, in rank order, on rank 0 (None on the
        others)."""
        import torch.distributed as dist

        got = [None] * self.tp if self.leader else None
        dist.gather_object(obj, got, dst=self._src, group=self.ctl)
        return got

    def agree(self, ok: bool) -> bool:
        """Whether `ok` holds on every rank, on every rank."""
        import torch.distributed as dist

        got = [None] * self.tp
        dist.all_gather_object(got, bool(ok), group=self.ctl)
        return all(got)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.ctl)

    # -- failure and teardown ------------------------------------------------
    def _store(self):
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()

    def report_failure(self, err: BaseException) -> None:
        """This rank's error, left where the other ranks read it (the job's
        store: rank 0 names it in its requests' failure, every rank's
        watcher sees it), then the groups closed and aborted."""
        try:
            store = self._store()
            store.set(f"tp/{self.name}/error/{self.rank}", f"{type(err).__name__}: {err}")
            store.add(f"tp/{self.name}/failed", 1)
        except Exception:
            pass  # the store is gone with its job: closing still fails the peers
        finally:
            self.close(abort=True)

    def _watch(self) -> None:
        """The watcher thread: until the groups close, read the store for a
        failure report; on one, mark it and abort the forward's NCCL
        communicators, so a collective this rank has pending on the failed
        rank ends now (an aborted gloo collective would not: gloo's end
        when the peer closes its connections)."""
        key = f"tp/{self.name}/failed"
        group = self.group
        try:
            store = self._store()
            while not self._closed.wait(WATCH_S):
                if store.check([key]):
                    self.failed = True
                    if self.nccl and hasattr(group, "abort"):
                        group.abort()
                    return
        except Exception:
            return  # the store or the group went with the job: nothing to watch

    def check(self) -> None:
        """Rank 0, after each operation: raise if a rank reported a failure.
        Over NCCL the stream is synchronised first, so an operation whose
        collective the watcher aborted is refused before its outputs are
        read."""
        if self.nccl:
            torch.cuda.current_stream(self.device).synchronize()
        if self.failed:
            raise RuntimeError("a rank of this tensor-parallel engine failed")

    def peer_error(self) -> Optional[str]:
        """What a follower reported before it closed (`report_failure`), or
        None."""
        try:
            store = self._store()
            for r in range(1, self.tp):
                key = f"tp/{self.name}/error/{r}"
                if store.check([key]):
                    return f"rank {r}: {store.get(key).decode()}"
        except Exception:  # the store is gone with its job: nothing to add
            return None
        return None

    def close(self, abort: bool = False) -> None:
        """Idempotent: destroy the engine's groups (aborting them first when
        a rank failed) and drop every reference to them, which closes their
        connections."""
        import torch.distributed as dist

        self._closed.set()
        if self._watcher is not threading.current_thread():
            self._watcher.join(timeout=5.0)  # before the groups go: it may be aborting one
        groups, self.group, self.ctl = [g for g in (self.group, self.ctl) if g is not None], \
            None, None
        for g in groups:
            if abort and hasattr(g, "abort"):
                try:
                    g.abort()
                except Exception:
                    pass  # already torn down by its peer
            try:
                dist.destroy_process_group(g)
            except Exception:
                pass  # the default group (or the job) is gone already


__all__ = [
    "GROUP_TIMEOUT_S",
    "WATCH_S",
    "ShardedKVPool",
    "TPShard",
    "build_tp_mesh",
    "checkpoint_shardings",
    "kv_cache_sharding",
    "kv_prefix_sharding",
    "param_spec",
    "per_device_byte_map",
    "per_device_bytes",
    "shard_decode_params",
    "shard_leaf",
    "tp_degree",
    "tp_device_count",
]
