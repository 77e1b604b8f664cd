"""ray_tpu_torch.checkpoint: sharded, asynchronous, atomically-committed
checkpoints of trees of torch tensors, in ray_tpu.checkpoint's on-disk
format (a checkpoint written by either package restores in the other).

- **Sharded format** (`_format`): each process writes only the slices it
  owns (a DTensor's distinct slices, keyed by global offsets, each by the
  lowest rank holding it) plus its spec; process 0 commits `MANIFEST.json`
  last, atomically, once every spec is there and the shards tile every
  leaf — a directory without a manifest is garbage by definition.
- **AsyncCheckpointWriter** (`_writer`): the step loop pays one batched
  device->host snapshot of the rank's own shards; persistence + commit run
  on a background thread behind a bounded queue.
- **Resharding restore** (`_restore`): onto the host, one device, or a
  mesh, where each rank reads only the regions of its slice of the new
  placements, so a save on N ranks restores on M.

Quick use::

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.parallel.spmd import state_tree, state_from_tree

    ckpt.save(path, state_tree(state))                    # sync, committed
    writer = ckpt.AsyncCheckpointWriter()
    writer.save(path, state_tree(state))                  # returns after the snapshot
    writer.wait_until_finished()
    state = state_from_tree(model, cfg, opt, ckpt.restore(path))

    # over a mesh: every rank saves its shards, process 0 commits
    state, shardings = init_state(model, cfg, opt, mesh, rng=0)
    ckpt.save(path, state_tree(state))
    tree = ckpt.restore(path, mesh=mesh, placements=shardings)
    state = state_from_tree(model, cfg, opt, tree)

``ShardedState`` (a tree marked for ``train.report``) waits for the port's
trainer (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.checkpoint._format import (
    CommitTimeout,
    MANIFEST_NAME,
    SENTINEL_NAME,
    _process_args,
    commit,
    is_committed,
    is_partial,
    is_sharded,
    load_manifest,
    write_process_shards,
)
from ray_tpu_torch.checkpoint._restore import restore, restore_leaf
from ray_tpu_torch.checkpoint._writer import AsyncCheckpointWriter


def save(path: str, tree, *, process_index: Optional[int] = None,
         process_count: Optional[int] = None,
         commit_timeout_s: Optional[float] = None) -> str:
    """Synchronous sharded save. Every process writes its shards and spec;
    process 0 then commits, once every process's spec exists (waiting at
    most `commit_timeout_s`, else raising CommitTimeout) and the shards tile
    every leaf. The process index and count default to torch.distributed's
    rank and world size (0 and 1 without it). Returns ``path``: committed
    when process 0's call returns."""
    me, count = _process_args(process_index, process_count)
    write_process_shards(path, tree, process_index=me, process_count=count)
    if me == 0:
        commit(path, process_count=count, timeout_s=commit_timeout_s)
    return path


__all__ = [
    "AsyncCheckpointWriter",
    "CommitTimeout",
    "MANIFEST_NAME",
    "SENTINEL_NAME",
    "commit",
    "is_committed",
    "is_partial",
    "is_sharded",
    "load_manifest",
    "restore",
    "restore_leaf",
    "save",
    "write_process_shards",
]
