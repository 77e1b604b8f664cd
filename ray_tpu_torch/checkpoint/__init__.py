"""ray_tpu_torch.checkpoint: sharded, asynchronous, atomically-committed
checkpoints of trees of torch tensors, in ray_tpu.checkpoint's on-disk
format (a checkpoint written by either package restores in the other).

- **Sharded format** (`_format`): slice files keyed by global offsets, a
  per-process spec, and `MANIFEST.json` written last, atomically — a
  directory without a manifest is garbage by definition.
- **AsyncCheckpointWriter** (`_writer`): the step loop pays one batched
  device->host snapshot; persistence + commit run on a background thread
  behind a bounded queue.
- **Restore** (`_restore`): the tree is reassembled from manifest offsets,
  onto the host or one device.

Quick use::

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.parallel.spmd import state_tree, state_from_tree

    ckpt.save(path, state_tree(state))                    # sync, committed
    writer = ckpt.AsyncCheckpointWriter()
    writer.save(path, state_tree(state))                  # returns after the snapshot
    writer.wait_until_finished()
    state = state_from_tree(model, cfg, opt, ckpt.restore(path))

``ShardedState`` (a tree marked for ``train.report``) waits for the port's
trainer (ROADMAP.md).
"""

from __future__ import annotations

from ray_tpu_torch.checkpoint._format import (
    MANIFEST_NAME,
    SENTINEL_NAME,
    commit,
    is_committed,
    is_partial,
    is_sharded,
    load_manifest,
    write_process_shards,
)
from ray_tpu_torch.checkpoint._restore import restore, restore_leaf
from ray_tpu_torch.checkpoint._writer import AsyncCheckpointWriter


def save(path: str, tree) -> str:
    """Synchronous sharded save, committed when it returns. Returns ``path``."""
    write_process_shards(path, tree)
    commit(path)
    return path


__all__ = [
    "AsyncCheckpointWriter",
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
