"""Restore: assemble whole leaves from slice files, onto the host or one device.

The port's copy of `ray_tpu/checkpoint/_restore.py`. The manifest records
global offsets per slice file, so restore never depends on the save-time
process count: each leaf is assembled whole from its slice files
(memory-mapped).
Where JAX redistributes onto a mesh (`shardings=`), the port places every
leaf on one device (`device=`); restoring onto a mesh of several GPUs comes
with ROADMAP Queue 1 item 1c.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.checkpoint._format import _decode_tree, load_manifest


class _LeafReader:
    """Reads one whole leaf from its slice files (mmap-backed). A bfloat16
    leaf is read as its raw 2-byte values (numpy has no bfloat16 without
    ml_dtypes) and handed out as a torch bfloat16 tensor."""

    def __init__(self, path: str, key: str, spec: dict):
        self._path = path
        self._key = key
        self.shape = tuple(int(d) for d in spec["shape"])
        self.bf16 = spec["dtype"] == "bfloat16"
        self.dtype = np.dtype("V2") if self.bf16 else np.dtype(spec["dtype"])
        self._shards = spec["shards"]

    def _file(self, name: str) -> np.ndarray:
        arr = np.load(os.path.join(self._path, name), mmap_mode="r", allow_pickle=False)
        if arr.dtype != self.dtype and arr.dtype.kind == "V" \
                and arr.dtype.itemsize == self.dtype.itemsize:
            # Extension dtypes (bfloat16) hit the .npy format as raw void
            # bytes; reinterpret against the manifest's dtype.
            arr = arr.view(self.dtype)
        if arr.dtype != self.dtype:
            raise ValueError(
                f"checkpoint leaf {self._key!r}: {name} holds {arr.dtype}, "
                f"the manifest says {self.dtype}"
            )
        return arr

    def read_numpy(self) -> np.ndarray:
        """The whole leaf, each slice file copied to its global offsets (a
        leaf JAX saved from a mesh has one file per distinct shard)."""
        if not self.shape:  # 0-d leaf: exactly one scalar shard
            return np.array(self._file(self._shards[0]["file"]))
        out = np.empty(self.shape, self.dtype)
        covered = 0
        for shard in self._shards:
            sel = tuple(slice(int(a), int(b)) for a, b in shard["index"])
            out[sel] = self._file(shard["file"])
            covered += int(np.prod([int(b) - int(a) for a, b in shard["index"]]))
        if covered != out.size:
            raise ValueError(
                f"checkpoint leaf {self._key!r}: slice files cover {covered} of "
                f"{out.size} elements — slice files missing or manifest corrupt"
            )
        return out

    def read(self, device=None):
        """The whole leaf: on the host a numpy array (a torch bfloat16 tensor
        for bfloat16), on `device` a torch tensor."""
        arr = self.read_numpy()
        if self.bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            return t if device is None else t.to(device)
        return arr if device is None else torch.from_numpy(arr).to(device)


def restore(path: str, *, device=None):
    """Load a committed sharded checkpoint.

    - ``restore(path)`` -> host tree with the saved structure: numpy arrays
      for every dtype numpy has, torch bfloat16 tensors for bfloat16.
    - ``restore(path, device=...)`` -> every leaf a torch tensor on that
      device (the port's counterpart of JAX's ``shardings=`` on one device).

    Raises FileNotFoundError when the directory was never committed.
    """
    manifest = load_manifest(path)
    readers = {
        key: _LeafReader(path, key, spec)
        for key, spec in manifest["leaves"].items()
    }
    device = None if device is None else torch.device(device)

    return _decode_tree(manifest["tree"], lambda key: readers[key].read(device))


def restore_leaf(path: str, key: str, *, device: Optional[torch.device] = None):
    """Load a single leaf by manifest key (serve warm-start helper)."""
    manifest = load_manifest(path)
    spec = manifest["leaves"].get(key)
    if spec is None:
        raise KeyError(
            f"{key!r} not in checkpoint {path} "
            f"(leaves: {sorted(manifest['leaves'])[:8]}...)"
        )
    return _LeafReader(path, key, spec).read(None if device is None else torch.device(device))
