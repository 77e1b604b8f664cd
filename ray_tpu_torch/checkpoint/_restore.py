"""Resharding restore: read slice-file regions onto the host, one device, or
a mesh.

The port's copy of `ray_tpu/checkpoint/_restore.py`. The manifest records
global offsets per slice file, so restore never depends on the save-time
process count or mesh: a rank restoring onto a mesh reads, per leaf,
exactly the file regions that overlap its own slice of the NEW placements
(slice files are memory-mapped, so a partial overlap reads only the pages
it touches) and wraps them as a DTensor. A save on N ranks restores on M.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.checkpoint._format import _decode_tree, load_manifest
from ray_tpu_torch.parallel.mesh import local_region


class _LeafReader:
    """Reads regions of one leaf from its slice files (mmap-backed, opened
    lazily). A bfloat16 leaf is read as its raw 2-byte values (numpy has no
    bfloat16 without ml_dtypes) and handed out as a torch bfloat16 tensor."""

    def __init__(self, path: str, key: str, spec: dict):
        self._path = path
        self._key = key
        self.shape = tuple(int(d) for d in spec["shape"])
        self.bf16 = spec["dtype"] == "bfloat16"
        self.dtype = np.dtype("V2") if self.bf16 else np.dtype(spec["dtype"])
        self._shards = spec["shards"]
        self._open: dict[str, np.ndarray] = {}

    def _file(self, name: str) -> np.ndarray:
        arr = self._open.get(name)
        if arr is not None:
            return arr
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
        self._open[name] = arr
        return arr

    def read_numpy(self, region=None) -> np.ndarray:
        """The region (a (start, stop) per dimension; None for the whole
        leaf) assembled from every slice file that overlaps it."""
        if not self.shape:  # 0-d leaf: exactly one scalar shard
            return np.array(self._file(self._shards[0]["file"]))
        region = [(0, n) for n in self.shape] if region is None else region
        out = np.empty(tuple(b - a for a, b in region), self.dtype)
        covered = 0
        for shard in self._shards:
            src_sel, dst_sel, size = [], [], 1
            for (ra, rb), (sa, sb) in zip(region, shard["index"]):
                lo, hi = max(ra, int(sa)), min(rb, int(sb))
                if lo >= hi:
                    size = 0
                    break
                src_sel.append(slice(lo - int(sa), hi - int(sa)))
                dst_sel.append(slice(lo - ra, hi - ra))
                size *= hi - lo
            if size:
                out[tuple(dst_sel)] = self._file(shard["file"])[tuple(src_sel)]
                covered += size
        if covered != out.size:
            raise ValueError(
                f"checkpoint leaf {self._key!r}: slice files cover {covered} of the "
                f"{out.size} elements of region {region} — slice files missing or "
                f"manifest corrupt"
            )
        return out

    def read(self, device=None, region=None):
        """The leaf (or a region of it): on the host a numpy array (a torch
        bfloat16 tensor for bfloat16), on `device` a torch tensor."""
        arr = self.read_numpy(region)
        if self.bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            return t if device is None else t.to(device)
        return arr if device is None else torch.from_numpy(arr).to(device)

    def read_dtensor(self, mesh, placements):
        """This rank's slice of the leaf under `placements` on `mesh`, read
        from the overlapping file regions only, as a DTensor."""
        from torch.distributed.tensor import DTensor

        region = local_region(self.shape, mesh.mesh.shape, placements, mesh.get_coordinate())
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        local = self.read(device, region)
        stride = tuple(int(np.prod(self.shape[i + 1:], dtype=np.int64))
                       for i in range(len(self.shape)))
        return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                                  shape=torch.Size(self.shape), stride=stride)


def restore(path: str, *, device=None, placements=None, mesh=None):
    """Load a committed sharded checkpoint.

    - ``restore(path)`` -> host tree with the saved structure: numpy arrays
      for every dtype numpy has, torch bfloat16 tensors for bfloat16.
    - ``restore(path, device=...)`` -> every leaf a whole torch tensor on
      that device.
    - ``restore(path, mesh=mesh, placements=...)`` -> DTensors on `mesh`:
      `placements` is one placements tuple for every leaf, or a dict of
      manifest leaf key -> placements (`spmd.state_shardings` for a train
      state), a leaf it leaves out read onto the host. Each rank reads only
      the file regions that overlap its slice.
    - ``restore(path, mesh=mesh)`` -> every leaf a DTensor replicated over
      `mesh`.

    Not collective: each rank reads its own slices. Raises FileNotFoundError when the directory was never committed.
    """
    manifest = load_manifest(path)
    readers = {key: _LeafReader(path, key, spec) for key, spec in manifest["leaves"].items()}
    if placements is not None and mesh is None:
        raise ValueError("restore: placements are placements on a mesh; pass mesh=")
    if mesh is not None and device is not None:
        raise ValueError("restore: a mesh and a device exclude each other")
    if mesh is not None:
        from torch.distributed.tensor import Replicate

        if placements is None:
            placements = (Replicate(),) * mesh.ndim

        def leaf_fn(key: str):
            want = placements.get(key) if isinstance(placements, dict) else placements
            if want is None:
                return readers[key].read(None)
            return readers[key].read_dtensor(mesh, want)
    else:
        device = None if device is None else torch.device(device)

        def leaf_fn(key: str):
            return readers[key].read(device)

    return _decode_tree(manifest["tree"], leaf_fn)


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
