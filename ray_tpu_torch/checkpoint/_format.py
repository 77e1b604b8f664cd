"""Sharded checkpoint format: per-process slice files + atomic manifest commit.

The port's own copy of `ray_tpu/checkpoint/_format.py`, writing the same
on-disk format, so that a checkpoint written by either package restores in
the other::

    checkpoint_000003/
      .ray_tpu_sharded                 # sentinel: a sharded save targets this dir
      params.dense.kernel--0_64.0_32.npy   # one slice file per distinct shard
      process_0.json                   # per-process spec (fsynced before manifest)
      process_1.json
      MANIFEST.json                    # written LAST, atomically — the commit record

Commit protocol: every process persists only the slices it owns plus its
`process_<i>.json` spec; the committer (process 0) waits a bounded time
for every spec, merges them, checks that each leaf's shards tile its
global shape, and writes `MANIFEST.json` via tmp-file -> fsync -> rename
-> directory fsync. A directory without a manifest is garbage by
definition: restore refuses it.

Leaves: a DTensor is cut into the slices its placements give each rank
of its mesh; each distinct slice, keyed by its global offsets, is written
once, by the lowest rank holding it (JAX's lowest device id), and only by
that rank, which holds it locally. Any other torch tensor is one shard
covering the whole array, and numpy arrays and Python scalars are host
leaves; process 0 writes both. The process index and count default to
the rank and world size of `torch.distributed` (0 and 1 without it). A
bfloat16 leaf is written as its raw 2-byte values (numpy dtype `V2`) under
manifest dtype "bfloat16", which is what numpy writes for ml_dtypes'
bfloat16 and what both restores view back against the manifest's dtype.
(Writing them as uint16 would make JAX's restore cast the integers to
bfloat16 numerically.)
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import is_dtensor, local_region

FORMAT_NAME = "ray_tpu.sharded_ckpt"
FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
SENTINEL_NAME = ".ray_tpu_sharded"
_PROCESS_SPEC_FMT = "process_{}.json"


# --------------------------------------------------------------------- pytree

def _encode_tree(tree):
    """Structure-only encoding of a tree of dicts/lists/tuples; leaves become
    {"leaf": key}. Keys double as slice-file stems, so they use "/" separators
    here and "." in filenames."""

    def rec(node, path):
        if isinstance(node, dict):
            return {"kind": "dict",
                    "items": {str(k): rec(v, path + (str(k),))
                              for k, v in sorted(node.items(), key=lambda kv: str(kv[0]))}}
        if isinstance(node, (list, tuple)):
            return {"kind": "list" if isinstance(node, list) else "tuple",
                    "items": [rec(v, path + (str(i),)) for i, v in enumerate(node)]}
        if node is None:
            return {"kind": "none"}
        return {"kind": "leaf", "key": "/".join(path)}

    return rec(tree, ())


def _decode_tree(enc, leaf_fn):
    if enc["kind"] == "dict":
        return {k: _decode_tree(v, leaf_fn) for k, v in enc["items"].items()}
    if enc["kind"] == "list":
        return [_decode_tree(v, leaf_fn) for v in enc["items"]]
    if enc["kind"] == "tuple":
        return tuple(_decode_tree(v, leaf_fn) for v in enc["items"])
    if enc["kind"] == "none":
        return None
    return leaf_fn(enc["key"])


def _flatten(tree):
    """[(key, leaf)] in the same order _encode_tree assigns keys."""
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in sorted(node.items(), key=lambda kv: str(kv[0])):
                rec(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        elif node is None:
            pass
        else:
            out.append(("/".join(path), node))

    rec(tree, ())
    return out


# --------------------------------------------------------------------- shards

def _shard_file_name(key: str, offsets: list[list[int]]) -> str:
    stem = key.replace("/", ".")
    if not offsets:
        return f"{stem}--scalar.npy"
    span = ".".join(f"{a}_{b}" for a, b in offsets)
    return f"{stem}--{span}.npy"


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype: numpy's name ("float32",
    "int32", "bool"), "bfloat16" as ml_dtypes names it."""
    return str(dtype).removeprefix("torch.")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as the numpy array the slice file holds (no
    copy): bfloat16 as raw 2-byte values (`V2`), as numpy writes ml_dtypes'
    bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _process_args(process_index, process_count) -> tuple[int, int]:
    """(this process's index, the process count): as given, else the rank
    and world size of torch.distributed, else (0, 1)."""
    if (process_index is None) != (process_count is None):
        raise ValueError("process_index and process_count go together")
    if process_index is not None:
        return int(process_index), int(process_count)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _distinct_slices(leaf) -> dict:
    """{region: owner rank} for every non-empty slice of a DTensor over its
    mesh, a region a tuple of (start, stop) per dimension; among ranks
    holding the same slice (replicas) the lowest owns it."""
    mesh = leaf.device_mesh
    grid = mesh.mesh
    owners: dict[tuple, int] = {}
    for coord in np.ndindex(*grid.shape):
        region = tuple(local_region(leaf.shape, grid.shape, leaf.placements, coord))
        if any(a >= b for a, b in region):
            continue
        rank = int(grid[coord])
        owners[region] = min(owners.get(region, rank), rank)
    return owners


def _owned_shard(key: str, leaf, me: int):
    """(local tensor, offsets) of the slice of DTensor `leaf` that process
    `me` writes, or None when it owns none. The owner of a slice holds it
    locally, so the owned slice is always this rank's own."""
    import torch.distributed as dist

    mesh = leaf.device_mesh
    mine = tuple(local_region(leaf.shape, mesh.mesh.shape, leaf.placements,
                              mesh.get_coordinate()))
    owned = [region for region, owner in _distinct_slices(leaf).items() if owner == me]
    if not owned:
        return None
    if owned != [mine] or dist.get_rank() != me:
        raise ValueError(f"process {me} owns shards {owned} of {key!r}, but this "
                         f"rank holds only {mine}")
    return leaf.to_local(), [list(r) for r in mine]


def plan_snapshot(tree, *, process_index=None, process_count=None):
    """Split a tree into (encoded_tree, plan): one ``{key, dtype, shape,
    offsets, file, data}`` entry per shard THIS process owns, ``data``
    still the leaf's own tensor (a DTensor's local shard) or a host copy."""
    me, _ = _process_args(process_index, process_count)
    encoded = _encode_tree(tree)
    plan = []
    for key, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            dtype, shape = _dtype_name(leaf.dtype), [int(d) for d in leaf.shape]
            if is_dtensor(leaf):
                shard = _owned_shard(key, leaf, me)
            else:  # one shard covering the whole tensor, process 0's
                shard = (leaf, [[0, d] for d in shape]) if me == 0 else None
        else:  # host leaf: one full shard, process 0's
            if me != 0:
                continue
            arr = np.array(leaf)
            dtype, shape = str(arr.dtype), [int(d) for d in arr.shape]
            shard = (arr, [[0, d] for d in shape])
        if shard is None:
            continue
        data, offs = shard
        plan.append({"key": key, "dtype": dtype, "shape": shape, "offsets": offs,
                     "file": _shard_file_name(key, offs), "data": data})
    return encoded, plan


@torch.no_grad()
def snapshot(tree, *, process_index=None, process_count=None):
    """`plan_snapshot` with every ``data`` a numpy copy of its values at the
    call. Every CUDA tensor is copied into pinned host memory in one batch
    of asynchronous copies on the current stream, then one synchronisation
    per device, so the values hold however the tensors change after it
    returns (the port's optimizer updates them in place)."""
    encoded, plan = plan_snapshot(tree, process_index=process_index,
                                  process_count=process_count)
    devices = set()
    for entry in plan:
        data = entry["data"]
        if isinstance(data, torch.Tensor):
            host = torch.empty(data.shape, dtype=data.dtype, pin_memory=data.is_cuda)
            host.copy_(data, non_blocking=data.is_cuda)
            if data.is_cuda:
                devices.add(data.device)
            entry["data"] = host
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    for entry in plan:
        if isinstance(entry["data"], torch.Tensor):
            entry["data"] = _host_array(entry["data"])
    return encoded, plan


# ---------------------------------------------------------------------- write

def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, payload: bytes):
    """tmp-file -> fsync -> rename: the file either exists complete or not at all."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def write_snapshot(path: str, encoded_tree, plan, *, process_index=None) -> dict:
    """Persist one process's snapshot: slice files first (each durable
    before the spec references it), then its spec `process_<i>.json`.
    Returns the spec dict."""
    me = 0 if process_index is None else int(process_index)
    os.makedirs(path, exist_ok=True)
    sentinel = os.path.join(path, SENTINEL_NAME)
    if not os.path.exists(sentinel):
        _write_atomic(sentinel, b"")
    total_bytes = 0
    leaves: dict[str, dict] = {}
    for entry in plan:
        arr = entry["data"]
        with open(os.path.join(path, entry["file"] + ".part"), "wb") as f:
            np.save(f, arr, allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(path, entry["file"] + ".part"),
                   os.path.join(path, entry["file"]))
        total_bytes += arr.nbytes
        spec = leaves.setdefault(entry["key"], {
            "dtype": entry["dtype"], "shape": entry["shape"], "shards": [],
        })
        spec["shards"].append({"file": entry["file"], "index": entry["offsets"]})
    _fsync_dir(path)
    spec = {
        "process_index": me,
        "tree": encoded_tree,
        "leaves": leaves,
        "bytes": total_bytes,
        "ts": time.time(),
    }
    _write_atomic(os.path.join(path, _PROCESS_SPEC_FMT.format(me)), json.dumps(spec).encode())
    return spec


def write_process_shards(path: str, tree, *, process_index=None,
                         process_count=None) -> dict:
    """Sync path: snapshot + persist this process's shards and its spec
    (no manifest)."""
    me, count = _process_args(process_index, process_count)
    encoded, plan = snapshot(tree, process_index=me, process_count=count)
    return write_snapshot(path, encoded, plan, process_index=me)


# --------------------------------------------------------------------- commit

class CommitTimeout(TimeoutError):
    """Not every writing process produced its spec before the deadline — the
    directory stays manifest-less (i.e. garbage) by design."""


def commit(path: str, *, process_count: int = 1, timeout_s: float | None = None,
           poll_s: float = 0.05) -> str:
    """Merge all process specs into MANIFEST.json — the atomic commit point.

    Waits (bounded by `timeout_s`, else unbounded) for every
    ``process_<i>.json``; verifies each leaf's shards tile its global
    shape; then writes the manifest last, atomically. Any failure before
    the final rename leaves the directory uncommitted. A directory with no
    spec at all and no deadline raises FileNotFoundError."""
    spec_paths = [os.path.join(path, _PROCESS_SPEC_FMT.format(i))
                  for i in range(process_count)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        missing = [p for p in spec_paths if not os.path.exists(p)]
        if not missing:
            break
        if deadline is None and len(missing) == len(spec_paths):
            raise FileNotFoundError(f"checkpoint {path}: no process spec was written")
        if deadline is not None and time.monotonic() > deadline:
            raise CommitTimeout(
                f"checkpoint {path}: {len(missing)}/{process_count} process "
                f"spec(s) missing after {timeout_s}s (first: {missing[0]})"
            )
        time.sleep(poll_s)
    specs = []
    for p in spec_paths:
        with open(p, "r") as f:
            specs.append(json.load(f))
    tree = next((s["tree"] for s in specs if s.get("tree") is not None), None)
    leaves: dict[str, dict] = {}
    for s in specs:
        for key, leaf_spec in s["leaves"].items():
            merged = leaves.setdefault(key, {
                "dtype": leaf_spec["dtype"],
                "shape": leaf_spec["shape"],
                "shards": [],
            })
            if (merged["dtype"] != leaf_spec["dtype"]
                    or merged["shape"] != leaf_spec["shape"]):
                raise ValueError(
                    f"checkpoint {path}: leaf {key!r} dtype/shape disagrees "
                    f"across processes"
                )
            merged["shards"].extend(leaf_spec["shards"])
    _verify_coverage(path, leaves)
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "process_count": process_count,
        "tree": tree,
        "leaves": leaves,
        "ts": time.time(),
    }
    manifest_path = os.path.join(path, MANIFEST_NAME)
    _write_atomic(manifest_path, json.dumps(manifest).encode())
    return manifest_path


def _verify_coverage(path: str, leaves: dict):
    """Every leaf's shards must tile its global shape exactly (distinct
    slices, union = whole array) — a missing writer can't silently commit."""
    for key, spec in leaves.items():
        total = int(np.prod(spec["shape"])) if spec["shape"] else 1
        covered = 0
        seen = set()
        for shard in spec["shards"]:
            idx = tuple(tuple(p) for p in shard["index"])
            if idx in seen:
                raise ValueError(
                    f"checkpoint {path}: duplicate shard {idx} for {key!r}"
                )
            seen.add(idx)
            size = 1
            for a, b in shard["index"]:
                size *= max(0, b - a)
            covered += size
        if covered != total:
            raise ValueError(
                f"checkpoint {path}: leaf {key!r} covers {covered} of {total} "
                f"elements — a writer's shards are missing; refusing to commit"
            )


# --------------------------------------------------------------------- status

def is_sharded(path: str) -> bool:
    """A sharded save targeted (or completed in) this directory."""
    return (os.path.exists(os.path.join(path, SENTINEL_NAME))
            or os.path.exists(os.path.join(path, MANIFEST_NAME)))


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST_NAME))


def is_partial(path: str) -> bool:
    """A sharded save started here but never committed — garbage by definition."""
    return is_sharded(path) and not is_committed(path)


def load_manifest(path: str) -> dict:
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"{path} has no {MANIFEST_NAME}: the checkpoint was never "
            f"committed (partial saves are garbage by definition)"
        )
    with open(manifest_path, "r") as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(f"{manifest_path}: not a {FORMAT_NAME} manifest")
    return manifest
