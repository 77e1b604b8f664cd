"""Sharded checkpoint format: slice files + atomic manifest commit.

The port's own copy of `ray_tpu/checkpoint/_format.py`, writing the same
on-disk format, so that a checkpoint written by either package restores in
the other::

    checkpoint_000003/
      .ray_tpu_sharded                 # sentinel: a sharded save targets this dir
      params.dense.kernel--0_64.0_32.npy   # one slice file per distinct shard
      process_0.json                   # the writer's spec (fsynced before manifest)
      MANIFEST.json                    # written LAST, atomically — the commit record

Commit protocol: the port writes from one process, as process 0 of JAX's
protocol: its slice files, then its `process_0.json` spec, then
`MANIFEST.json` via tmp-file -> fsync -> rename -> directory fsync. A
directory without a manifest is garbage by definition: restore refuses it.

Leaves: a torch tensor on one device is one shard covering the whole array
(DTensor slices come with the mesh, ROADMAP Queue 1 item 1c); numpy arrays
and Python scalars are host leaves, as in JAX. A bfloat16 leaf is written as
its raw 2-byte values (numpy dtype `V2`) under manifest dtype "bfloat16",
which is what numpy writes for ml_dtypes' bfloat16 and what both restores
view back against the manifest's dtype. (Writing them as uint16 would make
JAX's restore cast the integers to bfloat16 numerically.)
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

FORMAT_NAME = "ray_tpu.sharded_ckpt"
FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
SENTINEL_NAME = ".ray_tpu_sharded"
# The spec of the one writing process, as JAX names process 0's.
_SPEC_NAME = "process_0.json"


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


@torch.no_grad()
def snapshot(tree):
    """Split a tree into (encoded_tree, plan): one ``{key, dtype, shape,
    offsets, file, data}`` entry per leaf, each the one shard covering the
    whole array, ``data`` a numpy copy of the leaf's values at the call.
    Every CUDA tensor is copied into pinned host memory in one batch of
    asynchronous copies on the current stream, then one synchronisation per
    device, so the values hold however the tensors change after it returns
    (the port's optimizer updates them in place)."""
    encoded = _encode_tree(tree)
    plan, devices = [], set()
    for key, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
            host.copy_(leaf, non_blocking=leaf.is_cuda)
            if leaf.is_cuda:
                devices.add(leaf.device)
            entry = {"dtype": _dtype_name(leaf.dtype), "data": host}
        else:
            arr = np.array(leaf)
            entry = {"dtype": str(arr.dtype), "data": arr}
        shape = [int(d) for d in entry["data"].shape]
        offs = [[0, d] for d in shape]
        entry.update(key=key, shape=shape, offsets=offs, file=_shard_file_name(key, offs))
        plan.append(entry)
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


def write_snapshot(path: str, encoded_tree, plan) -> dict:
    """Persist a snapshot: slice files first (each durable before the spec
    references it), then the spec `process_0.json`. Returns the spec dict."""
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
        leaves[entry["key"]] = {
            "dtype": entry["dtype"], "shape": entry["shape"],
            "shards": [{"file": entry["file"], "index": entry["offsets"]}],
        }
    _fsync_dir(path)
    spec = {
        "process_index": 0,
        "tree": encoded_tree,
        "leaves": leaves,
        "bytes": total_bytes,
        "ts": time.time(),
    }
    _write_atomic(os.path.join(path, _SPEC_NAME), json.dumps(spec).encode())
    return spec


def write_process_shards(path: str, tree) -> dict:
    """Sync path: snapshot + persist every leaf and the spec (no manifest)."""
    return write_snapshot(path, *snapshot(tree))


# --------------------------------------------------------------------- commit

def commit(path: str) -> str:
    """Turn the spec into MANIFEST.json — the atomic commit point, written
    last via tmp-file -> fsync -> rename -> directory fsync. A directory
    whose spec was never written raises FileNotFoundError and stays
    uncommitted. (The multi-process commit, which waits for every process's
    spec and checks that the shards tile each leaf, comes with the mesh:
    ROADMAP Queue 1 item 1c.)"""
    with open(os.path.join(path, _SPEC_NAME), "r") as f:
        spec = json.load(f)
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "process_count": 1,
        "tree": spec["tree"],
        "leaves": spec["leaves"],
        "ts": time.time(),
    }
    manifest_path = os.path.join(path, MANIFEST_NAME)
    _write_atomic(manifest_path, json.dumps(manifest).encode())
    return manifest_path


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
