"""Device mesh construction and logical-axis sharding rules over torch.distributed.

The port of `ray_tpu/parallel/mesh.py`. JAX lays a `Mesh` over its devices
and XLA inserts the collectives; here one process drives one device (a GPU
over NCCL, or the CPU over gloo), the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the processes' ranks with
JAX's axis names, and the collectives are FSDP2's and `torch.distributed`'s.
Axis conventions are JAX's:

    dp    data parallel (batch split; gradients all-reduced)
    fsdp  fully-sharded data parallel (batch AND params split; all-gather on use)
    tp    tensor parallel (heads/mlp split)
    sp    sequence/context parallel
    pp    pipeline parallel
    ep    expert parallel

Rank r sits where JAX puts device r, for flat and hybrid meshes alike
(`mesh_ranks`). A logical spec maps to JAX's per-dimension axis tuple
(`logical_to_spec`) and to DTensor placements (`logical_to_placements`).
Training runs over `dp` and `fsdp`; a mesh with `tp`, `sp`, `pp` or `ep`
above 1 is built, and `check_train_mesh` refuses it with its ROADMAP item.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import resolve_device

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")

# Logical tensor-dimension name -> mesh axis (or tuple of axes): JAX's table.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": "pp",
    "expert": "ep",
    "stage": "pp",
}

# The axes training over a mesh does not take yet, and the ROADMAP item
# that brings each.
UNPORTED_TRAIN_AXES = {"tp": "[7d]", "sp": "[10]", "pp": "[10]", "ep": "[10]"}
# The axes a train step's batch and FSDP2 run over.
TRAIN_AXES = ("dp", "fsdp")


def _resolve_sizes(axes: Mapping[str, int], n_devices: int) -> dict[str, int]:
    """Fill missing axes with 1 and resolve a single -1 wildcard against
    n_devices (shared by the flat and hybrid layouts)."""
    sizes = {name: axes.get(name, 1) for name in AXIS_ORDER}
    wild = [name for name, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if wild:
        if n_devices % fixed:
            raise ValueError(f"{n_devices} devices not divisible by {fixed}")
        sizes[wild[0]] = n_devices // fixed
    return sizes


def _slice_groups(ranks: Sequence[int], n_slices: int,
                  local_world_size: Optional[int]) -> list[list[int]]:
    """Group ranks by node, JAX's slices: runs of `local_world_size`
    consecutive ranks when it is known, else `n_slices` equal contiguous
    groups (as JAX splits CPU devices, which carry no slice index)."""
    if local_world_size:
        if len(ranks) % local_world_size:
            raise ValueError(f"{len(ranks)} ranks are not whole nodes of "
                             f"{local_world_size}")
        groups = [list(ranks[i:i + local_world_size])
                  for i in range(0, len(ranks), local_world_size)]
        if len(groups) < n_slices:
            raise ValueError(f"dcn axes need {n_slices} slices; ranks span {len(groups)}")
        return groups[:n_slices]
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} devices not divisible into {n_slices} slices")
    per = len(ranks) // n_slices
    return [list(ranks[i * per:(i + 1) * per]) for i in range(n_slices)]


def _hybrid_ranks(axes: dict, dcn_axes: dict, ranks: list,
                  local_world_size: Optional[int]) -> np.ndarray:
    for name, size in dcn_axes.items():
        if name not in AXIS_ORDER:
            raise ValueError(f"unknown dcn axis {name!r}; valid: {AXIS_ORDER}")
        if int(size) < 1:
            raise ValueError(
                f"dcn axis {name!r} must be a positive slice count, got {size} "
                "(-1 wildcards are only valid for per-slice axes)"
            )
    dcn_sizes = {name: int(dcn_axes.get(name, 1)) for name in AXIS_ORDER}
    n_slices = math.prod(dcn_sizes.values())
    groups = _slice_groups(ranks, n_slices, local_world_size)
    per_slice = len(groups[0])
    ici_sizes = _resolve_sizes(axes, per_slice)
    if math.prod(ici_sizes.values()) != per_slice:
        raise ValueError(
            f"per-slice axes {ici_sizes} use {math.prod(ici_sizes.values())} "
            f"devices, slice has {per_slice}"
        )
    dcn_shape = tuple(dcn_sizes[name] for name in AXIS_ORDER)
    ici_shape = tuple(ici_sizes[name] for name in AXIS_ORDER)
    # (*dcn_shape, *ici_shape), interleaved (dcn_0, ici_0, dcn_1, ...) and
    # each pair merged: axis k spans dcn_k * ici_k, DCN-major, as JAX's.
    arr = np.asarray(groups, dtype=np.int64).reshape(dcn_shape + ici_shape)
    n = len(AXIS_ORDER)
    perm = [k for pair in ((i, i + n) for i in range(n)) for k in pair]
    return arr.transpose(perm).reshape(tuple(dcn_shape[i] * ici_shape[i] for i in range(n)))


def mesh_ranks(axes: Mapping[str, int] | None = None, devices: Sequence[int] = (),
               dcn_axes: Mapping[str, int] | None = None, *,
               local_world_size: Optional[int] = None) -> np.ndarray:
    """The ranks of a mesh, an int array shaped by AXIS_ORDER's sizes, laid
    out as JAX's `create_mesh` lays out devices with these ids: missing
    axes get 1, one axis may be -1 to take the rest, the first
    prod(sizes) of `devices` fill it row-major. With `dcn_axes` the layout
    is hybrid: those axes vary across nodes (groups of `local_world_size`
    consecutive ranks, else equal contiguous groups) and the `axes` sizes
    are per node."""
    ranks = [int(r) for r in devices]
    axes = dict(axes or {})
    for name in axes:
        if name not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {name!r}; valid: {AXIS_ORDER}")
    if dcn_axes:
        return _hybrid_ranks(axes, dict(dcn_axes), ranks, local_world_size)
    sizes = _resolve_sizes(axes, len(ranks))
    total = math.prod(sizes.values())
    if total > len(ranks):
        raise ValueError(f"mesh of {total} devices > {len(ranks)} available")
    return np.asarray(ranks[:total], dtype=np.int64).reshape(
        tuple(sizes[name] for name in AXIS_ORDER))


def create_mesh(axes: Mapping[str, int] | None = None, devices: Sequence[int] | None = None,
                dcn_axes: Mapping[str, int] | None = None, *, device=None):
    """A DeviceMesh over this job's ranks with JAX's axis names (all six,
    size 1 where not given), laid out by `mesh_ranks`.

    Collective: every rank calls it, after `torch.distributed.
    init_process_group` (its address, world size and rank given by the
    caller or by `torchrun`). `device` is "cuda" by default (NCCL; raises
    without a GPU) or "cpu" (gloo). `devices` are ranks (default: all);
    `dcn_axes` makes a hybrid mesh over nodes of `LOCAL_WORLD_SIZE` ranks
    (torchrun sets it). Every rank of the job must sit in the mesh: a rank
    is one device, and a device outside the mesh would have nothing to run."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs torch.distributed initialised: call "
            "init_process_group(backend, init_method=..., world_size=..., rank=...) "
            "on every rank first")
    backend = str(dist.get_backend())
    if (dev.type == "cuda" and "nccl" not in backend) or (dev.type == "cpu"
                                                          and backend == "nccl"):
        raise ValueError(f"a {dev.type} mesh cannot run over the process group's "
                         f"backend {backend} (cuda takes nccl, cpu gloo)")
    world = dist.get_world_size()
    lws = os.environ.get("LOCAL_WORLD_SIZE")
    ranks = mesh_ranks(axes, range(world) if devices is None else devices, dcn_axes,
                       local_world_size=int(lws) if lws else None)
    if ranks.size != world or sorted(ranks.reshape(-1).tolist()) != list(range(world)):
        raise ValueError(f"the mesh holds ranks {sorted(ranks.reshape(-1).tolist())} "
                         f"of a world of {world}; every rank must be one of its devices")
    return DeviceMesh(dev.type, torch.as_tensor(ranks), mesh_dim_names=AXIS_ORDER)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Mapping[str, object] | None = None) -> tuple:
    """Logical dimension names -> JAX's PartitionSpec entries as a tuple:
    per dimension None, one axis name, or a tuple of axis names. An axis
    already used by an earlier dimension is dropped, as JAX drops it."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    parts = []
    used: set[str] = set()
    for name in logical_axes:
        axis = rules.get(name) if name is not None else None
        if axis is None:
            parts.append(None)
            continue
        axes_tuple = (axis,) if isinstance(axis, str) else tuple(axis)
        free = tuple(a for a in axes_tuple if a not in used)
        used.update(free)
        if not free:
            parts.append(None)
        elif len(free) == 1:
            parts.append(free[0])
        else:
            parts.append(free)
    return tuple(parts)


def _dim_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", mesh)
    if names is None:
        raise ValueError("the mesh has no dimension names")
    return tuple(names)


def logical_to_placements(logical_axes: Sequence[Optional[str]], mesh,
                          rules: Mapping[str, object] | None = None) -> tuple:
    """DTensor placements of a tensor with these logical dimensions on
    `mesh` (a DeviceMesh, or its dimension names): `Shard(d)` on each mesh
    dimension the rules bind tensor dimension d to, `Replicate()` on the
    rest; axes a submesh lacks (mesh["dp", "fsdp"] lacks tp) are left out.
    A dimension split over several axes (the batch over dp and fsdp) is
    sharded by them in the mesh's order, which DTensor's default reading of
    repeated `Shard(d)` shares with JAX's axis tuple (dp-major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _dim_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(logical_to_spec(logical_axes, rules)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        where = [names.index(a) for a in axes if a in names]
        if where != sorted(where):
            raise ValueError(f"dimension {dim} is split over {axes}, against the "
                             f"mesh's order {names}; DTensor places only the latter")
        for i in where:
            out[i] = Shard(dim)
    return tuple(out)


def batch_sharding(mesh, rules: Mapping[str, object] | None = None) -> tuple:
    """The placements of a global [B, S] batch: JAX's `batch_sharding`,
    the batch over ("dp", "fsdp"), dp-major. `batch_rows` gives the rows a
    rank holds under them."""
    return logical_to_placements(("batch", "seq"), mesh, rules)


def local_region(shape: Sequence[int], mesh_shape: Sequence[int], placements: Sequence,
                 coordinate: Sequence[int]) -> list[tuple[int, int]]:
    """The [start, stop) per dimension of a global array of `shape` that
    the rank at `coordinate` of a mesh of `mesh_shape` holds under
    `placements`, as DTensor chunks it: along each mesh dimension in order,
    a `Shard(d)` cuts the rank's current range of d into chunks of
    ceil(n / size), the last ones short or empty."""
    region = [[0, int(n)] for n in shape]
    for size, coord, placement in zip(mesh_shape, coordinate, placements):
        dim = getattr(placement, "dim", None)
        if dim is None or not placement.is_shard():
            continue
        lo, hi = region[dim]
        chunk = -(-(hi - lo) // size)
        start = min(lo + chunk * coord, hi)
        region[dim] = [start, min(start + chunk, hi)]
    return [tuple(r) for r in region]


def batch_shards(mesh, rules: Mapping[str, object] | None = None) -> int:
    """Into how many row blocks `batch_sharding` cuts a batch on `mesh`."""
    return math.prod(int(n) for n, p in zip(mesh.mesh.shape, batch_sharding(mesh, rules))
                     if p.is_shard() and p.dim == 0)


def batch_rows(mesh, batch_size: int, rules: Mapping[str, object] | None = None) -> slice:
    """The rows of a global batch of `batch_size` rows that this rank
    holds: `batch_sharding`'s block. The rows must split evenly over the
    batch's axes, as JAX's placement of a batch requires."""
    placements = batch_sharding(mesh, rules)
    shards = batch_shards(mesh, rules)
    if batch_size % shards:
        raise ValueError(f"a batch of {batch_size} rows does not split over "
                         f"{shards} batch shards")
    (start, stop), _ = local_region((batch_size, 1), tuple(mesh.mesh.shape), placements,
                                    mesh.get_coordinate())
    return slice(start, stop)


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor, without importing DTensor's module (about a
    second) where nothing has: no DTensor exists before it is imported."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def check_train_mesh(mesh) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a mesh that
    training cannot run yet: any of `tp`, `sp`, `pp`, `ep` above 1."""
    sizes = dict(zip(_dim_names(mesh), mesh.mesh.shape))
    for axis, item in UNPORTED_TRAIN_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"training over a mesh with {axis}={sizes[axis]} is ROADMAP Queue 1 "
                f"item {item} of the port; training runs over dp and fsdp")


def host_local_mesh_info(mesh) -> dict:
    """Summary used by the train controller to assign per-host shards."""
    return {
        "axis_names": _dim_names(mesh),
        "shape": dict(zip(_dim_names(mesh), (int(n) for n in mesh.mesh.shape))),
        "num_devices": int(mesh.mesh.numel()),
    }
