"""ray_tpu_torch.parallel.mesh against ray_tpu.parallel.mesh, on the CPU
without worker processes.

- `create_mesh`'s rank layout (a DeviceMesh over a fake eight-rank process
  group, which runs no collective) equals the device ids of JAX's mesh on
  the eight virtual CPU devices of `conftest.py`, for flat meshes, the -1
  wildcard and hybrid `dcn_axes` meshes; `mesh_ranks` equals it where the
  mesh holds fewer devices than there are; every error JAX raises, the
  port raises.
- `logical_to_spec` equals JAX's PartitionSpec for every `DEFAULT_RULES`
  name and under rules overrides; `logical_to_placements` shards the same
  tensor dimensions over the same axes.
- Each test-tiny weight's logical axes (`PARAM_AXES`) give the spec JAX's
  `init_state` placed it with on `create_mesh({"dp": 2, "fsdp": 2})`, and
  the FSDP2 placement on (dp, fsdp) shards the dimension JAX shards over
  fsdp, for the unfused and the fused-qkv trees.
"""

import jax
import numpy as np
import optax
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.parallel import mesh as tmesh

FLAT = [{"dp": 2, "fsdp": 4}, {"fsdp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}, {"fsdp": -1},
        {"dp": 2, "fsdp": -1}, {"tp": 2, "fsdp": -1}, {"dp": 2, "sp": 2, "pp": 2},
        {"ep": -1, "dp": 4}]
HYBRID = [({"fsdp": 2, "tp": 2}, {"dp": 2}), ({"tp": -1}, {"dp": 2}),
          ({"fsdp": -1}, {"dp": 2}), ({"fsdp": 2}, {"dp": 2, "pp": 2}),
          ({"dp": 2, "fsdp": -1}, {"fsdp": 2})]
SMALLER = [{"dp": 2}, {"fsdp": 2, "tp": 2}, {}]
ERRORS = [({"bogus": 2}, None), ({"dp": -1, "fsdp": -1}, None), ({"dp": 16}, None),
          ({"dp": 3, "fsdp": -1}, None), ({"tp": 3}, {"dp": 2}), ({}, {"dp": 3}),
          ({}, {"bogus": 2}), ({"fsdp": 2}, {"dp": 0}), ({"tp": 2}, {"dp": 2})]


@pytest.fixture
def fake_world(monkeypatch):
    """A fake process group of eight ranks (this process is rank 0)."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("axes", FLAT, ids=str)
def test_flat_mesh_layout_matches_jax(axes, fake_world):
    mesh = tmesh.create_mesh(axes, device="cpu")
    assert mesh.mesh_dim_names == tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    np.testing.assert_array_equal(mesh.mesh.numpy(), _ids(jmesh.create_mesh(axes)))


@pytest.mark.parametrize("axes,dcn", HYBRID, ids=str)
def test_hybrid_mesh_layout_matches_jax(axes, dcn, fake_world):
    """Without LOCAL_WORLD_SIZE the ranks split into equal contiguous
    groups, as JAX splits CPU devices into fake slices."""
    mesh = tmesh.create_mesh(axes, dcn_axes=dcn, device="cpu")
    np.testing.assert_array_equal(mesh.mesh.numpy(),
                                  _ids(jmesh.create_mesh(axes, dcn_axes=dcn)))


def test_hybrid_mesh_groups_by_node():
    """With nodes of 2 ranks, a dcn axis of 2 takes the first two nodes,
    as JAX takes the first slices of devices grouped by slice index."""
    got = tmesh.mesh_ranks({"fsdp": 2}, range(8), {"dp": 2}, local_world_size=2)
    np.testing.assert_array_equal(got.reshape(-1), [0, 1, 2, 3])
    with pytest.raises(ValueError, match="ranks span 2"):
        tmesh.mesh_ranks({"fsdp": 4}, range(8), {"dp": 3}, local_world_size=4)


@pytest.mark.parametrize("axes", SMALLER, ids=str)
def test_smaller_mesh_ranks_match_jax_and_create_mesh_refuses_them(axes, fake_world):
    np.testing.assert_array_equal(tmesh.mesh_ranks(axes, range(8)),
                                  _ids(jmesh.create_mesh(axes)))
    if int(np.prod(list(axes.values()) or [1])) < 8:
        with pytest.raises(ValueError, match="every rank must be one of its devices"):
            tmesh.create_mesh(axes, device="cpu")


@pytest.mark.parametrize("axes,dcn", ERRORS, ids=str)
def test_mesh_errors_match_jax(axes, dcn):
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(axes, dcn_axes=dcn)
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_ranks(axes, range(8), dcn)
    assert str(terr.value) == str(jerr.value)


def test_create_mesh_needs_a_process_group_and_the_cpu_or_a_gpu():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.create_mesh({"dp": 1}, device="cpu")
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        tmesh.create_mesh({"dp": 1})


# ------------------------------------------------------------------ rules

SPECS = [(name,) for name in jmesh.DEFAULT_RULES] + [
    ("batch", "seq", "embed"), ("embed", "heads", "head_dim"), ("embed", "embed"),
    ("batch", "embed", "mlp"), ("vocab", "embed"), (None, "embed"), ("mlp", "embed"),
    ("layers", "batch", "seq"), ("expert", "embed", "mlp"), ("unknown", "embed")]
OVERRIDES = [None, {"embed": ("fsdp", "tp")}, {"mlp": None}, {"batch": "dp"},
             {"heads": ("tp", "fsdp")}, {"vocab": ("fsdp", "tp"), "embed": None},
             {"seq": ("sp", "dp")}]


def _norm(spec, ndim):
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)


@pytest.mark.parametrize("rules", OVERRIDES, ids=str)
def test_logical_to_spec_matches_jax(rules):
    for axes in SPECS:
        jspec = _norm(jmesh.logical_to_spec(axes, rules), len(axes))
        assert tmesh.logical_to_spec(axes, rules) == jspec, (axes, rules)


@pytest.mark.parametrize("rules", OVERRIDES, ids=str)
def test_logical_to_placements_shard_what_the_spec_shards(rules):
    for axes in SPECS:
        spec = tmesh.logical_to_spec(axes, rules)
        try:
            placements = tmesh.logical_to_placements(axes, tmesh.AXIS_ORDER, rules)
        except ValueError as e:
            # DTensor splits a dimension over axes in the mesh's order only.
            assert "against the mesh's order" in str(e)
            assert any(isinstance(p, tuple) and list(p) != sorted(
                p, key=tmesh.AXIS_ORDER.index) for p in spec)
            continue
        for axis, place in zip(tmesh.AXIS_ORDER, placements):
            dims = [d for d, p in enumerate(spec)
                    if p == axis or (isinstance(p, tuple) and axis in p)]
            assert (place.is_shard() and [place.dim] == dims) or (
                not place.is_shard() and not dims), (axes, rules, axis)


def test_batch_placement_is_dp_major():
    """A [B, S] batch over (dp, fsdp) = (2, 2): JAX's shards go to device
    (dp, fsdp) in row blocks dp-major; `local_region` gives the same rows."""
    jm = jmesh.create_mesh({"dp": 2, "fsdp": 2})
    shard_rows = jmesh.batch_sharding(jm).devices_indices_map((8, 4))
    placements = tmesh.logical_to_placements(("batch", "seq"), tmesh.AXIS_ORDER)
    shape = tuple(jm.devices.shape)
    for coord in np.ndindex(*shape):
        rows = shard_rows[jm.devices[coord]][0]
        region = tmesh.local_region((8, 4), shape, placements, coord)
        assert region[0] == (rows.start, rows.stop) and region[1] == (0, 4)


# ------------------------------------------------------------------ weights

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-qkv"])
def test_param_axes_match_jax_init_state_placement(fused):
    over = dict(attention="flash", remat=True, fused_qkv=fused)
    jcfg = jtr.get_config("test-tiny", **over)
    mesh = jmesh.create_mesh({"dp": 2, "fsdp": 2})
    state, _ = jspmd.init_state(jtr.Transformer(jcfg), jcfg, optax.adamw(1e-3), mesh,
                                sample_shape=(2, 32))
    jparams = _flat(state.params)
    cfg = ttr.get_config("test-tiny", **over)
    shapes = {path: shape for path, shape, _ in ttr.param_shapes(cfg)}
    assert set(shapes) == set(jparams)
    for path, leaf in jparams.items():
        assert tuple(leaf.shape) == shapes[path], path
        axes = ttr.param_axes(path)
        assert len(axes) == leaf.ndim
        jspec = _norm(leaf.sharding.spec, leaf.ndim)
        assert tmesh.logical_to_spec(axes) == jspec, path
        # FSDP2 over (dp, fsdp): replicated over dp, sharded on JAX's fsdp dim.
        dp_place, fsdp_place = tmesh.logical_to_placements(axes, ("dp", "fsdp"))
        assert not dp_place.is_shard()
        fsdp_dims = [d for d, p in enumerate(jspec)
                     if p == "fsdp" or (isinstance(p, tuple) and "fsdp" in p)]
        assert fsdp_place.is_shard() and [fsdp_place.dim] == fsdp_dims, path
        # And the slices JAX's devices hold are the port's ranks' slices.
        jslices = leaf.sharding.devices_indices_map(leaf.shape)
        placements = tmesh.logical_to_placements(axes, mesh.axis_names)
        for coord in np.ndindex(*mesh.devices.shape):
            want = [(s.start or 0, leaf.shape[d] if s.stop is None else s.stop)
                    for d, s in enumerate(jslices[mesh.devices[coord]])]
            got = tmesh.local_region(leaf.shape, mesh.devices.shape, placements, coord)
            assert got == want, (path, coord)


def test_meta_model_has_the_drawn_shapes_and_no_storage():
    cfg = ttr.get_config("test-tiny")
    model = ttr.Transformer(cfg, device="meta")
    named = dict(model.named_parameters())
    drawn = dict(ttr.draw_params(cfg, device="cpu"))
    for path, name in model.named_tree_params():
        assert named[name].is_meta and named[name].shape == drawn[path].shape
    ref = ttr.init_params(cfg, device="cpu")
    for path, leaf in drawn.items():
        node = ref
        for key in path:
            node = node[key]
        assert node.equal(leaf), path
    assert jax.devices()  # JAX stays on its eight CPU devices beside the port


# The tp case keeps the id it has always run under; the item it expects
# moved to [7f] when tensor-parallel serving was split from training.
@pytest.mark.parametrize("axis,item", [pytest.param("tp", "[7f]", id="tp-[7d]"),
                                       ("sp", "[10]"), ("pp", "[10]"), ("ep", "[10]")])
def test_training_refuses_unported_axes(axis, item, fake_world):
    """A mesh with tp, sp, pp or ep above 1 is built; training on it raises
    and names its ROADMAP item, before any weight is touched."""
    from ray_tpu_torch.parallel import optim as toptim
    from ray_tpu_torch.parallel import spmd as tspmd

    mesh = tmesh.create_mesh({axis: 2, "fsdp": 4}, device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[axis] == 2
    cfg = ttr.get_config("test-tiny")
    model = ttr.Transformer(cfg, device="meta")
    with pytest.raises(NotImplementedError, match=rf"{axis}=2 is ROADMAP Queue 1 item \{item}"):
        tspmd.init_state(model, cfg, toptim.adamw(1e-3), mesh, rng=0)
    assert all(p.is_meta for p in model.parameters())
