"""Training: state init and train-step construction, on one device or over a mesh.

The port of `ray_tpu/parallel/spmd.py`. JAX jits one program over a named
mesh, with the state donated; here the step runs eagerly and updates the
state in place (the PyTorch idiom for `donate=True`). The step keeps JAX's
contract: (state, batch{tokens, targets, mask?}) -> (state, metrics{loss,
step, grad_norm?}), bf16 compute over f32 params and optimizer state, and
the same automatic switch to the chunked fused cross-entropy.

Over a mesh (`parallel/mesh.py`'s `create_mesh`, one process per device):
`init_state` shards the model with FSDP2, `fully_shard` on each Block and
then the root over the ("dp", "fsdp") submesh (HSDP when dp > 1:
replicated over dp, sharded over fsdp), each weight's shard on the
dimension its logical axes bind to fsdp (`models/transformer.py`'s
PARAM_AXES under the rules); the parameters are gathered in their own
dtype (f32). The weights then fill the shards one leaf at a time, so the
peak is the sharded state plus one whole leaf. Each rank steps on its rows
of the global batch (`build_train_step`'s placement); the loss is JAX's
global mean (the summed loss over the all-reduced token or mask count),
the fused cross-entropy switch reads the global batch shape, and
`grad_norm` is the global norm. A mesh with tp, sp, pp or ep above 1 is
ROADMAP Queue 1 item [7f] (tp) or [10] and raises.

`state_tree` and `state_from_tree` map a TrainState to and from the tree a
JAX user checkpoints (`{"step", "params", "opt_state"}`), so a run saved by
either package through `checkpoint.save` resumes in the other; over a mesh
their leaves are DTensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import unstack_layers
from ray_tpu_torch.models.transformer import (
    ModelConfig,
    Transformer,
    cross_entropy_loss,
    draw_params,
    fused_cross_entropy_loss,
    param_axes,
)
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel.optim import global_norm, tree_leaves, tree_unflatten


def _leaf_paths(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _leaf_paths(tree[key], prefix + (key,))]
    return ["/".join(prefix)]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


# Logits bytes (b * s * vocab * 4) above which the step takes the fused
# cross-entropy, as spmd.py:136 decides.
FUSED_CE_LOGITS_BYTES = 2_000_000_000


@dataclasses.dataclass
class TrainState:
    """step: updates taken; params: the model's nn.Parameters in the flax
    tree layout (`Transformer.param_tree(trainable=True)`; DTensors over a
    mesh); opt_state: the optimizer's state over the same tree."""

    step: int
    params: Any
    opt_state: Any


def _check_mesh(mesh) -> None:
    """A mesh training can run over: the port's DeviceMesh with tp, sp, pp
    and ep at 1 (NotImplementedError citing [7f] or [10] otherwise)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != \
            mesh_lib.AXIS_ORDER:
        raise TypeError(f"expected a mesh from ray_tpu_torch.parallel.mesh.create_mesh, "
                        f"got {type(mesh).__name__}")
    mesh_lib.check_train_mesh(mesh)


def _mesh_of(model) -> Optional[Any]:
    """The mesh `model` was sharded over by `shard_model`, or None."""
    return getattr(model, "_train_mesh", None)


def shard_model(model: Transformer, mesh, rules=None) -> None:
    """Shard `model` over `mesh` with FSDP2, once: `fully_shard` each Block,
    then the root, over mesh["dp", "fsdp"], each weight sharded on the
    dimension the rules bind to fsdp (and replicated over dp). No mixed
    precision policy: parameters are gathered in their own dtype. A model
    on the "meta" device is then given uninitialised storage on the mesh's
    device. Raises for a weight the rules do not shard over fsdp when fsdp
    > 1 (FSDP2 shards every weight), and for a model sharded over another
    mesh."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    _check_mesh(mesh)
    if _mesh_of(model) is not None:
        if _mesh_of(model) is not mesh:
            raise ValueError("the model is already sharded over another mesh")
        return
    sub = mesh[mesh_lib.TRAIN_AXES]
    fsdp = int(sub.mesh.shape[1])
    named = dict(model.named_parameters())
    shard_of = {}
    for path, name in model.named_tree_params():
        dp_place, fsdp_place = mesh_lib.logical_to_placements(param_axes(path), sub, rules)
        if dp_place.is_shard() or (fsdp > 1 and not fsdp_place.is_shard()):
            raise NotImplementedError(
                f"{'/'.join(path)}: the rules place it as {(dp_place, fsdp_place)} on "
                f"(dp, fsdp); FSDP2 shards every weight over fsdp and replicates it "
                f"over dp")
        shard_of[id(named[name])] = fsdp_place if fsdp_place.is_shard() else Shard(0)

    def placement(param):
        return shard_of[id(param)]

    for block in model.layers:
        fully_shard(block, mesh=sub, shard_placement_fn=placement)
    fully_shard(model, mesh=sub, shard_placement_fn=placement)
    device = (torch.device("cuda", torch.cuda.current_device()) if sub.device_type == "cuda"
              else torch.device(sub.device_type))
    if model.device.type == "meta":
        model.to_empty(device=device)
        model._needs_weights = True
    model.device = device
    model._train_mesh = mesh


def _copy_leaf_(dst: torch.Tensor, src) -> None:
    """dst <- src: whole tensors, or into a DTensor `dst` its own slice of
    `src` (a whole tensor or array, or a DTensor, whose local slice is
    copied as it is when it is dst's region and gathered otherwise)."""
    src = _as_tensor(src)
    if not mesh_lib.is_dtensor(dst):
        dst.copy_(src)
        return
    mesh = dst.device_mesh
    region = mesh_lib.local_region(dst.shape, mesh.mesh.shape, dst.placements,
                                   mesh.get_coordinate())
    if mesh_lib.is_dtensor(src):
        src_mesh = src.device_mesh
        if mesh_lib.local_region(src.shape, src_mesh.mesh.shape, src.placements,
                                 src_mesh.get_coordinate()) == region:
            dst.to_local().copy_(src.to_local())
            return
        src = src.full_tensor()
    dst.to_local().copy_(src[tuple(slice(a, b) for a, b in region)])


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def _load_params_(model: Transformer, params) -> None:
    named = dict(model.named_parameters())
    for path, name in model.named_tree_params():
        src, dst = _at(params, path), named[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)}, "
                             f"model has {tuple(dst.shape)}")
        _copy_leaf_(dst, src)


@torch.no_grad()
def _draw_params_(model: Transformer, gen: torch.Generator) -> None:
    """Fill the model's weights from `gen` one leaf at a time, each drawn
    whole on the model's device (the draws of `init_params` from the same
    generator) and its slice kept."""
    named = dict(model.named_parameters())
    names = dict(model.named_tree_params())
    for path, leaf in draw_params(model.cfg, gen, model.device):
        _copy_leaf_(named[names[path]], leaf)


def state_shardings(model: Transformer, cfg: ModelConfig, optimizer, mesh, rules=None) -> dict:
    """{checkpoint leaf key: placements on `mesh`} of the state `init_state`
    gives over `mesh` (JAX's `state_shardings`, keyed as a save of
    `state_tree` keys its leaves): the params and adam's two moments as
    their logical axes place them, the step and count replicated. What
    `checkpoint.restore(path, mesh=mesh, placements=...)` takes to read a
    state onto `mesh`, without materialising it; `optimizer` is adamw's."""
    from torch.distributed.tensor import Replicate

    _check_mesh(mesh)
    out = {"step": (Replicate(),) * mesh.ndim, "opt_state/0/0": (Replicate(),) * mesh.ndim}
    for path, _ in model.named_tree_params():
        place = mesh_lib.logical_to_placements(param_axes(path), mesh, rules)
        key = "/".join(path)
        for prefix in ("params", "opt_state/0/1", "opt_state/0/2"):
            out[f"{prefix}/{key}"] = place
    return out


def init_state(model: Transformer, cfg: ModelConfig, optimizer, mesh=None, rules=None,
               rng=None, sample_shape=(1, 128), params=None) -> Tuple[TrainState, Any]:
    """A TrainState over `model`'s own parameters; returns (state,
    shardings): None on one device, `state_shardings` over a mesh.

    Over `mesh` the model is first sharded (`shard_model`; collective, so
    every rank calls it), and the state's tree is taken after, from the
    DTensor parameters. The weights are `params` (a flax-layout tree of
    whole leaves or DTensors, e.g. from `models.convert.params_from_jax`),
    each rank keeping its slice, when given; else drawn from `rng` (an int
    seed or a torch.Generator on the model's device) one leaf at a time;
    else the model's current weights (none for a model on "meta": pass one
    of the two). `sample_shape` is accepted for JAX's signature."""
    if cfg != model.cfg:
        raise ValueError("init_state: cfg differs from the model's config")
    if mesh is not None:
        shard_model(model, mesh, rules)
    elif _mesh_of(model) is not None:
        raise ValueError("init_state: the model is sharded over a mesh; pass that mesh")
    if model.device.type == "meta":
        raise ValueError("init_state: a model on the meta device needs a mesh")
    if params is None and rng is not None:
        gen = rng if isinstance(rng, torch.Generator) else torch.Generator(
            device=model.device).manual_seed(int(rng))
        _draw_params_(model, gen)
    elif params is not None:
        _load_params_(model, params)
    elif getattr(model, "_needs_weights", False):
        raise ValueError("init_state: the model was built on the meta device; pass "
                         "params= or rng=")
    model._needs_weights = False
    tree = model.param_tree(trainable=True)
    state = TrainState(step=0, params=tree, opt_state=optimizer.init(tree))
    return state, (None if mesh is None else state_shardings(model, cfg, optimizer, mesh, rules))


def fused_ce_enabled(model, tokens_shape, loss_fn: Optional[Callable] = None,
                     fused_ce: Optional[bool] = None) -> bool:
    """Whether a step over `tokens_shape` (the global batch's) takes the
    fused cross-entropy: forced by `fused_ce`, else (auto) only for a
    Transformer with no custom `loss_fn` whose [B,S,V] f32 logits would
    pass 2e9 bytes."""
    if fused_ce is not None:
        return fused_ce
    if loss_fn is not None or not isinstance(model, Transformer):
        return False
    b, s = tokens_shape
    return b * s * model.cfg.vocab_size * 4 > FUSED_CE_LOGITS_BYTES


def train_loss(model: Transformer, batch: dict, loss_fn: Optional[Callable] = None,
               fused_ce: Optional[bool] = None, *, denominator=None) -> torch.Tensor:
    """The train step's loss of `batch` under `model`'s current weights:
    the chunked fused cross-entropy against the tied table or `lm_head` when
    `fused_ce_enabled`, else `loss_fn` (default `cross_entropy_loss`) on
    the full logits. `denominator` replaces the built-in losses' local count
    (a rank's share of a global mean). Dense models sow no auxiliary losses
    (JAX's "losses" collection sums to 0 for them); MoE is not ported and
    raises at construction."""
    tokens, targets, mask = batch["tokens"], batch["targets"], batch.get("mask")
    cfg = model.cfg
    if fused_ce_enabled(model, tokens.shape, loss_fn, fused_ce):
        hidden = model(tokens, return_hidden=True)
        table, cdim = (model.embedding, 1) if cfg.tie_embeddings else (model.lm_head, 0)
        return fused_cross_entropy_loss(hidden, table, targets, mask, contract_dim=cdim,
                                        compute_dtype=cfg.dtype, denominator=denominator)
    if loss_fn is None:
        return cross_entropy_loss(model(tokens), targets, mask, denominator=denominator)
    return loss_fn(model(tokens), targets, mask)


class BatchPlacement(dict):
    """Where a batch goes: "tokens" and "targets" map to the device the
    step's batch must be on, and calling it with a global batch (tensors
    or numpy arrays) returns the rank's rows of it on that device, as
    JAX's batch shardings place them (all rows on one device)."""

    def __init__(self, device: torch.device, mesh=None, rules=None):
        super().__init__(tokens=device, targets=device)
        self.device, self._mesh, self._rules = device, mesh, rules

    def __call__(self, batch: dict) -> dict:
        rows = slice(None)
        if self._mesh is not None:
            rows = mesh_lib.batch_rows(self._mesh, len(batch["tokens"]), self._rules)
        return {key: _as_tensor(val)[rows].to(self.device) for key, val in batch.items()}


def build_train_step(model: Transformer, optimizer, mesh=None, rules=None,
                     loss_fn: Optional[Callable] = None, donate: bool = True,
                     fused_ce: Optional[bool] = None, with_grad_norm: bool = True):
    """One train step: (state, batch{tokens, targets, mask?}) -> (state,
    metrics). Returns (step_fn, placement), a `BatchPlacement`: placement[
    "tokens"] is the device the batch must be on, placement(batch) a global
    batch's rows for this rank there.

    Over `mesh` (the one `init_state` sharded the model over) the step is
    collective: each rank passes its rows and gets the global metrics. A
    custom `loss_fn` there is averaged over the ranks' rows.
    fused_ce (default: auto, see `fused_ce_enabled`): compute the head and
    cross-entropy in sequence chunks so the [B,S,V] logits are never held.
    metrics: "loss" (0-d f32 tensor), "step" (int), and with
    `with_grad_norm` "grad_norm", the global L2 norm of the gradients."""
    if not donate:
        raise NotImplementedError(
            "build_train_step updates the state in place (donate=True); a "
            "step that keeps the old state is not ported")
    if mesh is not None:
        _check_mesh(mesh)
        if _mesh_of(model) is not mesh:
            raise ValueError("build_train_step: shard the model over this mesh first "
                             "(init_state(model, cfg, optimizer, mesh))")
        return (_mesh_step(model, optimizer, mesh, rules, loss_fn, fused_ce, with_grad_norm),
                BatchPlacement(model.device, mesh, rules))
    if _mesh_of(model) is not None:
        raise ValueError("build_train_step: the model is sharded over a mesh; pass it")

    def step(state: TrainState, batch: dict):
        loss = train_loss(model, batch, loss_fn, fused_ce)
        grads = torch.autograd.grad(loss, tree_leaves(state.params))
        metrics = {"loss": loss.detach()}
        if with_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        optimizer.update_(tree_unflatten(state.params, grads), state.opt_state, state.params)
        del grads
        state.step += 1
        metrics["step"] = state.step
        return state, metrics

    return step, BatchPlacement(model.device)


def _mesh_step(model, optimizer, mesh, rules, loss_fn, fused_ce, with_grad_norm):
    """The step over a mesh. Each rank's loss is its rows' summed loss over
    the global count (tokens, or the mask's ones all-reduced), so the ranks'
    losses sum to JAX's global mean; the backward runs on that loss times
    the number of row blocks, which FSDP2's gradient mean over the data-
    parallel ranks divides back out, leaving the global loss's gradient."""
    import torch.distributed as dist

    shards = mesh_lib.batch_shards(mesh, rules)
    if shards != mesh.size():
        raise NotImplementedError(
            f"the rules split the batch into {shards} row blocks over a mesh of "
            f"{mesh.size()} ranks; the step needs every rank its own rows, as the "
            f"default rules place the batch over (dp, fsdp)")

    def step(state: TrainState, batch: dict):
        tokens, mask = batch["tokens"], batch.get("mask")
        global_shape = (tokens.shape[0] * shards, tokens.shape[1])
        fused = fused_ce_enabled(model, global_shape, loss_fn, fused_ce)
        if loss_fn is None or fused:
            if mask is None:
                count = float(global_shape[0] * global_shape[1])
            else:
                count = mask.to(torch.float32).sum()
                dist.all_reduce(count)
                count = count.clamp_min(1.0)
            loss = train_loss(model, batch, loss_fn, fused, denominator=count)
        else:
            loss = train_loss(model, batch, loss_fn, fused) / shards
        (loss * shards).backward()
        loss = loss.detach()
        dist.all_reduce(loss)
        params = tree_leaves(state.params)
        grads = [p.grad for p in params]
        metrics = {"loss": loss}
        if with_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        optimizer.update_(tree_unflatten(state.params, grads), state.opt_state, state.params)
        for p in params:
            p.grad = None
        del grads
        state.step += 1
        metrics["step"] = state.step
        return state, metrics

    return step


def eval_logits_fn(model: Transformer, rules=None):
    """forward(params, tokens) -> f32 logits [B,S,V] of `model` evaluated
    with the weights of `params` (a flax-layout tree of tensors), without
    gradients. Over a mesh the forward is collective (every rank calls it,
    each with the tokens it wants logits of) and evaluates the model's own
    sharded weights, so `params` must be the state's."""
    from torch.func import functional_call

    def forward(params, tokens):
        if _mesh_of(model) is not None:
            own = model.param_tree(trainable=True)
            if any(a is not b for a, b in zip(tree_leaves(params), tree_leaves(own))):
                raise ValueError("over a mesh, eval_logits_fn evaluates the model's own "
                                 "weights: pass the state's params")
            with torch.no_grad():
                logits = model(tokens)
            model.reshard()  # the root keeps its gathered weights after a forward
            return logits
        named = {name: _at(params, path) for path, name in model.named_tree_params()}
        with torch.no_grad():
            return functional_call(model, named, (tokens,))

    return forward


def state_tree(state: TrainState) -> dict:
    """The tree of `state` as a JAX user checkpoints a TrainState:
    ``{"step", "params", "opt_state"}``, with `opt_state` nested as
    `optax.adamw`'s chain nests its state for a constant learning rate,
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``, here
    ``((count, mu, nu), (), ())``; step and count are int32 scalars as in
    JAX. The tensors are the state's own (DTensors over a mesh; a
    checkpoint save snapshots them); params are in the unscanned
    `layer_{i}` layout, which JAX reads with `scan_layers=False` or through
    its engine."""
    opt = state.opt_state
    return {"step": np.asarray(state.step, np.int32), "params": state.params,
            "opt_state": ((np.asarray(opt.count, np.int32), opt.mu, opt.nu), (), ())}


def _scalar(x) -> int:
    if mesh_lib.is_dtensor(x):
        x = x.to_local()
    return int(x.item()) if isinstance(x, torch.Tensor) else int(np.asarray(x))


def state_from_tree(model: Transformer, cfg: ModelConfig, optimizer, tree,
                    mesh=None) -> TrainState:
    """A TrainState over `model`'s parameters from a tree `state_tree` wrote
    or a JAX user saved (the host tree of `checkpoint.restore`, its tensors
    on a device, or DTensors restored onto a mesh): the params are loaded
    into the model, the adam moments copied into a fresh `optimizer.init`
    state, and the step and count set. Over a mesh (the one the model is
    sharded over, or `mesh` to shard it now) each rank keeps its slice of
    every leaf, read as it lies when the tree's leaves are placed as the
    model's. Scanned `layers` stacks are split into `layer_{i}`. Raises
    ValueError when the tree is not adamw's or its leaves do not match the
    model's parameters in path, shape or the optimizer's dtype."""
    params = _tree_map(_as_tensor, unstack_layers(tree["params"], cfg.n_layers))
    state, _ = init_state(model, cfg, optimizer, mesh if mesh is not None else _mesh_of(model),
                          params=params)
    adam = tree["opt_state"][0]
    if not isinstance(adam, (tuple, list)) or len(adam) != 3:
        raise ValueError("state_from_tree: opt_state[0] is not optax.adamw's "
                         "ScaleByAdamState(count, mu, nu)")
    count, mu, nu = adam
    with torch.no_grad():
        for name, src, dst in (("mu", mu, state.opt_state.mu), ("nu", nu, state.opt_state.nu)):
            src = unstack_layers(src, cfg.n_layers)
            if _leaf_paths(src) != _leaf_paths(dst):
                raise ValueError(f"state_from_tree: {name}'s leaves are not the params'")
            for path, s, d in zip(_leaf_paths(dst), tree_leaves(src), tree_leaves(dst)):
                s = _as_tensor(s)
                if s.dtype != d.dtype or tuple(s.shape) != tuple(d.shape):
                    raise ValueError(f"state_from_tree: {name}/{path} is {s.dtype} "
                                     f"{tuple(s.shape)}, the optimizer keeps {d.dtype} "
                                     f"{tuple(d.shape)}")
                _copy_leaf_(d, s)
    state.opt_state.count = _scalar(count)
    state.step = _scalar(tree["step"])
    return state
