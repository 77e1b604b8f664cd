"""Training: state init and train-step construction on one device.

The port of `ray_tpu/parallel/spmd.py`. JAX jits one program over a named
mesh, with the state donated; here the step runs eagerly on the model's own
device and updates the state in place (the PyTorch idiom for `donate=True`).
The step keeps JAX's contract: (state, batch{tokens, targets, mask?}) ->
(state, metrics{loss, step, grad_norm?}), bf16 compute over f32 params and
optimizer state, and the same automatic switch to the chunked fused
cross-entropy. A mesh of more than one device (FSDP, tensor parallelism) is
ROADMAP Queue 1 item 1c and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (
    ModelConfig,
    Transformer,
    cross_entropy_loss,
    fused_cross_entropy_loss,
    init_params,
)
from ray_tpu_torch.parallel.optim import global_norm, tree_leaves, tree_unflatten

# Logits bytes (b * s * vocab * 4) above which the step takes the fused
# cross-entropy, as spmd.py:136 decides.
FUSED_CE_LOGITS_BYTES = 2_000_000_000


@dataclasses.dataclass
class TrainState:
    """step: updates taken; params: the model's nn.Parameters in the flax
    tree layout (`Transformer.param_tree(trainable=True)`); opt_state: the
    optimizer's state over the same tree."""

    step: int
    params: Any
    opt_state: Any


def _check_mesh(mesh) -> None:
    if mesh is None:
        return
    size = mesh.size() if callable(getattr(mesh, "size", None)) else np.size(
        getattr(mesh, "devices", [None]))
    if size > 1:
        raise NotImplementedError(
            f"a mesh of {size} devices (parallel/mesh.py + FSDP2) is ROADMAP "
            f"Queue 1 item 1c of the port; pass mesh=None to train on the "
            f"model's device"
        )


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _load_params_(model: Transformer, params) -> None:
    named = dict(model.named_parameters())
    with torch.no_grad():
        for path, name in model.named_tree_params():
            src, dst = _at(params, path), named[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)}, "
                                 f"model has {tuple(dst.shape)}")
            dst.copy_(src)


def init_state(model: Transformer, cfg: ModelConfig, optimizer, mesh=None, rules=None,
               rng=None, sample_shape=(1, 128), params=None) -> Tuple[TrainState, None]:
    """A TrainState over `model`'s own parameters; returns (state, None)
    (there are no shardings on one device). The weights are `params` (a
    flax-layout tree, e.g. from `models.convert.params_from_jax`) when given,
    else drawn from `rng` (an int seed or a torch.Generator on the model's
    device) when given, else the model's current weights. `rules` and
    `sample_shape` are accepted for JAX's signature and not needed here."""
    _check_mesh(mesh)
    if cfg != model.cfg:
        raise ValueError("init_state: cfg differs from the model's config")
    if params is None and rng is not None:
        gen = rng if isinstance(rng, torch.Generator) else torch.Generator(
            device=model.device).manual_seed(int(rng))
        params = init_params(cfg, gen, model.device)
    if params is not None:
        _load_params_(model, params)
    tree = model.param_tree(trainable=True)
    return TrainState(step=0, params=tree, opt_state=optimizer.init(tree)), None


def fused_ce_enabled(model, tokens_shape, loss_fn: Optional[Callable] = None,
                     fused_ce: Optional[bool] = None) -> bool:
    """Whether a step over `tokens_shape` takes the fused cross-entropy:
    forced by `fused_ce`, else (auto) only for a Transformer with no custom
    `loss_fn` whose [B,S,V] f32 logits would pass 2e9 bytes."""
    if fused_ce is not None:
        return fused_ce
    if loss_fn is not None or not isinstance(model, Transformer):
        return False
    b, s = tokens_shape
    return b * s * model.cfg.vocab_size * 4 > FUSED_CE_LOGITS_BYTES


def train_loss(model: Transformer, batch: dict, loss_fn: Optional[Callable] = None,
               fused_ce: Optional[bool] = None) -> torch.Tensor:
    """The train step's loss of `batch` under `model`'s current weights:
    the chunked fused cross-entropy against the tied table or `lm_head` when
    `fused_ce_enabled`, else `loss_fn` (default `cross_entropy_loss`) on
    the full logits. Dense models sow no auxiliary losses (JAX's "losses"
    collection sums to 0 for them); MoE is not ported and raises at
    construction."""
    tokens, targets, mask = batch["tokens"], batch["targets"], batch.get("mask")
    cfg = model.cfg
    if fused_ce_enabled(model, tokens.shape, loss_fn, fused_ce):
        hidden = model(tokens, return_hidden=True)
        table, cdim = (model.embedding, 1) if cfg.tie_embeddings else (model.lm_head, 0)
        return fused_cross_entropy_loss(hidden, table, targets, mask, contract_dim=cdim,
                                        compute_dtype=cfg.dtype)
    return (loss_fn or cross_entropy_loss)(model(tokens), targets, mask)


def build_train_step(model: Transformer, optimizer, mesh=None, rules=None,
                     loss_fn: Optional[Callable] = None, donate: bool = True,
                     fused_ce: Optional[bool] = None, with_grad_norm: bool = True):
    """One train step: (state, batch{tokens, targets, mask?}) -> (state,
    metrics). Returns (step_fn, batch_placement), where batch_placement maps
    "tokens" and "targets" to the device the batch must be on.

    fused_ce (default: auto, see `fused_ce_enabled`): compute the head and
    cross-entropy in sequence chunks so the [B,S,V] logits are never held.
    metrics: "loss" (0-d f32 tensor), "step" (int), and with
    `with_grad_norm` "grad_norm", the global L2 norm of the gradients."""
    _check_mesh(mesh)
    if not donate:
        raise NotImplementedError(
            "build_train_step updates the state in place (donate=True); a "
            "step that keeps the old state is not ported")

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

    placement = {"tokens": model.device, "targets": model.device}
    return step, placement


def eval_logits_fn(model: Transformer, rules=None):
    """forward(params, tokens) -> f32 logits of `model` evaluated with the
    weights of `params` (a flax-layout tree of tensors), without gradients."""
    from torch.func import functional_call

    def forward(params, tokens):
        named = {name: _at(params, path) for path, name in model.named_tree_params()}
        with torch.no_grad():
            return functional_call(model, named, (tokens,))

    return forward
