"""AdamW for the port: the counterpart of `optax.adamw`, which every JAX
training entry point of ray_tpu uses (`bench.py`, `parallel/spmd.py`'s
callers, the trainers).

Same signature, same defaults and the same arithmetic as optax 0.2's
`chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)`:

    mu  = (1 - b1) * g + b1 * mu          (b1 * mu in mu's stored dtype)
    nu  = (1 - b2) * g**2 + b2 * nu
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t) + eps_root) + eps)
    p  -= lr * (u + weight_decay * p)     (decay of the pre-update param)

with t the step count after the increment and the bias corrections in f32.
The first moment's new value is f32; it is bias-corrected in f32 and then
stored cast to `mu_dtype`. With a bf16 `mu_dtype`, JAX's weak typing rounds
b1 to bf16 in `b1 * mu` (0.8984375 for 0.9); the port does the same. `torch.optim.AdamW` differs (decay default 0.01, no `mu_dtype`),
so this module does the update itself with `torch._foreach_*` ops.

PyTorch idiom: `update_(grads, state, params)` applies the step to `params`
and `state` in place (JAX returns new trees; the port's train step mutates
the model's own parameters, as `donate=True` lets XLA reuse their buffers).

Over a mesh the leaves are DTensors (FSDP2's sharded parameters, their
gradients, and moments made like them): the update is elementwise, so it
runs on each rank's local shards with no gather, and `global_norm` sums
the squares of the shards each rank owns in one all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import is_dtensor

ParamTree = Dict[str, Any]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order, as jax.tree.leaves."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: ParamTree
    nu: ParamTree


class AdamW:
    """`adamw(...)`'s result: `init(params)` and `update_(grads, state, params)`."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]], b1: float,
                 b2: float, eps: float, eps_root: float, mu_dtype: Optional[torch.dtype],
                 weight_decay: float):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype = mu_dtype
        self.weight_decay = weight_decay

    def init(self, params: ParamTree) -> AdamWState:
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype or p.dtype, requires_grad=False)

        mu = tree_unflatten(params, [zeros(p, self.mu_dtype) for p in tree_leaves(params)])
        nu = tree_unflatten(params, [zeros(p) for p in tree_leaves(params)])
        return AdamWState(count=0, mu=mu, nu=nu)

    def _bias_correction(self, decay: float, count: int) -> float:
        # optax: 1 - decay**count in f32 (count is an int32 array there).
        return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))

    @torch.no_grad()
    def update_(self, grads: ParamTree, state: AdamWState, params: ParamTree) -> AdamWState:
        """One AdamW step on `params` (in place) from `grads`; returns `state`,
        also updated in place."""
        lr = (self.learning_rate(state.count) if callable(self.learning_rate)
              else self.learning_rate)
        state.count += 1
        bc1 = self._bias_correction(self.b1, state.count)
        bc2 = self._bias_correction(self.b2, state.count)
        # Every leaf in one pass of foreach ops; the f32 temporaries peak at
        # about 2.5 times the params' size.
        p, g = _locals(tree_leaves(params)), _locals(tree_leaves(grads))
        m, n = _locals(tree_leaves(state.mu)), _locals(tree_leaves(state.nu))
        if not (len(p) == len(g) == len(m) == len(n)):
            raise ValueError("grads, params and optimizer state have different trees")
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) * g + b1 * mu, as JAX's weak typing computes it: b1 *
        # mu in mu's stored dtype with b1 itself rounded to that dtype (for
        # bf16, 0.8984375), then the sum in f32 (bf16 + f32 promotes to f32).
        b1_m = float(torch.tensor(b1, dtype=m[0].dtype))
        mu = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(mu, [t.float() for t in torch._foreach_mul(m, b1_m)])
        torch._foreach_copy_(m, mu)  # stored in mu_dtype
        # nu = (1 - b2) * g**2 + b2 * nu
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(n, b2)
        torch._foreach_add_(n, sq)
        del sq
        # u = mu_hat / (sqrt(nu_hat + eps_root) + eps), mu_hat from the f32 mu.
        torch._foreach_div_(mu, bc1)
        den = torch._foreach_div(n, bc2)
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(mu, p, alpha=self.weight_decay)
        torch._foreach_mul_(mu, -lr)
        torch._foreach_add_(p, mu)
        return state


def adamw(learning_rate: Union[float, Callable[[int], float]], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None, weight_decay: float = 1e-4,
          mask=None, *, nesterov: bool = False) -> AdamW:
    """optax.adamw's signature and defaults. `learning_rate` is a float or a
    schedule of the step count before the update, as in optax. `mask` and
    `nesterov` are not ported and raise."""
    if mask is not None or nesterov:
        raise NotImplementedError("adamw: mask and nesterov are not ported")
    return AdamW(learning_rate, b1, b2, eps, eps_root, mu_dtype, weight_decay)


def _locals(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each DTensor's local shard (a view: updates write the DTensor), other
    tensors as they are."""
    return [t.to_local() if is_dtensor(t) else t for t in tensors]


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every element of every tensor (optax.global_norm).
    DTensors (whose mesh spans every rank) count each distinct slice once:
    a rank adds the squares of a shard only where its coordinate is 0 on
    every dimension the shard is replicated over, and one all-reduce sums
    the ranks' parts; the norm is then the same on every rank."""
    leaves = tree_leaves(tensors) if isinstance(tensors, dict) else list(tensors)
    if not any(is_dtensor(t) for t in leaves):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))
    import torch.distributed as dist

    owned = []
    for t in leaves:
        coord = t.device_mesh.get_coordinate()
        if t.device_mesh.size() != dist.get_world_size():
            raise ValueError("global_norm: a DTensor's mesh does not span every rank")
        if all(c == 0 for c, p in zip(coord, t.placements) if not p.is_shard()):
            owned.append(t.to_local())
    device = _locals(leaves[:1])[0].device
    squares = torch.zeros((), dtype=torch.float32, device=device)
    if owned:
        squares = torch.stack(torch._foreach_norm(owned)).float().square().sum()
    dist.all_reduce(squares)
    return squares.sqrt()
