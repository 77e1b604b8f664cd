"""Map a JAX (flax) param tree onto the port's parameters.

The one place where layouts are mapped. The port keeps the flax tree's names
and per-tensor layouts (`q/kernel` [E,H,D], `o/kernel` [H,D,E], `gate/kernel`
[E,F], ...), so the only reshaping is of layer stacking: a model built with
`scan_layers=True` stores every layer under `layers` with a leading layer
axis, which is split here into the unscanned `layer_{i}` entries that the
port's Transformer and DecodeEngine read. The fused-qkv layout (`qkv/kernel`,
`gate_up/kernel`) maps over the same way. Leaves may be numpy arrays or torch
tensors (a checkpoint restored by `ray_tpu_torch.checkpoint` holds bfloat16
leaves as torch tensors).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.transformer import ModelConfig, ParamTree

_NORMS = ("attn_norm", "mlp_norm", "final_norm")


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _convert(node: Mapping[str, Any], dtype, device, name: str = "") -> ParamTree:
    out: ParamTree = {}
    for key, val in node.items():
        if isinstance(val, Mapping):
            out[key] = _convert(val, dtype, device, key)
        else:
            # Norm scales stay f32 (the engine's RMSNorm multiplies in f32).
            out[key] = _tensor(val, torch.float32 if name in _NORMS else dtype, device)
    return out


def _unstack(stacked: Mapping[str, Any], i: int):
    return {k: (_unstack(v, i) if isinstance(v, Mapping)
                else v[i] if isinstance(v, torch.Tensor) else np.asarray(v)[i])
            for k, v in stacked.items()}


def unstack_layers(tree: Mapping[str, Any], n_layers: int) -> dict:
    """A param-shaped tree (params, or an optimizer moment over them) with
    a scanned `layers` stack split into `layer_{i}` entries; returned as it
    is (a shallow copy) when it has none."""
    tree = dict(tree)
    if "layers" in tree:
        stacked = tree.pop("layers")
        for i in range(n_layers):
            tree[f"layer_{i}"] = _unstack(stacked, i)
    return tree


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> ParamTree:
    """A nested dict of numpy arrays (the flax param tree, boxes stripped;
    a `{"params": ...}` variables dict is accepted too) -> the port's param
    tree on `device`, matrices in `dtype` (default `cfg.param_dtype`), norm
    scales in f32. Takes both the unscanned `layer_{i}` layout and the
    scanned `layers` stacks."""
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    if set(tree) == {"params"}:
        tree = tree["params"]
    tree = unstack_layers(tree, cfg.n_layers)
    missing = [f"layer_{i}" for i in range(cfg.n_layers) if f"layer_{i}" not in tree]
    if missing or "embedding" not in tree:
        raise ValueError(f"param tree lacks {missing or ['embedding']} for {cfg}")
    return _convert(tree, dtype, dev)
