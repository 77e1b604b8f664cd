"""Decoder-only transformer (llama family) in PyTorch.

Twin of `ray_tpu/models/transformer.py`: RMSNorm, rotary embeddings,
grouped-query attention, SwiGLU MLP, untied or tied output head; activations
in `cfg.dtype` (bf16 for the named models) with f32 norm reductions and an
f32-accumulated head. Parameters keep the flax tree's names and layouts
(`layer_{i}/attn/q/kernel` is [E,H,D], `o/kernel` is [H,D,E], and so on), so a
JAX checkpoint maps over one to one (`models/convert.py`) and the serving
engine reads the same tensors. Parameters are trainable; serving runs under
`torch.inference_mode()`.

Training: `remat=True` recomputes each block in the backward pass
(`torch.utils.checkpoint`, non-reentrant), keeping what JAX's `remat_block`
policy keeps (`remat_context`): nothing under "full", the attention output
under "attn", every matmul's output under "dots", and under "selective" the
tensors JAX names "save" plus the flash forward's outputs
("flash_residuals"). `forward(..., return_hidden=True)` stops before the
head for `fused_cross_entropy_loss`, which never holds the full [B,S,V]
logits.

Attention routes, as in the JAX module: "flash" runs the projections straight
into [B,H,S,D] and the K1 kernel in that layout (`ops.attention.
flash_attention_bhsd`, K2 in its backward); "reference" runs plain attention
in [B,S,H,D]; a call with kv caches takes the plain cached route.
`fused_qkv=True` projects q|k|v (and the MLP's gate|up) with one matrix each
and, on the flash route, runs K1 and K2 in the [B,S,H,D] layout
(`flash_attention`), as JAX's fused branch does. The ring, ulysses and MoE
routes are later slices and raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import (
    FLASH_FWD_OP,
    flash_attention,
    flash_attention_bhsd,
    reference_attention,
)

ParamTree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    mlp_dim: int = 1408
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Storage type of the matrices; norm scales are always f32. JAX keeps f32
    # params and casts at use; serving stores bf16 copies (the same math).
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    # Training memory: recompute each block in the backward pass, keeping
    # what `remat_policy` names (REMAT_POLICIES).
    remat: bool = True
    remat_policy: str = "full"
    # Inert: accepted so JAX's config overrides carry over; the port runs
    # the same layer loop either way.
    scan_layers: bool = True
    fused_qkv: bool = False
    attention: str = "flash"  # flash | reference | ring | ulysses
    moe_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    def num_params(self) -> int:
        e = self.vocab_size * self.hidden
        attn = self.hidden * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        mlp = 3 * self.hidden * self.mlp_dim
        per_layer = attn + mlp + 2 * self.hidden
        head = 0 if self.tie_embeddings else e
        return e + self.n_layers * per_layer + self.hidden + head


# The same names and shapes as ray_tpu's CONFIGS.
CONFIGS: Dict[str, ModelConfig] = {
    "test-tiny": ModelConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128,
        max_seq=128, dtype=torch.float32, remat=False, scan_layers=False,
        attention="reference",
    ),
    "gpt2-125m": ModelConfig(
        vocab_size=50257, hidden=768, n_layers=12, n_heads=12, n_kv_heads=12,
        mlp_dim=3072, max_seq=1024, tie_embeddings=True,
    ),
    "llama3-1b": ModelConfig(
        vocab_size=128256, hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        mlp_dim=8192, max_seq=8192, tie_embeddings=True,
    ),
    "llama3-8b": ModelConfig(
        vocab_size=128256, hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_dim=14336, max_seq=8192,
    ),
}


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} (ops/ring_attention.py) is ROADMAP "
            f"Queue 1 item 7 (parallel ops) of the port"
        )
    if cfg.attention not in ("flash", "reference"):
        raise ValueError(f"unknown attention route {cfg.attention!r}")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0 (ops/moe.py) is ROADMAP Queue 1 item 7 (parallel "
            "ops) of the port"
        )


# ---------------------------------------------------------------- remat


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """JAX's `checkpoint_name` as a dispatched op, so that a selective-
    checkpoint policy can keep the tensor by its name. Torch's policies
    decide per op, not per tensor, and a custom op may not return its input,
    so this is a copy (one read and one write of x) whose gradient passes
    through; the model calls it only where its remat policy keeps the name.

    The names buy parity of memory with JAX, not compute: the non-reentrant
    recompute reruns the block's Python in order, so every op upstream of a
    kept tensor still reruns and only the tag's own copy is spared (where
    XLA drops the upstream ops as dead code). Of what "attn" and
    "selective" keep, only `flash_fwd`'s outputs spare work: K1's rerun."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))

_CHECKPOINT_NAME_OP = torch.ops.ray_tpu_torch.checkpoint_name.default

# What each policy keeps for the backward pass, as JAX's `remat_block`
# (ray_tpu/models/transformer.py:437) has it: the checkpoint names it saves,
# and whether it saves every matmul's output (`dots_saveable`). The name
# "flash_residuals" is the flash forward's (out, lse), the outputs of the
# `flash_fwd` op.
REMAT_POLICIES: Dict[str, Tuple[Tuple[str, ...], bool]] = {
    "full": ((), False),
    "attn": (("attn_out",), False),
    "dots": ((), True),
    "selective": (("save", "flash_residuals"), False),
}
# What dot_general becomes in aten: x @ w and einsum dispatch these.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def remat_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The checkpoint names a block of `cfg` tags (none without remat)."""
    return REMAT_POLICIES[cfg.remat_policy][0] if cfg.remat else ()


def remat_context(policy: str):
    """The `context_fn` of `torch.utils.checkpoint` for a remat policy: None
    for "full" (keep nothing), else a selective-checkpoint policy that keeps
    the outputs of the ops the policy names (MUST_SAVE) and recomputes the
    rest."""
    names, dots = REMAT_POLICIES[policy]
    if not names and not dots:
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved_ops = set(_DOT_OPS) if dots else set()
    if "flash_residuals" in names:
        saved_ops.add(FLASH_FWD_OP)

    def policy_fn(ctx, op, *args, **kwargs):
        if op in saved_ops or (op is _CHECKPOINT_NAME_OP and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _named(x: torch.Tensor, name: str, names: Tuple[str, ...]) -> torch.Tensor:
    """x tagged with `name` where the block's policy keeps it and a backward
    pass may need it (no copy under no_grad or inference)."""
    return checkpoint_name(x, name) if name in names and torch.is_grad_enabled() else x


# ---------------------------------------------------------------- rotary


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embedding: [B,S,half] f32 each, computed once
    per forward."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B,S,half]
    return torch.cos(angles), torch.sin(angles)


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply the rotation in the activation dtype. x: [B,S,H,D]; cos/sin: [B,S,D//2]."""
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope_apply_bhsd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply the rotation in the kernel-native layout. x: [B,H,S,D]."""
    cos = cos[:, None, :, :].to(x.dtype)
    sin = sin[:, None, :, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding. x: [B,S,H,D]; positions: [B,S] or [S]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rope_apply(x, cos, sin)


# ---------------------------------------------------------------- parameters


def _normal(shape, std, dtype, device, generator):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype) * std


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> ParamTree:
    """Random weights in the flax tree layout (unscanned `layer_{i}`; with
    `fused_qkv`, `attn/qkv` [E,H+2Hkv,D] and `mlp/gate_up` [E,2F] in place of
    q, k, v and gate, up).

    The distributions follow the JAX module's initializers (embedding
    normal(0.02), matrices lecun-normal over their fan-in, norm scales one),
    drawn from `generator`, a torch.Generator on `device` (seeded with 0 when
    not given). JAX's PRNG gives other numbers from the same seed, so tests
    hand both packages the same numpy weights instead."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    wd = cfg.param_dtype
    E, H, Hkv, D, F = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.mlp_dim

    def dense(shape, fan_in):
        return {"kernel": _normal(shape, 1.0 / math.sqrt(fan_in), wd, dev, g)}

    def norm():
        return {"scale": torch.ones(E, dtype=torch.float32, device=dev)}

    params: ParamTree = {"embedding": _normal((cfg.vocab_size, E), 0.02, wd, dev, g)}
    for i in range(cfg.n_layers):
        if cfg.fused_qkv:
            attn = {"qkv": dense((E, H + 2 * Hkv, D), E)}
            mlp = {"gate_up": dense((E, 2 * F), E)}
        else:
            attn = {"q": dense((E, H, D), E), "k": dense((E, Hkv, D), E),
                    "v": dense((E, Hkv, D), E)}
            mlp = {"gate": dense((E, F), E), "up": dense((E, F), E)}
        params[f"layer_{i}"] = {
            "attn_norm": norm(),
            "attn": dict(attn, o=dense((H, D, E), H * D)),
            "mlp_norm": norm(),
            "mlp": dict(mlp, down=dense((F, E), F)),
        }
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((E, cfg.vocab_size), E)
    return params


# ---------------------------------------------------------------- modules


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.eps = eps

    def forward(self, x):
        # f32 mean-of-squares; the normalizing multiply runs in the activation
        # dtype (the engine's _rmsnorm multiplies in f32 on purpose: the two
        # differ in bf16 and both are kept).
        x32 = x.float()
        inv = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return x * (inv.to(x.dtype) * self.scale.to(x.dtype))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, p: ParamTree):
        super().__init__()
        self.cfg = cfg
        self.names = remat_names(cfg)
        if cfg.fused_qkv:
            self.qkv = nn.Parameter(p["qkv"]["kernel"])  # [E,H+2Hkv,D]: q | k | v
        else:
            self.q = nn.Parameter(p["q"]["kernel"])  # [E,H,D]
            self.k = nn.Parameter(p["k"]["kernel"])  # [E,Hkv,D]
            self.v = nn.Parameter(p["v"]["kernel"])
        self.o = nn.Parameter(p["o"]["kernel"])  # [H,D,E]

    def _proj(self, x, w):
        """[B,S,E] -> [B,S,heads,D] in the activation dtype."""
        B, S, E = x.shape
        return (x.to(self.cfg.dtype) @ w.to(self.cfg.dtype).reshape(E, -1)).view(
            B, S, w.shape[1], w.shape[2])

    def _out(self, out):
        """[B,S,H,D] -> [B,S,E]."""
        B, S = out.shape[:2]
        w = self.o.to(self.cfg.dtype)
        return out.reshape(B, S, -1).to(self.cfg.dtype) @ w.reshape(-1, w.shape[-1])

    def forward(self, x, positions, rope=None, kv_cache=None):
        cfg = self.cfg
        if cfg.attention == "flash" and kv_cache is None and not cfg.fused_qkv:
            return self._flash_bhsd(x, positions, rope), None
        if cfg.fused_qkv:
            # One [E, H+2Hkv, D] projection split into q | k | v, as JAX's
            # fused branch; v stays a strided view (the kernels take strides).
            qkv = self._proj(x, self.qkv)
            q, k, v = qkv.split([cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads], dim=2)
        else:
            q, k, v = self._proj(x, self.q), self._proj(x, self.k), self._proj(x, self.v)
        if rope is None:
            rope = _rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = _rope_apply(q, *rope)
        k = _rope_apply(k, *rope)
        q, k, v = (_named(t, "save", self.names) for t in (q, k, v))
        new_cache = None
        if kv_cache is not None:
            # Decode path: append to the cache and attend over the full prefix.
            # The write is in place (JAX's dynamic_update_slice returns a new
            # array; start clamped to [0, T-S] the same way).
            cache_k, cache_v, cache_len = kv_cache
            S, T = x.shape[1], cache_k.shape[1]
            start = min(max(int(cache_len), 0), T - S)
            cache_k[:, start:start + S] = k.to(cache_k.dtype)
            cache_v[:, start:start + S] = v.to(cache_v.dtype)
            new_cache = (cache_k, cache_v, int(cache_len) + S)
            out = reference_attention(
                q, cache_k, cache_v, causal=True,
                positions_q=positions[0] if positions.ndim > 1 else positions,
                positions_kv=torch.arange(T, device=x.device),
            )
        elif cfg.attention == "reference":
            out = reference_attention(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, True, None)
        return self._out(self._name_out(out, flash=kv_cache is None
                                        and cfg.attention == "flash")), new_cache

    def _name_out(self, out, flash: bool):
        """JAX names the attention output "attn_out" under `attn` and "save"
        under `selective`. The flash op's output is already kept under
        "flash_residuals" by `selective`, so it is not copied a second time."""
        out = _named(out, "attn_out", self.names)
        return out if flash else _named(out, "save", self.names)

    def _flash_bhsd(self, x, positions, rope):
        """Transpose-free route: projections land in [B,H,S,D] (a strided view
        of the matmul output), K1 runs in that layout, and the output
        projection contracts back to [B,S,E]."""
        cfg = self.cfg
        q = self._proj(x, self.q).transpose(1, 2)
        k = self._proj(x, self.k).transpose(1, 2)
        v = self._proj(x, self.v).transpose(1, 2)
        if rope is None:
            rope = _rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = _rope_apply_bhsd(q, *rope)
        k = _rope_apply_bhsd(k, *rope)
        q, k, v = (_named(t, "save", self.names) for t in (q, k, v))
        out = self._name_out(flash_attention_bhsd(q, k, v, True, None), flash=True)
        return self._out(out.transpose(1, 2))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, p: ParamTree):
        super().__init__()
        self.cfg = cfg
        self.names = remat_names(cfg)
        if cfg.fused_qkv:
            self.gate_up = nn.Parameter(p["gate_up"]["kernel"])  # [E,2F]: gate | up
        else:
            self.gate = nn.Parameter(p["gate"]["kernel"])
            self.up = nn.Parameter(p["up"]["kernel"])
        self.down = nn.Parameter(p["down"]["kernel"])

    def forward(self, x):
        dt = self.cfg.dtype
        x = x.to(dt)
        if self.cfg.fused_qkv:
            gate, up = (x @ self.gate_up.to(dt)).chunk(2, dim=-1)
        else:
            gate = x @ self.gate.to(dt)
            up = x @ self.up.to(dt)
        # selective keeps the narrow down output; gate and up are recomputed.
        return _named((nn.functional.silu(gate) * up) @ self.down.to(dt), "save", self.names)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, p: ParamTree):
        super().__init__()
        self.attn_norm = RMSNorm(p["attn_norm"]["scale"], cfg.norm_eps)
        self.attn = Attention(cfg, p["attn"])
        self.mlp_norm = RMSNorm(p["mlp_norm"]["scale"], cfg.norm_eps)
        self.mlp = MLP(cfg, p["mlp"])
        self.names = remat_names(cfg)

    def forward(self, x, positions, rope=None, kv_cache=None):
        attn_out, new_cache = self.attn(self.attn_norm(x), positions, rope, kv_cache)
        x = x + attn_out
        x = x + self.mlp(_named(self.mlp_norm(x), "save", self.names))
        return x, new_cache


class Transformer(nn.Module):
    """The model over a flax-layout param tree (`init_params` or
    `convert.params_from_jax`); random weights from `generator` when `params`
    is None. The modules hold the tree's tensors, not copies, so a second
    Transformer (another attention route) or the engine can share them."""

    def __init__(self, cfg: ModelConfig, params: Optional[ParamTree] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, generator, self.device)
        self.embedding = nn.Parameter(params["embedding"])
        self.layers = nn.ModuleList(
            Block(cfg, params[f"layer_{i}"]) for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(params["final_norm"]["scale"], cfg.norm_eps)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(params["lm_head"]["kernel"])
        self._remat_context = remat_context(cfg.remat_policy) if cfg.remat else None
        self.to(self.device)

    def named_tree_params(self) -> Iterator[Tuple[Tuple[str, ...], str]]:
        """(flax path, module parameter name) of every weight, in the flax
        tree's layout: ("layer_0", "attn", "q", "kernel") -> "layers.0.attn.q"."""
        yield ("embedding",), "embedding"
        for i in range(len(self.layers)):
            for norm in ("attn_norm", "mlp_norm"):
                yield (f"layer_{i}", norm, "scale"), f"layers.{i}.{norm}.scale"
            fused = self.cfg.fused_qkv
            for n in ("qkv", "o") if fused else ("q", "k", "v", "o"):
                yield (f"layer_{i}", "attn", n, "kernel"), f"layers.{i}.attn.{n}"
            for n in ("gate_up", "down") if fused else ("gate", "up", "down"):
                yield (f"layer_{i}", "mlp", n, "kernel"), f"layers.{i}.mlp.{n}"
        yield ("final_norm", "scale"), "final_norm.scale"
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), "lm_head"

    def param_tree(self, trainable: bool = False) -> ParamTree:
        """The weights in the flax layout. By default plain tensors sharing the
        parameters' storage (what the engine reads); with `trainable=True` the
        nn.Parameters themselves (what training updates in place)."""
        named = dict(self.named_parameters())
        tree: ParamTree = {}
        for path, name in self.named_tree_params():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = named[name] if trainable else named[name].data
        return tree

    def forward(self, tokens, positions=None,
                kv_caches: Optional[List[Tuple[torch.Tensor, torch.Tensor, int]]] = None,
                return_hidden: bool = False):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.embedding[tokens].to(cfg.dtype)
        rope = _rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        # JAX's nn.remat(Block, policy=...): a block keeps for the backward
        # pass only what its policy names and reruns the rest when its
        # gradient is taken (K1 included, except where "selective" keeps the
        # flash forward's outputs).
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        new_caches = []
        for i, blk in enumerate(self.layers):
            if remat:
                kw = {"context_fn": self._remat_context} if self._remat_context else {}
                x = checkpoint(_block_no_cache, blk, x, positions, rope, use_reentrant=False,
                               **kw)
                continue
            cache = kv_caches[i] if kv_caches is not None else None
            x, new_cache = blk(x, positions, rope, cache)
            new_caches.append(new_cache)
        x = self.final_norm(x)
        if return_hidden:
            # Training fast path: the caller takes fused_cross_entropy_loss
            # against the table instead of materializing [B,S,V] f32 logits.
            return x
        if cfg.tie_embeddings:
            # bf16 operands, f32 products and sums: the f32 result JAX's
            # preferred_element_type gives (bf16 products are exact in f32).
            logits = _matmul_f32(x.to(cfg.dtype), self.embedding.T)
        else:
            logits = (x.to(cfg.dtype) @ self.lm_head.to(cfg.dtype)).float()
        if kv_caches is not None:
            return logits, new_caches
        return logits


def _block_no_cache(blk: Block, x, positions, rope):
    return blk(x, positions, rope)[0]


# ---------------------------------------------------------------- head and losses


class _MatmulF32Out(torch.autograd.Function):
    """a [..., K] @ b [K, N] with a in bf16/f16, b's values rounded to a's
    dtype (`b_low`), f32 sums and an f32 result, on the GPU (cuBLAS through
    `torch.mm(..., out_dtype=torch.float32)`): what JAX's
    `preferred_element_type=f32` computes, at the tensor cores' rate rather
    than an f32 GEMM's. The backward rounds the f32 cotangent to a's dtype,
    as a bf16 product on the TPU does; a's grad is summed in f32 and rounded
    once to a's dtype (cuBLAS's bf16-output GEMM read about twice one
    rounding's error at gpt2-125m's head), and b's is summed in f32 and
    returned in b's dtype, so a table used by many chunks accumulates its
    grad in f32."""

    @staticmethod
    def forward(ctx, a, b, b_low):
        ctx.save_for_backward(a, b_low)
        ctx.b_dtype = b.dtype
        return torch.mm(a.reshape(-1, a.shape[-1]), b_low, out_dtype=torch.float32).view(
            *a.shape[:-1], b_low.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b_low = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g2, b_low.T, out_dtype=torch.float32).to(a.dtype).view(a.shape)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.reshape(-1, a.shape[-1]).T, g2,
                          out_dtype=torch.float32).to(ctx.b_dtype)
        return da, db, None


def _matmul_f32(a: torch.Tensor, b: torch.Tensor,
                b_low: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [..., K] @ b [K, N] -> f32, with b rounded to a's dtype (bf16
    products are exact in f32). `b_low`, b already cast (`b.detach().to(
    a.dtype)`), spares the cast when b is used many times."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        if b_low is None:
            b_low = b.detach().to(a.dtype)
        return _MatmulF32Out.apply(a, b, b_low)
    return a.float() @ b.to(a.dtype).float()


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token loss. logits:[B,S,V] float32; targets:[B,S] int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _chunk_nll_sum(h, w, w_low, t, m):
    logits = _matmul_f32(h, w, w_low)  # [B,c,V] f32
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, t[..., None])[..., 0]
    return (nll * m).sum() if m is not None else nll.sum()


def fused_cross_entropy_loss(hidden, table, targets, mask=None, *, chunk: int = 256,
                             contract_dim: int = 1, compute_dtype=torch.bfloat16):
    """Chunked head matmul + cross-entropy that never holds the full logits.

    The port of ray_tpu's `fused_cross_entropy_loss`: the sequence is cut
    into chunks of gcd(S, chunk) positions; each chunk's [B,c,V] f32 logits
    are computed under a non-reentrant checkpoint, so the backward pass
    recomputes them and at most one chunk's logits is alive at a time.
    hidden: [B,S,E] (post final norm); table: the tied embedding [V,E]
    (contract_dim=1) or an untied lm_head kernel [E,V] (contract_dim=0);
    targets: [B,S] int. The head is the model's: `compute_dtype` operands,
    f32 sums and result."""
    B, S, E = hidden.shape
    c = math.gcd(S, chunk)
    if contract_dim == 1:
        w = table.T  # [E,V]
    elif contract_dim == 0:
        w = table
    else:
        raise ValueError(f"contract_dim must be 0 or 1, got {contract_dim}")
    # Cast once for every chunk; each chunk's grad reaches the table in f32,
    # as JAX's per-chunk cast inside the checkpoint gives it.
    w_low = w.detach().to(compute_dtype) if hidden.is_cuda else None
    targets = targets.long()
    if mask is not None:
        mask = mask.to(torch.float32)
    total = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        h = hidden[:, s0:s0 + c].to(compute_dtype)
        m = None if mask is None else mask[:, s0:s0 + c]
        total = total + checkpoint(_chunk_nll_sum, h, w, w_low, targets[:, s0:s0 + c], m,
                                   use_reentrant=False)
    count = (torch.tensor(float(B * S), device=hidden.device) if mask is None
             else mask.sum())
    return total / count.clamp_min(1.0)
