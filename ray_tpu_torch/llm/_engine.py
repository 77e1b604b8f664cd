"""Decode engine: continuous-batching generation over transformer weights.

Twin of `ray_tpu/llm/_engine.py`, single device. The engine owns the weights
(the flax-layout param tree, `models/transformer.py`), the per-slot KV pool
and a stepper thread that executes the iteration-level `Scheduler`'s plans:
bucketed prefill chunks, then one batched decode dispatch (or a multi-step
greedy chunk). PyTorch runs eagerly, so there are no compiled programs; the
bucket table still fixes every prefill shape.

Where JAX returns updated KV caches from each program, this engine writes the
pool in place (`_write_kv`), with the same clamped start rows and the same
write gate. Attention is the JAX engine's plain math, except for a prompt's
first chunk (offset 0): its visibility mask there is exactly the top-left
causal mask over the chunk's own rows, so that chunk's attention runs the K1
flash-forward kernel over the rows it just wrote.

As JAX's engine does by default, it builds a paged KV prefix cache
(`llm/kvcache/`, the host block pool) and a request flight recorder
(`llm/flight_recorder.py`). A prefix-cache hit attaches exactly its cached
rows [0, cached_offset) — JAX pads them to a bucket because it compiles one
attach program per bucket — and prefills the suffix from that offset through
the masked route. With `llm_kv_device_bytes` or `llm_kv_spill_dir` set the
cache is the tiered hierarchy (`llm/kvcache/tiers.py`): a hit whose every
block holds a device copy attaches from the card with no host->device copy,
and host eviction spills to disk, from where a later lookup promotes the
chain back.

Guided decoding (`submit(constraint=...)`, `llm/generate/`) adds a
constraint's host mask to the admission sample and to each host sampling
row; speculative decoding (`spec_config`, `llm/scheduler/spec.py`) runs a
verify phase between the chunks and the decode phase: one batched gated
forward over every participating slot's [t0, d1..dk], with the guided
slots' per-position masks added before the on-device argmax. A model
draft's prefill is an offset-0 forward, so it runs K1 too. `open_stream`
hands back a cancellable `TokenStream`.

Multi-LoRA serving (`lora_config`, `add_lora`, `submit(lora=)`): a pageable
`AdapterCache` (`llm/adapters.py`) holds a fixed number of device slots;
admission pins each request's adapter (paging it in, or leaving the request
queued while every slot is pinned), and every forward adds the per-slot
low-rank delta to q and v before RoPE and the KV write, on the K1 route and
the masked route alike. The prefix cache is namespaced by adapter. A model
draft runs without adapters, as JAX's does. An engine without `lora_config`
computes no delta.

The PD handoff in process (prefill/decode disaggregation): one engine's
`prefill_detached` prefills a prompt without holding a decode slot and
returns its first logits and KV rows; another engine's `submit_prefilled`
admits a request from them, and its stepper attaches the rows and samples
the first token (`_exec_attach`). The detached cold prefill is an offset-0
forward over scratch caches, so it runs K1 as a local prompt's first chunk
does; a prefix-cache hit prefills only the suffix through the masked route.
The detached rows are exactly [0, prompt_len) (JAX pads them to a bucket).

Tensor parallelism (`tp=N`, `llm/tp.py`): the N ranks of a
torch.distributed job each build the engine, one process per device, over
their shards of the weights (Megatron's splits), of the KV pool (by kv head)
and of the LoRA B factors. Rank 0 is the engine users see: the scheduler,
sampling, the prefix cache's host pool, the adapter registry, the recorder
and streams are its host work. Every device operation goes through `_op`:
rank 0 announces it and its host arguments, then runs it; each follower's
thread runs the same operation on its shards in the order announced. The
forward all-reduces o's and down's f32 partial products and the masked
embedding rows; the logits stay split by vocab until a token is chosen
(gathered to rank 0 for host sampling; an argmax across the ranks for the
verify and the multi-step chunk). The tiered prefix cache's host pool and
disk tier are rank 0's; its device hot tier is per rank: rank 0's tier
keeps the book (ids, LRU, bytes), every rank keeps its kv-head slice of
each resident block on its own card, and a device hit attaches from each
rank's own slices with no host rows moving. Not with tp > 1 yet (they
raise, ROADMAP [7e]): the PD handoff and model drafts. Not ported yet: the
DeviceChannel transport.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch._config import CONFIG
from ray_tpu_torch.checkpoint import restore
from ray_tpu_torch.llm.adapters import AdapterCache, UnknownAdapterError
from ray_tpu_torch.llm.flight_recorder import FlightRecorder, ServeMetrics
from ray_tpu_torch.llm.kvcache import PrefixCacheManager, TieredPrefixCacheManager
from ray_tpu_torch.llm.tp import (
    PING_S,
    ShardedKVPool,
    TPShard,
    build_tp_mesh,
    checkpoint_shardings,
    kv_prefix_sharding,
    shard_decode_params,
    tp_degree,
)
from ray_tpu_torch.llm.scheduler.scheduler import (
    EngineOverloadedError,
    Request,
    ScheduledChunk,
    Scheduler,
)
from ray_tpu_torch.models.transformer import ModelConfig, ParamTree, _rope
from ray_tpu_torch.ops.attention import flash_forward

_NEG_INF = -1e30

__all__ = ["DecodeEngine", "EngineOverloadedError", "SamplingParams"]


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = no top-k filter
    stop_token_id: Optional[int] = None


# -- functional forward over the param tree ----------------------------------


def _dense(x, kernel):
    """x [..., M] . kernel [M, N] in x's dtype. A bf16 product accumulates in
    f32 and rounds once, as JAX's preferred_element_type=f32 then astype."""
    return x @ kernel.to(x.dtype)


def _dense_f32(x, kernel):
    """x [..., M] . kernel [M, N] with kernel rounded to x's dtype, f32 sums
    and an f32 result: a row-parallel rank's partial product, summed over
    the ranks before the one rounding to x's dtype."""
    w = kernel.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32).view(
            *x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _row_parallel(x, kernel, split: bool, tp):
    """x . kernel where kernel's input rows are this rank's slice (o, down):
    the partials all-reduced in f32 and rounded once. A replicated kernel
    (split False) holds every row, so its product is whole already."""
    if tp is None or not split:
        return _dense(x, kernel)
    return tp.all_reduce(_dense_f32(x, kernel)).to(x.dtype)


def _embed(embed, tokens, dtype, tp):
    """The embedding rows of tokens in dtype. With the vocab split each rank
    looks up the tokens in its row range, zeros elsewhere, and the ranks'
    rows are summed: one term is non-zero, so the sum is exact."""
    if tp is None or not tp.vocab_split:
        return embed[tokens].to(dtype)
    lo, hi = tp.vocab
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    x = embed[local.clamp(0, hi - lo - 1)].to(dtype)
    return tp.all_reduce(torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                                      device=x.device)))


def _rmsnorm(x, scale, eps):
    # Multiplies in f32 and casts after, unlike the model's RMSNorm (which
    # multiplies in the activation dtype): both are kept as JAX has them.
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * scale.float()).to(x.dtype)


def _lora_delta(x, A, B, scale):
    """Per-slot low-rank delta: x [B,S,M]; A [B,M,r]; B [B,r,O]; scale [B].
    Two batched products in x's dtype, then the scale in x's dtype, as JAX
    computes it (outside any kernel)."""
    h = torch.bmm(x, A.to(x.dtype))
    d = torch.bmm(h, B.to(x.dtype))
    return d * scale[:, None, None].to(x.dtype)


def _write_kv(cache, new, write_at, write_gate=None):
    """In place: slot b's rows [at_b, at_b + S) <- new[b]. The start is clamped
    to [0, T - S], as jax.lax.dynamic_update_slice clamps it. A slot whose
    write_gate is False writes its current rows back unchanged (also at the
    clamped rows), so it is a no-op even at the cache end.

    cache: [B,T,Hkv,D]; new: [B,S,Hkv,D]; write_at: [B] int; write_gate: [B]
    bool or None."""
    B, S = new.shape[:2]
    T = cache.shape[1]
    rows = write_at.clamp(0, T - S)[:, None] + torch.arange(S, device=cache.device)
    slots = torch.arange(B, device=cache.device)[:, None]
    new = new.to(cache.dtype)
    if write_gate is not None:
        new = torch.where(write_gate[:, None, None, None], new, cache[slots, rows])
    cache[slots, rows] = new


def _attn_cached(layer, x, positions, cache_k, cache_v, write_at, kv_mask, cfg,
                 write_gate=None, lora_layer=None, adapter_ids=None, tp=None):
    """One attention layer against the KV cache.

    x: [B, S, M]; positions: [B, S]; cache_k/v: [B, T, Hkv, D] (written in
    place); write_at: [B] start row per slot; kv_mask: [B, S, T] visibility,
    or None for a chunk that starts at row 0 and sees exactly its own rows
    causally (the K1 kernel's top-left causal mask over rows [0, S)).
    lora_layer (optional): this layer's stacked adapter tables {"q_A":
    [A,M,r], "q_B": [A,r,H*D], "v_A", "v_B", "scale": [A]}, gathered per
    slot by adapter_ids [B]; the delta lands in q and v before RoPE and the
    KV write, so both attention routes see it.
    tp (a `TPShard`, or None): the layer's weights, the caches and the
    LoRA B factors hold this rank's heads; the attention runs on them and o's
    partial products are summed over the ranks."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if tp is not None:
        H, Hkv = tp.heads, tp.kv_heads
    q = _dense(x, layer["q"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, H, D)
    k = _dense(x, layer["k"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, Hkv, D)
    v = _dense(x, layer["v"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, Hkv, D)
    if lora_layer is not None:
        scale = lora_layer["scale"][adapter_ids]
        dq = _lora_delta(x, lora_layer["q_A"][adapter_ids], lora_layer["q_B"][adapter_ids],
                         scale)
        q = q + dq.view(B, S, H, D)
        dv = _lora_delta(x, lora_layer["v_A"][adapter_ids], lora_layer["v_B"][adapter_ids],
                         scale)
        v = v + dv.view(B, S, Hkv, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    _write_kv(cache_k, k, write_at, write_gate)
    _write_kv(cache_v, v, write_at, write_gate)

    scale = 1.0 / math.sqrt(D)
    select = None if tp is None else tp.kv_select
    if kv_mask is None:
        kk, vv = cache_k[:, :S], cache_v[:, :S]
        if select is not None:
            kk, vv = _kv_heads(kk, select), _kv_heads(vv, select)
        out, _ = flash_forward(q, kk, vv, causal=True, scale=scale, layout="bshd")
    else:
        if select is not None:
            cache_k, cache_v = _kv_heads(cache_k, select), _kv_heads(cache_v, select)
        # GQA without copying the cache: query head h = g * rep + r reads kv
        # head g, the pairing jnp.repeat(kk, rep, axis=2) gives.
        T, rep = cache_k.shape[1], H // cache_k.shape[2]
        qg = q.view(B, S, -1, rep, D)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg, cache_k.to(q.dtype))
        logits = logits.reshape(B, H, S, T) * scale
        logits = torch.where(kv_mask[:, None], logits.float(), _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bgrst,btgd->bsgrd", probs.view(B, -1, rep, S, T),
                           cache_v.to(q.dtype)).reshape(B, S, H, D)
    o_kernel = layer["o"]["kernel"].reshape(-1, cfg.hidden)
    return _row_parallel(out.reshape(B, S, -1), o_kernel, tp is not None and tp.q_split, tp)


def _kv_heads(cache, select):
    """The kv heads [B, T, ., D] a rank's query heads read (`TPShard.
    kv_select`): a view for a slice, one gathered head per query head for an
    index."""
    if isinstance(select, slice):
        return cache[:, :, select]
    return cache.index_select(2, select)


def _mlp(layer, x, tp=None):
    gate = _dense(x, layer["gate"]["kernel"])
    up = _dense(x, layer["up"]["kernel"])
    return _row_parallel(F.silu(gate) * up, layer["down"]["kernel"],
                         tp is not None and tp.mlp_split, tp)


def _forward_cached(params: ParamTree, cfg: ModelConfig, tokens, positions, caches,
                    write_at, kv_mask, write_gate=None, lora=None, adapter_ids=None, tp=None):
    """tokens: [B,S] -> logits [B,S,V] f32; writes the caches in place.

    lora: the AdapterCache's stacked tables ({"q_A": [L, A, M, r], ...}),
    indexed per layer here; adapter_ids [B] picks each slot's row (0 = the
    base model). None computes no delta. tp (a `TPShard`): params, caches
    and tables are this rank's shards; the logits are its vocab slice
    [B, S, V / tp] (whole where the vocab does not split)."""
    embed = params["embedding"]
    x = _embed(embed, tokens, cfg.dtype, tp)
    for i in range(cfg.n_layers):
        layer = params[f"layer_{i}"]
        normed = _rmsnorm(x, layer["attn_norm"]["scale"], cfg.norm_eps)
        lora_layer = None if lora is None else {k: v[i] for k, v in lora.items()}
        x = x + _attn_cached(layer["attn"], normed, positions, caches[i][0],
                             caches[i][1], write_at, kv_mask, cfg, write_gate,
                             lora_layer, adapter_ids, tp)
        x = x + _mlp(layer["mlp"], _rmsnorm(x, layer["mlp_norm"]["scale"], cfg.norm_eps), tp)
    x = _rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        # bf16 operands, f32 products and sums (JAX: preferred_element_type).
        return x.to(cfg.dtype).float() @ embed.to(cfg.dtype).float().T
    return _dense(x, params["lm_head"]["kernel"]).float()


def _sample_host(logits_row: np.ndarray, sampling: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Per-slot host-side sampling: slots may carry different sampling params."""
    if sampling.temperature <= 0:
        return int(np.argmax(logits_row))
    scaled = logits_row / sampling.temperature
    if sampling.top_k > 0:
        thresh = np.sort(scaled)[-sampling.top_k]
        scaled = np.where(scaled < thresh, _NEG_INF, scaled)
    scaled = scaled - scaled.max()
    probs = np.exp(scaled)
    probs /= probs.sum()
    return int(rng.choice(len(probs), p=probs))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of t. From a CUDA tensor into pageable memory the copy
    returns only once the stream has run every launch before it, so the
    reads that produced t are complete when it returns."""
    return t.to("cpu")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _not_in_slice(what: str, where: str):
    return NotImplementedError(
        f"{what} is not in this slice of the PyTorch port; it is queued in "
        f"ROADMAP.md ({where})"
    )


def _tp_later(what: str):
    return _not_in_slice(f"{what} on a tensor-parallel engine (tp > 1)", "Queue 1, item [7e]")


# The engine methods a follower runs when rank 0 announces them (`_op`).
_TP_OPS = frozenset({"_prefill_at", "_decode_logits", "_decode_multi", "_spec_verify_batched",
                     "_attach_kv", "_read_kv_blocks", "_install_adapter_row", "_ping",
                     "_promote_hot", "_attach_hot", "_drop_hot", "_hot_report"})


def _leader_only(fn):
    """A public engine call: on a tensor-parallel follower (rank > 0) it
    raises, since rank 0 is the engine users see."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self._tp is not None and not self._tp.leader:
            raise RuntimeError(
                f"{fn.__name__}: rank {self._tp.rank} of this tensor-parallel engine is "
                f"a follower; rank 0 serves")
        return fn(self, *args, **kwargs)
    return call


def sharded_params(path: str):
    """The params of a committed sharded checkpoint, on the host: its
    "params" subtree for a train state, else the whole tree (a bare params
    save), as ray_tpu's warm start reads it. Refuses uncommitted
    directories."""
    tree = restore(path)
    return tree.get("params", tree) if isinstance(tree, dict) else tree


def local_params(path: str, tp, device):
    """`sharded_params`, or with tp > 1 (collective) this rank's shards of
    them: each leaf read from the regions that overlap its slice under
    `param_spec`, as torch tensors."""
    mesh = build_tp_mesh(tp, device)
    if mesh is None:
        return sharded_params(path)
    from torch.distributed.tensor import DTensor

    tree = restore(path, mesh=mesh, placements=checkpoint_shardings(path, mesh))
    tree = tree.get("params", tree) if isinstance(tree, dict) else tree

    def local(node):
        if isinstance(node, dict):
            return {k: local(v) for k, v in node.items()}
        return node.to_local() if isinstance(node, DTensor) else node

    return local(tree)


class DecodeEngine:
    """B-slot continuous-batching engine. Thread-safe submit(); a background
    stepper thread executes the scheduler's per-iteration plans on the
    engine's device and CUDA stream."""

    def __init__(self, cfg: ModelConfig, params: ParamTree, *, num_slots: int = 4,
                 max_seq: Optional[int] = None, seed: int = 0,
                 lora_config: Optional[dict] = None, decode_loop: bool = True,
                 spec_config: Optional[dict] = None,
                 multi_step: Optional[int] = None,
                 prefix_cache=None,
                 max_queue_depth: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 wfq: bool = True,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: Optional[int] = None,
                 tp=1, device=None):
        if cfg.fused_qkv or "qkv" in params.get("layer_0", {}).get("attn", {}):
            raise ValueError(
                "DecodeEngine reads separate q, k, v and gate, up matrices "
                "(layer['attn']['q'], as ray_tpu's engine does), so a fused_qkv "
                "model cannot be served by either; split qkv and gate_up first"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        # Tensor parallelism: tp > 1 (or {"tp": N}) is called collectively
        # by the N ranks of the job, one process per device, each holding
        # its shards of the weights, the KV pool and the adapter tables.
        # Rank 0 is the engine users see; the others follow its operations
        # (`_op`, `_follow`). tp=1 keeps the single-device path.
        self.tp = tp_degree(tp)
        self._tp: Optional[TPShard] = None
        self._kv_pool: Optional[ShardedKVPool] = None
        if self.tp > 1:
            self._check_tp(spec_config)
            self._tp = TPShard(cfg, self.tp, self.device)
            params = shard_decode_params(params, self.tp, self._tp.rank, cfg)
        self.params = _tree_to(params, self.device)
        self.B = num_slots
        self.T = max_seq or cfg.max_seq
        self._np_rng = np.random.default_rng(seed)
        # Multi-LoRA: a pageable AdapterCache on the engine's device backs
        # the stacked tables (row 0 = the base model). lora_config keys:
        # max_loras (registry cap), rank (rank bucket), cache_bytes /
        # cache_slots (device budget; default llm_adapter_cache_bytes, 0 =
        # every registered adapter resident).
        self._adapters: Optional[AdapterCache] = None
        if lora_config:
            budget = lora_config.get("cache_bytes")
            if budget is None:
                budget = CONFIG.llm_adapter_cache_bytes
            self._adapters = AdapterCache(
                n_layers=cfg.n_layers, hidden=cfg.hidden,
                q_out=cfg.n_heads * cfg.head_dim,
                v_out=cfg.n_kv_heads * cfg.head_dim,
                rank=int(lora_config.get("rank", 8)), dtype=cfg.dtype,
                max_adapters=int(lora_config.get("max_loras", 4)),
                budget_bytes=int(budget),
                cache_slots=lora_config.get("cache_slots"),
                name=f"engine-{id(self):x}", device=self.device,
                **self._tp_adapter_args(),
            )
        # Each slot's adapter row (device table row, not the stable uid),
        # host-native like lens and shipped with each batched dispatch.
        self._adapter_ids = np.zeros((self.B,), np.int64)
        kv_shape = (self.B, self.T, cfg.n_kv_heads, cfg.head_dim)
        if self._tp is not None:
            self._kv_pool = ShardedKVPool(
                n_layers=cfg.n_layers, shape=kv_shape, dtype=cfg.dtype, device=self.device,
                tp=self.tp, n_kv_heads=cfg.n_kv_heads, name=f"engine-{id(self):x}")
            self._caches = self._kv_pool.caches
        else:
            self._caches = [
                (torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
                 torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device))
                for _ in range(cfg.n_layers)
            ]
        # Per-slot lengths and last tokens are host-native (numpy): the
        # stepper reads and writes them every step; each dispatch ships them
        # host->device (a few bytes).
        self._lens = np.zeros((self.B,), np.int64)
        self._last_token = np.zeros((self.B,), np.int64)
        self._stop = False
        # Cross-thread cancel plane: cancel() resolves still-queued requests
        # synchronously; anything prefilling or decoding goes into this set
        # and the stepper retires it at the top of its next iteration.
        self._pending_cancels: set = set()
        self._cancel_lock = threading.Lock()
        # Set when the stepper thread dies on an exception; submitters check
        # it instead of waiting forever on callbacks that will never fire.
        self.error: Optional[BaseException] = None
        if multi_step is None:
            multi_step = CONFIG.llm_multi_step
        self._multi_step = max(1, int(multi_step))
        # Prefill bucket table: every chunk is padded to one of these lengths
        # (power-of-two multiples of llm_prefill_bucket_min, capped at T).
        buckets = []
        b = max(1, CONFIG.llm_prefill_bucket_min)
        while b < self.T:
            buckets.append(b)
            b *= 2
        buckets.append(self.T)
        self._prefill_buckets = tuple(buckets)
        # Paged KV prefix cache: host-side ref-counted block pool + radix
        # prefix index. A repeated prompt prefix attaches its cached KV and
        # prefills only the suffix. prefix_cache=None (or True) builds one
        # from the config flags; False disables; a PrefixCacheManager
        # instance is used as-is. With llm_kv_device_bytes / llm_kv_spill_dir
        # set the cache is the TIERED hierarchy: a device hot tier above the
        # host pool (hot attaches are zero-H2D) and an async disk spill tier
        # below it. On a TP engine the cache is rank 0's: a follower builds
        # none (no spill store, no spill worker) and ignores one passed in.
        if self._tp is not None and not self._tp.leader:
            prefix_cache = None
        elif prefix_cache is None or prefix_cache is True:
            prefix_cache = None
            if CONFIG.llm_prefix_cache_bytes > 0:
                if CONFIG.llm_kv_device_bytes > 0 or CONFIG.llm_kv_spill_dir:
                    prefix_cache = TieredPrefixCacheManager(
                        CONFIG.llm_kv_block_size, CONFIG.llm_prefix_cache_bytes,
                        name=f"engine-{id(self):x}",
                        device_bytes=CONFIG.llm_kv_device_bytes,
                        to_device=self._kv_block_to_device,
                        spill_dir=CONFIG.llm_kv_spill_dir,
                        spill_bytes=CONFIG.llm_kv_spill_bytes,
                    )
                else:
                    prefix_cache = PrefixCacheManager(
                        CONFIG.llm_kv_block_size, CONFIG.llm_prefix_cache_bytes,
                        name=f"engine-{id(self):x}",
                    )
        self._prefix_cache = prefix_cache or None
        self._kv_block_size = (CONFIG.llm_kv_block_size if self._prefix_cache is None
                               else self._prefix_cache.block_size)
        # A TP rank's slices of the blocks rank 0's hot tier holds (block id
        # -> [L, 2, bs, Hkv / tp, D] on its card); `_tier_sync` keeps their
        # ids rank 0's tier's.
        self._hot_slices: Dict[int, torch.Tensor] = {}
        self._hot_shared = False
        self._tier_lock = threading.Lock()
        if self._tp is not None:
            self._kv_block_size = self._tp.broadcast(self._kv_block_size)
            if (isinstance(self._prefix_cache, TieredPrefixCacheManager)
                    and self._prefix_cache._device is not None):
                self._prefix_cache.share_device_tier(functools.partial(self._op, "_promote_hot"))
                self._hot_shared = True
        if max_queue_depth is None:
            max_queue_depth = CONFIG.llm_max_queue_depth
        if token_budget is None:
            token_budget = CONFIG.llm_sched_token_budget
        # The prefix-cache lookup is injected so admission plans chunks over
        # the uncached suffix only; the adapter pin callbacks make admission
        # adapter-aware: resident adapters are preferred, cold ones page in
        # at admission (on the stepper thread and stream), and a fully
        # pinned cache leaves the request queued instead of failing it.
        lookup = None
        if self._prefix_cache is not None:
            cache = self._prefix_cache

            def lookup(prompt, adapter):
                with self._tier_sync():
                    return cache.lookup(prompt, namespace=adapter)

        adapter_acquire = adapter_resident = None
        if self._adapters is not None:
            adapter_acquire = self._adapters.try_acquire
            adapter_resident = self._adapters.is_resident
        self._sched = Scheduler(
            num_slots=self.B, buckets=self._prefill_buckets, max_seq=self.T,
            token_budget=token_budget, max_queue_depth=max_queue_depth,
            multi_step=self._multi_step, lookup=lookup, wfq=wfq,
            tenant_weights=tenant_weights, tenant_quota=tenant_quota,
            adapter_acquire=adapter_acquire, adapter_resident=adapter_resident,
        )
        # Request-lifecycle flight recorder + per-tenant SLO burn windows:
        # phase events accrue host-side off the dispatch path; each
        # completion folds into its tenant's bounded window, and
        # recorder_stats() reports the burn rates.
        self._recorder = FlightRecorder(name=f"engine-{id(self):x}")
        self._serve_metrics = ServeMetrics(name=f"{id(self):x}")
        # Diagnostics for benches/tests: shape of the most recent prefill
        # dispatch (offset > 0 means a prefix-cache hit prefilled suffix-only)
        # and of the most recent cache attach.
        self.last_prefill: Optional[dict] = None
        self.last_attach: Optional[dict] = None
        # Speculative decoding as a scheduler-scheduled phase: a
        # DraftProvider proposes up to k tokens per eligible slot, and ONE
        # batched gated verify forward scores every participating slot.
        # Greedy output is token-identical to plain decode by construction;
        # acceptance only affects speed.
        self._draft = None
        self._spec_counters = {
            "rounds": 0, "proposed_tokens": 0, "accepted_tokens": 0,
            "emitted_tokens": 0,
        }
        if spec_config:
            self._draft = self._build_draft(dict(spec_config))
        # The stepper launches on the stream that was current here.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        # Rank 0 announces and runs each device operation under this lock,
        # so the followers see the operations in the order rank 0 runs them.
        self._op_lock = threading.Lock()
        self._last_announce = time.monotonic()
        self._thread = None
        if self._tp is not None and not self._tp.leader:
            self._thread = threading.Thread(target=self._follow, daemon=True)
            self._thread.start()
        elif decode_loop:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _check_tp(self, spec_config: Optional[dict]) -> None:
        """Refuse, before any group is made, what a TP engine does not run
        yet: a model draft ([7e])."""
        if spec_config and spec_config.get("method") != "ngram":
            raise _tp_later("a model draft (draft_layers, draft_cfg, the self-draft)")

    def _tp_adapter_args(self) -> dict:
        """A TP rank's AdapterCache keeps the q_B and v_B columns of its own
        heads (the split of q and v themselves); rank 0's page-ins ship the
        rows to every rank."""
        if self._tp is None:
            return {}
        args = {"q_cols": self._tp.q_cols, "v_cols": self._tp.v_cols}
        if self._tp.leader:
            args["install"] = functools.partial(self._op, "_install_adapter_row")
        return args

    def _build_draft(self, spec_config: dict):
        """spec_config -> DraftProvider. method="ngram" builds the zero-FLOP
        retrieval draft; otherwise a draft MODEL: `draft_layers=j` shares
        the target's first j layers + embeddings (EAGLE-style early exit),
        `draft_cfg`/`draft_params` plug an external model (its params moved
        to the engine's device), and the default (no keys) is the
        self-draft used as an all-accept test rig."""
        from ray_tpu_torch.llm.scheduler.spec import (
            ModelDraft,
            NGramDraft,
            early_exit_draft,
        )

        k = max(1, int(spec_config.get("num_spec_tokens", 6)))
        if spec_config.get("method") == "ngram":
            return NGramDraft(
                k=k,
                n=int(spec_config.get("ngram", CONFIG.llm_spec_ngram)),
                store_entries=int(spec_config.get(
                    "store_entries", CONFIG.llm_spec_store_entries)),
            )
        if spec_config.get("draft_layers"):
            d_cfg, d_params = early_exit_draft(
                self.cfg, self.params, int(spec_config["draft_layers"])
            )
        else:
            d_cfg = spec_config.get("draft_cfg") or self.cfg
            d_params = self.params
            if "draft_params" in spec_config:
                d_params = _tree_to(spec_config["draft_params"], self.device)
        return ModelDraft(d_cfg, d_params, k=k, num_slots=self.B, max_seq=self.T,
                          bucket=self._bucket, device=self.device)

    # -- warm start --------------------------------------------------------
    @classmethod
    def from_sharded_checkpoint(cls, cfg: ModelConfig, path: str, *, tp=1,
                                **kwargs) -> "DecodeEngine":
        """An engine whose weights come from a committed sharded checkpoint
        (`ray_tpu_torch.checkpoint`, the format either package writes): a
        bare params save or a train-state save holding a "params" subtree,
        matrices in `cfg.param_dtype` on the engine's device. Refuses
        uncommitted (manifest-less) directories. With tp > 1 (called by
        every rank) each rank reads only the file regions of its own shards
        (`tp.checkpoint_shardings`), never the whole tree."""
        from ray_tpu_torch.models.convert import params_from_jax

        device = resolve_device(kwargs.get("device"))
        return cls(cfg, params_from_jax(local_params(path, tp, device), cfg, device), tp=tp,
                   **kwargs)

    # -- lora registry -----------------------------------------------------
    @_leader_only
    def add_lora(self, name: str, layer_weights: Dict[int, Dict[str, np.ndarray]],
                 alpha: float = 1.0) -> int:
        """Register an adapter host-side. layer_weights: layer index ->
        {"q_A": [M,r], "q_B": [r,H*D], "v_A": [M,r], "v_B": [r,Hkv*D]}
        (missing projections stay zero). Shapes and rank are validated
        against the bucketed table here (ValueError). Returns the adapter's
        stable uid; the device slot is paged in on first use."""
        if self._adapters is None:
            raise ValueError("engine built without lora_config")
        return self._adapters.register(name, layer_weights, alpha)

    # Explicit alias: the serve layers call this "register_adapter".
    register_adapter = add_lora

    def _adapter_index(self, lora: str) -> int:
        """Stable adapter uid for a request ("" = base). Raises the typed,
        client-visible UnknownAdapterError (a KeyError subclass) instead of
        a bare KeyError from deep inside the engine."""
        if not lora:
            return 0
        if self._adapters is None:
            raise UnknownAdapterError(
                f"unknown lora adapter {lora!r}: engine built without "
                f"lora_config"
            )
        return self._adapters.uid_of(lora)

    @_leader_only
    def adapter_stats(self) -> Optional[dict]:
        """AdapterCache residency and paging counters (None when the engine
        has no lora_config)."""
        return None if self._adapters is None else self._adapters.stats()

    # -- forward passes ----------------------------------------------------
    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _lora(self, adapter_ids=None) -> dict:
        """The LoRA arguments of one dispatch: the stacked tables and each
        row's adapter ids on the device (the slots' `_adapter_ids` unless
        given). Empty without lora_config: no delta is computed."""
        if self._adapters is None:
            return {}
        if adapter_ids is None:
            adapter_ids = self._adapter_ids
        return {"lora": self._adapters.tables(), "adapter_ids": self._dev(adapter_ids)}

    def _op(self, name: str, *args):
        """Run the device operation `name` (an engine method) with host
        arguments. On a TP engine rank 0 first announces it, with the slots'
        adapter rows, to the followers, which run the same method on their
        shards in the order announced; rank 0 then refuses the result if a
        rank reported a failure meanwhile (`TPShard.check`). Tensor arguments
        are not announced: the method hands each rank its part of them
        itself."""
        if self._tp is None:
            return getattr(self, name)(*args)
        with self._op_lock:
            self._tp.announce(name, ([None if isinstance(a, torch.Tensor) else a for a in args],
                                     self._adapter_ids.copy()))
            self._last_announce = time.monotonic()
            out = getattr(self, name)(*args)
            self._tp.check()
            return out

    def _ping(self):
        """The no-op an idle rank 0 announces (keeps the followers' waits
        inside the groups' timeout)."""

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The argmax over the vocab, on every rank of a TP engine."""
        return torch.argmax(logits, dim=-1) if self._tp is None else self._tp.argmax(logits)

    def _vocab_cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a [..., V] tensor (all of them at tp=1)."""
        if self._tp is None or not self._tp.vocab_split:
            return t
        lo, hi = self._tp.vocab
        return t[..., lo:hi]

    def _prefill_at(self, tokens: torch.Tensor, slot: int, offset: int,
                    total_len: int, adapter_slot: int = 0) -> torch.Tensor:
        """tokens: [1, Sbucket] right-padded, starting at row/position
        `offset` (0 = a prompt's first chunk; > 0 = a later chunk), under
        the adapter in table row `adapter_slot`. Writes slot `slot`'s cache
        rows [offset, offset + S) in place and returns the logits row of
        prompt position total_len - 1 (on a TP engine: the whole row on rank
        0, None on the others)."""
        tokens = self._dev(tokens)
        S = tokens.shape[1]
        positions = (offset + torch.arange(S, device=self.device))[None, :]
        # One-slot views: writes through them land in the pool.
        slot_caches = [(ck[slot:slot + 1], cv[slot:slot + 1]) for ck, cv in self._caches]
        if offset == 0:
            mask = None  # K1 over the chunk's own rows, see _attn_cached
        else:
            # key row j visible iff j <= the query's global position
            mask = (positions[0][:, None]
                    >= torch.arange(self.T, device=self.device)[None, :])[None]
        logits = _forward_cached(self.params, self.cfg, tokens, positions, slot_caches,
                                 self._dev([offset]), mask, **self._lora([adapter_slot]),
                                 tp=self._tp)
        # An intermediate chunk's row is discarded; clamp the index as JAX's
        # gather does.
        row = logits[0, min(total_len - 1 - offset, S - 1)]
        return row if self._tp is None else self._tp.gather_vocab(row)

    def _decode_step(self, last_token: torch.Tensor, lens: torch.Tensor,
                     gate: torch.Tensor, adapter_ids=None):
        """One token for every slot. last_token, lens: [B]; gate: [B] bool —
        only slots in the decode phase land their KV row (a slot mid-chunked-
        prefill rides through with a stale lens and must not write there);
        adapter_ids: [B] table rows (default: the slots' own).
        Returns (logits [B, V], lens + 1); a TP rank's logits are its vocab
        slice."""
        positions = lens[:, None]
        # key j visible iff j <= lens (the new token writes at index lens)
        kv_mask = (torch.arange(self.T, device=self.device)[None, :]
                   <= lens[:, None])[:, None, :]
        logits = _forward_cached(self.params, self.cfg, last_token[:, None], positions,
                                 self._caches, lens, kv_mask, write_gate=gate,
                                 **self._lora(adapter_ids), tp=self._tp)
        return logits[:, 0], lens + 1

    def _decode_logits(self, last_token, lens, gate) -> Optional[np.ndarray]:
        """One decode step, and its logits [B, V] f32 pulled to the host: the
        step's one device->host copy (on a TP engine the ranks' vocab slices
        gathered to rank 0; None on the others)."""
        logits, _ = self._decode_step(self._dev(last_token), self._dev(lens), self._dev(gate))
        if self._tp is not None:
            logits = self._tp.gather_vocab(logits)
        return None if logits is None else logits.cpu().numpy()

    def _spec_verify_batched(self, tokens: torch.Tensor, lens: torch.Tensor,
                             gate: torch.Tensor,
                             constraint_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Target forward over [t0, d1..dk] for EVERY slot in one dispatch:
        tokens [B, k+1] at positions lens..lens+k, through the masked route.
        Non-participating slots (gate False) flow through the forward for
        batching but leave their KV rows untouched — the canonical row for a
        plainly-decoding slot is written by the decode dispatch that follows
        the verify phase.

        constraint_mask [B, k+1, V] is the guided-decoding composition
        point: an additive logits mask, zeros for unguided slots, folded in
        before the argmax. A disallowed draft token's row pins its logit to
        -1e30, the masked argmax disagrees with the proposal, and the
        acceptance rule rejects there with the masked argmax as the
        correction — what masked plain decode would emit. JAX passes the
        mask always (one compiled program); the eager port passes None in a
        round without a guided participant and adds nothing.

        Each slot verifies under its own adapter (the slots' `_adapter_ids`).
        Returns the on-device argmax [B, k+1] (the host needs k+1 ints per
        slot, not logits); a TP engine's argmax is over the whole vocab, on
        every rank, each adding its columns of the mask."""
        tokens, lens, gate = self._dev(tokens), self._dev(lens), self._dev(gate)
        S = tokens.shape[1]
        positions = lens[:, None] + torch.arange(S, device=self.device)[None, :]
        kv_mask = (torch.arange(self.T, device=self.device)[None, None, :]
                   <= positions[:, :, None])
        logits = _forward_cached(self.params, self.cfg, tokens, positions, self._caches,
                                 lens, kv_mask, write_gate=gate, **self._lora(), tp=self._tp)
        if constraint_mask is not None:
            logits = logits + self._vocab_cols(self._dev(constraint_mask))
        return self._argmax(logits)

    def _decode_multi(self, last_token: torch.Tensor, lens: torch.Tensor,
                      gate: torch.Tensor, n: int) -> torch.Tensor:
        """n greedy tokens for every slot with on-device argmax; the caller
        pulls the [n, B] result to the host once. The adapter ids ship
        once for the n steps. Every rank of a TP engine gets the tokens (each
        step's input)."""
        last_token, lens, gate = self._dev(last_token), self._dev(lens), self._dev(gate)
        ids = self._lora().get("adapter_ids")
        toks = []
        for _ in range(n):
            logits, lens = self._decode_step(last_token, lens, gate, ids)
            last_token = self._argmax(logits)
            toks.append(last_token)
        return torch.stack(toks)

    # -- public API --------------------------------------------------------
    @_leader_only
    def submit(self, token_ids: List[int], sampling: SamplingParams, callback,
               tenant: Optional[str] = None, request_id: Optional[str] = None,
               lora: str = "", constraint=None):
        """callback(token_id: int, finished: bool) per generated token.

        lora names a registered adapter ("" = the base model). tenant keys
        the weighted-fair admission queue; it defaults to the adapter name,
        the natural tenant of a LoRA fleet. request_id keys the
        flight-recorder record (`request_timing()`) and is the cancel()
        handle. constraint is a compiled guided-decoding constraint
        (`llm.generate.compile_constraint`: callers own the tokenizer, the
        engine owns the per-request state): its token masks fold into this
        request's host sampling rows and spec-verify argmax, and its state
        releases on finish, cancel, shutdown and stepper death. Raises
        ValueError when the prompt cannot fit the engine's sequence budget
        (it is never silently truncated) or the constraint was compiled for
        another logits width, UnknownAdapterError for an unregistered
        adapter, EngineOverloadedError when the tenant's quota or the global
        depth cap is hit, and RuntimeError when the stepper is dead."""
        self._check_alive()
        token_ids = list(token_ids) or [0]  # empty prompt decodes from token 0
        if len(token_ids) > self.T - 1:
            raise ValueError(
                f"prompt of {len(token_ids)} tokens exceeds this engine's "
                f"max_seq={self.T} budget (prompt_len <= max_seq - 1 so at "
                f"least one token can be generated); truncate the prompt "
                f"client-side or raise max_seq"
            )
        adapter = self._adapter_index(lora)
        self._check_constraint(constraint)
        # The prompt is never truncated; a generation budget that would
        # overflow the KV rows shrinks max_tokens instead.
        headroom = self.T - 1 - len(token_ids)
        if sampling.max_tokens > headroom:
            sampling = dataclasses.replace(sampling, max_tokens=max(1, headroom))
        tenant = lora if tenant is None else tenant
        req = Request("prompt", prompt=token_ids, sampling=sampling, callback=callback,
                      adapter=adapter, tenant=tenant)
        req.rid = request_id
        req.rec = self._start_record(request_id, tenant, prompt_len=len(token_ids))
        self._enqueue(req, constraint)

    def _enqueue(self, req: Request, constraint):
        """Begin the request's constraint state and hand the request to the
        scheduler. On EngineOverloadedError the state is released and the
        record retires as "rejected" before the error propagates."""
        if constraint is not None:
            req.constraint = constraint.begin(req.rid or f"req-{id(req):x}")
        try:
            self._sched.submit(req)
        except EngineOverloadedError:
            if req.constraint is not None:
                req.constraint.release()
                req.constraint = None
            summary = self._recorder.finish(req.rec, status="rejected")
            if summary is not None:
                self._serve_metrics.record(summary)
            raise

    def _check_constraint(self, constraint):
        """A constraint compiled against a different logits width would
        mis-mask silently; fail the submit loudly instead."""
        if constraint is None:
            return
        vocab = getattr(constraint, "vocab", None)
        if vocab is not None and int(vocab) != int(self.cfg.vocab_size):
            raise ValueError(
                f"guided constraint compiled for vocab {vocab} but this "
                f"engine's model has vocab_size={self.cfg.vocab_size}; "
                f"compile_constraint(spec, tokenizer, vocab_size) must use "
                f"the model's logits width"
            )

    @_leader_only
    def submit_prefilled(self, kv, prompt_len: int, first_logits, sampling: SamplingParams,
                         callback, lora: str = "", token_ids: Optional[List[int]] = None,
                         tenant: Optional[str] = None, request_id: Optional[str] = None,
                         transfer_s: Optional[float] = None, constraint=None):
        """Admit a request whose prefill ran elsewhere (PD disaggregation):
        kv [L, 2, P, Hkv, D] with P >= prompt_len is the transferred prefix
        (host numpy, a CPU tensor, or a CUDA tensor on this engine's device,
        which is attached without a host round trip) and first_logits [V]
        the prompt's last-position logits. token_ids (optional, the prompt
        behind kv) feeds the transferred prefix to this engine's prefix
        cache and keeps the slot spec-eligible. transfer_s, the seconds the
        caller spent moving kv, becomes the record's `pd-transfer` span.
        Raises as submit() does; a prefix that leaves no row to generate
        into (prompt_len >= max_seq) raises ValueError."""
        if self._tp is not None:
            raise _tp_later("submit_prefilled (the PD handoff)")
        self._check_alive()
        if prompt_len >= self.T:
            raise ValueError(
                f"transferred KV prefix of {prompt_len} tokens does not fit this "
                f"decode engine's max_seq={self.T}; align prefill and decode "
                f"max_seq"
            )
        adapter = self._adapter_index(lora)
        self._check_constraint(constraint)
        # The same KV headroom contract as the prompt path.
        headroom = self.T - 1 - prompt_len
        if sampling.max_tokens > headroom:
            sampling = dataclasses.replace(sampling, max_tokens=max(1, headroom))
        if isinstance(kv, torch.Tensor) and kv.is_cuda:
            # The stepper reads kv on the engine's stream: work still queued
            # on the submitter's stream must have landed first.
            producer = torch.cuda.current_stream(kv.device)
            if producer != self._stream:
                producer.synchronize()
        tenant = lora if tenant is None else tenant
        req = Request("prefilled", prompt=None if token_ids is None else list(token_ids),
                      prompt_len=int(prompt_len), sampling=sampling, callback=callback,
                      adapter=adapter, kv=kv, first_logits=first_logits, tenant=tenant)
        req.rid = request_id
        req.rec = self._start_record(request_id, tenant, prompt_len=int(prompt_len))
        if req.rec is not None and transfer_s is not None:
            t1 = time.time()
            req.rec.span("pd-transfer", t1 - transfer_s, t1, prompt_len=int(prompt_len))
        self._enqueue(req, constraint)

    @_leader_only
    def open_stream(self, token_ids: List[int], sampling: SamplingParams, *,
                    lora: str = "", tenant: Optional[str] = None,
                    request_id: Optional[str] = None, on_token=None, constraint=None,
                    buffer_cap: Optional[int] = None):
        """Submit a request and return its `TokenStream` subscription
        instead of wiring a raw callback: per-token delivery through
        iteration/`get()` (buffered) or the `on_token` relay (the shape
        `LLMServer.generate_stream` uses). The stream's `close()`/`cancel()`
        is the mid-stream-disconnect path: it cancels the request, and the
        engine frees the slot, prefix lease, adapter pin and constraint state
        within one scheduler iteration. Every open_stream resolves through close()
        (iterating to exhaustion closes it)."""
        import uuid

        from ray_tpu_torch.llm.generate import TokenStream

        rid = request_id or f"stream-{uuid.uuid4().hex}"
        stream = TokenStream(self, rid, on_token=on_token, buffer_cap=buffer_cap)
        try:
            self.submit(token_ids, sampling, stream._push, tenant=tenant,
                        request_id=rid, lora=lora, constraint=constraint)
        except BaseException:
            # The submit never enqueued: close the subscription without the
            # cancel round-trip (there is no request to cancel).
            stream._finished.set()
            stream.close()
            raise
        return stream

    def _start_record(self, request_id: Optional[str], tenant: str, **mark_attrs):
        """Open a flight-recorder record for one admission (no trace
        context: the port has no tracing plane)."""
        rec = self._recorder.start(request_id, tenant=tenant)
        if rec is not None:
            rec.mark("queued", tenant=tenant,
                     depth=self._sched.queue_depth(), **mark_attrs)
        return rec

    @_leader_only
    def cancel(self, request_id: Optional[str]) -> bool:
        """Cancel one request by the id its submit carried. Still-queued
        requests retire here (callback(-1, True)); prefilling or decoding ones
        retire at the top of the stepper's next iteration. Never raises."""
        if not request_id:
            return False
        req = self._sched.cancel_queued(request_id)
        if req is not None:
            self._fail_cancelled_request(req)
            return True
        with self._cancel_lock:
            self._pending_cancels.add(request_id)
        return True

    @_leader_only
    def prefill_detached(self, token_ids: List[int], lora: str = "",
                         request_id: Optional[str] = None):
        """Prefill without holding a decode slot, for transfer to a decode
        engine's `submit_prefilled`: returns (first_logits [V] f32 numpy,
        kv [L, 2, P, Hkv, D] on the host in the cache dtype, prompt_len),
        here with P == prompt_len. A prompt that does not fit raises
        ValueError (it is never truncated). A prefix-cache hit prefills only
        the suffix against the leased rows; the prompt's whole blocks then
        feed the cache.

        It runs on the caller's thread while the stepper keeps decoding, so
        it touches neither `_caches` nor `_lens`: its forward writes scratch
        caches of its own, on the engine's stream. The adapter pin is held
        until the results are on the host. JAX may release it once the
        program is dispatched (its tables are immutable); here a released
        row may be paged over in place on the stepper's stream while the
        forward still reads it."""
        if self._tp is not None:
            raise _tp_later("prefill_detached (the PD handoff)")
        prompt = list(token_ids)
        if len(prompt) > self.T - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds this prefill engine's "
                f"max_seq={self.T} budget (prompt_len <= max_seq - 1); "
                f"truncate the prompt client-side or raise max_seq"
            )
        adapter = self._adapter_index(lora)  # stable uid: the cache namespace
        rec = self._recorder.start(request_id, tenant=lora)
        t_pf0 = time.time()
        handle = None
        with self._device_context():
            if self._adapters is not None and adapter:
                resident = self._adapters.is_resident(adapter)
                try:
                    # A page-in's copy lands on the engine's stream (held here).
                    handle = self._adapters.acquire(adapter)
                except BaseException:
                    self._recorder.drop(rec)
                    raise
                if rec is not None and not resident:
                    rec.mark("adapter-page-in", adapter=adapter)
            try:
                adapter_slot = 0 if handle is None else handle.slot
                lease = None
                tier = "host"
                if self._prefix_cache is not None:
                    lease = self._prefix_cache.lookup(prompt, namespace=adapter)
                if lease is not None:
                    # Released in a finally: the detached path has no
                    # scheduler drain to release a lease it strands.
                    try:
                        m = lease.matched_tokens
                        tier = lease.tier
                        prefix_kv = lease.kv()  # a new tensor: safe to release
                    finally:
                        lease.release()
                    first_logits, kv = self._detached_suffix(prompt, m, prefix_kv,
                                                             adapter_slot)
                else:
                    m = 0
                    first_logits, kv = self._detached_cold(prompt, adapter_slot)
            except BaseException:
                self._recorder.drop(rec)
                raise
            finally:
                # Both results are host copies by now: every read of the
                # adapter's row is complete, so the row may be paged over.
                if handle is not None:
                    handle.release()
        self.last_prefill = {"offset": m, "prompt_len": len(prompt), "detached": True,
                             "tier": tier}
        if rec is not None:
            rec.span("prefill-detached", t_pf0, time.time(), prompt_len=len(prompt),
                     cached_tokens=m, tier=tier)
            # A prefill-only record has no tokens: it feeds the ring, not the
            # SLO windows.
            self._recorder.finish(rec)
        if self._prefix_cache is not None:
            n = (len(prompt) // self._prefix_cache.block_size) * self._prefix_cache.block_size
            if n > m:  # nothing new when the hit covered every whole block
                self._prefix_cache.insert(prompt[:n], kv, namespace=adapter)
        return first_logits, kv, len(prompt)

    def _detached_cold(self, prompt: List[int], adapter_slot: int):
        """The whole prompt at offset 0 over scratch caches of its bucket: the
        attention is K1's, as a local prompt's first chunk. Returns host
        copies of (first_logits [V], kv rows [0, prompt_len))."""
        cfg, n = self.cfg, len(prompt)
        S = self._bucket(n)
        padded = np.zeros((1, S), np.int64)
        padded[0, :n] = prompt
        # One buffer holds every layer's scratch rows: [L, 2, 1, S, Hkv, D].
        scratch = torch.zeros((cfg.n_layers, 2, 1, S, cfg.n_kv_heads, cfg.head_dim),
                              dtype=cfg.dtype, device=self.device)
        logits = _forward_cached(
            self.params, cfg, self._dev(padded), torch.arange(S, device=self.device)[None],
            [(layer[0], layer[1]) for layer in scratch], self._dev([0]), None,
            **self._lora([adapter_slot]))
        return (_to_host(logits[0, n - 1]).numpy(),
                _to_host(scratch[:, :, 0, :n]))

    def _detached_suffix(self, prompt: List[int], m: int, prefix_kv: torch.Tensor,
                         adapter_slot: int):
        """Detached prefill of prompt[m:] against a cached m-row prefix
        (prefix_kv [L, 2, m, Hkv, D] on the host), with the cold path's
        contract. As JAX lays it out: the prefix padded to its own bucket mb
        in rows [0, mb), the suffix's bucket sb in rows [mb, mb + sb); a
        suffix row sees the real prefix rows and the suffix rows up to its
        own, through the masked route."""
        cfg = self.cfg
        suffix = prompt[m:]
        mb, sb = self._bucket(m), self._bucket(len(suffix))
        padded = np.zeros((1, sb), np.int64)
        padded[0, :len(suffix)] = suffix
        scratch = torch.zeros((cfg.n_layers, 2, 1, mb + sb, cfg.n_kv_heads, cfg.head_dim),
                              dtype=cfg.dtype, device=self.device)
        scratch[:, :, 0, :m] = prefix_kv.to(self.device)
        rows = torch.arange(mb + sb, device=self.device)[None, :]
        steps = torch.arange(sb, device=self.device)[:, None]
        mask = ((rows < m) | ((rows >= mb) & (rows - mb <= steps)))[None]
        logits = _forward_cached(
            self.params, cfg, self._dev(padded), (m + steps.T),
            [(layer[0], layer[1]) for layer in scratch], self._dev([mb]), mask,
            **self._lora([adapter_slot]))
        suffix_kv = _to_host(scratch[:, :, 0, mb:mb + len(suffix)])
        return (_to_host(logits[0, len(suffix) - 1]).numpy(),
                torch.cat([prefix_kv.to(cfg.dtype), suffix_kv], dim=2))

    def _insert_prompt_kv(self, slot: int, prompt: List[int], adapter: int,
                          cached_offset: int):
        """Populate the prefix cache from the slot's freshly prefilled rows.
        Skips when the prompt has no full block beyond what the cache already
        held (cached_offset tokens)."""
        cache = self._prefix_cache
        bs = cache.block_size
        n = (len(prompt) // bs) * bs
        if n == 0 or n <= cached_offset:
            return
        # JAX pulls rows [0, n) and lets the radix walk dedup the cached
        # prefix; the port reads back only the blocks the cache lacks and
        # has room for (insert_missing), with the same counters.
        ck = self._caches[0][0]
        block_nbytes = (len(self._caches) * 2 * bs * ck.shape[2] * ck.shape[3]
                        * ck.element_size())
        if self._tp is not None and self._tp.kv_split:
            block_nbytes *= self.tp  # the pool's blocks hold every kv head
        with self._tier_sync():  # an eviction drops device copies
            cache.insert_missing(prompt[:n],
                                 lambda first, stop: self._op("_read_kv_blocks", slot, first, stop),
                                 block_nbytes, namespace=adapter)

    def _read_kv_blocks(self, slot: int, first: int, stop: int) -> List[torch.Tensor]:
        """Host copies of slot's cache blocks [first, stop): one owned
        [L, 2, block_size, Hkv, D] tensor per block, the pool's layout. The
        rows are gathered block-major on the device and pulled in one copy;
        each block is then one contiguous host copy (the pool accounts every
        block's bytes, so no block may be a view of a shared buffer). On a TP
        engine whose kv heads split, the ranks' rows are gathered to rank 0
        and joined on the kv-head axis, so the blocks are tp=1's; with the kv
        heads replicated, rank 0's own rows are whole. Followers return
        None."""
        tp = self._tp
        if tp is not None and not tp.leader and not tp.kv_split:
            return None
        bs = self._kv_block_size
        a, b = first * bs, stop * bs
        rows = torch.stack([torch.stack([ck[slot, a:b], cv[slot, a:b]])
                            for ck, cv in self._caches])
        if tp is not None and tp.kv_split:
            parts = tp.gather_host(rows.cpu())
            if not tp.leader:
                return None
            rows = torch.cat(parts, dim=kv_prefix_sharding(self.tp, self.cfg.n_kv_heads))
        L, _, _, H, D = rows.shape
        blocks = rows.view(L, 2, stop - first, bs, H, D).permute(2, 0, 1, 3, 4, 5)
        return [blk.clone() for blk in blocks.contiguous().cpu().unbind(0)]

    def _install_adapter_row(self, slot: int, blob: dict) -> None:
        """A page-in's rows written into this rank's tables (its columns)."""
        self._adapters.write_row(slot, blob)

    def _kv_block_to_device(self, host_kv: torch.Tensor) -> torch.Tensor:
        """Hot-tier promotion copy: one [L, 2, bs, Hkv, D] host block onto
        this engine's device in the cache dtype, on the engine's stream,
        where every attach that reads it runs. From pageable memory the copy
        returns once the block is staged, so the host block may be evicted
        afterwards. On the CPU it is the host tensor itself."""
        with contextlib.ExitStack() as stack:
            if self._stream is not None:
                stack.enter_context(torch.cuda.stream(self._stream))
            return host_kv.to(self.device, self.cfg.dtype)

    def _leased_kv(self, lease):
        """A lease's prefix rows from the best tier, and the tier that served
        them: the tiered cache's device copies when every block holds one
        (zero H2D on attach), else the host blocks. A lease stamped "device"
        whose copies were dropped mid-lease is served by the host."""
        device_kv = getattr(self._prefix_cache, "device_kv", None)
        kv = None if device_kv is None else device_kv(lease)
        if kv is not None:
            return kv, lease.tier
        return lease.kv(), "host" if lease.tier == "device" else lease.tier

    @_leader_only
    def prefix_cache_stats(self) -> Optional[dict]:
        """Hit/eviction/residency counters of the paged KV prefix cache,
        with the per-tier breakdown ("tiers") of a tiered cache (None when
        the cache is disabled)."""
        if self._prefix_cache is None:
            return None
        return self._prefix_cache.stats()

    @_leader_only
    def lease_prefix(self, token_ids: List[int], lora: str = ""):
        """Full-coverage lease of this engine's longest cached prefix of
        token_ids (no len-1 cap: the caller wants every cached row) — the
        export side of a prefix transfer. None when the cache is disabled or
        cold. The caller must release() the lease. Its caller is the DP/PD
        routers' prefix pull (ROADMAP.md, Queue 1 item 9)."""
        if self._prefix_cache is None:
            return None
        return self._prefix_cache.lease_prefix(token_ids,
                                               namespace=self._adapter_index(lora))

    @_leader_only
    def insert_prefix(self, token_ids: List[int], kv, lora: str = "") -> int:
        """Feed a prefix's KV rows [L, 2, P, Hkv, D] (numpy or a CPU tensor)
        fetched elsewhere into this engine's cache — the import side: the
        next lookup for these tokens hits locally and prefills suffix-only.
        Returns blocks added. The import side of the routers' prefix pull
        (ROADMAP.md, Queue 1 item 9)."""
        if self._prefix_cache is None:
            return 0
        adapter = self._adapter_index(lora)
        insert = getattr(self._prefix_cache, "insert_remote", self._prefix_cache.insert)
        with self._tier_sync():
            return insert(token_ids, kv, namespace=adapter)

    @_leader_only
    def scheduler_stats(self) -> dict:
        """Iteration-level scheduler occupancy (per-phase token counters,
        interleaving, queue depths), speculative-decoding acceptance
        ("spec", with a draft), the adapter cache's and the prefix cache's
        counters and `recorder_stats()`."""
        out = self._sched.stats()
        if self._adapters is not None:
            out["adapters"] = self._adapters.stats()
        if self._prefix_cache is not None:
            out["prefix_cache"] = self._prefix_cache.stats()
        if self._draft is not None:
            spec = dict(self._spec_counters)
            spec["accept_rate"] = (
                spec["accepted_tokens"] / max(1, spec["proposed_tokens"])
            )
            spec["draft"] = self._draft.stats()
            out["spec"] = spec
        out["recorder"] = self.recorder_stats()
        return out

    @_leader_only
    def recorder_stats(self) -> dict:
        """Flight-recorder counters, and each tenant's SLO burn rate over its
        recent completions ("burn_rates": windowed breach fraction over
        llm_slo_error_budget, "" for untenanted traffic). `autopilot_signals()`
        reads the same rates; ray_tpu also exports them as util.metrics
        gauges, which the port does not have yet (ROADMAP.md, Queue 1 item 8)."""
        return {**self._recorder.stats(),
                "burn_rates": self._serve_metrics.burn_rates()}

    @_leader_only
    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Reshare one tenant's weighted-fair queue weight (the serve
        autopilot's actuator, and the operator's)."""
        self._sched.set_tenant_weight(tenant, weight)

    @_leader_only
    def autopilot_signals(self) -> dict:
        """The serve autopilot's signal vector: queue depth and occupancy
        from the scheduler, SLO burn rates from the metrics windows. The
        batch tenant (`llm_batch_tenant`) is non-SLO load: its queued
        requests, burn and weight are left out. JAX's version runs under
        its distsan report-path check, a devtool the port does not have."""
        st = self._sched.stats()
        batch = CONFIG.llm_batch_tenant
        tenants = st.get("tenants") or {}
        batch_queued = int((tenants.get(batch) or {}).get("queued", 0))
        online_burns = {t: b for t, b in self._serve_metrics.burn_rates().items()
                        if t != batch}
        return {
            "role": "engine",
            "queued": max(0, st.get("queue_depth", 0) - batch_queued),
            "running": (st.get("running", 0) or 0) + (st.get("prefilling", 0) or 0),
            "burn_rate": max(online_burns.values(), default=0.0),
            "tenant_burn": {t: b for t, b in online_burns.items() if t},
            "tenant_weights": {t: info.get("weight", 1.0)
                               for t, info in tenants.items() if t != batch},
        }

    @_leader_only
    def request_timing(self, rid: str) -> Optional[dict]:
        """Per-request timing breakdown (the response-metadata payload):
        queue/prefill/decode phase durations, TTFT, mean TPOT, e2e — from
        the flight recorder's ring."""
        summary = self._recorder.lookup(rid)
        if summary is None:
            return None
        return {
            "request_id": summary["rid"],
            "queue_s": summary["queue_s"],
            "ttft_s": summary["ttft_s"],
            "tpot_s": summary["tpot_s"],
            "e2e_s": summary["e2e_s"],
            "tokens": summary["tokens"],
            "route": summary["route"],
            "phases": {
                name: {"count": p["count"],
                       "seconds": round(p["seconds"], 6)}
                for name, p in summary["phases"].items()
            },
            "trace_id": summary["trace_id"],
        }

    def _fail_cancelled_request(self, req: Request):
        """Retire a cancelled not-yet-active request: its constraint state
        releases, its flight record retires as "cancelled" and the callback
        observes the terminal sentinel exactly once (the scheduler released
        its lease)."""
        if req.constraint is not None:
            req.constraint.release()
            req.constraint = None
        rec, req.rec = req.rec, None
        summary = self._recorder.finish(rec, status="cancelled")
        if summary is not None:
            self._serve_metrics.record(summary)
        if req.callback is not None:
            try:
                req.callback(-1, True)
            except Exception:
                pass  # the cancel must complete past a broken callback

    def _process_cancels(self):
        with self._cancel_lock:
            if not self._pending_cancels:
                return
            rids, self._pending_cancels = self._pending_cancels, set()
        for rid in rids:
            self._cancel_one(rid)

    def _cancel_one(self, rid: str):
        req = self._sched.cancel_queued(rid) or self._sched.cancel_prefilling(rid)
        if req is not None:
            self._fail_cancelled_request(req)
            return
        for i, s in enumerate(self._sched.slots):
            if s.active and s.rid == rid:
                s.active = False
                self._release_slot_constraint(s)
                self._finish_record(s, status="cancelled")
                self._release_slot_pin(s)
                if self._draft is not None:
                    self._draft.on_finish(i, s)
                if s.callback is not None:
                    try:
                        s.callback(-1, True)
                    except Exception:
                        pass  # the cancel must complete past a broken callback
                return

    def _check_alive(self):
        if self.error is not None:
            raise RuntimeError(
                "engine stepper died; no further requests are accepted"
            ) from self.error
        if self._stop:
            raise RuntimeError("engine is shut down")

    def _fail_all(self):
        """Fail every active and queued request (callback(-1, True)) so
        submitters unwind instead of hanging; every slot's adapter pin and
        constraint state release here, queued and prefilling requests'
        prefix leases, adapter pins and constraint states in the scheduler's
        drain, and every live flight record retires as "dropped"."""
        for slot in self._sched.slots:
            self._release_slot_pin(slot)
            self._release_slot_constraint(slot)
            if slot.active and slot.callback is not None:
                slot.active = False
                try:
                    slot.callback(-1, True)
                except Exception:
                    pass  # teardown must proceed past a broken callback
        for req in self._sched.drain():
            if req.callback is not None:
                try:
                    req.callback(-1, True)
                except Exception:
                    pass  # teardown must proceed past a broken callback
        self._recorder.close()

    def shutdown(self):
        """Idempotent. Stops the stepper, then fails every request that is
        still active or queued; a tiered cache writes its queued spills and
        stops its spill worker. On a TP engine rank 0 then announces the stop,
        waits until every follower has ended its thread and freed its pool and
        weights, frees its own and destroys the engine's groups; a follower's
        shutdown returns once rank 0's has stopped it (or rank 0 failed)."""
        if self._tp is not None and not self._tp.leader:
            self._thread.join()
            self._release_tp_state()
            self._tp.close()
            return
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_all()
        close_cache = getattr(self._prefix_cache, "close", None)
        if close_cache is not None:
            close_cache()
        if self._tp is not None:
            if self._tp.group is not None:
                try:
                    with self._op_lock:
                        self._tp.announce("_stop", ([], self._adapter_ids.copy()))
                    self._tp.barrier()
                except RuntimeError:
                    pass  # a rank failed and closed the groups: nothing to stop
            self._release_tp_state()
            self._tp.close()

    def _release_tp_state(self):
        """A TP rank's pool, weights and hot-tier slices dropped (idempotent):
        with them the rank's device memory of this engine, past what the
        caller holds. Rank 0's tier drops its copies too."""
        if self._kv_pool is not None:
            self._kv_pool.free()
            self._caches = []
            self.params = None
            self._hot_slices.clear()
            if self._hot_shared:
                self._prefix_cache.release_device_tier()

    # -- stepper -----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._prefill_buckets:
            if n <= b:
                return b
        return self.T

    def _attach_kv(self, slot: int, kv: torch.Tensor):
        """Write a KV prefix into slot's cache rows [0, P), cast to the
        cache dtype. kv: [L, 2, P, Hkv, D], owned by the caller. From the
        host it is one H2D copy on the engine's stream, which from pageable
        memory returns once the rows are staged, so the caller may drop kv
        afterwards; a kv on the engine's device is copied on the device. On a
        TP engine rank 0 hands each rank its kv-head slice of the host rows
        (all of them where the kv heads replicate), and followers pass None."""
        tp = self._tp
        if tp is not None:
            kv = tp.scatter_host(self._kv_head_parts(kv) if tp.leader else None)
        self._write_rows(slot, kv)

    def _write_rows(self, slot: int, kv: torch.Tensor):
        """kv [L, 2, P, Hkv_local, D] into slot's cache rows [0, P), copied
        to the engine's device first where it is not there."""
        kv = kv.to(self.device)
        P = kv.shape[2]
        for i, (ck, cv) in enumerate(self._caches):
            ck[slot, :P] = kv[i, 0]
            cv[slot, :P] = kv[i, 1]

    def _kv_head_parts(self, kv: torch.Tensor) -> List[torch.Tensor]:
        """Rank by rank, its kv-head slice of a KV prefix [L, 2, P, Hkv, D]:
        the whole prefix for every rank where the kv heads replicate."""
        dim = kv_prefix_sharding(self.tp, self.cfg.n_kv_heads)
        if dim is None:
            return [kv] * self.tp
        return [part.contiguous() for part in kv.chunk(self.tp, dim=dim)]

    # -- a TP engine's tiered cache: each rank's slices of rank 0's hot tier --
    @contextlib.contextmanager
    def _tier_sync(self):
        """Around each call rank 0 makes into a TP engine's tiered cache
        (lookup, insert, the device attach): one call at a time, and on its
        way out the ids the hot tier dropped meanwhile (LRU, eviction, an
        orphaned copy) go to every rank as one announced `_drop_hot`, so
        when the call returns every rank holds exactly the tier's ids. The
        tier drops under the manager's lock, where no collective may run, so
        it logs them (`take_dropped`). One call at a time keeps a drop of an
        id from passing a later copy of the same id. A no-op elsewhere."""
        if not self._hot_shared:
            yield
            return
        with self._tier_lock:
            try:
                yield
            finally:
                dropped = self._prefix_cache.take_dropped()
                if dropped:
                    self._op("_drop_hot", dropped)

    def _promote_hot(self, block_id: int, host: Optional[torch.Tensor]):
        """A hot-tier promotion on every rank, the copy rank 0's manager
        makes (outside its lock) through `_op`: rank 0 hands each rank its
        kv-head slice of the host block [L, 2, bs, Hkv, D], and each copies
        its slice to its card on the engine's stream and keeps it under the
        block's id. Returns rank 0's slice, which its tier holds. A device
        out-of-memory on any rank is every rank's (`TPShard.agree`): no rank
        keeps the slice, no rank fails, and rank 0 raises it to the manager,
        which stops promoting, as on one device."""
        tp = self._tp
        part = tp.scatter_host(self._kv_head_parts(host) if tp.leader else None)
        try:
            dev = self._kv_block_to_device(part)
        except torch.cuda.OutOfMemoryError:
            dev = None
        if not tp.agree(dev is not None):
            if tp.leader:
                raise torch.cuda.OutOfMemoryError(
                    f"a rank could not hold its slice of KV block {block_id}")
            return None
        self._hot_slices[block_id] = dev
        return dev

    def _attach_hot(self, slot: int, block_ids: List[int], kv: Optional[torch.Tensor] = None):
        """A device-tier attach on every rank: each writes its own slices of
        the leased blocks into slot's rows, on its card (rank 0 passes the
        chain its tier joined, `device_kv`). No host rows move."""
        if kv is None:
            slices = [self._hot_slices[bid] for bid in block_ids]
            kv = slices[0] if len(slices) == 1 else torch.cat(slices, dim=2)
        self._write_rows(slot, kv)

    def _drop_hot(self, block_ids: List[int]):
        """Every rank drops its slices of the blocks rank 0's tier dropped."""
        for bid in block_ids:
            self._hot_slices.pop(bid, None)

    def _hot_report(self, with_rows: bool = False):
        """Every rank's hot-tier slices, gathered to rank 0 (None on the
        others): per rank, block id -> (shape, bytes, a host copy when
        with_rows else None). A diagnostic (tests, chip_mesh.py); announced
        through `_op`, it reads each rank's slices after every earlier
        operation."""
        mine = {bid: (list(t.shape), t.nbytes, t.cpu() if with_rows else None)
                for bid, t in self._hot_slices.items()}
        return self._tp.gather_host(mine)

    def _attach_lease(self, slot: int, lease) -> str:
        """Write a lease's prefix rows into slot's cache rows; returns the
        tier that served them. One device: from `_leased_kv`'s best tier.
        TP: where rank 0's hot tier holds every leased block, each rank
        reads its own slices (`_attach_hot`); else rank 0 scatters the host
        rows (`_attach_kv`), a lease stamped "device" whose copies went
        meanwhile included, as `_leased_kv` decides on one device."""
        if self._tp is None:
            kv, tier = self._leased_kv(lease)
            self._op("_attach_kv", slot, kv)
            return tier
        with self._tier_sync():
            kv = self._prefix_cache.device_kv(lease) if self._hot_shared else None
            if kv is not None:
                self._op("_attach_hot", slot, list(lease.block_ids), kv)
                return lease.tier
        self._op("_attach_kv", slot, lease.kv())
        return "host" if lease.tier == "device" else lease.tier

    def _exec_chunk(self, chunk: ScheduledChunk):
        """Dispatch one scheduled prefill chunk. The FIRST chunk of a
        cache-hit request attaches the leased prefix rows; the LAST chunk
        samples the request's first token (the one per-admission host pull),
        feeds the prompt's rows to the prefix cache and activates the
        slot. A transferred prefix ("prefilled") is attached instead."""
        req = chunk.request
        if req.kind == "prefilled":
            self._exec_attach(req)
            return
        rec = req.rec
        slot = req.slot
        offset = req.prefilled
        if chunk.is_first and req.lease is not None:
            t_attach = time.time()
            # Attach exactly the cached rows [0, cached_offset), then prefill
            # only the suffix (in chunks). The lease pins the blocks until
            # the rows are copied out of them; it releases in a finally — on
            # an attach failure the stepper dies and the scheduler drain
            # would release it too, but only after req.lease was cleared
            # here, so the release must not depend on the happy path.
            try:
                # The host form is a new tensor, and device copies are
                # never written, so releasing the lease cannot change the
                # rows the copy reads.
                tier = self._attach_lease(slot, req.lease)
            finally:
                req.lease.release()
                req.lease = None
            if rec is not None:
                # Host-stamped: the span covers the concatenation and the
                # staged H2D copy (none from the device tier).
                rec.span("cache-attach", t_attach, time.time(),
                         cached_tokens=req.cached_offset, tier=tier)
            self.last_attach = {"tier": tier, "cached_tokens": req.cached_offset}
        t_chunk = time.time()
        padded = np.zeros((1, chunk.bucket), np.int64)
        padded[0, : len(chunk.tokens)] = chunk.tokens
        last_logits = self._op("_prefill_at", padded, slot, offset, req.prompt_len,
                               req.adapter_slot)
        self._sched.chunk_done(chunk)
        if rec is not None:
            rec.span("prefill-chunk", t_chunk, time.time(),
                     bucket=chunk.bucket, offset=offset,
                     tokens=len(chunk.tokens), chunk=req.chunks - 1)
        # The host lens mirror advances with every chunk: the decode write
        # gate keeps interleaved decode dispatches off a mid-prefill slot,
        # and an accurate lens is the backstop.
        self._lens[slot] = req.prefilled
        if not chunk.is_last:
            return
        self.last_prefill = {
            "bucket": chunk.bucket, "offset": req.cached_offset,
            "prompt_len": req.prompt_len, "chunks": req.chunks,
        }
        first_row = last_logits.cpu().numpy()
        if req.constraint is not None:
            first_row = first_row + req.constraint.mask(
                req.sampling.stop_token_id, budget=req.sampling.max_tokens
            )
        first = _sample_host(first_row, req.sampling, self._np_rng)
        if self._prefix_cache is not None:
            self._insert_prompt_kv(slot, req.prompt, req.adapter, req.cached_offset)
        if self._draft is not None:
            # Draft catch-up: cache-hit admissions (offset > 0) stay
            # spec-eligible — the model draft prefills its own cache on the
            # whole prompt; the ngram draft only indexes the ids.
            self._draft.on_admit(slot, list(req.prompt))
        self._start_slot(req, first)

    def _exec_attach(self, req: Request):
        """Admission of a transferred prefix (PD disaggregation): write its
        rows [0, prompt_len) into the slot, sample the first token from the
        transferred logits (under the constraint's start-state mask) and
        start the slot. A kv already on the engine's device is copied on the
        device; host rows cross in one H2D copy. With the prompt's token
        ids the rows feed the prefix cache and the draft catches up."""
        slot, prompt_len = req.slot, req.prompt_len
        kv, req.kv = req.kv, None
        t_attach = time.time()
        on_device = isinstance(kv, torch.Tensor) and kv.device == self.device
        if isinstance(kv, np.ndarray):
            kv = torch.from_numpy(kv)
        if kv.is_cuda:
            # The copy below reads kv on this stream: its memory must not be
            # reused on the stream it was allocated on until then.
            kv.record_stream(torch.cuda.current_stream(kv.device))
        # The bucket JAX pads the attach to; the port writes exactly the rows.
        bucket = self._bucket(max(kv.shape[2], prompt_len))
        self._attach_kv(slot, kv[:, :, :prompt_len])
        self._lens[slot] = prompt_len
        if req.rec is not None:
            req.rec.span("pd-attach", t_attach, time.time(), prompt_len=prompt_len,
                         bucket=bucket, on_device=on_device)
        first_logits = req.first_logits
        if isinstance(first_logits, torch.Tensor):
            first_logits = first_logits.float().cpu().numpy()
        first_row = np.asarray(first_logits, np.float32)
        if req.constraint is not None:
            # The start-state mask a local prefill's first sample gets.
            first_row = first_row + req.constraint.mask(
                req.sampling.stop_token_id, budget=req.sampling.max_tokens
            )
        first = _sample_host(first_row, req.sampling, self._np_rng)
        known = bool(req.prompt) and len(req.prompt) >= prompt_len
        if self._prefix_cache is not None and known:
            if kv.device.type == "cpu":
                # Host rows are in the pool's layout already: no read-back.
                n = (prompt_len // self._prefix_cache.block_size) * self._prefix_cache.block_size
                if n:
                    self._prefix_cache.insert(req.prompt[:n], kv, namespace=req.adapter)
            else:
                self._insert_prompt_kv(slot, req.prompt[:prompt_len], req.adapter, 0)
        if self._draft is not None:
            if known:
                self._draft.on_admit(slot, list(req.prompt[:prompt_len]))
            else:
                self._draft.on_plain_decode(slot)  # no ids, no draft history
        self._start_slot(req, first)

    def _start_slot(self, req: Request, first: int):
        self._sched.start_decode(req, first)
        # The device row, not the stable uid: paging can move an adapter
        # between rows, but the slot's pin (held until the request ends)
        # keeps this row valid for the whole generation.
        self._adapter_ids[req.slot] = req.adapter_slot
        self._last_token[req.slot] = first
        self._emit(req.slot, first)

    def _finish_record(self, s, status: str = "ok"):
        """Retire a slot's flight record exactly once: the decode phase
        aggregates into ONE span (first..last token) and the completion
        summary folds into the SLO burn windows. status="cancelled"
        is the disconnect path: it stays out of the SLO good/bad books."""
        rec, s.rec = s.rec, None
        if rec is None:
            return
        tt = rec.token_times
        if tt:
            rec.span("decode", tt[0], tt[-1], tokens=len(tt))
        summary = self._recorder.finish(rec, status=status)
        if summary is not None:
            self._serve_metrics.record(summary)

    def _emit(self, slot: int, token: int):
        s = self._sched.slots[slot]
        done = (
            s.generated >= s.params.max_tokens
            or (s.params.stop_token_id is not None and token == s.params.stop_token_id)
        )
        if s.constraint is not None and not (
                s.params.stop_token_id is not None and token == s.params.stop_token_id):
            # The stop token ends output; it never enters the DFA.
            s.constraint.advance(token)
            if s.constraint.is_complete():
                # Accepting dead-end: nothing can legally extend the output,
                # so finish now instead of burning max_tokens.
                done = True
        self._sched.note_emitted(slot)
        if s.rec is not None:
            s.rec.token()  # host timestamp; TTFT/TPOT derive from these
            if done:
                # Retire the record BEFORE the callback observes
                # finished=True: a caller reading request_timing() the
                # moment its future resolves sees the finished summary.
                self._finish_record(s)
        try:
            s.callback(token, done)
        except Exception:
            done = True
            self._finish_record(s)  # callback-abort path: books still balance
        if done:
            s.active = False
            self._release_slot_constraint(s)
            self._release_slot_pin(s)
            if self._draft is not None:
                self._draft.on_finish(slot, s)

    @staticmethod
    def _release_slot_pin(s):
        """Unpin the slot's adapter exactly once; the finish, cancel,
        shutdown and stepper-death paths all funnel here (a second release
        would free a pin a later admission took)."""
        handle, s.adapter_handle = s.adapter_handle, None
        if handle is not None:
            handle.release()

    @staticmethod
    def _release_slot_constraint(s):
        """Release a slot's guided constraint state exactly once; the
        finish, cancel, shutdown and stepper-death paths all funnel here."""
        state, s.constraint = s.constraint, None
        if state is not None:
            state.release()

    def _device_context(self) -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _loop(self):
        try:
            with self._device_context():
                self._loop_inner()
        except BaseException as e:
            self.error = e
            if self._tp is not None:
                # A follower's own error, where it left one, is the cause;
                # the report and the closed groups end the followers' waits.
                peer = self._tp.peer_error()
                if peer is not None:
                    self.error = RuntimeError(f"tensor-parallel follower failed: {peer}")
                    self.error.__cause__ = e
                self._tp.report_failure(self.error)
            self._fail_all()
            raise

    def _follow(self):
        """A TP follower's thread: run rank 0's device operations on this
        rank's shards, in the order announced, until rank 0 stops the engine;
        then free the pool and weights and tell rank 0. An error is reported
        in the job's store (rank 0 names it) and closes the engine's groups;
        rank 0's pending collective then fails (gloo's when the groups close,
        NCCL's when rank 0's watcher aborts it)."""
        tp = self._tp
        try:
            with self._device_context():
                while True:
                    name, (args, adapter_ids) = tp.receive()
                    if name == "_stop":
                        break
                    if name not in _TP_OPS:
                        raise RuntimeError(f"unknown tensor-parallel operation {name!r}")
                    self._adapter_ids[:] = adapter_ids
                    getattr(self, name)(*args)
            self._release_tp_state()
            tp.barrier()
        except BaseException as e:
            self.error = e
            tp.report_failure(e)
            raise

    def _loop_inner(self):
        """Execute one scheduler plan per iteration: prefill chunks, then
        the speculative verify phase, then the batched decode phase (the
        order is load-bearing: plainly-decoding slots' canonical rows land
        last). The draft proposes inside next_plan."""
        while not self._stop:
            # Cancels retire first, so a cancelled slot never joins another
            # dispatch: cancel-to-free is bounded by one iteration.
            self._process_cancels()
            plan = self._sched.next_plan(draft=self._draft)
            if plan.idle:
                if self._tp is not None and time.monotonic() - self._last_announce > PING_S:
                    self._op("_ping")
                time.sleep(0.002)
                continue
            for chunk in plan.chunks:
                self._exec_chunk(chunk)
            if plan.spec_slots:
                self._spec_round(plan)
            if plan.decode_slots:
                if plan.multi_step > 1:
                    self._multi_round(plan.decode_slots, plan.multi_step)
                else:
                    self._decode_round(plan.decode_slots)
                if self._draft is not None:
                    for i in plan.decode_slots:
                        # A plain step advances the target but not a model
                        # draft's cache; the ngram draft ignores it.
                        self._draft.on_plain_decode(i)

    def _spec_round(self, plan):
        """One scheduler-scheduled speculative phase: the draft's proposals
        (gathered at plan time) verify for every participating slot in ONE
        batched dispatch, and each slot emits its longest accepted prefix
        plus the target's correction token — exactly the greedy chain."""
        draft = self._draft
        S = draft.k + 1
        tokens = np.zeros((self.B, S), np.int64)
        gate = np.zeros((self.B,), bool)
        base_lens: Dict[int, int] = {}
        # Guided composition: per-position masks for guided participants,
        # built host-side by walking a clone of each slot's automaton
        # through its known proposal (the real state advances only in
        # _emit); zeros for the others.
        cmask = None
        for i in plan.spec_slots:
            s = self._sched.slots[i]
            p = plan.proposals[i]
            tokens[i, 0] = s.tokens[-1]
            tokens[i, 1:1 + len(p)] = p
            gate[i] = True
            base_lens[i] = s.host_len
            if s.constraint is not None:
                if cmask is None:
                    cmask = np.zeros((self.B, S, self.cfg.vocab_size), np.float32)
                rows = s.constraint.proposal_masks(
                    [int(x) for x in p], s.params.stop_token_id, length=S,
                    budget=s.params.max_tokens - s.generated,
                )
                cmask[i, :len(rows)] = rows
        t_verify = time.time()
        greedy_dev = self._op("_spec_verify_batched", tokens, self._lens, gate, cmask)
        # The round's one acceptance sync: k+1 tokens per participating slot
        # in a single batched pull.
        greedy = greedy_dev.cpu().numpy()
        c = self._spec_counters
        c["rounds"] += 1
        for i in plan.spec_slots:
            s = self._sched.slots[i]
            p = plan.proposals[i]
            base = base_lens[i]
            m = 0
            while m < len(p) and int(greedy[i, m]) == int(p[m]):
                m += 1
            emitted = [int(x) for x in p[:m]] + [int(greedy[i, m])]
            # Rows [base, base+m] now hold [t0, accepted...]; rows beyond
            # hold rejected proposals' kv, invisible behind lens and
            # overwritten write-before-read by the next dispatch.
            s.host_len = base + m + 1
            draft.on_accept(i, s, base, p, m)
            c["proposed_tokens"] += len(p)
            c["accepted_tokens"] += m
            if s.rec is not None:
                s.rec.span("spec-verify", t_verify, time.time(),
                           proposed=len(p), accepted=m)
            for token in emitted:
                if not s.active:
                    break
                s.generated += 1
                s.tokens.append(token)
                s.history.append(token)
                self._emit(i, token)
            self._lens[i] = s.host_len
            if s.tokens:
                self._last_token[i] = s.tokens[-1]
            c["emitted_tokens"] += len(emitted)

    def _decode_round(self, decode_slots: List[int]):
        # The write gate restricts KV writes to exactly the slots whose lens
        # advances below: idle and mid-prefill slots pass through write-free.
        gate = np.zeros((self.B,), bool)
        gate[decode_slots] = True
        logits_np = self._op("_decode_logits", self._last_token, self._lens, gate)
        for i in decode_slots:
            s = self._sched.slots[i]
            self._lens[i] += 1  # the decode step wrote this slot's kv row
            if not s.active:
                continue
            row = logits_np[i]
            if s.constraint is not None:
                # One cached [V] mask row + one numpy add on the pulled
                # logits. When the unconstrained argmax is already legal the
                # mask cannot change it. budget= steers onto a completable
                # path once the remaining max_tokens gets tight.
                row = row + s.constraint.mask(
                    s.params.stop_token_id,
                    budget=s.params.max_tokens - s.generated,
                )
            token = _sample_host(row, s.params, self._np_rng)
            s.generated += 1
            s.host_len += 1
            s.tokens.append(token)
            s.history.append(token)
            self._last_token[i] = token
            self._emit(i, token)

    def _multi_round(self, decode_slots: List[int], n: int):
        """One multi-token dispatch + host-side emission with rollback for
        slots that stop early: their lens rolls back to what was consumed."""
        gate = np.zeros((self.B,), bool)
        gate[decode_slots] = True
        toks_dev = self._op("_decode_multi", self._last_token, self._lens, gate, n)
        # The chunk's one device->host pull: n tokens x B slots.
        toks = toks_dev.cpu().numpy()
        for i in decode_slots:
            s = self._sched.slots[i]
            self._lens[i] += n  # the device wrote n kv rows for this slot
            consumed = 0
            for j in range(n):
                if not s.active:
                    break
                token = int(toks[j, i])
                consumed += 1
                s.generated += 1
                s.host_len += 1
                s.tokens.append(token)
                s.history.append(token)
                self._last_token[i] = token
                self._emit(i, token)
            if consumed < n:
                # Early stop: rows past the last consumed token are invisible
                # once lens rolls back and get overwritten by the next occupant.
                self._lens[i] = s.host_len
