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
the masked route.

Guided decoding (`submit(constraint=...)`, `llm/generate/`) adds a
constraint's host mask to the admission sample and to each host sampling
row; speculative decoding (`spec_config`, `llm/scheduler/spec.py`) runs a
verify phase between the chunks and the decode phase: one batched gated
forward over every participating slot's [t0, d1..dk], with the guided
slots' per-position masks added before the on-device argmax. A model
draft's prefill is an offset-0 forward, so it runs K1 too. `open_stream`
hands back a cancellable `TokenStream`.

Not in this slice (each raises): LoRA adapters, tensor parallelism. Not
ported yet: PD transfer, the cache's device and disk tiers.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from ray_tpu_torch.llm.flight_recorder import FlightRecorder, ServeMetrics
from ray_tpu_torch.llm.kvcache import PrefixCacheManager
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


def _rmsnorm(x, scale, eps):
    # Multiplies in f32 and casts after, unlike the model's RMSNorm (which
    # multiplies in the activation dtype): both are kept as JAX has them.
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * scale.float()).to(x.dtype)


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
                 write_gate=None):
    """One attention layer against the KV cache.

    x: [B, S, M]; positions: [B, S]; cache_k/v: [B, T, Hkv, D] (written in
    place); write_at: [B] start row per slot; kv_mask: [B, S, T] visibility,
    or None for a chunk that starts at row 0 and sees exactly its own rows
    causally (the K1 kernel's top-left causal mask over rows [0, S))."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _dense(x, layer["q"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, H, D)
    k = _dense(x, layer["k"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, Hkv, D)
    v = _dense(x, layer["v"]["kernel"].reshape(cfg.hidden, -1)).view(B, S, Hkv, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    _write_kv(cache_k, k, write_at, write_gate)
    _write_kv(cache_v, v, write_at, write_gate)

    scale = 1.0 / math.sqrt(D)
    if kv_mask is None:
        out, _ = flash_forward(q, cache_k[:, :S], cache_v[:, :S], causal=True,
                               scale=scale, layout="bshd")
    else:
        # GQA without copying the cache: query head h = g * rep + r reads kv
        # head g, the pairing jnp.repeat(kk, rep, axis=2) gives.
        T, rep = cache_k.shape[1], H // Hkv
        qg = q.view(B, S, Hkv, rep, D)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg, cache_k.to(q.dtype))
        logits = logits.reshape(B, H, S, T) * scale
        logits = torch.where(kv_mask[:, None], logits.float(), _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bgrst,btgd->bsgrd", probs.view(B, Hkv, rep, S, T),
                           cache_v.to(q.dtype)).reshape(B, S, H, D)
    o_kernel = layer["o"]["kernel"].reshape(-1, cfg.hidden)
    return _dense(out.reshape(B, S, -1), o_kernel)


def _mlp(layer, x):
    gate = _dense(x, layer["gate"]["kernel"])
    up = _dense(x, layer["up"]["kernel"])
    return _dense(F.silu(gate) * up, layer["down"]["kernel"])


def _forward_cached(params: ParamTree, cfg: ModelConfig, tokens, positions, caches,
                    write_at, kv_mask, write_gate=None):
    """tokens: [B,S] -> logits [B,S,V] f32; writes the caches in place."""
    embed = params["embedding"]
    x = embed[tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        layer = params[f"layer_{i}"]
        normed = _rmsnorm(x, layer["attn_norm"]["scale"], cfg.norm_eps)
        x = x + _attn_cached(layer["attn"], normed, positions, caches[i][0],
                             caches[i][1], write_at, kv_mask, cfg, write_gate)
        x = x + _mlp(layer["mlp"], _rmsnorm(x, layer["mlp_norm"]["scale"], cfg.norm_eps))
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _not_in_slice(what: str, where: str):
    return NotImplementedError(
        f"{what} is not in this slice of the PyTorch port; it is queued in "
        f"ROADMAP.md ({where})"
    )


def sharded_params(path: str):
    """The params of a committed sharded checkpoint, on the host: its
    "params" subtree for a train state, else the whole tree (a bare params
    save), as ray_tpu's warm start reads it. Refuses uncommitted
    directories."""
    tree = restore(path)
    return tree.get("params", tree) if isinstance(tree, dict) else tree


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
        if lora_config:
            raise _not_in_slice("lora_config (multi-LoRA serving)", "Queue 1, item 7")
        if tp != 1:
            raise _not_in_slice("tp > 1 (tensor-parallel serving)", "Queue 1, item 7")
        if cfg.fused_qkv or "qkv" in params.get("layer_0", {}).get("attn", {}):
            raise ValueError(
                "DecodeEngine reads separate q, k, v and gate, up matrices "
                "(layer['attn']['q'], as ray_tpu's engine does), so a fused_qkv "
                "model cannot be served by either; split qkv and gate_up first"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _tree_to(params, self.device)
        self.B = num_slots
        self.T = max_seq or cfg.max_seq
        self._np_rng = np.random.default_rng(seed)
        kv_shape = (self.B, self.T, cfg.n_kv_heads, cfg.head_dim)
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
        # instance is used as-is.
        if prefix_cache is None or prefix_cache is True:
            prefix_cache = None
            if CONFIG.llm_prefix_cache_bytes > 0:
                prefix_cache = PrefixCacheManager(
                    CONFIG.llm_kv_block_size, CONFIG.llm_prefix_cache_bytes,
                    name=f"engine-{id(self):x}",
                )
        self._prefix_cache = prefix_cache or None
        if max_queue_depth is None:
            max_queue_depth = CONFIG.llm_max_queue_depth
        if token_budget is None:
            token_budget = CONFIG.llm_sched_token_budget
        # The prefix-cache lookup is injected so admission plans chunks over
        # the uncached suffix only.
        lookup = None
        if self._prefix_cache is not None:
            cache = self._prefix_cache

            def lookup(prompt, adapter):
                return cache.lookup(prompt, namespace=adapter)

        self._sched = Scheduler(
            num_slots=self.B, buckets=self._prefill_buckets, max_seq=self.T,
            token_budget=token_budget, max_queue_depth=max_queue_depth,
            multi_step=self._multi_step, lookup=lookup, wfq=wfq,
            tenant_weights=tenant_weights, tenant_quota=tenant_quota,
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
        self._thread = None
        if decode_loop:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

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
        uncommitted (manifest-less) directories."""
        from ray_tpu_torch.models.convert import params_from_jax

        if tp != 1:
            raise _not_in_slice("tp > 1 (tensor-parallel serving)", "Queue 1, item 7")
        device = resolve_device(kwargs.get("device"))
        return cls(cfg, params_from_jax(sharded_params(path), cfg, device), tp=tp, **kwargs)

    # -- forward passes ----------------------------------------------------
    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _prefill_at(self, tokens: torch.Tensor, slot: int, offset: int,
                    total_len: int) -> torch.Tensor:
        """tokens: [1, Sbucket] right-padded, starting at row/position
        `offset` (0 = a prompt's first chunk; > 0 = a later chunk). Writes
        slot `slot`'s cache rows [offset, offset + S) in place and returns
        the logits row of prompt position total_len - 1."""
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
                                 self._dev([offset]), mask)
        # An intermediate chunk's row is discarded; clamp the index as JAX's
        # gather does.
        return logits[0, min(total_len - 1 - offset, S - 1)]

    def _decode_step(self, last_token: torch.Tensor, lens: torch.Tensor,
                     gate: torch.Tensor):
        """One token for every slot. last_token, lens: [B]; gate: [B] bool —
        only slots in the decode phase land their KV row (a slot mid-chunked-
        prefill rides through with a stale lens and must not write there).
        Returns (logits [B, V], lens + 1)."""
        positions = lens[:, None]
        # key j visible iff j <= lens (the new token writes at index lens)
        kv_mask = (torch.arange(self.T, device=self.device)[None, :]
                   <= lens[:, None])[:, None, :]
        logits = _forward_cached(self.params, self.cfg, last_token[:, None], positions,
                                 self._caches, lens, kv_mask, write_gate=gate)
        return logits[:, 0], lens + 1

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

        Returns the on-device argmax [B, k+1] (the host needs k+1 ints per
        slot, not logits)."""
        S = tokens.shape[1]
        positions = lens[:, None] + torch.arange(S, device=self.device)[None, :]
        kv_mask = (torch.arange(self.T, device=self.device)[None, None, :]
                   <= positions[:, :, None])
        logits = _forward_cached(self.params, self.cfg, tokens, positions, self._caches,
                                 lens, kv_mask, write_gate=gate)
        if constraint_mask is not None:
            logits = logits + constraint_mask
        return torch.argmax(logits, dim=-1)

    def _decode_multi(self, last_token: torch.Tensor, lens: torch.Tensor,
                      gate: torch.Tensor, n: int) -> torch.Tensor:
        """n greedy tokens for every slot with on-device argmax; the caller
        pulls the [n, B] result to the host once."""
        toks = []
        for _ in range(n):
            logits, lens = self._decode_step(last_token, lens, gate)
            last_token = torch.argmax(logits, dim=-1)
            toks.append(last_token)
        return torch.stack(toks)

    # -- public API --------------------------------------------------------
    def submit(self, token_ids: List[int], sampling: SamplingParams, callback,
               tenant: Optional[str] = None, request_id: Optional[str] = None,
               lora: str = "", constraint=None):
        """callback(token_id: int, finished: bool) per generated token.

        tenant keys the weighted-fair admission queue; request_id keys the
        flight-recorder record (`request_timing()`) and is the cancel()
        handle. constraint is a compiled guided-decoding constraint
        (`llm.generate.compile_constraint`: callers own the tokenizer, the
        engine owns the per-request state): its token masks fold into this
        request's host sampling rows and spec-verify argmax, and its state
        releases on finish, cancel, shutdown and stepper death. Raises
        ValueError when the prompt cannot fit the engine's sequence budget
        (it is never silently truncated) or the constraint was compiled for
        another logits width, EngineOverloadedError when the tenant's quota
        or the global depth cap is hit, and RuntimeError when the stepper is
        dead."""
        if lora:
            raise _not_in_slice("LoRA adapters", "Queue 1, item 7")
        self._check_alive()
        token_ids = list(token_ids) or [0]  # empty prompt decodes from token 0
        if len(token_ids) > self.T - 1:
            raise ValueError(
                f"prompt of {len(token_ids)} tokens exceeds this engine's "
                f"max_seq={self.T} budget (prompt_len <= max_seq - 1 so at "
                f"least one token can be generated); truncate the prompt "
                f"client-side or raise max_seq"
            )
        # The prompt is never truncated; a generation budget that would
        # overflow the KV rows shrinks max_tokens instead.
        headroom = self.T - 1 - len(token_ids)
        if sampling.max_tokens > headroom:
            sampling = dataclasses.replace(sampling, max_tokens=max(1, headroom))
        self._check_constraint(constraint)
        tenant = "" if tenant is None else tenant
        req = Request("prompt", prompt=token_ids, sampling=sampling, callback=callback,
                      tenant=tenant)
        req.rid = request_id
        req.rec = self._start_record(request_id, tenant, prompt_len=len(token_ids))
        if constraint is not None:
            req.constraint = constraint.begin(request_id or f"req-{id(req):x}")
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

    def open_stream(self, token_ids: List[int], sampling: SamplingParams, *,
                    tenant: Optional[str] = None, request_id: Optional[str] = None,
                    on_token=None, constraint=None, buffer_cap: Optional[int] = None):
        """Submit a request and return its `TokenStream` subscription
        instead of wiring a raw callback: per-token delivery through
        iteration/`get()` (buffered) or the `on_token` relay (the shape
        `LLMServer.generate_stream` uses). The stream's `close()`/`cancel()`
        is the mid-stream-disconnect path: it cancels the request, and the
        engine frees the slot, prefix lease and constraint state within one
        scheduler iteration. Every open_stream resolves through close()
        (iterating to exhaustion closes it)."""
        import uuid

        from ray_tpu_torch.llm.generate import TokenStream

        rid = request_id or f"stream-{uuid.uuid4().hex}"
        stream = TokenStream(self, rid, on_token=on_token, buffer_cap=buffer_cap)
        try:
            self.submit(token_ids, sampling, stream._push, tenant=tenant,
                        request_id=rid, constraint=constraint)
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
        cache.insert_missing(prompt[:n],
                             lambda first, stop: self._read_kv_blocks(slot, first, stop),
                             block_nbytes, namespace=adapter)

    def _read_kv_blocks(self, slot: int, first: int, stop: int) -> List[torch.Tensor]:
        """Host copies of slot's cache blocks [first, stop): one owned
        [L, 2, block_size, Hkv, D] tensor per block, the pool's layout. The
        rows are gathered block-major on the device and pulled in one copy;
        each block is then one contiguous host copy (the pool accounts every
        block's bytes, so no block may be a view of a shared buffer)."""
        bs = self._prefix_cache.block_size
        a, b = first * bs, stop * bs
        rows = torch.stack([torch.stack([ck[slot, a:b], cv[slot, a:b]])
                            for ck, cv in self._caches])
        L, _, _, H, D = rows.shape
        blocks = rows.view(L, 2, stop - first, bs, H, D).permute(2, 0, 1, 3, 4, 5)
        return [blk.clone() for blk in blocks.contiguous().cpu().unbind(0)]

    def prefix_cache_stats(self) -> Optional[dict]:
        """Hit/eviction/residency counters of the paged KV prefix cache (None
        when the cache is disabled)."""
        if self._prefix_cache is None:
            return None
        return self._prefix_cache.stats()

    def lease_prefix(self, token_ids: List[int], lora: str = ""):
        """Full-coverage lease of this engine's longest cached prefix of
        token_ids (no len-1 cap: the caller wants every cached row) — the
        export side of a prefix transfer. None when the cache is disabled or
        cold. The caller must release() the lease. Its caller is the DP/PD
        routers' prefix pull (ROADMAP.md, Queue 1 item 9)."""
        if lora:
            raise _not_in_slice("LoRA adapters", "Queue 1, item 7")
        if self._prefix_cache is None:
            return None
        return self._prefix_cache.lease_prefix(token_ids, namespace=0)

    def insert_prefix(self, token_ids: List[int], kv, lora: str = "") -> int:
        """Feed a prefix's KV rows [L, 2, P, Hkv, D] (numpy or a CPU tensor)
        fetched elsewhere into this engine's cache — the import side: the
        next lookup for these tokens hits locally and prefills suffix-only.
        Returns blocks added. The import side of the routers' prefix pull
        (ROADMAP.md, Queue 1 item 9)."""
        if lora:
            raise _not_in_slice("LoRA adapters", "Queue 1, item 7")
        if self._prefix_cache is None:
            return 0
        return self._prefix_cache.insert(token_ids, kv, namespace=0)

    def scheduler_stats(self) -> dict:
        """Iteration-level scheduler occupancy (per-phase token counters,
        interleaving, queue depths), speculative-decoding acceptance
        ("spec", with a draft), the prefix cache's counters and
        `recorder_stats()`."""
        out = self._sched.stats()
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

    def recorder_stats(self) -> dict:
        """Flight-recorder counters, and each tenant's SLO burn rate over its
        recent completions ("burn_rates": windowed breach fraction over
        llm_slo_error_budget, "" for untenanted traffic). ray_tpu reads the
        rates through `autopilot_signals()` and util.metrics gauges, which
        the port does not have yet (ROADMAP.md, Queue 1 items 8 and 9)."""
        return {**self._recorder.stats(),
                "burn_rates": self._serve_metrics.burn_rates()}

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
        submitters unwind instead of hanging; every slot's constraint state
        releases here, queued requests' prefix leases and constraint states
        in the scheduler's drain, and every live flight record retires as
        "dropped"."""
        for slot in self._sched.slots:
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
        still active or queued."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_all()

    # -- stepper -----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._prefill_buckets:
            if n <= b:
                return b
        return self.T

    def _attach_kv(self, slot: int, kv: torch.Tensor):
        """Write a cached KV prefix into slot's cache rows [0, P).
        kv: [L, 2, P, Hkv, D] on the host, owned by the caller. One H2D copy
        on the engine's stream; from pageable memory it returns once the
        rows are staged, so the caller may drop kv afterwards."""
        kv = kv.to(self.device)
        P = kv.shape[2]
        for i, (ck, cv) in enumerate(self._caches):
            ck[slot, :P] = kv[i, 0]
            cv[slot, :P] = kv[i, 1]

    def _exec_chunk(self, chunk: ScheduledChunk):
        """Dispatch one scheduled prefill chunk. The FIRST chunk of a
        cache-hit request attaches the leased prefix rows; the LAST chunk
        samples the request's first token (the one per-admission host pull),
        feeds the prompt's rows to the prefix cache and activates the
        slot."""
        req = chunk.request
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
            tier = req.lease.tier
            try:
                # lease.kv() is a new tensor: the copy reads no pool memory.
                self._attach_kv(slot, req.lease.kv())
            finally:
                req.lease.release()
                req.lease = None
            if rec is not None:
                # Host-stamped: the span covers the host concatenation and
                # the staged H2D copy.
                rec.span("cache-attach", t_attach, time.time(),
                         cached_tokens=req.cached_offset, tier=tier)
            self.last_attach = {"tier": tier, "cached_tokens": req.cached_offset}
        t_chunk = time.time()
        padded = np.zeros((1, chunk.bucket), np.int64)
        padded[0, : len(chunk.tokens)] = chunk.tokens
        last_logits = self._prefill_at(self._dev(padded), slot, offset, req.prompt_len)
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

    def _start_slot(self, req: Request, first: int):
        self._sched.start_decode(req, first)
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
            if self._draft is not None:
                self._draft.on_finish(slot, s)

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
            self._fail_all()
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
        greedy_dev = self._spec_verify_batched(
            self._dev(tokens), self._dev(self._lens), self._dev(gate),
            None if cmask is None else self._dev(cmask))
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
        logits, _ = self._decode_step(self._dev(self._last_token), self._dev(self._lens),
                                      self._dev(gate))
        # The step's one device->host pull: every slot's next-token logits.
        logits_np = logits.cpu().numpy()
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
        toks_dev = self._decode_multi(self._dev(self._last_token), self._dev(self._lens),
                                      self._dev(gate), n)
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
