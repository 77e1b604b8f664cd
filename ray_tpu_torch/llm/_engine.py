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

Not in this slice (each raises): LoRA adapters, speculative decoding, the
prefix cache, tensor parallelism, guided decoding, PD transfer, streams.
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
            raise _not_in_slice("lora_config (multi-LoRA serving)", "Queue 1, item 2")
        if spec_config:
            raise _not_in_slice("spec_config (speculative decoding)", "Queue 1, item 2")
        if prefix_cache:
            raise _not_in_slice("prefix_cache (paged KV prefix cache)", "Queue 1, item 2")
        if tp != 1:
            raise _not_in_slice("tp > 1 (tensor-parallel serving)", "Queue 1, item 2")
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
        if max_queue_depth is None:
            max_queue_depth = CONFIG.llm_max_queue_depth
        if token_budget is None:
            token_budget = CONFIG.llm_sched_token_budget
        self._sched = Scheduler(
            num_slots=self.B, buckets=self._prefill_buckets, max_seq=self.T,
            token_budget=token_budget, max_queue_depth=max_queue_depth,
            multi_step=self._multi_step, wfq=wfq, tenant_weights=tenant_weights,
            tenant_quota=tenant_quota,
        )
        # The stepper launches on the stream that was current here.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = None
        if decode_loop:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

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
            raise _not_in_slice("tp > 1 (tensor-parallel serving)", "Queue 1, item 2")
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

        tenant keys the weighted-fair admission queue; request_id is the
        cancel() handle. Raises ValueError when the prompt cannot fit the
        engine's sequence budget (it is never silently truncated),
        EngineOverloadedError when the tenant's quota or the global depth cap
        is hit, and RuntimeError when the stepper is dead."""
        if lora:
            raise _not_in_slice("LoRA adapters", "Queue 1, item 2")
        if constraint is not None:
            raise _not_in_slice("guided decoding", "Queue 1, item 2")
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
        req = Request("prompt", prompt=token_ids, sampling=sampling, callback=callback,
                      tenant="" if tenant is None else tenant)
        req.rid = request_id
        self._sched.submit(req)

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

    def scheduler_stats(self) -> dict:
        return self._sched.stats()

    @staticmethod
    def _fail_cancelled_request(req: Request):
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
        for s in self._sched.slots:
            if s.active and s.rid == rid:
                s.active = False
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
        submitters unwind instead of hanging."""
        for slot in self._sched.slots:
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

    def _exec_chunk(self, chunk: ScheduledChunk):
        """Dispatch one scheduled prefill chunk; the LAST chunk samples the
        request's first token (the one per-admission host pull) and
        activates the slot."""
        req = chunk.request
        slot = req.slot
        offset = req.prefilled
        padded = np.zeros((1, chunk.bucket), np.int64)
        padded[0, : len(chunk.tokens)] = chunk.tokens
        last_logits = self._prefill_at(self._dev(padded), slot, offset, req.prompt_len)
        self._sched.chunk_done(chunk)
        # The host lens mirror advances with every chunk: the decode write
        # gate keeps interleaved decode dispatches off a mid-prefill slot,
        # and an accurate lens is the backstop.
        self._lens[slot] = req.prefilled
        if not chunk.is_last:
            return
        first_row = last_logits.cpu().numpy()
        first = _sample_host(first_row, req.sampling, self._np_rng)
        self._start_slot(req, first)

    def _start_slot(self, req: Request, first: int):
        self._sched.start_decode(req, first)
        self._last_token[req.slot] = first
        self._emit(req.slot, first)

    def _emit(self, slot: int, token: int):
        s = self._sched.slots[slot]
        done = (
            s.generated >= s.params.max_tokens
            or (s.params.stop_token_id is not None and token == s.params.stop_token_id)
        )
        self._sched.note_emitted(slot)
        try:
            s.callback(token, done)
        except Exception:
            done = True
        if done:
            s.active = False

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
        """Execute one scheduler plan per iteration: prefill chunks, then the
        batched decode phase."""
        while not self._stop:
            self._process_cancels()
            plan = self._sched.next_plan()
            if plan.idle:
                time.sleep(0.002)
                continue
            for chunk in plan.chunks:
                self._exec_chunk(chunk)
            if plan.decode_slots:
                if plan.multi_step > 1:
                    self._multi_round(plan.decode_slots, plan.multi_step)
                else:
                    self._decode_round(plan.decode_slots)

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
            token = _sample_host(logits_np[i], s.params, self._np_rng)
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
