"""ray_tpu_torch.llm: LLM serving on one GPU or over a tensor-parallel group, in process.

Twin of `ray_tpu/llm/__init__.py` for this slice: `LLMConfig`, `load_model`
and `LLMServer` (generate, with guided decoding, LoRA adapters and its
flight-recorder `timing` breakdown; generate_stream; load_lora; model_id;
cache_stats; scheduler_stats; adapter_stats; recorder_stats;
set_tenant_weight; autopilot_signals; shutdown) over the port's
`DecodeEngine`, speculative decoding through `LLMConfig.spec_config` and
multi-LoRA serving through `LLMConfig.lora_config`, and tensor parallelism
through `LLMConfig.tp`: every rank of a torch.distributed job of `tp`
processes (one GPU each) builds the `LLMServer`, which loads only the rank's
shards; rank 0 serves, and the others follow until rank 0's `shutdown`
(theirs returns then). The PD handoff runs on
the engines (`DecodeEngine.prefill_detached` and `submit_prefilled`). The
Serve deployment, the OpenAI router (with its `model="base:adapter"`
selection), the DP/PD routers, `export_prefix`/`import_prefix` and
`capture_profile` are later slices (ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import pickle
import time
import uuid
from typing import Any, Dict, List, Optional, Union

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm._engine import (
    DecodeEngine,
    EngineOverloadedError,
    SamplingParams,
    local_params,
)
from ray_tpu_torch.llm.adapters import AdapterCacheFullError, UnknownAdapterError
from ray_tpu_torch.llm.generate import ConstraintCompiler
from ray_tpu_torch.llm.tp import shard_decode_params, shard_leaf, tp_degree, tp_device_count

__all__ = [
    "AdapterCacheFullError",
    "ByteTokenizer",
    "DecodeEngine",
    "EngineOverloadedError",
    "LLMConfig",
    "LLMServer",
    "SamplingParams",
    "UnknownAdapterError",
    "load_model",
    "tp_device_count",
]


class ByteTokenizer:
    """Default zero-dependency tokenizer: UTF-8 bytes as token ids (vocab >= 256)."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> Optional[bytes]:
        """Exact byte rendering of one token (the guided-decoding byte-DFA
        keys its token masks on this). None marks an unrenderable id, which
        the mask then permanently disallows."""
        if 0 <= token_id < 256:
            return bytes([token_id])
        return None


@dataclasses.dataclass
class LLMConfig:
    """The fields of ray_tpu's LLMConfig that this slice honours, plus the
    device."""

    model_id: str = "test-tiny"
    model_config: Optional[Any] = None  # ModelConfig; defaults to get_config(model_id)
    # A committed sharded checkpoint (ray_tpu.checkpoint's format, written by
    # either package: a params tree or a train state holding "params"), or a
    # directory holding params.pkl (a nested dict of numpy arrays, the flax
    # param tree); None -> random weights from `seed`.
    checkpoint_path: Optional[str] = None
    num_slots: int = 4            # continuous-batching slots
    max_seq: Optional[int] = None
    tokenizer: Optional[Any] = None  # anything with encode/decode; None -> bytes
    seed: int = 0
    # Multi-LoRA serving: {"max_loras": N, "rank": r} and optionally
    # "cache_slots" or "cache_bytes" (the device table's size; adapters page
    # through it). Adapters register at runtime via LLMServer.load_lora and
    # are selected per request with generate(lora=name).
    lora_config: Optional[dict] = None
    # Speculative decoding: e.g. {"method": "ngram", "num_spec_tokens": 8}
    # for the zero-FLOP retrieval draft, or {"draft_layers": j} /
    # {"draft_cfg": ..., "draft_params": ...} for a draft model; {} with
    # only num_spec_tokens is the self-draft. None disables.
    spec_config: Optional[dict] = None
    tenant_weights: Optional[dict] = None
    wfq: bool = True
    tenant_quota: Optional[int] = None
    # Tensor parallelism: the engine's degree (or {"tp": N}). With N > 1
    # every rank of a torch.distributed job of N processes builds the server
    # on its own device; rank 0 serves.
    tp: Any = 1
    device: Optional[str] = None  # None -> CUDA (raises without a GPU)


def load_model(config: LLMConfig):
    """(cfg, params) for a config: the flax-layout param tree on the config's
    device, matrices stored in the model's activation dtype (bf16 copies of
    f32 checkpoints give the same math) and norm scales in f32. A sharded
    checkpoint warm-starts from its "params" subtree (or the whole tree, for
    a bare params save); only a committed one is accepted. With `tp` > 1
    (collective) the tree is this rank's shards, and the device never holds
    the whole tree: a sharded checkpoint's rank reads only its regions,
    params.pkl is sliced on the host, and random weights are drawn leaf by
    leaf (the draws of tp=1) with each leaf cut to the rank's block at once,
    so the peak is the shards and one whole leaf."""
    from ray_tpu_torch.checkpoint import is_sharded
    from ray_tpu_torch.models.convert import params_from_jax, unstack_layers
    from ray_tpu_torch.models.transformer import CONFIGS, draw_params, get_config, init_params

    device = resolve_device(config.device)
    cfg = config.model_config or get_config(
        config.model_id if config.model_id in CONFIGS else "test-tiny"
    )
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    tp = tp_degree(config.tp)
    rank = 0
    if tp > 1:
        import torch.distributed as dist

        rank = dist.get_rank()
    if config.checkpoint_path:
        if is_sharded(config.checkpoint_path):
            tree = local_params(config.checkpoint_path, tp, device)
        else:
            path = os.path.join(config.checkpoint_path, "params.pkl")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{config.checkpoint_path} holds neither a sharded checkpoint "
                    f"nor params.pkl"
                )
            # Trusted input: params.pkl is this framework's own weight format.
            with open(path, "rb") as f:
                tree = pickle.load(f)
            if tp > 1:
                if set(tree) == {"params"}:
                    tree = tree["params"]
                tree = shard_decode_params(unstack_layers(tree, cfg.n_layers), tp, rank, cfg)
        params = params_from_jax(tree, cfg, device)
    elif tp > 1:
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = {}
        for path, leaf in draw_params(cfg, gen, device):
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = shard_leaf(path, leaf, tp, rank)
            del leaf
    else:
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = init_params(cfg, gen, device)
    return cfg, params


class LLMServer:
    """One replica: engine + tokenizer, on one GPU or (LLMConfig.tp) on the
    caller's GPU as one rank of a tensor-parallel group, where rank 0's
    server answers and the others' raise."""

    def __init__(self, config: LLMConfig):
        cfg, params = load_model(config)
        self._cfg = cfg
        self._config = config
        if isinstance(config.tokenizer, str):
            raise NotImplementedError(
                "tokenizer by name (HuggingFace) is not in this slice of the port; "
                "pass an object with encode/decode"
            )
        self._tokenizer = config.tokenizer or ByteTokenizer()
        # Guided decoding: specs compile once per distinct schema/regex
        # against this replica's tokenizer and model vocab; every request
        # with the same spec reuses the DFA and its mask rows.
        self._constraints = ConstraintCompiler(self._tokenizer, cfg.vocab_size)
        self._engine = DecodeEngine(
            cfg, params, num_slots=config.num_slots,
            max_seq=config.max_seq or min(cfg.max_seq, 2048), seed=config.seed,
            lora_config=config.lora_config, spec_config=config.spec_config,
            wfq=config.wfq, tenant_weights=config.tenant_weights,
            tenant_quota=config.tenant_quota, tp=config.tp, device=config.device,
        )

    async def load_lora(self, name: str, layer_weights: dict, alpha: float = 1.0) -> int:
        """Register a LoRA adapter on this replica: layer index -> {"q_A":
        [M, r], "q_B": [r, H*D], "v_A": [M, r], "v_B": [r, Hkv*D]} numpy
        factors. Returns its stable uid; it pages onto the device on first
        use."""
        return self._engine.add_lora(name, layer_weights, alpha)

    async def generate(self, prompt: Union[str, List[int]], *,
                       max_tokens: int = 64, temperature: float = 0.0,
                       top_k: int = 0, stop_token_id: Optional[int] = None,
                       lora: str = "", tenant: Optional[str] = None,
                       guided=None) -> Dict[str, Any]:
        """lora: a registered adapter's name ("" = the base model).
        guided: a regex string, or {"regex": ...}, {"json_schema": ...},
        {"grammar": rules, "root": name} — the output is held to it."""
        t0 = time.monotonic()
        rid = uuid.uuid4().hex  # keys the engine's flight-recorder record
        constraint = self._constraints.get(guided) if guided is not None else None
        token_ids = (
            self._tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()
        out: List[int] = []
        ttft = [None]

        def cb(token: int, finished: bool):
            if ttft[0] is None:
                ttft[0] = time.monotonic() - t0
            out.append(token)
            if finished:
                loop.call_soon_threadsafe(
                    lambda: done.set_result(None) if not done.done() else None
                )

        self._engine.submit(
            token_ids,
            SamplingParams(max_tokens=max_tokens, temperature=temperature,
                           top_k=top_k, stop_token_id=stop_token_id),
            cb, lora=lora, tenant=tenant, request_id=rid, constraint=constraint,
        )
        await done
        gen = list(out)
        if stop_token_id is not None and gen and gen[-1] == stop_token_id:
            gen = gen[:-1]
        return {
            "text": self._tokenizer.decode(gen),
            "token_ids": gen,
            "usage": {
                "prompt_tokens": len(token_ids),
                "completion_tokens": len(gen),
                "total_tokens": len(token_ids) + len(gen),
            },
            "ttft_s": ttft[0],
            "latency_s": time.monotonic() - t0,
            # Flight-recorder phase breakdown: queue/prefill/decode seconds,
            # TTFT/TPOT.
            "timing": self._engine.request_timing(rid),
        }

    async def generate_stream(self, prompt: Union[str, List[int]], *,
                              max_tokens: int = 64, temperature: float = 0.0,
                              top_k: int = 0, stop_token_id: Optional[int] = None,
                              lora: str = "", tenant: Optional[str] = None,
                              request_id: Optional[str] = None, guided=None):
        """Async generator: yields text increments as tokens are decoded.

        Closing the generator mid-stream (client disconnect) cancels the
        engine request: GeneratorExit lands on the `await`, the finally
        closes the TokenStream, and close() retires the slot and releases
        the lease, adapter pin and constraint state within one scheduler
        iteration."""
        token_ids = (
            self._tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        constraint = self._constraints.get(guided) if guided is not None else None
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def cb(token: int, finished: bool):
            loop.call_soon_threadsafe(queue.put_nowait, (token, finished))

        stream = self._engine.open_stream(
            token_ids,
            SamplingParams(max_tokens=max_tokens, temperature=temperature,
                           top_k=top_k, stop_token_id=stop_token_id),
            lora=lora, tenant=tenant, request_id=request_id, on_token=cb,
            constraint=constraint,
        )
        # Incremental detokenization with a short prefix window: deltas come
        # from decode(prefix + pending) minus decode(prefix), so tokenizers
        # whose rendering depends on context stay correct across yield
        # boundaries without the O(N^2) full-prefix decode. Held back while
        # ending mid-codepoint so multi-byte characters emit whole.
        PREFIX = 8
        emitted: List[int] = []
        sent = 0  # tokens already covered by yielded text
        try:
            while True:
                token, finished = await queue.get()
                if token >= 0 and not (
                    finished and stop_token_id is not None and token == stop_token_id
                ):
                    emitted.append(token)
                prefix = emitted[max(0, sent - PREFIX):sent]
                cur = self._tokenizer.decode(prefix + emitted[sent:])
                base = self._tokenizer.decode(prefix) if prefix else ""
                delta = cur[len(base):]
                if delta.endswith("\ufffd") and not finished:
                    pass  # mid-codepoint: hold until the remaining bytes arrive
                elif delta:
                    yield delta
                    sent = len(emitted)
                if finished:
                    return
        finally:
            # No-op after a clean finish; on disconnect or error this is the
            # cancel path that frees the slot and the constraint state.
            stream.close()

    async def model_id(self) -> str:
        return self._config.model_id

    async def cache_stats(self) -> Optional[dict]:
        """Paged KV prefix-cache counters for this replica's engine (None when
        the cache is disabled)."""
        return self._engine.prefix_cache_stats()

    async def scheduler_stats(self) -> dict:
        """Iteration-level scheduler occupancy, speculative-decoding
        acceptance and per-tenant metering for this replica's engine."""
        return self._engine.scheduler_stats()

    async def adapter_stats(self) -> Optional[dict]:
        """AdapterCache residency and paging counters for this replica's
        engine (None without lora_config)."""
        return self._engine.adapter_stats()

    async def recorder_stats(self) -> dict:
        """Flight-recorder counters for this replica's engine, with each
        tenant's SLO burn rate ("burn_rates"; the targets are
        llm_slo_ttft_s, llm_slo_tpot_s and llm_slo_error_budget)."""
        return self._engine.recorder_stats()

    async def set_tenant_weight(self, tenant: str, weight: float) -> float:
        """Reshare one tenant's weighted-fair queue weight on this replica's
        engine (the serve autopilot's actuator). Returns the weight."""
        self._engine.set_tenant_weight(tenant, weight)
        return float(weight)

    async def autopilot_signals(self) -> dict:
        """Queue depth, occupancy and per-tenant SLO burn rates of this
        replica's engine (`DecodeEngine.autopilot_signals`)."""
        return self._engine.autopilot_signals()

    async def shutdown(self):
        """Stop the stepper and fail queued requests so blocked submitters
        unwind now. On a tensor-parallel follower it returns once rank 0's
        server has shut down."""
        self._engine.shutdown()
