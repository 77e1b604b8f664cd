"""ray_tpu_torch.llm: LLM serving on one GPU, in process.

Twin of `ray_tpu/llm/__init__.py` for this slice: `LLMConfig`, `load_model`
and `LLMServer` (generate, with guided decoding and its flight-recorder
`timing` breakdown; generate_stream; recorder_stats; shutdown) over the
port's `DecodeEngine`, speculative decoding through `LLMConfig.spec_config`.
The Serve deployment, the OpenAI router and the DP/PD routers are later
slices (ROADMAP.md).
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
    sharded_params,
)
from ray_tpu_torch.llm.generate import ConstraintCompiler

__all__ = [
    "ByteTokenizer",
    "DecodeEngine",
    "EngineOverloadedError",
    "LLMConfig",
    "LLMServer",
    "SamplingParams",
    "load_model",
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
    # Speculative decoding: e.g. {"method": "ngram", "num_spec_tokens": 8}
    # for the zero-FLOP retrieval draft, or {"draft_layers": j} /
    # {"draft_cfg": ..., "draft_params": ...} for a draft model; {} with
    # only num_spec_tokens is the self-draft. None disables.
    spec_config: Optional[dict] = None
    tenant_weights: Optional[dict] = None
    wfq: bool = True
    tenant_quota: Optional[int] = None
    device: Optional[str] = None  # None -> CUDA (raises without a GPU)


def load_model(config: LLMConfig):
    """(cfg, params) for a config: the flax-layout param tree on the config's
    device, matrices stored in the model's activation dtype (bf16 copies of
    f32 checkpoints give the same math) and norm scales in f32. A sharded
    checkpoint warm-starts from its "params" subtree (or the whole tree, for
    a bare params save); only a committed one is accepted."""
    from ray_tpu_torch.checkpoint import is_sharded
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import CONFIGS, get_config, init_params

    device = resolve_device(config.device)
    cfg = config.model_config or get_config(
        config.model_id if config.model_id in CONFIGS else "test-tiny"
    )
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    if config.checkpoint_path:
        if is_sharded(config.checkpoint_path):
            tree = sharded_params(config.checkpoint_path)
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
        params = params_from_jax(tree, cfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = init_params(cfg, gen, device)
    return cfg, params


class LLMServer:
    """One GPU replica: engine + tokenizer."""

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
            spec_config=config.spec_config,
            wfq=config.wfq, tenant_weights=config.tenant_weights,
            tenant_quota=config.tenant_quota, device=config.device,
        )

    async def generate(self, prompt: Union[str, List[int]], *,
                       max_tokens: int = 64, temperature: float = 0.0,
                       top_k: int = 0, stop_token_id: Optional[int] = None,
                       tenant: Optional[str] = None, guided=None) -> Dict[str, Any]:
        """guided: a regex string, or {"regex": ...}, {"json_schema": ...},
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
            cb, tenant=tenant, request_id=rid, constraint=constraint,
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
                              tenant: Optional[str] = None,
                              request_id: Optional[str] = None, guided=None):
        """Async generator: yields text increments as tokens are decoded.

        Closing the generator mid-stream (client disconnect) cancels the
        engine request: GeneratorExit lands on the `await`, the finally
        closes the TokenStream, and close() retires the slot and releases
        the lease and constraint state within one scheduler iteration."""
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
            tenant=tenant, request_id=request_id, on_token=cb, constraint=constraint,
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

    async def recorder_stats(self) -> dict:
        """Flight-recorder counters for this replica's engine, with each
        tenant's SLO burn rate ("burn_rates"; the targets are
        llm_slo_ttft_s, llm_slo_tpot_s and llm_slo_error_budget)."""
        return self._engine.recorder_stats()

    async def shutdown(self):
        """Stop the stepper and fail queued requests so blocked submitters
        unwind now."""
        self._engine.shutdown()
