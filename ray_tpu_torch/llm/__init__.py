"""ray_tpu_torch.llm: LLM serving on one GPU, in process.

Twin of `ray_tpu/llm/__init__.py` for this slice: `LLMConfig`, `load_model`
and `LLMServer` (generate / shutdown) over the port's `DecodeEngine`. The
Serve deployment, the OpenAI router, the DP/PD routers, streaming and the
flight-recorder `timing` breakdown are later slices (ROADMAP.md).
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
        self._engine = DecodeEngine(
            cfg, params, num_slots=config.num_slots,
            max_seq=config.max_seq or min(cfg.max_seq, 2048), seed=config.seed,
            wfq=config.wfq, tenant_weights=config.tenant_weights,
            tenant_quota=config.tenant_quota, device=config.device,
        )

    async def generate(self, prompt: Union[str, List[int]], *,
                       max_tokens: int = 64, temperature: float = 0.0,
                       top_k: int = 0, stop_token_id: Optional[int] = None,
                       tenant: Optional[str] = None) -> Dict[str, Any]:
        t0 = time.monotonic()
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
            cb, tenant=tenant, request_id=uuid.uuid4().hex,
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
        }

    async def shutdown(self):
        """Stop the stepper and fail queued requests so blocked submitters
        unwind now."""
        self._engine.shutdown()
