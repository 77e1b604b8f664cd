"""The serving defaults the engine and scheduler read.

Copied (not imported) from the `llm_*` rows of ray_tpu's flag table
(`ray_tpu/_private/config.py`), with the same names and values.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # smallest prompt padding bucket for prefill chunks
    llm_prefill_bucket_min: int = 16
    # decode tokens per engine dispatch when every active slot is greedy
    # (on-device argmax chunks; 1 disables)
    llm_multi_step: int = 8
    # per-iteration scheduler token budget: decode tokens are reserved first,
    # the remainder is granted to bucketed prefill chunks (0 = whole prompts)
    llm_sched_token_budget: int = 256
    # engine admission queue cap (0 = unbounded)
    llm_max_queue_depth: int = 256
    # per-tenant admission quota on the weighted-fair queues (0 disables)
    llm_tenant_max_queue_depth: int = 64
    # the WFQ tenant offline batch traffic is admitted under, and its pinned
    # floor weight
    llm_batch_tenant: str = "batch"
    llm_batch_weight: float = 1e-6
    # token rows per paged KV prefix-cache block; prefixes are reused at
    # whole-block granularity
    llm_kv_block_size: int = 16
    # host bytes for the per-engine paged KV prefix cache; repeated prompt
    # prefixes attach cached KV and prefill suffix-only (0 disables)
    llm_prefix_cache_bytes: int = 32 << 20
    # finished request records kept in each engine's flight-recorder ring:
    # per-request phase events (queue/prefill-chunk/cache-attach/decode)
    # recorded host-side off the dispatch path (0 disables the recorder)
    llm_flight_records: int = 256
    # time-to-first-token SLO: completions whose TTFT exceeds this count as
    # SLO breaches in the burn/goodput counters
    llm_slo_ttft_s: float = 0.5
    # per-request mean inter-token-latency SLO: completions whose mean TPOT
    # exceeds this count as SLO breaches
    llm_slo_tpot_s: float = 0.05
    # allowed SLO breach fraction: burn rate = windowed breach fraction /
    # this budget, so burn > 1 means the error budget is being exhausted
    llm_slo_error_budget: float = 0.01
    # trailing n-gram length the ngram speculative draft matches against the
    # slot history and the cross-request continuation store
    llm_spec_ngram: int = 3
    # bounded LRU entries in the ngram draft's cross-request continuation
    # store (0 disables the shared store, leaving prompt lookup only)
    llm_spec_store_entries: int = 4096
    # DFA state cap for guided-decoding constraint compilation: a spec whose
    # subset construction exceeds it raises at compile time
    llm_guided_max_states: int = 4096
    # bounded-recursion inlining rounds for grammar constraints: a <rule>
    # reference surviving this many rounds is unbounded recursion and fails
    llm_guided_max_depth: int = 8
    # compiled-constraint LRU entries per server/tokenizer
    llm_guided_cache_entries: int = 32
    # undelivered buffered tokens a TokenStream holds before cancelling its
    # own request (0 disables the guard)
    llm_stream_buffer_tokens: int = 4096


CONFIG = Config()
