"""TokenConstraint protocol + the compiled constraint / per-request state.

Layering (docs/generation.md): callers that own a tokenizer (LLMServer,
EngineStage, the PD decode server) compile a guided spec into a `Constraint`
once — DFA construction and token-mask tables are compile-time work — and
hand the compiled object to `DecodeEngine.submit(constraint=...)`. The
engine calls `begin(request_id)` at admission and carries the returned
`ConstraintState` on the scheduler Request/Slot; per-token work on the
decode loop is one dict lookup (cached mask row) + one numpy vector add,
strictly host-side.

A copy of `ray_tpu/llm/generate/_constraint.py` (the port imports nothing
of ray_tpu) without its leaksan book-keeping: the port has no sanitizer.
Lifecycle contract: every `begin()` is balanced by exactly one `release()`
— on finish, cancel, drain, stepper death, or engine shutdown — and
`released` says whether it happened, which the tests read.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any, List, Optional, Protocol, runtime_checkable

import numpy as np

from ray_tpu_torch.llm.generate._fsm import (
    NEG_INF,
    TokenDFA,
    compile_pattern,
    token_byte_table,
)
from ray_tpu_torch.llm.generate._grammar import grammar_to_regex
from ray_tpu_torch.llm.generate._schema import schema_to_regex


@runtime_checkable
class TokenConstraint(Protocol):
    """What the engine needs from a compiled constraint: a per-request
    state factory. Any object with this shape plugs in — the built-in
    `Constraint` is the regex/schema/grammar DFA implementation."""

    def begin(self, request_id: str = "") -> "ConstraintState":
        ...


class ConstraintState:
    """One request's position in the constraint automaton. All methods run
    on whichever thread owns the request's current phase (submit thread,
    engine stepper) — the state is single-owner by construction, no lock."""

    __slots__ = ("_tdfa", "_state", "_rid", "_released")

    def __init__(self, tdfa: TokenDFA, request_id: str = ""):
        self._tdfa = tdfa
        self._state = tdfa.start()
        self._rid = request_id or f"cs-{id(self):x}"
        self._released = False

    def mask(self, stop_token_id: Optional[int] = None,
             budget: Optional[int] = None) -> np.ndarray:
        """Additive logits mask ([vocab] float32) for the NEXT token from
        the current state; the stop token is allowed only when accepting.
        `budget` = tokens the request may still emit INCLUDING this one —
        when set, the mask steers onto completable paths (docs/generation.md
        budget steering) so finite max_tokens can't truncate mid-pattern."""
        return self._tdfa.mask(self._state, stop_token_id, budget)

    def min_tokens_to_finish(self) -> int:
        """Lower bound on tokens still needed to reach an accepting state."""
        return self._tdfa.min_tokens_to_accept(self._state)

    def allows(self, token: int) -> bool:
        return self._tdfa.advance(self._state, token) >= 0

    def advance(self, token: int) -> bool:
        """Consume one emitted token; False means the token left the
        automaton (only possible for tokens the mask never offered)."""
        self._state = self._tdfa.advance(self._state, token)
        return self._state >= 0

    def is_complete(self) -> bool:
        """Accepting dead-end: nothing can legally extend the output, so
        the engine finishes the slot now (no stop token required)."""
        return self._tdfa.is_complete(self._state)

    def is_accepting(self) -> bool:
        return self._state in self._tdfa.dfa.accepting

    def proposal_masks(self, proposal, stop_token_id: Optional[int] = None,
                       length: Optional[int] = None,
                       budget: Optional[int] = None) -> List[np.ndarray]:
        """Per-position masks for a spec-decode verify round: row j is the
        mask after consuming proposal[:j] (a cloned walk — the real state
        only advances through the engine's _emit). Once a proposed token
        falls off the automaton the remaining rows are all-NEG_INF; the
        verifier's masked argmax already rejected at that position, so
        those rows are never consulted. `budget` is the remaining token
        budget at row 0; each later row has one token less."""
        n = len(proposal) + 1 if length is None else length
        rows: List[np.ndarray] = []
        state = self._state
        dead = np.full(self._tdfa.vocab, NEG_INF, np.float32)
        for j in range(n):
            b = None if budget is None else max(1, budget - j)
            rows.append(
                self._tdfa.mask(state, stop_token_id, b)
                if state >= 0 else dead
            )
            if j < len(proposal) and state >= 0:
                state = self._tdfa.advance(state, int(proposal[j]))
        return rows

    @property
    def released(self) -> bool:
        return self._released

    def release(self):
        """Idempotent: every end-of-life path (finish/cancel/drain/
        shutdown/stepper death) calls it."""
        self._released = True


class Constraint:
    """A compiled constraint: the shared TokenDFA plus spec metadata.
    Reusable across requests; `begin()` per request."""

    def __init__(self, tdfa: TokenDFA, spec: Any = None):
        self._tdfa = tdfa
        self.spec = spec
        self.vocab = tdfa.vocab

    def begin(self, request_id: str = "") -> ConstraintState:
        return ConstraintState(self._tdfa, request_id)


def _spec_pattern(spec: Any) -> str:
    """Normalize a guided spec to a regex pattern. Accepted shapes:
    a bare regex string; {"regex": pat}; {"json_schema": schema} (or the
    OpenAI response_format envelope {"type": "json_schema", "json_schema":
    {"schema": ...}}); {"grammar": rules, "root": name}."""
    if isinstance(spec, str):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(f"unsupported guided spec {type(spec).__name__}")
    if "regex" in spec:
        return str(spec["regex"])
    if "json_schema" in spec:
        schema = spec["json_schema"]
        if isinstance(schema, dict) and "schema" in schema:
            schema = schema["schema"]  # OpenAI response_format envelope
        return schema_to_regex(schema)
    if "schema" in spec:
        return schema_to_regex(spec["schema"])
    if "grammar" in spec:
        return grammar_to_regex(spec["grammar"], spec.get("root", "root"))
    raise ValueError(
        "guided spec needs one of: a regex string, or a dict with "
        "'regex' / 'json_schema' / 'schema' / 'grammar'"
    )


def compile_constraint(spec: Any, tokenizer, vocab_size: int) -> Constraint:
    """Spec -> Constraint against `tokenizer`'s token/byte mapping, with the
    mask rows sized to the MODEL vocab (`vocab_size` — logits width; ids the
    tokenizer cannot render are permanently masked)."""
    pattern = _spec_pattern(spec)
    dfa = compile_pattern(pattern)
    tdfa = TokenDFA(dfa, token_byte_table(tokenizer, vocab_size))
    return Constraint(tdfa, spec)


class ConstraintCompiler:
    """Bounded LRU of compiled constraints keyed by canonical spec JSON —
    repeated guided requests (the common serve shape: one schema, many
    calls) skip DFA construction entirely. One per server/tokenizer."""

    def __init__(self, tokenizer, vocab_size: int,
                 capacity: Optional[int] = None):
        if capacity is None:
            from ray_tpu_torch._config import CONFIG

            capacity = CONFIG.llm_guided_cache_entries
        self._tokenizer = tokenizer
        self._vocab = int(vocab_size)
        self._capacity = max(1, int(capacity))
        self._cache: "OrderedDict[str, Constraint]" = OrderedDict()

    def get(self, spec: Any) -> Constraint:
        try:
            key = json.dumps(spec, sort_keys=True, default=str)
        except TypeError:
            return compile_constraint(spec, self._tokenizer, self._vocab)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        built = compile_constraint(spec, self._tokenizer, self._vocab)
        self._cache[key] = built
        while len(self._cache) > self._capacity:
            self._cache.popitem(last=False)
        return built


__all__ = [
    "Constraint",
    "ConstraintCompiler",
    "ConstraintState",
    "TokenConstraint",
    "compile_constraint",
]
