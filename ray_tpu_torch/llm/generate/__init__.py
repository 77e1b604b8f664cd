"""ray_tpu_torch.llm.generate: generation modes riding the one decode scheduler.

A copy of `ray_tpu/llm/generate/` with the same exports (the port imports
nothing of ray_tpu):

- **Guided decoding** — `compile_constraint` / `Constraint` /
  `ConstraintState`: regex, JSON-schema and grammar specs compile to a
  byte-DFA whose per-state token masks fold into the engine's host sampling
  row and the batched spec-verify argmax (token-identical to unconstrained
  greedy whenever the unconstrained argmax is already legal).
- **Token streaming** — `TokenStream` from `DecodeEngine.open_stream`: the
  cancellable per-token subscription behind `LLMServer.generate_stream`;
  closing it mid-stream cancels the request and frees the slot.
"""

from ray_tpu_torch.llm.generate._constraint import (
    Constraint,
    ConstraintCompiler,
    ConstraintState,
    TokenConstraint,
    compile_constraint,
)
from ray_tpu_torch.llm.generate._fsm import (
    PatternError,
    compile_pattern,
    escape_literal,
    token_byte_table,
)
from ray_tpu_torch.llm.generate._grammar import GrammarError, grammar_to_regex
from ray_tpu_torch.llm.generate._schema import SchemaError, schema_to_regex
from ray_tpu_torch.llm.generate._stream import StreamClosed, TokenStream

__all__ = [
    "Constraint",
    "ConstraintCompiler",
    "ConstraintState",
    "GrammarError",
    "PatternError",
    "SchemaError",
    "StreamClosed",
    "TokenConstraint",
    "TokenStream",
    "compile_constraint",
    "compile_pattern",
    "escape_literal",
    "grammar_to_regex",
    "schema_to_regex",
    "token_byte_table",
]
