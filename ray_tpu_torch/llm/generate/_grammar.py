"""Grammar -> regex lowering for guided decoding.

A copy of `ray_tpu/llm/generate/_grammar.py` (the port imports nothing of
ray_tpu), its depth cap read from the port's CONFIG.

A grammar is a dict of rule-name -> pattern fragments in the `_fsm` regex
subset, where `<rule>` references another rule. Rules lower to one flat
regex by bounded-recursion inlining: every reference substitutes its rule's
body (wrapped in a non-capturing group), up to `llm_guided_max_depth`
rounds. A reference that survives the budget means the grammar recurses
deeper than the DFA can bound — that is a compile-time `GrammarError`, not
a silent truncation (a constraint that cannot be enforced must never
degrade to unconstrained sampling).

This trades unbounded CFG recursion for a finite automaton, which is what
lets grammar constraints ride the exact same per-state token-mask machinery
as plain regex constraints (docs/generation.md; contrast xgrammar's pushdown
approach in docs/divergences.md).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

_REF = re.compile(r"<([A-Za-z_][A-Za-z0-9_]*)>")


class GrammarError(ValueError):
    """Unknown rule reference, or recursion beyond llm_guided_max_depth."""


def grammar_to_regex(rules: Dict[str, str], root: str = "root",
                     *, max_depth: Optional[int] = None) -> str:
    if max_depth is None:
        from ray_tpu_torch._config import CONFIG

        max_depth = CONFIG.llm_guided_max_depth
    if root not in rules:
        raise GrammarError(f"grammar has no root rule {root!r}")

    def substitute(match: "re.Match[str]") -> str:
        name = match.group(1)
        body = rules.get(name)
        if body is None:
            raise GrammarError(f"grammar references unknown rule <{name}>")
        return f"(?:{body})"

    pattern = f"(?:{rules[root]})"
    for _ in range(max(1, int(max_depth))):
        if not _REF.search(pattern):
            return pattern
        pattern = _REF.sub(substitute, pattern)
    if _REF.search(pattern):
        raise GrammarError(
            f"grammar recursion not bounded within llm_guided_max_depth="
            f"{max_depth} inlining rounds (unbounded CFG recursion cannot "
            f"compile to a finite token-mask DFA)"
        )
    return pattern


__all__ = ["GrammarError", "grammar_to_regex"]
