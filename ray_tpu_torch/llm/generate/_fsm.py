"""Byte-level regex -> DFA compiler with per-state token masks.

A copy of `ray_tpu/llm/generate/_fsm.py` (numpy only; the port imports
nothing of ray_tpu), its state cap read from the port's CONFIG.

The guided-decoding core (docs/generation.md): a constraint pattern is
compiled ONCE into a byte-alphabet DFA (Thompson NFA -> subset construction
over byte equivalence classes), and each DFA state lazily materializes one
additive logits mask row: token t is allowed in state s iff walking t's
UTF-8 bytes from s stays inside live states (states from which an accepting
state is still reachable). Disallowed tokens get `_NEG_INF` so a masked
argmax/softmax can never pick them.

Everything here is host-side numpy — the decode hot path adds one vector add
per guided slot and never touches a device handle or a metric (distsan
clean). The design matches Outlines/xgrammar's index-based approach, except
the masks live host-side against the engine's host logits readback instead
of as device bitmask kernels (docs/divergences.md).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

NEG_INF = -1e30  # matches the engine's _NEG_INF (llm/_engine.py)

_SPECIALS = set("\\.^$*+?{}[]()|")


def escape_literal(text: str) -> str:
    """Escape `text` so the pattern matches it verbatim."""
    return "".join("\\" + c if c in _SPECIALS else c for c in text)


# -- pattern AST --------------------------------------------------------------


class _Lit:
    __slots__ = ("bytes_",)

    def __init__(self, bytes_: FrozenSet[int]):
        self.bytes_ = bytes_


class _Concat:
    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts


class _Alt:
    __slots__ = ("options",)

    def __init__(self, options: list):
        self.options = options


class _Repeat:
    __slots__ = ("node", "lo", "hi")  # hi None = unbounded

    def __init__(self, node, lo: int, hi: Optional[int]):
        self.node = node
        self.lo = lo
        self.hi = hi


_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C])
_ALL = frozenset(range(256))
_ESCAPES = {
    "d": _DIGITS, "D": _ALL - _DIGITS,
    "w": _WORD, "W": _ALL - _WORD,
    "s": _SPACE, "S": _ALL - _SPACE,
    "n": frozenset([0x0A]), "t": frozenset([0x09]), "r": frozenset([0x0D]),
    "f": frozenset([0x0C]), "v": frozenset([0x0B]), "0": frozenset([0x00]),
}


class PatternError(ValueError):
    """The pattern uses syntax outside the supported regex subset."""


class _Parser:
    """Recursive-descent parser for the supported regex subset: literals,
    escapes (\\d \\w \\s and friends), char classes with ranges and negation,
    `.`, groups `(...)` / `(?:...)`, alternation `|`, and the quantifiers
    `*` `+` `?` `{m}` `{m,}` `{m,n}`. Non-ASCII literals compile to their
    UTF-8 byte sequence; the whole pattern is matched fullmatch-style."""

    def __init__(self, pattern: str):
        self._p = pattern
        self._i = 0

    def parse(self):
        node = self._alt()
        if self._i != len(self._p):
            raise PatternError(
                f"unexpected {self._p[self._i]!r} at {self._i} in pattern"
            )
        return node

    def _peek(self) -> str:
        return self._p[self._i] if self._i < len(self._p) else ""

    def _take(self) -> str:
        c = self._peek()
        self._i += 1
        return c

    def _alt(self):
        options = [self._concat()]
        while self._peek() == "|":
            self._take()
            options.append(self._concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def _concat(self):
        parts = []
        while self._peek() not in ("", "|", ")"):
            parts.append(self._quantified())
        if len(parts) == 1:
            return parts[0]
        return _Concat(parts)

    def _quantified(self):
        node = self._atom()
        c = self._peek()
        if c == "*":
            self._take()
            return _Repeat(node, 0, None)
        if c == "+":
            self._take()
            return _Repeat(node, 1, None)
        if c == "?":
            self._take()
            return _Repeat(node, 0, 1)
        if c == "{":
            j = self._p.find("}", self._i)
            body = self._p[self._i + 1:j] if j >= 0 else ""
            if j >= 0 and body and all(ch.isdigit() or ch == "," for ch in body):
                self._i = j + 1
                if "," not in body:
                    lo = hi = int(body)
                elif body.endswith(","):
                    lo, hi = int(body[:-1]), None
                else:
                    lo_s, hi_s = body.split(",", 1)
                    lo, hi = int(lo_s or 0), int(hi_s)
                if hi is not None and hi < lo:
                    raise PatternError(f"bad repetition {{{body}}}")
                return _Repeat(node, lo, hi)
            # a bare "{" with no counted-repetition body is a literal
        return node

    def _atom(self):
        c = self._take()
        if c == "":
            raise PatternError("pattern ended unexpectedly")
        if c == "(":
            if self._peek() == "?":
                self._take()
                if self._take() != ":":
                    raise PatternError("only (?:...) groups are supported")
            node = self._alt()
            if self._take() != ")":
                raise PatternError("unbalanced parenthesis")
            return node
        if c == "[":
            return _Lit(self._char_class())
        if c == ".":
            return _Lit(_ALL - frozenset([0x0A]))
        if c == "\\":
            return _Lit(self._escape())
        if c in ")|":
            raise PatternError(f"unexpected {c!r}")
        return self._literal_char(c)

    def _literal_char(self, c: str):
        data = c.encode("utf-8")
        if len(data) == 1:
            return _Lit(frozenset([data[0]]))
        return _Concat([_Lit(frozenset([b])) for b in data])

    def _escape(self) -> FrozenSet[int]:
        c = self._take()
        if c == "":
            raise PatternError("dangling backslash")
        if c in _ESCAPES:
            return _ESCAPES[c]
        if c == "x":
            hx = self._take() + self._take()
            try:
                return frozenset([int(hx, 16)])
            except ValueError:
                raise PatternError(f"bad \\x escape {hx!r}")
        data = c.encode("utf-8")
        if len(data) != 1:
            raise PatternError(f"non-ASCII escape \\{c!r}")
        return frozenset([data[0]])

    def _class_item(self) -> Tuple[Set[int], Optional[int]]:
        """One class member: (byte set, the single byte when it is one —
        usable as a range endpoint, including escaped endpoints like \\x1f)."""
        c = self._take()
        if c == "":
            raise PatternError("unterminated character class")
        if c == "\\":
            bs = self._escape()
            return set(bs), next(iter(bs)) if len(bs) == 1 else None
        data = c.encode("utf-8")
        if len(data) != 1:
            raise PatternError("non-ASCII char in class")
        return {data[0]}, data[0]

    def _char_class(self) -> FrozenSet[int]:
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        members: Set[int] = set()
        first = True
        while True:
            if self._peek() == "]" and not first:
                self._take()
                break
            first = False
            bs, lo = self._class_item()
            if lo is not None and self._peek() == "-" \
                    and self._i + 1 < len(self._p) \
                    and self._p[self._i + 1] != "]":
                self._take()
                _hi_bs, hi = self._class_item()
                if hi is None or hi < lo:
                    raise PatternError("bad character range")
                members |= set(range(lo, hi + 1))
            else:
                members |= bs
        return frozenset(_ALL - members if negate else members)


# -- NFA ----------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _build(nfa: _NFA, node, start: int) -> int:
    """Wire `node` from `start`; returns the fragment's accept state."""
    if isinstance(node, _Lit):
        end = nfa.state()
        nfa.edges[start].append((node.bytes_, end))
        return end
    if isinstance(node, _Concat):
        cur = start
        for part in node.parts:
            cur = _build(nfa, part, cur)
        return cur
    if isinstance(node, _Alt):
        end = nfa.state()
        for opt in node.options:
            s = nfa.state()
            nfa.eps[start].append(s)
            nfa.eps[_build(nfa, opt, s)].append(end)
        return end
    if isinstance(node, _Repeat):
        cur = start
        for _ in range(node.lo):
            cur = _build(nfa, node.node, cur)
        if node.hi is None:
            loop = nfa.state()
            nfa.eps[cur].append(loop)
            body_end = _build(nfa, node.node, loop)
            nfa.eps[body_end].append(loop)
            return loop
        ends = [cur]
        for _ in range(node.hi - node.lo):
            cur = _build(nfa, node.node, cur)
            ends.append(cur)
        end = nfa.state()
        for e in ends:
            nfa.eps[e].append(end)
        return end
    raise PatternError(f"unknown pattern node {type(node).__name__}")


# -- DFA ----------------------------------------------------------------------


_DIST_INF = 1 << 30  # dist value for states that can never reach accept


class ByteDFA:
    """Deterministic byte automaton: `trans[state][byte_class] -> state | -1`,
    with `accepting` / `live` state sets and `dist[state]` = minimum bytes
    from the state to SOME accepting state (_DIST_INF for non-live states).
    State 0 is the start state."""

    __slots__ = ("trans", "accepting", "live", "byte_class", "n_classes",
                 "dist")

    def __init__(self, trans, accepting, live, byte_class, n_classes, dist):
        self.trans = trans              # List[List[int]]  (-1 = dead)
        self.accepting = accepting      # Set[int]
        self.live = live                # Set[int]
        self.byte_class = byte_class    # List[int] len 256
        self.n_classes = n_classes
        self.dist = dist                # List[int], bytes-to-accept

    def step(self, state: int, byte: int) -> int:
        if state < 0:
            return -1
        nxt = self.trans[state][self.byte_class[byte]]
        if nxt >= 0 and nxt not in self.live:
            return -1
        return nxt

    def walk(self, state: int, data: bytes) -> int:
        for b in data:
            state = self.step(state, b)
            if state < 0:
                return -1
        return state


def compile_pattern(pattern: str, *, max_states: Optional[int] = None) -> ByteDFA:
    """Pattern -> ByteDFA (fullmatch semantics). `max_states` bounds subset
    construction (default `llm_guided_max_states`) so an adversarial pattern
    cannot grow compile memory without limit."""
    if max_states is None:
        from ray_tpu_torch._config import CONFIG

        max_states = CONFIG.llm_guided_max_states
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start = nfa.state()
    accept = _build(nfa, ast, start)

    # Byte equivalence classes: bytes with identical membership across every
    # NFA edge set transition identically, so subset construction (and the
    # DFA table) runs over ~dozens of classes instead of 256 raw bytes.
    sets = {bs for edges in nfa.edges for bs, _ in edges}
    sig_to_class: Dict[tuple, int] = {}
    byte_class = [0] * 256
    for b in range(256):
        sig = tuple(b in bs for bs in sets)
        cls = sig_to_class.setdefault(sig, len(sig_to_class))
        byte_class[b] = cls
    n_classes = max(1, len(sig_to_class))
    class_rep = [0] * n_classes  # one representative byte per class
    for b in range(255, -1, -1):
        class_rep[byte_class[b]] = b

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    dfa_ids: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    trans: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = [-1] * n_classes
        for cls in range(n_classes):
            b = class_rep[cls]
            nxt = set()
            for s in cur:
                for bs, t in nfa.edges[s]:
                    if b in bs:
                        nxt.add(t)
            if nxt:
                key = closure(frozenset(nxt))
                if key not in dfa_ids:
                    if len(order) >= max_states:
                        raise PatternError(
                            f"pattern compiles to more than "
                            f"llm_guided_max_states={max_states} DFA states"
                        )
                    dfa_ids[key] = len(order)
                    order.append(key)
                row[cls] = dfa_ids[key]
        trans.append(row)
    accepting = {dfa_ids[k] for k in order if accept in k}

    # Live states: accepting reachable. Walks that leave this set can never
    # complete the pattern, so their tokens are masked out.
    rev: Dict[int, Set[int]] = {}
    for s, row in enumerate(trans):
        for t in row:
            if t >= 0:
                rev.setdefault(t, set()).add(s)
    live = set(accepting)
    stack = list(accepting)
    while stack:
        s = stack.pop()
        for p in rev.get(s, ()):
            if p not in live:
                live.add(p)
                stack.append(p)

    # Distance-to-accept (bytes): reverse BFS from the accepting set. The
    # budget-steering mask (TokenDFA.mask with budget=) uses this to force
    # generation onto a path that can still COMPLETE the pattern within the
    # request's remaining max_tokens — without it, an unbounded quantifier
    # (JSON integers, string bodies) can eat the whole budget and truncate
    # mid-pattern.
    dist = [_DIST_INF] * len(trans)
    frontier = list(accepting)
    for s in frontier:
        dist[s] = 0
    d = 0
    while frontier:
        d += 1
        nxt: List[int] = []
        for s in frontier:
            for p in rev.get(s, ()):
                if dist[p] > d:
                    dist[p] = d
                    nxt.append(p)
        frontier = nxt
    return ByteDFA(trans, accepting, live, byte_class, n_classes, dist)


# -- token-level view ---------------------------------------------------------


def token_byte_table(tokenizer, vocab_size: int) -> List[Optional[bytes]]:
    """Per-token-id byte sequences for `tokenizer`. Prefers an explicit
    `token_bytes(tid)` method (exact bytes — ByteTokenizer implements it);
    falls back to single-token decode, skipping ids whose decode is lossy
    (the U+FFFD replacement char) — those ids are simply never allowed under
    a constraint. Ids past the tokenizer's own vocab are None (masked)."""
    n_tok = int(getattr(tokenizer, "vocab_size", vocab_size) or vocab_size)
    table: List[Optional[bytes]] = []
    has_bytes = hasattr(tokenizer, "token_bytes")
    for tid in range(vocab_size):
        if tid >= n_tok:
            table.append(None)
            continue
        if has_bytes:
            try:
                table.append(bytes(tokenizer.token_bytes(tid)))
            except Exception:
                table.append(None)
            continue
        text = tokenizer.decode([tid])
        if not text or "�" in text:
            table.append(None)
        else:
            table.append(text.encode("utf-8"))
    return table


class TokenDFA:
    """A ByteDFA lifted to the token alphabet: per-DFA-state additive logits
    masks ([vocab] float32, 0 allowed / NEG_INF disallowed), built lazily on
    first visit and cached — steady-state guided decoding is one dict lookup
    plus one vector add per emitted token."""

    def __init__(self, dfa: ByteDFA, token_bytes: List[Optional[bytes]]):
        self.dfa = dfa
        self.vocab = len(token_bytes)
        self._token_bytes = token_bytes
        self._masks: Dict[Tuple[int, Optional[int]], np.ndarray] = {}
        self._complete: Dict[int, bool] = {}
        # Per-state [vocab] int32: dist-to-accept of the state each token
        # lands in (_DIST_INF for disallowed tokens). Built alongside the
        # base mask; budget steering is one vectorized compare against it.
        self._next_dist: Dict[int, np.ndarray] = {}

    def start(self) -> int:
        return 0 if 0 in self.dfa.live else -1

    def advance(self, state: int, token: int) -> int:
        tb = self._token_bytes[token] if 0 <= token < self.vocab else None
        if tb is None:
            return -1
        return self.dfa.walk(state, tb)

    def _base_mask(self, state: int) -> np.ndarray:
        mask = np.full(self.vocab, NEG_INF, np.float32)
        nd = np.full(self.vocab, _DIST_INF, np.int64)
        if state >= 0:
            for tid, tb in enumerate(self._token_bytes):
                if tb:
                    end = self.dfa.walk(state, tb)
                    if end >= 0:
                        mask[tid] = 0.0
                        nd[tid] = self.dfa.dist[end]
        self._next_dist[state] = nd
        return mask

    def min_tokens_to_accept(self, state: int) -> int:
        """Lower bound on tokens needed to reach an accepting state (every
        token consumes >= 1 byte, so the byte distance bounds it; for a
        byte-level tokenizer it is exact). _DIST_INF when unreachable."""
        if state < 0:
            return _DIST_INF
        return self.dfa.dist[state]

    def mask(self, state: int, stop_token_id: Optional[int] = None,
             budget: Optional[int] = None) -> np.ndarray:
        key = (state, stop_token_id)
        cached = self._masks.get(key)
        if cached is None:
            base = self._masks.get((state, None))
            if base is None:
                base = self._masks[(state, None)] = self._base_mask(state)
            if stop_token_id is None:
                cached = base
            else:
                cached = base
                if state in self.dfa.accepting \
                        and 0 <= stop_token_id < self.vocab:
                    cached = base.copy()
                    cached[stop_token_id] = 0.0
                self._masks[key] = cached
        if budget is None or state < 0:
            return cached
        # Budget steering: with `budget` tokens left (including the one this
        # mask samples), only offer tokens whose landing state can still
        # finish within budget-1 MORE tokens — the pattern then completes
        # (or hits an accepting prefix) before max_tokens truncates it.
        # When the state can't finish within budget at all, or steering
        # would strand a tokenizer with no byte-granular path, fall back to
        # the plain mask: a legal prefix beats an illegal token.
        if self.dfa.dist[state] > budget:
            return cached
        nd = self._next_dist.get(state)
        if nd is None:
            self._base_mask(state)
            nd = self._next_dist[state]
        tight = np.where(nd <= budget - 1, cached, np.float32(NEG_INF))
        if stop_token_id is not None and state in self.dfa.accepting \
                and 0 <= stop_token_id < self.vocab:
            tight[stop_token_id] = 0.0
        if not np.any(tight > NEG_INF / 2):
            return cached
        return tight

    def is_complete(self, state: int) -> bool:
        """Accepting with no live continuation: generation MUST stop here
        (the engine finishes the slot without needing a stop token)."""
        if state not in self.dfa.accepting:
            return False
        done = self._complete.get(state)
        if done is None:
            row = self.dfa.trans[state]
            done = not any(t >= 0 and t in self.dfa.live for t in row)
            self._complete[state] = done
        return done


__all__ = [
    "ByteDFA",
    "NEG_INF",
    "PatternError",
    "TokenDFA",
    "compile_pattern",
    "escape_literal",
    "token_byte_table",
]
