"""Draft providers for scheduler-scheduled speculative decoding.

A copy of `ray_tpu/llm/scheduler/spec.py` (the port imports nothing of
ray_tpu): `DraftProvider` and `NGramDraft` are numpy, copied as they are;
`ModelDraft` keeps its KV caches as torch tensors on the engine's device and
runs the engine's eager forward (`_engine._forward_cached`) where JAX
compiles programs.

The engine's spec phase is draft-agnostic: each iteration the scheduler asks
the provider for up to `k` proposed tokens per eligible slot, the engine
verifies every participating slot in ONE batched target forward, and the
longest matching prefix (plus the target's correction token) is emitted —
greedy output is token-identical to plain decode by construction.

Two providers:

- `NGramDraft` — retrieval speculation (vLLM's prompt-lookup / ngram
  speculator, REST's datastore shape): proposals come from suffix-matching
  the slot's own token history plus a bounded cross-request continuation
  store. Greedy decode is deterministic, so repeated traffic (the same
  workload the prefix cache serves on the prefill side) re-proposes earlier
  completions at near-full acceptance — and the draft costs ZERO device
  dispatches. Composes with prefix-cache hits trivially: the draft needs
  only token ids, which the admission path always has.

- `ModelDraft` — a draft MODEL proposes k tokens greedily (the vLLM
  draft-worker shape; JAX runs the k steps as one lax.scan program, the
  port as a Python loop of single-token forwards): an external tiny model,
  the target itself (self-draft: the all-accept upper bound used in
  tests), or an EAGLE-style early-exit head built by `early_exit_draft` —
  the target's first j layers + final norm + output head, every parameter
  shared with the target, so the draft costs ~j/L of a target forward and
  no extra device memory for weights. A slot admitted through a
  prefix-cache hit catches the draft cache up with one full-prompt draft
  prefill instead of downgrading to plain decode.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.llm._engine import _forward_cached


class DraftProvider:
    """Interface the scheduler/engine drive. `propose` may return None (no
    speculation for that slot this iteration — it decodes plainly)."""

    kind = "none"
    k = 0

    def eligible(self, slot_idx: int, slot) -> bool:
        raise NotImplementedError

    def propose(self, slot_idx: int, slot) -> Optional[np.ndarray]:
        raise NotImplementedError

    def on_admit(self, slot_idx: int, prompt: List[int]):
        """Prompt fully attached/prefilled on the target; sync draft state."""

    def on_accept(self, slot_idx: int, slot, base_len: int,
                  proposed: np.ndarray, accepted: int):
        """Post-verify bookkeeping. base_len = target host_len before the
        round; accepted = length of the matched proposal prefix."""

    def on_plain_decode(self, slot_idx: int):
        """The slot advanced without the draft (plain/multi-step decode)."""

    def on_finish(self, slot_idx: int, slot):
        """The slot's request completed."""

    def stats(self) -> dict:
        return {"kind": self.kind, "k": self.k}


class NGramDraft(DraftProvider):
    """Zero-FLOP retrieval draft: propose the continuation that followed the
    history's trailing n-gram — in this request (prompt lookup) or in any
    recent request (cross-request store; greedy decode is deterministic, so
    repeats verify at full length).

    Matching is LONGEST-SUFFIX-first across several n-gram levels (REST's
    suffix-matching shape approximated with a small ladder of hash tables):
    a short n-gram aliases badly in self-similar text (a run of one token
    maps to many continuations), while a 16-gram match almost uniquely
    pins the position in the source sequence — measured on this repo's
    tiny-model streams, level-3-only accepts ~0.37 of proposals on repeat
    traffic where the ladder accepts ~1.0."""

    kind = "ngram"

    def __init__(self, *, k: int, n: int = 3, store_entries: int = 4096,
                 scan_window: int = 256, levels=(16, 8, 5)):
        self.k = max(1, int(k))
        self.n = max(1, int(n))  # the minimum (and prompt-lookup) level
        self.levels = tuple(sorted(
            {lv for lv in levels if lv > self.n} | {self.n}, reverse=True
        ))
        self._store_entries = max(0, int(store_entries))
        self._scan_window = max(self.n + 1, int(scan_window))
        # per level: trailing n-gram -> the (up to k) tokens that followed
        # it, most recent occurrence wins; bounded LRU per level so the
        # store cannot grow with traffic volume.
        self._stores: Dict[int, "OrderedDict[tuple, np.ndarray]"] = {
            lv: OrderedDict() for lv in self.levels
        }

    def eligible(self, slot_idx: int, slot) -> bool:
        return len(slot.history) >= self.n

    def propose(self, slot_idx: int, slot) -> Optional[np.ndarray]:
        hist = slot.history
        if self._store_entries:
            for lv in self.levels:          # longest suffix first
                if len(hist) < lv:
                    continue
                store = self._stores[lv]
                cont = store.get(tuple(hist[-lv:]))
                if cont is not None and len(cont):
                    store.move_to_end(tuple(hist[-lv:]))
                    return cont[: self.k]
        # Prompt-lookup fallback: the most recent earlier occurrence of the
        # trailing min-level n-gram inside this request's own history.
        n = self.n
        key = tuple(hist[-n:])
        lo = max(0, len(hist) - self._scan_window)
        for i in range(len(hist) - n - 1, lo - 1, -1):
            if tuple(hist[i:i + n]) == key:
                cont = hist[i + n: i + n + self.k]
                if cont:
                    return np.asarray(cont, np.int32)
                break
        return None

    def on_admit(self, slot_idx: int, prompt: List[int]):
        self._index(prompt)

    def on_finish(self, slot_idx: int, slot):
        self._index(slot.history)

    def _index(self, seq: List[int]):
        if not self._store_entries:
            return
        k = self.k
        for lv in self.levels:
            store = self._stores[lv]
            for j in range(len(seq) - lv):
                key = tuple(seq[j:j + lv])
                store.pop(key, None)
                store[key] = np.asarray(seq[j + lv: j + lv + k], np.int32)
            while len(store) > self._store_entries:
                store.popitem(last=False)

    def stats(self) -> dict:
        return {"kind": self.kind, "k": self.k, "n": self.n,
                "levels": list(self.levels),
                "store_entries": sum(len(s) for s in self._stores.values())}


class ModelDraft(DraftProvider):
    """Draft-model provider: k greedy proposals per slot against the draft's
    own KV cache. Slot draft state (lengths, readiness, the pending
    all-accepted token whose KV must catch up) is host-native, mirroring the
    engine's slot bookkeeping discipline.

    The whole-prompt prefill (`on_admit`, JAX's `_prefill_prog`) is an
    offset-0 forward, so each draft layer's attention runs K1 over the rows
    it just wrote (on CUDA it launches the kernel or raises). `propose`
    (JAX's `_propose_prog`) runs k single-token steps through the masked
    route, argmax on the device, and pulls the k tokens once."""

    kind = "model"

    def __init__(self, cfg, params, *, k: int, num_slots: int, max_seq: int,
                 bucket: Callable, device):
        self.cfg = cfg
        self.params = params
        self.k = max(1, int(k))
        self.B = num_slots
        self.T = max_seq
        self._bucket = bucket
        self.device = torch.device(device)
        kv_shape = (self.B, self.T, cfg.n_kv_heads, cfg.head_dim)
        self.caches = [
            (torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.n_layers)
        ]
        self._host_lens = np.zeros((self.B,), np.int64)
        self._ready = [False] * self.B
        # all-k-accepted leaves one proposed token's kv missing from the
        # draft cache; it catches up at the next round's first step.
        self._pending: List[Optional[int]] = [None] * self.B

    def _slot_caches(self, slot: int):
        # One-slot views: writes through them land in the draft's pool.
        return [(ck[slot:slot + 1], cv[slot:slot + 1]) for ck, cv in self.caches]

    # -- DraftProvider ------------------------------------------------------
    def eligible(self, slot_idx: int, slot) -> bool:
        return (
            self._ready[slot_idx]
            and int(self._host_lens[slot_idx]) + self.k + 1 <= self.T
        )

    @torch.inference_mode()
    def propose(self, slot_idx: int, slot) -> Optional[np.ndarray]:
        """k greedy tokens from t0 = the slot's last token at row dlens.
        With a pending token (the previous round accepted all k), the first
        step ingests it at dlens and the chain restarts from t0: JAX's
        catch-up, one step more and no extra pull."""
        t0 = int(slot.tokens[-1])
        dlens = int(self._host_lens[slot_idx])
        pend = self._pending[slot_idx]
        catchup = pend is not None
        steps = self.k + 1 if catchup else self.k
        dev = self.device
        caches = self._slot_caches(slot_idx)
        positions = dlens + torch.arange(steps, device=dev)
        rows = torch.arange(self.T, device=dev)
        tok = torch.tensor([[pend if catchup else t0]], device=dev)
        toks = []
        for j in range(steps):
            pos = positions[j:j + 1]
            kv_mask = (rows <= pos)[None, None]  # row r visible iff r <= pos
            logits = _forward_cached(self.params, self.cfg, tok, pos[None], caches,
                                     pos, kv_mask)
            if catchup and j == 0:
                tok = torch.tensor([[t0]], device=dev)  # restart the chain at t0
                continue
            tok = torch.argmax(logits[:, 0], dim=-1, keepdim=True)
            toks.append(tok[0])
        if catchup:
            self._host_lens[slot_idx] += 1  # the first step landed pend's kv
            self._pending[slot_idx] = None
        # Per-round proposal sync: k tokens in one pull, before the batched
        # verify assembles every slot's proposals host-side.
        return torch.cat(toks).cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def on_admit(self, slot_idx: int, prompt: List[int]):
        """Prefill the draft cache on the (padded) whole prompt: spec decode
        needs the draft's kv history in lockstep with the target's — this is
        also the cache-hit catch-up path, since the draft never holds the
        target's attached prefix rows. An offset-0 forward: rows [0, S) of
        the slot's draft cache are exactly the chunk's own k and v, so every
        layer's attention is K1 (`_attn_cached`'s kv_mask=None route)."""
        bucket = self._bucket(len(prompt))
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(prompt)] = prompt
        positions = torch.arange(bucket, device=self.device)[None]
        _forward_cached(self.params, self.cfg, torch.as_tensor(padded, device=self.device),
                        positions, self._slot_caches(slot_idx),
                        torch.zeros(1, dtype=torch.long, device=self.device), None)
        self._host_lens[slot_idx] = len(prompt)
        self._ready[slot_idx] = True
        self._pending[slot_idx] = None

    def on_accept(self, slot_idx: int, slot, base_len: int,
                  proposed: np.ndarray, accepted: int):
        if accepted == len(proposed) == self.k:
            self._host_lens[slot_idx] += self.k
            self._pending[slot_idx] = int(proposed[-1])
        else:
            # Rows past the accepted prefix are stale; the next round's first
            # step overwrites them starting at the correction token's row.
            self._host_lens[slot_idx] = base_len + accepted + 1
            self._pending[slot_idx] = None

    def on_plain_decode(self, slot_idx: int):
        # A plain step advances the target but not the draft: its proposals
        # would be garbage. Disable until the next admission re-prefills.
        self._ready[slot_idx] = False
        self._pending[slot_idx] = None

    def on_finish(self, slot_idx: int, slot):
        self._ready[slot_idx] = False
        self._pending[slot_idx] = None

    def stats(self) -> dict:
        return {
            "kind": self.kind, "k": self.k,
            "draft_layers": self.cfg.n_layers,
            "ready_slots": sum(1 for r in self._ready if r),
        }


def early_exit_draft(cfg, params, n_layers: int):
    """EAGLE-style early-exit head: the target's first `n_layers` layers +
    final norm + output head, sharing every tensor with the target (the same
    objects: zero extra memory, ~n_layers/L of a target forward per proposed
    token). Returns (draft_cfg, draft_params) for ModelDraft."""
    import dataclasses

    if not 0 < n_layers < cfg.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {cfg.n_layers - 1}], got {n_layers}"
        )
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    dparams = {"embedding": params["embedding"],
               "final_norm": params["final_norm"]}
    for i in range(n_layers):
        dparams[f"layer_{i}"] = params[f"layer_{i}"]
    if not cfg.tie_embeddings and "lm_head" in params:
        dparams["lm_head"] = params["lm_head"]
    return dcfg, dparams
