"""AdapterCache: a device-byte-budgeted pageable pool of LoRA adapter slots.

Twin of `ray_tpu/llm/adapters.py` (S-LoRA's unified paging of adapter
weights, vLLM's multi-LoRA LRU cache). The engine's stacked device tables
(`q_A/q_B/v_A/v_B/scale`, gathered per slot by adapter ids in
`_engine._attn_cached`) hold a FIXED number of device slots, sized by
`llm_adapter_cache_bytes` or `cache_slots`; row 0 is the base model (zero
factors). Every registered adapter keeps a host copy (the registry), and a
request whose adapter is not resident pages it in at admission: one
host-to-device copy of its packed f32 factors, then a cast into the slot's
row.

Pinning contract: `acquire()` pins an adapter for the lifetime of the
returned `AdapterHandle`; a pinned adapter is never evicted, so the row an
in-flight request dispatches with stays valid until `release()`.

Where JAX's install is functional (it swaps the table reference, so a
dispatch that already captured the old table stays valid), this one writes
the slot's row in place. That is correct because (a) only an unpinned row is
written: no request that is still running reads it, and (b) the copy is
enqueued on the CUDA stream that is current in `acquire()`. The engine calls
`try_acquire` from its stepper thread at admission, inside its device
context, so the copy lands on the stepper's stream after every launch that
read the row's previous contents. A caller acquiring from another thread
must hold the same stream.

On a tensor-parallel engine each rank's tables hold the q_B and v_B columns
of its own heads (`q_cols`, `v_cols`); rank 0 keeps the registry, the pins
and the LRU, and its page-ins write the row through `install`, which ships
the whole factors to every rank (each keeps its columns, `write_row`).

No metrics are pushed and no leaksan books are kept: `stats()` returns the
counters and `AdapterHandle.released` says whether a pin was released.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "AdapterCache",
    "AdapterCacheFullError",
    "AdapterHandle",
    "UnknownAdapterError",
]


class UnknownAdapterError(KeyError):
    """The request named a LoRA adapter this engine has never registered.

    Client-visible and typed; it subclasses KeyError so handlers of a bare
    KeyError keep working."""

    def __str__(self):  # KeyError wraps its message in quotes; don't.
        return self.args[0] if self.args else ""


class AdapterCacheFullError(RuntimeError):
    """Every device slot is pinned by an in-flight request: the acquire
    cannot page in without evicting someone's live adapter. Admission leaves
    the request queued and retries next iteration (back-pressure)."""


class AdapterHandle:
    """One pin on a resident adapter: `slot` is the device-table row the
    holder may dispatch with until `release()`."""

    __slots__ = ("_cache", "name", "uid", "slot", "_released")

    def __init__(self, cache: "AdapterCache", name: str, uid: int, slot: int):
        self._cache = cache
        self.name = name
        self.uid = uid
        self.slot = slot
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def release(self):
        """Idempotent: a second release does not unpin twice."""
        if not self._released:
            self._released = True
            if self.uid:
                self._cache._unpin(self.uid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class _AdapterEntry:
    """Host-side registry record: packed f32 factors padded to the rank
    bucket, ready to copy to the device."""

    __slots__ = ("name", "uid", "rank", "alpha", "blob")

    def __init__(self, name: str, uid: int, rank: int, alpha: float, blob: dict):
        self.name = name
        self.uid = uid
        self.rank = rank        # the adapter's TRUE rank (scale = alpha/rank)
        self.alpha = alpha
        self.blob = blob        # {"q_A": [L,M,rb], "q_B": [L,rb,HD], ...} f32


def _rank_bucket(rank: int) -> int:
    """Smallest power of two >= rank: factors pad with zero columns (a zero
    rank dim contributes an exactly-zero delta), so every adapter of the
    bucket shares one table shape."""
    b = 1
    while b < rank:
        b *= 2
    return b


class AdapterCache:
    """Fixed-slot stacked adapter tables on the engine's device + host
    registry + LRU paging.

    Thread contract: `register`/`acquire`/`try_acquire`/release run under
    one cache lock; `tables()` returns the same tensors for the cache's
    whole life (installs write rows in place, see the module docstring)."""

    def __init__(self, *, n_layers: int, hidden: int, q_out: int, v_out: int,
                 rank: int, dtype: torch.dtype, max_adapters: int,
                 device, budget_bytes: int = 0, cache_slots: Optional[int] = None,
                 name: str = "", q_cols: Optional[slice] = None,
                 v_cols: Optional[slice] = None, install=None):
        self.name = name or f"adapters-{id(self):x}"
        self.device = torch.device(device)
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.q_out = int(q_out)
        self.v_out = int(v_out)
        # The columns of q_B and v_B this device holds (a tensor-parallel
        # rank's heads); the registry validates and keeps the whole factors.
        self.q_cols = q_cols or slice(0, self.q_out)
        self.v_cols = v_cols or slice(0, self.v_out)
        # Writes a paged-in adapter's rows: `write_row` here, or a caller's
        # function that also ships them to the other ranks.
        self._install = install or self.write_row
        self.rank_bucket = _rank_bucket(max(1, int(rank)))
        self.max_adapters = max(1, int(max_adapters))
        rb = self.rank_bucket
        # Per-adapter device footprint of one slot (factors in the model
        # dtype + one f32 scale per layer).
        self.slot_bytes = (
            self.n_layers * rb * (2 * self.hidden + q_out + v_out) * dtype.itemsize
            + self.n_layers * 4
        )
        if cache_slots is not None:
            slots = int(cache_slots)
        elif budget_bytes and budget_bytes > 0:
            slots = int(budget_bytes) // self.slot_bytes
        else:
            slots = self.max_adapters
        # At least one pageable slot; never more slots than adapters can use.
        self.num_slots = max(1, min(self.max_adapters, slots))
        S = self.num_slots + 1          # row 0 = base model (zero factors)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        self._tables = {
            "q_A": zeros(self.n_layers, S, self.hidden, rb),
            "q_B": zeros(self.n_layers, S, rb, self.q_cols.stop - self.q_cols.start),
            "v_A": zeros(self.n_layers, S, self.hidden, rb),
            "v_B": zeros(self.n_layers, S, rb, self.v_cols.stop - self.v_cols.start),
            "scale": zeros(self.n_layers, S, dt=torch.float32),
        }
        self._lock = threading.Lock()
        self._registry: Dict[str, _AdapterEntry] = {}
        self._by_uid: Dict[int, _AdapterEntry] = {}
        self._resident: "OrderedDict[int, int]" = OrderedDict()  # uid -> slot (LRU order)
        self._free: List[int] = list(range(1, S))
        self._pins: Dict[int, int] = {}
        self._counters = {
            "registered": 0, "hits": 0, "misses": 0, "evictions": 0,
            "page_ins": 0, "rejected_full": 0,
        }

    # -- registry ----------------------------------------------------------
    def register(self, name: str, layer_weights: Dict[int, Dict[str, np.ndarray]],
                 alpha: float = 1.0) -> int:
        """Validate and record an adapter host-side (no device work: a cold
        adapter costs its first request a page-in, not every register a
        slot). Returns the adapter's stable uid — the id the prefix cache
        namespaces by; device slots move under it as paging churns. Shapes
        and rank are validated here, against the bucketed table, so a
        mismatched checkpoint fails at register time."""
        rank = None
        for li, w in layer_weights.items():
            if not (0 <= int(li) < self.n_layers):
                raise ValueError(
                    f"adapter {name!r}: layer index {li} outside the model's "
                    f"{self.n_layers} layers"
                )
            for key, in_dim, out_dim in (
                ("q_A", self.hidden, None), ("q_B", None, self.q_out),
                ("v_A", self.hidden, None), ("v_B", None, self.v_out),
            ):
                if key not in w:
                    continue
                arr = np.asarray(w[key])
                if arr.ndim != 2:
                    raise ValueError(
                        f"adapter {name!r} layer {li} {key}: expected a 2-D "
                        f"factor, got shape {arr.shape}"
                    )
                r = arr.shape[1] if key.endswith("_A") else arr.shape[0]
                fixed = arr.shape[0] if key.endswith("_A") else arr.shape[1]
                want = in_dim if key.endswith("_A") else out_dim
                if fixed != want:
                    raise ValueError(
                        f"adapter {name!r} layer {li} {key}: dim {fixed} does "
                        f"not match the model's {want}"
                    )
                if rank is None:
                    rank = r
                elif r != rank:
                    raise ValueError(
                        f"adapter {name!r}: inconsistent LoRA rank across "
                        f"factors ({rank} vs {r} at layer {li} {key})"
                    )
        rank = rank or 1
        if rank > self.rank_bucket:
            raise ValueError(
                f"adapter {name!r} rank {rank} exceeds this engine's rank "
                f"bucket {self.rank_bucket} (lora_config rank); re-register "
                f"the engine with a larger rank"
            )
        L, rb = self.n_layers, self.rank_bucket
        blob = {
            "q_A": np.zeros((L, self.hidden, rb), np.float32),
            "q_B": np.zeros((L, rb, self.q_out), np.float32),
            "v_A": np.zeros((L, self.hidden, rb), np.float32),
            "v_B": np.zeros((L, rb, self.v_out), np.float32),
            "scale": np.full((L,), float(alpha) / max(1, rank), np.float32),
        }
        for li, w in layer_weights.items():
            for key in ("q_A", "q_B", "v_A", "v_B"):
                if key not in w:
                    continue
                arr = np.asarray(w[key], np.float32)
                if key.endswith("_A"):
                    blob[key][li, :, : arr.shape[1]] = arr
                else:
                    blob[key][li, : arr.shape[0], :] = arr
        with self._lock:
            if name in self._registry:
                return self._registry[name].uid
            if len(self._registry) >= self.max_adapters:
                raise ValueError(
                    f"lora capacity {self.max_adapters} exhausted "
                    f"(registry holds {len(self._registry)} adapters)"
                )
            uid = len(self._registry) + 1
            entry = _AdapterEntry(name, uid, rank, float(alpha), blob)
            self._registry[name] = entry
            self._by_uid[uid] = entry
            self._counters["registered"] += 1
        return uid

    def uid_of(self, name: str) -> int:
        """Stable uid of a registered adapter ("" = base, uid 0); raises the
        typed client-visible UnknownAdapterError otherwise."""
        if not name:
            return 0
        with self._lock:
            entry = self._registry.get(name)
        if entry is None:
            raise UnknownAdapterError(
                f"unknown lora adapter {name!r}: not registered on this "
                f"engine (register_adapter/load_lora it first)"
            )
        return entry.uid

    def is_resident(self, uid: int) -> bool:
        if uid == 0:
            return True
        with self._lock:
            return uid in self._resident

    def resident_adapters(self) -> List[str]:
        """Names currently paged into device slots."""
        with self._lock:
            return [self._by_uid[u].name for u in self._resident]

    # -- pin / page --------------------------------------------------------
    def acquire(self, name_or_uid) -> AdapterHandle:
        """Pin an adapter (paging it in if evicted) and return the handle
        whose `slot` the holder dispatches with. Raises UnknownAdapterError
        for unregistered names and AdapterCacheFullError when every slot is
        pinned by other in-flight requests."""
        if isinstance(name_or_uid, str):
            uid = self.uid_of(name_or_uid)
        else:
            uid = int(name_or_uid)
        if uid == 0:
            return AdapterHandle(self, "", 0, 0)
        with self._lock:
            entry = self._by_uid.get(uid)
            if entry is None:
                raise UnknownAdapterError(f"unknown lora adapter uid {uid}")
            slot = self._resident.get(uid)
            if slot is None:
                slot = self._page_in_locked(entry)
                self._counters["misses"] += 1
            else:
                self._counters["hits"] += 1
            self._resident.move_to_end(uid)
            self._pins[uid] = self._pins.get(uid, 0) + 1
        return AdapterHandle(self, entry.name, uid, slot)

    def try_acquire(self, name_or_uid) -> Optional[AdapterHandle]:
        """acquire(), but a fully-pinned table returns None instead of
        raising — the admission loop's leave-it-queued shape."""
        try:
            return self.acquire(name_or_uid)
        except AdapterCacheFullError:
            return None

    def _page_in_locked(self, entry: _AdapterEntry) -> int:
        if self._free:
            slot = self._free.pop(0)
        else:
            victim = next(
                (u for u in self._resident if not self._pins.get(u)), None
            )
            if victim is None:
                self._counters["rejected_full"] += 1
                raise AdapterCacheFullError(
                    f"all {self.num_slots} adapter slots are pinned by "
                    f"in-flight requests; retry once one finishes"
                )
            slot = self._resident.pop(victim)
            self._counters["evictions"] += 1
        # The row is unpinned: no running request reads it. Both copies go
        # on the current stream (the stepper's, at admission), after every
        # launch that read the row's previous adapter. The f32 factors cross
        # from pageable host memory, then cast into the row on the device.
        try:
            self._install(slot, entry.blob)
        except BaseException:
            # The row may be half written: it holds no adapter any more.
            self._free.insert(0, slot)
            raise
        self._resident[entry.uid] = slot
        self._counters["page_ins"] += 1
        return slot

    def write_row(self, slot: int, blob: dict) -> None:
        """Copy an adapter's packed f32 factors into table row `slot`: one
        host-to-device copy per table (this device's columns of q_B and
        v_B), then the cast into the row, on the current stream."""
        cols = {"q_B": self.q_cols, "v_B": self.v_cols}
        for key, row in blob.items():
            if key in cols:
                row = row[..., cols[key]]
            self._tables[key][:, slot].copy_(torch.from_numpy(row).to(self.device))

    def _unpin(self, uid: int):
        with self._lock:
            n = self._pins.get(uid, 0) - 1
            if n <= 0:
                self._pins.pop(uid, None)
            else:
                self._pins[uid] = n

    # -- device view -------------------------------------------------------
    def tables(self) -> dict:
        """The stacked device tables the forward gathers from:
        {"q_A": [L, S+1, M, rb], "q_B": [L, S+1, rb, q_out], "v_A", "v_B",
        "scale": [L, S+1] f32}; row 0 is the base model."""
        return self._tables

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["resident"] = len(self._resident)
            out["pinned"] = sum(1 for v in self._pins.values() if v)
            out["slots"] = self.num_slots
            out["slot_bytes"] = self.slot_bytes
            out["bytes_resident"] = (self.num_slots + 1) * self.slot_bytes
            out["rank_bucket"] = self.rank_bucket
            out["resident_adapters"] = [
                self._by_uid[u].name for u in self._resident
            ]
            lookups = max(1, out["hits"] + out["misses"])
            out["hit_rate"] = out["hits"] / lookups
        # JAX counts its cached install programs here; the eager port
        # compiles none, and None is JAX's own value when it cannot count.
        out["install_programs"] = None
        return out
