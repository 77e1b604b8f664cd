"""Request-lifecycle flight recorder + SLO metrics for the LLM serve plane.

A copy of `ray_tpu/llm/flight_recorder.py` (the port imports nothing of
ray_tpu). Every request accrues host-timestamped PHASE EVENTS as it moves
through the engine —

    queued -> admitted (slot, cached prefix tokens)
           -> cache-attach (cached tokens, tier) -> prefill-chunk[i]
              (bucket, offset) -> decode (aggregated; per-token host
              timestamps give TTFT/TPOT) -> finished

— into a bounded per-engine ring buffer, the vLLM per-request metrics shape.
Three rules carry over from the reference:

- **Host-side only.** Recording is list appends of plain tuples under the
  GIL; no device handle is ever touched, so the decode loop's device-pull
  count is unchanged.
- **Nothing on the dispatch path reads the books.** Counters, summaries
  and burn rates are read from the engine's `recorder_stats()` /
  `scheduler_stats()` / `request_timing()` report calls.
- **Bounded everything.** The ring holds `llm_flight_records` finished
  records; each record caps its events and token timestamps, counting (not
  growing on) overflow; each tenant's SLO window holds `ServeMetrics.WINDOW`
  bits.

What differs: the SLO burn rates are plain numbers that `recorder_stats()`
reports, folded in at each completion (ray_tpu queues summaries for its
metrics flush and autopilot probe, which the port does not have yet); the
util.metrics series and the span export to the runtime's task-event
pipeline (`flush_task_events`) wait for the port's runtime (ROADMAP.md,
Queue 1 item 8); `trace` is always None because the port has no tracing
context. `spans()` still builds the span tree a tracer would take; its
caller is that export.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from ray_tpu_torch._config import CONFIG

# Per-record caps: phase events beyond this count (and token timestamps
# beyond _MAX_TOKEN_TIMES) are dropped-and-counted, never grown.
_MAX_EVENTS = 128
_MAX_TOKEN_TIMES = 4096


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestRecord:
    """One request's in-flight lifecycle state. Appends are plain list ops
    (GIL-atomic) from whichever thread owns the phase — the submitting
    asyncio thread, the scheduler's admission path, the engine stepper —
    with no lock and no device access."""

    __slots__ = ("rid", "trace_id", "span_id", "parent_span_id", "tenant",
                 "route", "t_submit", "events", "dropped_events",
                 "token_times", "meta")

    def __init__(self, rid: str, *, trace: Optional[dict] = None,
                 tenant: str = "", route: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.rid = rid
        self.trace_id = (trace or {}).get("trace_id")
        self.parent_span_id = (trace or {}).get("span_id")
        self.span_id = _new_span_id()
        self.tenant = tenant
        self.route = route
        self.t_submit = time.time()
        self.events: List[tuple] = []  # (name, t0, t1, attrs | None)
        self.dropped_events = 0
        self.token_times: List[float] = []
        self.meta = meta

    # -- recording (any thread; never blocks, never touches a device) ------
    def mark(self, name: str, **attrs):
        """Instant event (rendered as a zero-duration span)."""
        t = time.time()
        self.span(name, t, t, **attrs)

    def span(self, name: str, t0: float, t1: float, **attrs):
        if len(self.events) >= _MAX_EVENTS:
            self.dropped_events += 1
            return
        self.events.append((name, t0, t1, attrs or None))

    def token(self):
        """One generated token's host timestamp (TTFT = first, TPOT = gaps)."""
        if len(self.token_times) < _MAX_TOKEN_TIMES:
            self.token_times.append(time.time())

    # -- summarization ------------------------------------------------------
    def summary(self, status: str = "ok") -> dict:
        """The completion record that feeds the ring, the SLO metrics, and
        the response-metadata timing breakdown."""
        t_end = time.time()
        tt = self.token_times
        ttft = (tt[0] - self.t_submit) if tt else None
        gaps = [b - a for a, b in zip(tt, tt[1:])]
        tpot = (sum(gaps) / len(gaps)) if gaps else None
        phases: Dict[str, dict] = {}
        for name, t0, t1, _attrs in self.events:
            p = phases.setdefault(name, {"count": 0, "seconds": 0.0})
            p["count"] += 1
            p["seconds"] += max(0.0, t1 - t0)
        admitted = next(
            (t0 for name, t0, _t1, _a in self.events if name == "admitted"),
            None,
        )
        return {
            "rid": self.rid,
            "status": status,
            "tenant": self.tenant,
            "route": self.route,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "t_submit": self.t_submit,
            "t_end": t_end,
            "e2e_s": t_end - self.t_submit,
            "queue_s": (admitted - self.t_submit) if admitted else None,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "tokens": len(tt),
            "phases": phases,
            "events": list(self.events),
            "dropped_events": self.dropped_events,
            "meta": self.meta,
        }


class FlightRecorder:
    """Bounded per-engine ring of finished request records plus the live
    set. `llm_flight_records <= 0` disables recording entirely (start()
    returns None and every caller is None-guarded)."""

    def __init__(self, name: str = "", capacity: Optional[int] = None):
        if capacity is None:
            capacity = CONFIG.llm_flight_records
        self.name = name
        self.capacity = max(0, int(capacity))
        self._live: Dict[str, RequestRecord] = {}
        self._ring: deque = deque(maxlen=self.capacity or 1)
        self._lock = threading.Lock()
        self._counters = {"started": 0, "finished": 0, "dropped": 0,
                          "rejected": 0, "cancelled": 0}

    # -- lifecycle ----------------------------------------------------------
    def start(self, rid: Optional[str] = None, *, trace: Optional[dict] = None,
              tenant: str = "", route: Optional[str] = None,
              meta: Optional[dict] = None) -> Optional[RequestRecord]:
        if self.capacity <= 0:
            return None
        rec = RequestRecord(rid or uuid.uuid4().hex, trace=trace,
                            tenant=tenant, route=route, meta=meta)
        with self._lock:
            self._counters["started"] += 1
            self._live[rec.rid] = rec
        return rec

    def _retire(self, rec: RequestRecord, status: str, counter: str) -> dict:
        summary = rec.summary(status)
        with self._lock:
            if self._live.pop(rec.rid, None) is None:
                return summary  # already retired (idempotent)
            self._counters[counter] += 1
            self._ring.append(summary)
        return summary

    def finish(self, rec: Optional[RequestRecord],
               status: str = "ok") -> Optional[dict]:
        """Normal completion: move the record to the ring and return its
        summary (the engine folds it into the SLO windows). Idempotent.
        status="cancelled" (the mid-stream-disconnect path,
        docs/generation.md) keeps its own counter so operators can tell
        client hang-ups from served completions at a glance."""
        if rec is None:
            return None
        counter = status if status in ("rejected", "cancelled") else "finished"
        return self._retire(rec, status, counter)

    def drop(self, rec: Optional[RequestRecord]) -> Optional[dict]:
        """Abnormal end (drain, stepper death, shutdown): books still
        balance — the record retires with status "dropped"."""
        if rec is None:
            return None
        return self._retire(rec, "dropped", "dropped")

    def close(self):
        """Engine shutdown or stepper death: retire every live record
        (status "dropped"), so none is stranded."""
        with self._lock:
            live = list(self._live.values())
        for rec in live:
            self.drop(rec)

    # -- read paths ---------------------------------------------------------
    def lookup(self, rid: str) -> Optional[dict]:
        """Timing breakdown for one request (ring first, then live)."""
        with self._lock:
            for summary in reversed(self._ring):
                if summary["rid"] == rid:
                    return dict(summary)
            rec = self._live.get(rid)
        return rec.summary("running") if rec is not None else None

    def records(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["live"] = len(self._live)
            out["ring"] = len(self._ring)
            out["capacity"] = self.capacity
        return out

    # -- report-path export (never called from the dispatch loop) ----------
    def spans(self, summaries: Optional[List[dict]] = None) -> List[dict]:
        """Span dicts in ray_tpu's tracing_export shape: one request-root
        span per record, phase events as children. The span export of the
        port's runtime (ROADMAP.md, Queue 1 item 8) is the caller this waits
        for; tests hold the shape against ray_tpu's meanwhile."""
        if summaries is None:
            summaries = self.records()
        spans: List[dict] = []
        for s in summaries:
            root = {
                "trace_id": s["trace_id"] or s["rid"],
                "span_id": s["span_id"],
                "parent_span_id": s["parent_span_id"],
                "name": "llm:request",
                "start_s": s["t_submit"],
                "end_s": s["t_end"],
                "ok": s["status"] in ("ok", "running"),
                "attributes": {
                    "ray_tpu.llm.rid": s["rid"],
                    "ray_tpu.llm.tenant": s["tenant"] or None,
                    "ray_tpu.llm.route": s["route"],
                    "ray_tpu.llm.tokens": s["tokens"],
                    "ray_tpu.llm.ttft_s": s["ttft_s"],
                    "ray_tpu.llm.engine": self.name,
                },
            }
            spans.append(root)
            for name, t0, t1, attrs in s["events"]:
                spans.append({
                    "trace_id": root["trace_id"],
                    "span_id": _new_span_id(),
                    "parent_span_id": s["span_id"],
                    "name": f"llm:{name}",
                    "start_s": t0,
                    "end_s": t1,
                    "ok": True,
                    "attributes": {
                        f"ray_tpu.llm.{k}": v for k, v in (attrs or {}).items()
                    },
                })
        return spans


class ServeMetrics:
    """Per-tenant SLO classification and burn rates, as plain numbers.
    `record()` folds one completion into its tenant's burn window: the
    recent good/bad bits (good = meets BOTH SLOs, TTFT <= llm_slo_ttft_s AND
    mean TPOT <= llm_slo_tpot_s), whose breach fraction over the error
    budget is the burn rate (1.0 = burning exactly the budget; >1 = on track
    to exhaust it). The engine reports the rates in `recorder_stats()`.

    ray_tpu queues summaries in a backlog that its report paths (the metrics
    flush, the autopilot's probe) drain into the same windows, and also
    exports outcome counts, good/breach counters and latency Histograms as
    util.metrics series. The port has neither reader yet (ROADMAP.md, Queue 1
    items 8 and 9), so it keeps no backlog: the windows hold what a flush
    would have left in them, and nothing grows between reports."""

    WINDOW = 256  # completions per tenant in the burn-rate window

    def __init__(self, name: str = "", *, slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None,
                 error_budget: Optional[float] = None):
        self.slo_ttft_s = (CONFIG.llm_slo_ttft_s if slo_ttft_s is None
                           else float(slo_ttft_s))
        self.slo_tpot_s = (CONFIG.llm_slo_tpot_s if slo_tpot_s is None
                           else float(slo_tpot_s))
        self.error_budget = max(1e-6, (
            CONFIG.llm_slo_error_budget if error_budget is None
            else float(error_budget)
        ))
        self._name = name
        self._window: Dict[str, deque] = {}  # tenant -> recent good/bad bits
        self._lock = threading.Lock()

    def good(self, summary: dict) -> bool:
        """Did this completion meet the SLO? (Rejected/dropped never do.)"""
        if summary.get("status") != "ok":
            return False
        ttft, tpot = summary.get("ttft_s"), summary.get("tpot_s")
        if ttft is None or ttft > self.slo_ttft_s:
            return False
        return tpot is None or tpot <= self.slo_tpot_s

    def record(self, summary: dict):
        """One completion into its tenant's bounded window (a classification
        and a deque append under the lock; no summary is kept)."""
        if summary["status"] == "cancelled":
            # A client hang-up is NOT an SLO breach: it must not feed the
            # burn window.
            return
        good = self.good(summary)
        with self._lock:
            self._window.setdefault(
                summary.get("tenant") or "", deque(maxlen=self.WINDOW)
            ).append(good)

    def burn_rate(self, tenant: str = "") -> float:
        """Breach fraction in the recent window over the error budget."""
        with self._lock:
            w = self._window.get(tenant)
            if not w:
                return 0.0
            breaches = sum(1 for ok in w if not ok)
            return (breaches / len(w)) / self.error_budget

    def burn_rates(self) -> Dict[str, float]:
        """Every tenant's current burn rate ("" is untenanted traffic); what
        the engine's `recorder_stats()` reports. Pure window math, safe from
        any path."""
        with self._lock:
            out = {}
            for tenant, w in self._window.items():
                if not w:
                    continue
                breaches = sum(1 for ok in w if not ok)
                out[tenant] = (breaches / len(w)) / self.error_budget
            return out


__all__ = ["FlightRecorder", "RequestRecord", "ServeMetrics"]
