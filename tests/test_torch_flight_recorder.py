"""ray_tpu_torch's flight recorder against ray_tpu's, on the CPU.

The recorders and SLO metrics get the same calls and must agree on their
counters, summaries and burn rates; the engines (test-tiny, f32, the same
JAX-initialized weights, stepped by hand) serve the same requests and must
record the same phases: `request_timing` has JAX's keys, phase names and
phase counts, and every record retires exactly once (finish, reject,
cancel, shutdown). `LLMServer.generate` returns the timing.
"""

import asyncio
import os
import pickle
import tempfile
import time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import flight_recorder as jfr
from ray_tpu.llm._engine import DecodeEngine as JEngine
from ray_tpu.llm._engine import SamplingParams as JSampling
from ray_tpu.llm.scheduler.scheduler import EngineOverloadedError as JOverloaded
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.models.transformer import get_config as jget_config
from ray_tpu.parallel.mesh import unbox
from ray_tpu_torch.llm import LLMConfig, LLMServer
from ray_tpu_torch.llm import flight_recorder as tfr
from ray_tpu_torch.llm._engine import DecodeEngine, EngineOverloadedError, SamplingParams
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import get_config

MODULES = [jfr, tfr]
# Keys of FlightRecorder.stats() in both packages (JAX's adds its span
# export's counters, which wait for the port's runtime).
STAT_KEYS = ("started", "finished", "dropped", "rejected", "cancelled", "live",
             "ring", "capacity")


def _stats(rec):
    s = rec.stats()
    return {k: s[k] for k in STAT_KEYS}


def test_ring_and_event_caps_match_jax():
    out = []
    for fr in MODULES:
        rec = fr.FlightRecorder(name="unit", capacity=4)
        for i in range(10):
            r = rec.start(f"r{i}")
            r.mark("queued")
            rec.finish(r)
        big = rec.start("big")
        for i in range(fr._MAX_EVENTS + 50):
            big.mark(f"e{i}")
        for _ in range(fr._MAX_TOKEN_TIMES + 5):
            big.token()
        summary = rec.finish(big)
        out.append((_stats(rec), len(big.events), summary["dropped_events"],
                    summary["tokens"], [s["rid"] for s in rec.records()]))
    assert out[1] == out[0]
    assert out[1][0]["ring"] == 4 and out[1][0]["finished"] == 11
    assert out[1][1:4] == (128, 50, 4096)


def test_capacity_zero_disables():
    for fr in MODULES:
        rec = fr.FlightRecorder(capacity=0)
        assert rec.start("x") is None
        assert rec.finish(None) is None and rec.drop(None) is None
        assert rec.stats()["started"] == 0


def test_finish_idempotent_lookup_and_spans_match_jax():
    out = []
    for fr in MODULES:
        rec = fr.FlightRecorder(name="unit", capacity=8)
        r = rec.start("a", tenant="t1", route="cache_routed")
        r.mark("admitted", slot=0)
        r.span("prefill-chunk", time.time() - 0.01, time.time(), bucket=32)
        r.token()
        r.token()
        s1, s2 = rec.finish(r), rec.finish(r)
        live = rec.start("b")
        running = rec.lookup("b")
        rec.finish(live, status="cancelled")
        rec.drop(rec.start("c"))
        spans = rec.spans()
        out.append({
            "stats": _stats(rec), "s1": {k: s1[k] for k in ("rid", "status", "tenant",
                                                             "route", "tokens", "trace_id")},
            "phases": {n: p["count"] for n, p in s1["phases"].items()},
            "s2_tenant": s2["tenant"], "found": rec.lookup("a")["route"],
            "running": running["status"], "missing": rec.lookup("missing"),
            "span_names": [s["name"] for s in spans],
            "parents_ok": all(s["parent_span_id"] == spans[0]["span_id"]
                              for s in spans[1:3]),
            "attrs": spans[2]["attributes"],
        })
    assert out[1] == out[0]
    assert out[1]["stats"]["finished"] == 1 and out[1]["stats"]["cancelled"] == 1
    assert out[1]["stats"]["dropped"] == 1 and out[1]["stats"]["live"] == 0


def _burns(m):
    """Burn rates after the completions recorded so far: JAX's drain its
    backlog first (its report-path flush); the port's fold in at record()."""
    if hasattr(m, "flush"):
        m.flush()
    return m.burn_rate(""), m.burn_rate("t"), m.burn_rates()


def test_serve_metrics_slo_classification_and_burn_match_jax():
    good = {"status": "ok", "ttft_s": 0.05, "tpot_s": 0.005, "e2e_s": 0.2, "tenant": ""}
    calls = [good, good, {**good, "ttft_s": 0.5}, good, {**good, "tpot_s": 0.02},
             {**good, "status": "rejected", "tenant": "t"},
             {**good, "status": "cancelled", "tenant": "t"}, {**good, "tenant": "t"}]
    out = []
    for fr in MODULES:
        m = fr.ServeMetrics("unit", slo_ttft_s=0.1, slo_tpot_s=0.01, error_budget=0.1)
        verdicts = [m.good(s) for s in calls]
        for s in calls:
            m.record(s)
        out.append((verdicts, *_burns(m)))
    assert out[1] == out[0]
    assert out[1][1] == pytest.approx((2 / 5) / 0.1)  # 2 breaches in 5 over 0.1
    assert out[1][2] == pytest.approx((1 / 2) / 0.1)  # the cancel stays out


def test_serve_metrics_stay_bounded_without_a_report_call():
    """Completions with no stats call in between: the port keeps one window
    of bits per tenant and no summary, and its burn rates equal JAX's after
    JAX's flush."""
    n = 3 * jfr.ServeMetrics.WINDOW + 7
    calls = [{"status": "ok", "ttft_s": 0.05 if i % 5 else 0.9, "tpot_s": 0.005,
              "tenant": "t" if i % 3 == 0 else "", "events": [("decode", 0.0, 1.0, None)]}
             for i in range(n)]
    out = []
    for fr in MODULES:
        m = fr.ServeMetrics("unit", slo_ttft_s=0.1, slo_tpot_s=0.01, error_budget=0.1)
        for s in calls:
            m.record(s)
        if fr is tfr:
            assert not any(isinstance(v, (list, deque)) and v and isinstance(v[0], dict)
                           for v in vars(m).values()), "a summary was kept"
            assert sorted(len(w) for w in m._window.values()) == [m.WINDOW] * 2
        out.append(_burns(m))
    assert out[1] == out[0]
    assert out[1][0] > 0 and out[1][1] > 0


def test_defaults_come_from_the_copied_flags():
    from ray_tpu._private.config import CONFIG as JCONFIG
    from ray_tpu_torch._config import CONFIG

    for name in ("llm_flight_records", "llm_slo_ttft_s", "llm_slo_tpot_s",
                 "llm_slo_error_budget", "llm_kv_block_size", "llm_prefix_cache_bytes"):
        assert getattr(CONFIG, name) == getattr(JCONFIG, name), name
    m, rec = tfr.ServeMetrics(), tfr.FlightRecorder()
    assert (m.slo_ttft_s, m.slo_tpot_s, m.error_budget) == (0.5, 0.05, 0.01)
    assert rec.capacity == 256


# -- engines -------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("test-tiny")
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    params = unbox(variables["params"])
    return jcfg, params, jax.tree.map(np.asarray, params)


def _port(tree, **kw):
    cfg = get_config("test-tiny")
    return DecodeEngine(cfg, params_from_jax(tree, cfg, "cpu"), device="cpu", **kw)


def _drive(engine, requests, sampling, budget=200):
    """Submit (rid, prompt, max_tokens) requests, then run the engine's
    scheduler iterations here (decode_loop=False) until every one finished."""
    done = set()
    for rid, prompt, n in requests:
        engine.submit(prompt, sampling(max_tokens=n),
                      lambda t, f, rid=rid: f and done.add(rid), request_id=rid)
    for _ in range(budget):
        if len(done) == len(requests):
            return
        plan = engine._sched.next_plan()
        with torch.inference_mode():
            for chunk in plan.chunks:
                engine._exec_chunk(chunk)
            if plan.decode_slots:
                engine._decode_round(plan.decode_slots)
    raise AssertionError(f"unfinished after {budget} iterations: {done}")


def _shape(timing):
    """What must agree with JAX: the keys and each phase's count."""
    return sorted(timing), {n: p["count"] for n, p in timing["phases"].items()}


def test_engine_timing_matches_jax(weights):
    """A cold prompt prefilled in two chunks, then a cache hit beside a
    second request: the same timing keys, phase names and counts, and the
    same event order per record."""
    jcfg, params, tree = weights
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 256, 40).tolist()
    kw = dict(num_slots=2, max_seq=96, multi_step=1, token_budget=32, decode_loop=False)
    jeng = JEngine(jcfg, params, **kw)
    teng = _port(tree, **kw)
    requests = [[("cold", prefix + [1, 2], 4)],
                [("hit", prefix + [3, 4, 5], 5), ("other", [7, 8, 9], 3)]]
    try:
        for batch in requests:
            _drive(jeng, batch, JSampling)
            _drive(teng, batch, SamplingParams)
        for rid in ("cold", "hit", "other"):
            jt, tt = jeng.request_timing(rid), teng.request_timing(rid)
            assert _shape(tt) == _shape(jt), rid
            assert tt["tokens"] == jt["tokens"] and tt["request_id"] == rid
            assert tt["e2e_s"] >= tt["ttft_s"] > 0 and tt["queue_s"] >= 0
        jrec = {r["rid"]: [e[0] for e in r["events"]] for r in jeng._recorder.records()}
        trec = {r["rid"]: [e[0] for e in r["events"]] for r in teng._recorder.records()}
        assert trec == jrec
        assert trec["hit"][:3] == ["queued", "admitted", "cache-attach"]
        assert trec["cold"].count("prefill-chunk") == 2 and trec["cold"][-1] == "decode"
        attach = next(e for e in teng._recorder.lookup("hit")["events"]
                      if e[0] == "cache-attach")
        assert attach[3] == {"cached_tokens": 32, "tier": "host"}
        assert _stats(teng._recorder) == _stats(jeng._recorder)
        assert teng.scheduler_stats()["recorder"]["finished"] == 3
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_every_record_retires_once(weights):
    """Reject at the quota, cancel while queued, cancel while decoding, and
    a queued request at shutdown: each record retires exactly once, under
    its own status, as in JAX's engine."""
    jcfg, params, tree = weights
    out = []
    for make, sampling in ((lambda **kw: JEngine(jcfg, params, **kw), JSampling),
                           (lambda **kw: _port(tree, **kw), SamplingParams)):
        eng = make(num_slots=1, max_seq=64, multi_step=1, max_queue_depth=2,
                   tenant_quota=0, decode_loop=False, prefix_cache=False)
        fired = []
        cb = fired.append
        try:
            eng.submit([1, 2, 3], sampling(max_tokens=50), lambda t, f: None,
                       request_id="long")
            eng.submit([4, 5], sampling(max_tokens=2), lambda t, f: cb(("q", t, f)),
                       request_id="queued")
            with pytest.raises((EngineOverloadedError, JOverloaded)):
                eng.submit([6], sampling(max_tokens=2), lambda t, f: None,
                           request_id="rejected")
            plan = eng._sched.next_plan()  # "long" takes the slot
            with torch.inference_mode():
                for chunk in plan.chunks:
                    eng._exec_chunk(chunk)
            assert eng.cancel("queued")
            eng.submit([7], sampling(max_tokens=2), lambda t, f: cb(("s", t, f)),
                       request_id="at-shutdown")
            eng.cancel("long")
            eng._process_cancels()
        finally:
            eng.shutdown()
        st, report = eng._recorder.stats(), eng.recorder_stats()
        # The port reports the burn rates; JAX's report call drains its
        # backlog into the same windows.
        burns = report.get("burn_rates", eng._serve_metrics.burn_rates())
        out.append(({k: st[k] for k in STAT_KEYS}, fired,
                    {r["rid"]: r["status"] for r in eng._recorder.records()}, burns))
    assert out[1] == out[0]
    stats, fired, status, burns = out[1]
    assert stats["started"] == 4 and stats["live"] == 0
    assert burns == {"": 1 / 0.01}  # the rejection breaches; cancels stay out
    assert status == {"rejected": "rejected", "queued": "cancelled",
                      "long": "cancelled", "at-shutdown": "dropped"}
    assert fired == [("q", -1, True), ("s", -1, True)]


def test_llm_server_generate_returns_timing(weights):
    _, _, tree = weights
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "params.pkl"), "wb") as f:
            pickle.dump(tree, f)
        server = LLMServer(LLMConfig(model_id="test-tiny", checkpoint_path=tmp,
                                     num_slots=2, max_seq=64, device="cpu"))
    prompt = np.random.default_rng(5).integers(1, 256, 20).tolist()

    async def run():
        try:
            first = await asyncio.wait_for(server.generate(prompt, max_tokens=4), 30)
            second = await asyncio.wait_for(server.generate(prompt + [9], max_tokens=3), 30)
            return first, second, await server.recorder_stats()
        finally:
            await server.shutdown()

    first, second, stats = asyncio.run(run())
    for res, n in ((first, 4), (second, 3)):
        t = res["timing"]
        assert t is not None and t["tokens"] == n
        assert set(t) == {"request_id", "queue_s", "ttft_s", "tpot_s", "e2e_s",
                          "tokens", "route", "phases", "trace_id"}
        assert t["phases"]["decode"]["count"] == 1
    assert "cache-attach" not in first["timing"]["phases"]
    assert second["timing"]["phases"]["cache-attach"]["count"] == 1  # 16 of 21 cached
    assert stats["finished"] == 2 and stats["live"] == 0
    assert set(stats["burn_rates"]) == {""}
