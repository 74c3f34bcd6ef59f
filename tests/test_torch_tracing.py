"""PyTorch port: request tracing and SLO burn rates on the CPU, against the
JAX package's.

* The wire form: a JAX `TraceContext.to_wire` read by the port's
  `from_wire` and back, children keeping the trace id, malformed wires
  read as None in both.
* `SpanAssembler` builds the same waterfall from the same spans,
  `make_span` the same dict, and `SloTracker` gives the same burn rates,
  burning state and stats as JAX's on the same outcomes with an
  injected `now`.
* Through the port's daemon: a sampled context comes back with the
  replica-side spans (serve, queue, dispatch, respond), the dispatch
  span linked to its batch-mates and carrying the cost model's count.
"""

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

from lightgbm_tpu.observability import tracing as jtr
from lightgbm_tpu_torch.observability import tracing as ttr


def test_wire_round_trip_between_packages():
    for sampled in (False, True):
        j = jtr.TraceContext.new(sampled=sampled)
        t = ttr.TraceContext.from_wire(j.to_wire())
        assert (t.trace_id, t.span_id, t.parent_id, t.sampled) == (
            j.trace_id, j.span_id, j.parent_id, j.sampled)
        c = t.child()
        back = jtr.TraceContext.from_wire(c.to_wire())
        assert back.trace_id == j.trace_id and back.parent_id == t.span_id
        assert back.sampled == sampled
        assert c.to_wire() == back.to_wire()
    for bad in (None, {}, "x", {"trace_id": 1}, {"span_id": "ab"}):
        assert (ttr.TraceContext.from_wire(bad) is None) == (
            jtr.TraceContext.from_wire(bad) is None)
    assert len(ttr.new_trace_id()) == len(jtr.new_trace_id()) == 16
    assert len(ttr.new_span_id()) == len(jtr.new_span_id()) == 8
    assert ttr.MAX_SPANS_PER_REQUEST == jtr.MAX_SPANS_PER_REQUEST


def _spans(mod, ctx):
    kid = ctx.child()
    return [
        mod.make_span(kid, "dispatch", 100.25, 100.5, links=[
            {"trace_id": "ab" * 8}], rows=4, bucket=None),
        mod.make_span(ctx, "route", 100.0, 100.75, model="m", attempt=1),
        mod.make_span(kid.child(), "respond", 100.5, 100.6),
    ]


def test_make_span_and_assembler_equal_jax():
    ctx = jtr.TraceContext("0123456789abcdef", "01234567", None, True)
    tctx = ttr.TraceContext.from_wire(ctx.to_wire())
    js, ts = _spans(jtr, ctx), _spans(ttr, tctx)
    ids = ("span_id", "parent_id")          # children draw fresh ids
    for a, b in zip(js, ts):
        assert {k: v for k, v in a.items() if k not in ids} == \
            {k: v for k, v in b.items() if k not in ids}
        b.update({k: a[k] for k in ids})
    ja, ta = jtr.SpanAssembler(capacity=8), ttr.SpanAssembler(capacity=8)
    jw = ja.assemble(ctx.trace_id, [dict(s) for s in js], model="m",
                     replica=1, version=None)
    tw = ta.assemble(ctx.trace_id, [dict(s) for s in ts], model="m",
                     replica=1, version=None)
    assert tw == jw
    assert [s["name"] for s in tw["spans"]] == ["route", "dispatch",
                                                 "respond"]
    assert [s["rel_ms"] for s in tw["spans"]] == [0.0, 250.0, 500.0]
    assert ta.get(ctx.trace_id) == tw and ta.latest() == tw
    for i in range(12):                     # bounded retention
        ta.assemble(f"{i:016x}", [dict(s) for s in ts])
        ja.assemble(f"{i:016x}", [dict(s) for s in js])
    assert ta.ids() == ja.ids() and len(ta.ids()) == 8


@pytest.mark.parametrize("p99,err_pct,outcomes", [
    (50.0, 1.0, [(10.0, True)] * 40),
    (50.0, 5.0, [(80.0, True)] * 10 + [(10.0, True)] * 30),
    (20.0, 2.0, [(5.0, i % 3 != 0) for i in range(48)]),
    (0.0, 1.0, [(10.0, False)] * 16)])
def test_slo_tracker_equals_jax(p99, err_pct, outcomes):
    kw = dict(error_pct=err_pct, fast_window_s=5.0, slow_window_s=30.0,
              burn_threshold=1.0)
    j, t = jtr.SloTracker(p99, **kw), ttr.SloTracker(p99, **kw)
    assert t.enabled == j.enabled
    for i, (lat, ok) in enumerate(outcomes):
        now = 1000.0 + 0.25 * i
        j.observe(lat, ok=ok, now=now)
        t.observe(lat, ok=ok, now=now)
        if i % 5 == 0:
            assert t.burn_rates(now=now) == j.burn_rates(now=now)
    end = 1000.0 + 0.25 * len(outcomes)
    for dt in (0.0, 6.0, 40.0):
        assert t.burn_rates(now=end + dt) == j.burn_rates(now=end + dt)
        assert t.evaluate(now=end + dt) == j.evaluate(now=end + dt)
        assert t.burning == j.burning
    assert t.stats() == j.stats()


def test_daemon_returns_linked_spans():
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.serving import ServingDaemon

    rng = np.random.RandomState(0)
    X = rng.randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    b = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device_type": "cpu"}, tlgb.Dataset(X, label=y), 3)
    d = ServingDaemon(Config({"device_type": "cpu",
                              "device_predict_min_bucket": 64,
                              "serve_max_batch_rows": 256,
                              "serve_max_coalesce_wait_ms": 50.0})).start()
    try:
        d.registry.register("m", model_str=b.model_to_string(), block=True)
        ctxs = [ttr.TraceContext.new(sampled=s) for s in (True, True, False)]
        futs = [d.submit("m", X[i:i + 2], trace=c)
                for i, c in enumerate(ctxs)]
        for f in futs:
            f.result(timeout=30)
        spans = futs[0].spans
        assert futs[2].spans is None
        assert [s["name"] for s in spans] == ["serve", "queue", "dispatch",
                                              "respond"]
        assert all(s["trace_id"] == ctxs[0].trace_id for s in spans)
        assert spans[0]["parent_id"] == ctxs[0].span_id
        disp = spans[2]
        if disp["attrs"]["group_requests"] == 3:    # one coalesced batch
            linked = {ln["trace_id"] for ln in disp["links"]}
            assert linked == {ctxs[1].trace_id, ctxs[2].trace_id}
        assert disp["attrs"]["bucket"] == 64 and disp["attrs"]["bytes"] > 0
    finally:
        d.stop()
