"""The port's copy of the observability layer: the metrics registry, span
tracer and exporters driven through the same operations as the JAX
package's ``repro.obs`` must give the same snapshots and exports; the
serving engine's instruments agree with its handles' timestamps."""
import json

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs.exporters import prometheus_exposition as jexpo
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.tracing import SpanTracer as JTracer
from repro_torch.obs.exporters import (JSONLExporter, PrometheusExporter,
                                       prometheus_exposition)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import SpanTracer


@pytest.fixture(autouse=True)
def _clean_obs():
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


def _drive_registry(r):
    """One fixed sequence of instrument operations."""
    c = r.counter("req_total", "requests", labels=("reason",))
    c.inc(3, ("eos",))
    c.inc(1, ("length",))
    g = r.gauge("depth", "queue depth")
    g.set(2)
    g.add(0.5)
    h = r.histogram("lat_seconds", "latency", edges=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 99.0):
        h.observe(v)
    d = r.histogram("default_seconds")
    for v in np.geomspace(1e-4, 50, 40):
        d.observe(float(v))
    return h, d


def test_registry_snapshot_and_exposition_match_jax():
    rt, rj = MetricsRegistry(), JRegistry()
    (ht, dt), (hj, dj) = _drive_registry(rt), _drive_registry(rj)
    assert rt.snapshot() == rj.snapshot()
    assert prometheus_exposition(rt) == jexpo(rj)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
        assert dt.quantile(q) == dj.quantile(q)
    assert ht.mean() == hj.mean()


def test_registration_conflicts_and_disabled_mode():
    r = MetricsRegistry()
    r.counter("m1", labels=("a",))
    assert r.counter("m1", labels=("a",)) is r.get("m1")
    with pytest.raises(ValueError):
        r.gauge("m1")
    with pytest.raises(ValueError):
        r.counter("m1", labels=("b",))
    with pytest.raises(ValueError):
        r.histogram("m3", edges=(2.0, 1.0))
    off = MetricsRegistry(enabled=False)
    c, h = off.counter("c"), off.histogram("h")
    c.inc()
    h.observe(1.0)
    assert c.value() == 0 and h.count() == 0
    off.enable()
    c.inc()
    assert c.value() == 1


def _drive_tracer(tr):
    with tr.span("outer", step=1, n=2):
        with tr.span("inner", step=1):
            tr.instant("tick", step=1)
    for i in range(6):
        tr.instant("e", step=i)


def test_tracer_records_match_jax():
    """Same nesting, ring order and drops; times differ by nature."""
    tt, tj = SpanTracer(capacity=5), JTracer(capacity=5)
    _drive_tracer(tt)
    _drive_tracer(tj)
    strip = [{k: v for k, v in rec.items() if k not in ("ts", "dur", "tid")}
             for rec in tt.records()]
    assert strip == [{k: v for k, v in rec.items()
                      if k not in ("ts", "dur", "tid")}
                     for rec in tj.records()]
    assert tt.dropped == tj.dropped == 4
    trace = json.loads(json.dumps(tt.chrome_trace()))
    assert [e["ph"] for e in trace["traceEvents"]] == \
        [e["ph"] for e in tj.chrome_trace()["traceEvents"]]
    tt.clear()
    assert tt.records() == [] and tt.dropped == 0
    off = SpanTracer(capacity=4, enabled=False)
    with off.span("s"):
        pass
    assert off.records() == []


def test_tracer_to_sink_buckets_by_step():
    class Sink:
        def __init__(self):
            self.rows = []

        def log_metrics(self, rec):
            self.rows.append(rec)

    tr = SpanTracer(capacity=32)
    for step in (1, 2):
        with tr.span("work", step=step):
            pass
    tr.instant("trip", step=2)
    with tr.span("unstepped"):
        pass
    sink = Sink()
    assert tr.to_sink(sink) == 3
    assert [r["step"] for r in sink.rows] == [1, 2, 2]
    assert "span/work" in sink.rows[0] and sink.rows[2]["event/trip"] == 1.0


def test_exporters_write_files(tmp_path):
    r = MetricsRegistry()
    r.counter("c_total").inc(5)
    h = r.histogram("h_seconds", edges=(1.0, 2.0))
    h.observe(0.5)
    path = tmp_path / "snap" / "metrics.prom"
    assert PrometheusExporter(r, str(path)).write() == str(path)
    assert "c_total 5" in path.read_text()
    assert not path.with_suffix(".prom.tmp").exists()
    exp = JSONLExporter(r, str(tmp_path / "m.jsonl"))
    exp.write(step=10)
    h.observe(1.5)
    exp.write(step=20)
    lines = [json.loads(ln) for ln in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [10, 20]
    assert lines[1]["metrics"]["h_seconds"]["series"][""]["count"] == 2
    bad = MetricsRegistry()
    bad.counter("bad-name")
    with pytest.raises(ValueError):
        prometheus_exposition(bad)


def test_module_api_matches_jax():
    assert tobs.__all__ == jobs.__all__
    tobs.enable()
    assert tobs.enabled() and tobs.tracer().enabled
    tobs.disable()
    assert not tobs.enabled()


@pytest.fixture(scope="module")
def engine_setup():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("llama-350m", smoke=True)
    return cfg, T.init_params(cfg, seed=0, device="cpu")


def _churn(cfg, params, *, cancel_one=False):
    from repro_torch.serve import PagedServeEngine, Session

    eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=32,
                           max_blocks_per_seq=6, num_slots=2,
                           max_prefill_len=16, prefill_chunk=8, num_splits=2)
    sess = Session(eng, "obs")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 5, 11, 7, 10)]
    budgets = [6, 3, 5, 4, 4]
    hs = [sess.submit(prompts[0], max_new_tokens=budgets[0]),
          sess.submit(prompts[1], max_new_tokens=budgets[1])]
    eng.step()
    eng.step()
    hs.append(sess.submit(prompts[2], max_new_tokens=budgets[2]))
    hs.append(sess.submit(prompts[3], max_new_tokens=budgets[3]))
    if cancel_one:
        hs.append(sess.submit(prompts[4], max_new_tokens=budgets[4]))
        hs[2].cancel()
    eng.run()
    return eng, hs


def test_serve_histograms_match_handle_timestamps(engine_setup):
    cfg, params = engine_setup
    tobs.enable()
    eng, hs = _churn(cfg, params)
    r = tobs.registry()
    for name, vals in (
            ("serve_ttft_seconds", [h.ttft for h in hs]),
            ("serve_itl_seconds",
             [g for h in hs for g in h.inter_token_latencies()]),
            ("serve_queue_wait_seconds", [h.queue_wait for h in hs]),
            ("serve_e2e_seconds", [h.e2e for h in hs])):
        hist = r.get(name)
        assert hist.count() == len(vals), name
        assert hist.sum() == pytest.approx(sum(vals), rel=1e-9), name
    assert r.get("serve_tokens_total").value() == \
        sum(len(h.tokens) for h in hs)
    assert r.get("serve_requests_finished_total").value(("length",)) == 4
    names = {rec["name"] for rec in tobs.tracer().records()}
    assert {"serve/admit", "serve/decode_step"} <= names


def test_serve_step_stats_and_counters(engine_setup):
    cfg, params = engine_setup
    eng, hs = _churn(cfg, params)
    st = eng.step_stats
    assert st["running"] == 0 and st["free_blocks"] == 32
    assert st["tokens_emitted"] == sum(len(h.tokens) for h in hs)
    assert tobs.registry().get("serve_tokens_total").value() == 0
    tobs.enable()
    eng, hs = _churn(cfg, params, cancel_one=True)
    r = tobs.registry()
    cancels = r.get("serve_cancellations_total")
    assert cancels.value(("queued",)) + cancels.value(("running",)) == 1
    assert r.get("serve_requests_finished_total").value(("cancelled",)) == 1
    assert r.get("serve_backpressure_steps_total").value(("slots",)) > 0
    assert r.get("serve_pool_free_blocks").value() == 32
