"""The port's copies of ``obs/``, ``serving/router.py`` and the retry and
backoff policies against the JAX package's, on the CPU: the same inputs
through both, the outputs compared exactly.

- the same Registry operations render byte-equal Prometheus and
  OpenMetrics text, with the same latency bucket ladder (so a fleet
  merges histograms across JAX and torch replicas);
- ``parse_exposition`` and ``merge_snapshots`` agree on the same
  expositions, and so do the catalogs' aggregation hints;
- ``traceparent`` parsing and formatting and ``derive_span_id`` agree;
- the two ``EVENT_CATALOG``s are equal;
- an ``SLOEvaluator`` on an injected clock over the same samples gives
  the same statuses at every step;
- ``PrefixRouter`` makes the same decisions over scripted sequences
  adapted from the goldens of tests/test_serving_router.py and
  tests/test_serving_disagg.py (loads, prefixes, tenants, admission
  bands, disaggregated thresholds), decision by decision;
- the retry policy's delay schedule and ``IdleBackoff``'s waits agree.
"""

import dataclasses

import pytest

from devspace_tpu.obs import events as jevents
from devspace_tpu.obs import fleet as jfleet
from devspace_tpu.obs import metrics as jmetrics
from devspace_tpu.obs import slo as jslo
from devspace_tpu.obs import tracing as jtracing
from devspace_tpu.resilience import policy as jpolicy
from devspace_tpu.serving import router as jrouter
from devspace_tpu_torch.obs import events as tevents
from devspace_tpu_torch.obs import fleet as tfleet
from devspace_tpu_torch.obs import metrics as tmetrics
from devspace_tpu_torch.obs import slo as tslo
from devspace_tpu_torch.obs import tracing as ttracing
from devspace_tpu_torch.resilience import policy as tpolicy
from devspace_tpu_torch.serving import router as trouter


def both(fn):
    """``fn(module set)`` for the JAX package's modules and the port's."""
    jax_side = fn(dict(metrics=jmetrics, fleet=jfleet, slo=jslo, tracing=jtracing,
                       events=jevents, router=jrouter, policy=jpolicy))
    torch_side = fn(dict(metrics=tmetrics, fleet=tfleet, slo=tslo, tracing=ttracing,
                         events=tevents, router=trouter, policy=tpolicy))
    return jax_side, torch_side


def scripted_registry(m):
    reg = m["metrics"].Registry()
    c = reg.counter("engine_requests_completed_total", "Requests that finished")
    c.inc()
    c.inc(4)
    lab = reg.counter("requests_finished_total", "Terminal outcomes", labels=("outcome",))
    lab.labels(outcome="completed").inc(3)
    lab.labels(outcome="failed").inc()
    g = reg.gauge("engine_active_slots", "Slots decoding")
    g.set(2.5)
    h = reg.histogram("ttft_seconds", "Time to first token")
    for v, ex in ((0.003, None), (0.04, "a" * 32), (0.9, None), (7.0, "b" * 32), (1e4, None)):
        h.observe(v, exemplar=ex)
    reg.register_callback("engine_queued_requests", "gauge", "Requests waiting", lambda: 3)
    reg.register_callback("slo_status", "gauge", "Status", lambda: [({"slo": "x"}, 1.0)],
                          labels=("slo",))
    return reg


@pytest.fixture
def frozen_wall_clock(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def test_registry_renders_byte_equal(frozen_wall_clock):
    (jr, tr) = both(scripted_registry)
    assert jr.render() == tr.render()
    assert jr.render_openmetrics() == tr.render_openmetrics()
    assert jr.snapshot() == tr.snapshot()
    assert jmetrics.render_snapshot(jr.snapshot()) == tmetrics.render_snapshot(tr.snapshot())
    assert jmetrics.DEFAULT_LATENCY_BUCKETS == tmetrics.DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize("value", [None, "off", "0", "on", "false", "1"])
def test_metrics_enabled_reads_the_same_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("DEVSPACE_ENGINE_METRICS", raising=False)
    else:
        monkeypatch.setenv("DEVSPACE_ENGINE_METRICS", value)
    for explicit in (None, True, False):
        assert jmetrics.metrics_enabled(explicit) == tmetrics.metrics_enabled(explicit)


def test_windowed_rate_agrees():
    def run(m):
        t = [100.0]
        rate = m["metrics"].WindowedRate(10.0, clock=lambda: t[0])
        out = []
        for step in range(30):
            t[0] += 0.7
            rate.add(step % 4)
            out.append(rate.rate())
        return out

    jax_side, torch_side = both(run)
    assert jax_side == torch_side


EXPOSITIONS = [
    "# HELP engine_tokens_generated_total Generated tokens\n"
    "# TYPE engine_tokens_generated_total counter\n"
    "engine_tokens_generated_total 120\n"
    "# HELP engine_dispatch_depth_occupancy Mean depth\n"
    "# TYPE engine_dispatch_depth_occupancy gauge\n"
    "engine_dispatch_depth_occupancy 1.5\n"
    "# HELP engine_max_slots Capacity\n"
    "# TYPE engine_max_slots gauge\n"
    "engine_max_slots 8\n"
    "# HELP ttft_seconds TTFT\n"
    "# TYPE ttft_seconds histogram\n"
    'ttft_seconds_bucket{le="0.1"} 3\n'
    'ttft_seconds_bucket{le="1"} 5\n'
    'ttft_seconds_bucket{le="+Inf"} 6\n'
    "ttft_seconds_sum 2.5\n"
    "ttft_seconds_count 6\n"
    "# HELP requests_finished_total Outcomes\n"
    "# TYPE requests_finished_total counter\n"
    'requests_finished_total{outcome="completed"} 5\n'
    'requests_finished_total{outcome="failed"} 1\n',
    "# HELP engine_tokens_generated_total Generated tokens\n"
    "# TYPE engine_tokens_generated_total counter\n"
    "engine_tokens_generated_total 30\n"
    "# HELP engine_dispatch_depth_occupancy Mean depth\n"
    "# TYPE engine_dispatch_depth_occupancy gauge\n"
    "engine_dispatch_depth_occupancy 0.5\n"
    "# HELP engine_max_slots Capacity\n"
    "# TYPE engine_max_slots gauge\n"
    "engine_max_slots 4\n"
    "# HELP ttft_seconds TTFT\n"
    "# TYPE ttft_seconds histogram\n"
    'ttft_seconds_bucket{le="0.1"} 1\n'
    'ttft_seconds_bucket{le="1"} 1\n'
    'ttft_seconds_bucket{le="+Inf"} 2\n'
    "ttft_seconds_sum 9.0\n"
    "ttft_seconds_count 2\n"
    "# HELP requests_finished_total Outcomes\n"
    "# TYPE requests_finished_total counter\n"
    'requests_finished_total{outcome="completed"} 2\n',
]


def test_parse_and_merge_agree(frozen_wall_clock):
    live = both(lambda m: scripted_registry(m).render())
    assert live[0] == live[1]
    texts = EXPOSITIONS + [live[0]]

    def run(m):
        snaps = [m["fleet"].parse_exposition(t) for t in texts]
        merged, notes = m["fleet"].merge_snapshots(snaps)
        return snaps, merged, sorted(notes), m["metrics"].render_snapshot(merged)

    jax_side, torch_side = both(run)
    assert jax_side == torch_side
    merged = torch_side[1]
    assert merged["engine_tokens_generated_total"]["samples"][0][1] == 150
    with pytest.raises(tfleet.ExpositionParseError):
        tfleet.parse_exposition("engine_x{le=} nope\n")


def test_aggregation_hints_agree_on_shared_families():
    j, t = jfleet.aggregation_hints(), tfleet.aggregation_hints()
    shared = set(j) & set(t)
    assert {n for n in j if n.startswith(("engine_", "slo_", "collector_", "ttft"))} <= shared
    assert {n: j[n] for n in shared} == {n: t[n] for n in shared}


TRACEPARENTS = [
    None, "", "garbage",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-09",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_and_format_agree(header):
    def run(m):
        ctx = m["tracing"].SpanContext.from_traceparent(header)
        return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.to_traceparent())

    jax_side, torch_side = both(run)
    assert jax_side == torch_side


def test_derive_span_id_agrees():
    for parent in ("00f067aa0ba902b7", "4bf92f3577b34da6a3ce929d0e0e4736", ""):
        for name in ("request-1", "prefill", "kv_migrate", "x" * 100):
            assert jtracing.derive_span_id(parent, name) == ttracing.derive_span_id(parent, name)


def test_event_catalogs_are_equal():
    assert tevents.EVENT_CATALOG == jevents.EVENT_CATALOG
    assert tevents.lint_catalog() == jevents.lint_catalog() == []
    assert jtracing.TIMELINE_TRACKS == ttracing.TIMELINE_TRACKS


def test_slo_evaluator_agrees_step_by_step():
    """TTFT observations, request outcomes and a token-rate gauge fed on
    one injected clock; every evaluation's statuses are equal."""

    def run(m):
        t = [0.0]
        reg = m["metrics"].Registry()
        ttft = reg.histogram("ttft_seconds", "TTFT")
        done = reg.counter("engine_requests_completed_total", "done")
        failed = reg.counter("engine_requests_failed_total", "failed")
        rate = reg.gauge("engine_tokens_per_sec_10s", "rate")
        active = reg.gauge("engine_active_slots", "active")
        specs = m["slo"].default_serving_slos(ttft_threshold_s=0.5, tok_s_floor=5.0,
                                             short_window_s=10.0, long_window_s=60.0)
        ev = m["slo"].SLOEvaluator(specs, reg.snapshot, clock=lambda: t[0],
                                   bus=m["events"].EventBus())
        out = []
        for step in range(40):
            t[0] += 1.0
            ttft.observe(0.1 if step < 15 or step > 30 else 2.0)
            (failed if step % 9 == 4 else done).inc()
            rate.set(20.0 if step < 20 else 1.0)
            active.set(1.0 if step % 3 else 0.0)
            out.append([s.to_dict() for s in ev.evaluate()])
            out.append((ev.ready(), ev.worst()))
        return out

    jax_side, torch_side = both(run)
    assert jax_side == torch_side
    statuses = {s["status"] for step in torch_side[::2] for s in step}
    assert {"ok", "breach"} <= statuses


# -- router decisions ----------------------------------------------------------
def decisions(m, replicas, loads, cfg, script):
    """Run ``script`` (a list of ("route", prompt, kwargs) /
    ("complete", replica, kwargs) / ("prefill_complete", replica, n, ok))
    through a router built from module set ``m``."""
    R = m["router"]
    loads = {n: R.ReplicaLoad(**kw) for n, kw in loads.items()}
    router = R.PrefixRouter(
        replicas_fn=lambda: {n: f"http://{n}" for n in replicas},
        loads_fn=lambda: loads,
        config=R.RouterConfig(**{"policy": "prefix", **cfg}),
        clock=lambda: 0.0,
    )
    out = []
    for op in script:
        if op[0] == "route":
            _, prompt, kw = op
            kw = dict(kw)
            if "exclude" in kw:
                kw["exclude"] = frozenset(kw["exclude"])
            d = router.route(prompt, **kw)
            out.append(dataclasses.asdict(d))
        elif op[0] == "observe":
            router.shadow.observe(op[1], R.fingerprint_chain(op[2], 8))
        elif op[0] == "complete":
            router.complete(op[1], **op[2])
        elif op[0] == "prefill_complete":
            router.prefill_complete(op[1], op[2], ok=op[3])
    stats = router.stats()
    snap = router.registry.snapshot()
    return out, stats, {n: f["samples"] for n, f in snap.items()}


LONG = list(range(40))
SHORT = list(range(16))
ROUTER_CASES = {
    "cold_ties": (("b", "a", "c"), {}, {}, [("route", SHORT, {})]),
    "affinity": (("a", "b"), {}, {}, [
        ("route", SHORT, {}), ("complete", "a", {"service_s": 0.1}),
        ("route", SHORT, {}), ("complete", "a", {"service_s": 0.1}),
        ("route", list(range(32)), {})]),
    "hot_holder_spills": (("a", "b"), {"a": dict(occupancy=1.0, queued=6, max_slots=6, active=6)},
                          {"admission": False}, [("observe", "a", SHORT), ("route", SHORT, {})]),
    "slo_pressure": (("a", "b"), {"a": dict(slo_pressure=2.0)}, {},
                     [("observe", "a", SHORT), ("route", SHORT, {})]),
    "tenants": (("a", "b"), {}, {}, [
        ("route", list(range(100 + 16 * i, 116 + 16 * i)), {"tenant": "big"}) for i in range(6)
    ] + [("route", SHORT, {"tenant": "small"}), ("route", SHORT, {"tenant": "big"})]),
    "least_loaded": (("a", "b"), {"a": dict(occupancy=0.5)}, {"policy": "least_loaded"},
                     [("observe", "a", SHORT), ("route", SHORT, {})]),
    "round_robin": (("c", "a", "b"), {}, {"policy": "round_robin"},
                    [("route", SHORT, {}) for _ in range(4)]),
    "admission_bands": (("a",), {"a": dict(occupancy=1.0, queued=4, max_slots=4, active=4)},
                        {}, [("route", SHORT, {}), ("route", LONG, {"stamp": False})]),
    "exclude": (("a", "b"), {}, {}, [("route", SHORT, {}),
                                     ("route", SHORT, {"exclude": ["a"]}),
                                     ("route", SHORT, {"exclude": ["a", "b"]})]),
    "no_replicas": ((), {}, {}, [("route", SHORT, {})]),
    "disagg_off": (("a", "b"), {}, {}, [("route", LONG, {})]),
    "disagg_short": (("a", "b"), {}, {"disagg_threshold_tokens": 32}, [("route", SHORT, {})]),
    "disagg_pool": (("a", "b", "p0"), {}, {"disagg_threshold_tokens": 32,
                                           "prefill_pool": ("p0",)}, [("route", LONG, {})]),
    "disagg_threshold": (("a", "b"), {}, {"disagg_threshold_tokens": 40}, [
        ("route", list(range(39)), {"stamp": False}), ("route", LONG, {}), ("route", LONG, {})]),
    "disagg_band": (("a", "b"), {"a": dict(occupancy=0.9), "b": dict(occupancy=0.9)},
                    {"disagg_threshold_tokens": 64}, [("route", SHORT, {}),
                                                      ("route", [1, 2, 3], {})]),
    "disagg_no_pool": (("a", "b", "c"), {}, {"disagg_threshold_tokens": 32}, [
        ("route", list(range(100, 140)), {}), ("route", list(range(200, 240)), {}),
        ("route", list(range(300, 340)), {})]),
    "disagg_pool_balance": (("a", "p0", "p1"), {}, {"disagg_threshold_tokens": 32,
                                                   "prefill_pool": ("p0", "p1")}, [
        ("route", list(range(100, 140)), {}), ("route", list(range(200, 240)), {}),
        ("prefill_complete", "p0", 40, True), ("route", list(range(300, 340)), {})]),
    "disagg_failure": (("a", "b"), {}, {"disagg_threshold_tokens": 32}, [
        ("route", LONG, {}), ("prefill_complete", "b", 40, False)]),
    "disagg_pool_degrades": (("a", "p0"), {}, {"disagg_threshold_tokens": 32,
                                              "prefill_pool": ("p0",)}, [
        ("route", LONG, {}), ("route", LONG, {"exclude": ["a"]})]),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_decisions_agree(case):
    replicas, loads, cfg, script = ROUTER_CASES[case]
    jax_side, torch_side = both(lambda m: decisions(m, replicas, loads, cfg, script))
    assert jax_side == torch_side
    assert jax_side[0], "the script made no decision"


def test_loads_from_collector_agree():
    class Target:
        def __init__(self, name, snapshot, up=True, quarantined=False, health=None):
            self.name, self.snapshot = name, snapshot
            self.up, self.quarantined, self.health = up, quarantined, health or {}

    def fam(v):
        return {"samples": [({}, v)], "kind": "gauge", "help": ""}

    snap = {"engine_dispatch_depth_occupancy": fam(0.5), "engine_queued_requests": fam(3.0),
            "engine_max_slots": fam(4.0), "engine_active_slots": fam(2.0)}

    class Collector:
        targets = [Target("r0", snap, health={"slo": {"status": "warn"}}),
                   Target("r1", snap, up=False), Target("r2", None),
                   Target("r3", snap, quarantined=True), Target("r4", snap)]

    j = {n: dataclasses.asdict(v) for n, v in jrouter.loads_from_collector(Collector()).items()}
    t = {n: dataclasses.asdict(v) for n, v in trouter.loads_from_collector(Collector()).items()}
    assert j == t and sorted(t) == ["r0", "r4"]


def test_retry_and_idle_backoff_schedules_agree():
    def run(m):
        pol = m["policy"].RetryPolicy(max_attempts=6, base_delay=0.1, max_delay=2.0, jitter=0.5,
                                      seed=7)
        idle = m["policy"].IdleBackoff(initial=0.05, maximum=1.0, jitter=0.5, seed=3)
        waits = [idle.next_wait() for _ in range(6)]
        idle.reset()
        return list(pol.delays()), waits, idle.next_wait()

    jax_side, torch_side = both(run)
    assert jax_side == torch_side


def test_autoscaler_decisions_agree():
    """The HPA-style decision core over one scripted run of occupancy
    signals on an injected clock: the same desired sizes, tick by tick."""
    from devspace_tpu.serving import autoscale as jscale
    from devspace_tpu_torch.serving import autoscale as tscale

    def pods(value):
        return [{"type": "Pods", "pods": {
            "metric": {"name": "engine_dispatch_depth_occupancy"},
            "target": {"type": "AverageValue", "averageValue": str(value)}}}]

    occupancy = [0.2, 0.9, 1.6, 1.7, 1.2, 0.5, 0.1, 0.1, 0.05, 0.8, 2.0, 0.3]

    def run(mod):
        t = [0.0]
        scaler = mod.Autoscaler(mod.AutoscalerConfig(max_replicas=5,
                                                     scale_down_stabilization_s=3.0),
                                clock=lambda: t[0])
        current, out = 1, []
        for occ in occupancy:
            t[0] += 1.0
            d = scaler.evaluate(pods(occ), current)
            out.append(dataclasses.asdict(d))
            current = d.desired
        return out

    got, want = run(tscale), run(jscale)
    assert got == want
    assert len({d["desired"] for d in got}) > 2


def test_circuit_breaker_states_agree():
    """Failures open the breaker, the reset timeout half-opens it, a probe
    closes or reopens it: the same state after every call, on one clock."""

    def run(m):
        t = [0.0]
        cb = m["policy"].CircuitBreaker(failure_threshold=2, reset_timeout=5.0,
                                       clock=lambda: t[0])
        states = []
        for dt, ok in ((0, False), (1, False), (1, True), (5, False), (1, True), (6, True),
                       (0, True)):
            t[0] += dt
            try:
                cb.call(lambda: None if ok else (_ for _ in ()).throw(OSError("down")))
                states.append(("ok", cb.state))
            except Exception as e:  # noqa: BLE001
                states.append((type(e).__name__, cb.state))
        return states

    jax_side, torch_side = both(run)
    assert jax_side == torch_side
    assert {s for _, s in torch_side} >= {"open", "closed"}


def test_collectors_federate_alike_and_serve_the_merge():
    """Both collectors over the same two expositions (an injected fetch):
    the same merged exposition; the port's ``make_http_server`` serves it
    on ``/metrics`` and reports both targets up on ``/healthz``."""
    import json
    import threading
    import urllib.request

    from devspace_tpu.obs import collector as jcollector
    from devspace_tpu_torch.obs import collector as tcollector

    pages = {"http://a": EXPOSITIONS[0], "http://b": EXPOSITIONS[1]}

    def fetch(url, timeout):
        if url.endswith("/metrics"):
            return pages[url[: -len("/metrics")]].encode()
        return json.dumps({"ok": True}).encode() if "/healthz" in url else b"{}"

    def run(mod):
        c = mod.TelemetryCollector([("a", "http://a"), ("b", "http://b")], fetch=fetch,
                                   clock=lambda: 100.0)
        c.scrape_once()
        return c, c.render_metrics()

    (_, jtext), (tcol, ttext) = run(jcollector), run(tcollector)
    assert ttext == jtext and "engine_tokens_generated_total 150" in ttext
    httpd = tcollector.make_http_server(tcol, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read().decode() == ttext
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and all(t.up for t in tcol.targets)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
