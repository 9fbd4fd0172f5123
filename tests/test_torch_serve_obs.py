"""The port's server surface against a live process on the CPU
(``python -m devspace_tpu_torch.serve --device cpu``, ``MODEL=tiny``), as
tests/test_serving_example.py drives the reference server:

- an injected TTFT breach (a microscopic ``DEVSPACE_SLO_TTFT_P99_S`` and
  a 3 s short window) flips ``/readyz`` to 503 within one evaluation
  interval while ``/healthz`` stays 200, and ``/readyz`` recovers once
  the window slides past it;
- ``/debug/events`` serves flight-recorder events whose trace ids
  cross-reference ``/debug/requests``; a ``traceparent`` header's trace
  id reaches the request's row, its spans and the OpenMetrics exemplars;
- ``/metrics``, ``/debug/config``, ``/debug/spans`` and ``/debug/trace``
  answer as the reference's do, and bad arguments are 400s;
- the JAX package's CLI reads the torch replica: ``debug bundle`` and
  ``status serving``.
"""

import json
import os
import subprocess
import sys
import tarfile
import time
import urllib.error
import urllib.request

import pytest

from devspace_tpu_torch.obs.fleet import parse_exposition
from devspace_tpu_torch.serving.fleet import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"


def get(base, path, headers=None, timeout=60):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, r.headers.get("Content-Type", ""), body
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def get_json(base, path, **kw):
    code, _, body = get(base, path, **kw)
    return code, json.loads(body)


def post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_for(fn, timeout, interval=0.1):
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got or time.monotonic() > deadline:
            return got
        time.sleep(interval)


@pytest.fixture(scope="module")
def base():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, MODEL="tiny", MAX_SLOTS="2", SPEC="0",
               DEVSPACE_SLO_INTERVAL_S="0.2", DEVSPACE_SLO_TTFT_P99_S="0.000001",
               DEVSPACE_SLO_SHORT_WINDOW_S="3", DEVSPACE_SLO_LONG_WINDOW_S="3600")
    env.pop("DEVSPACE_ENGINE_METRICS", None)
    env.pop("DEVSPACE_ENGINE_EVENTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "devspace_tpu_torch.serve", "--device", "cpu", "--port",
         str(port), "--host", "127.0.0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"

    def up():
        if proc.poll() is not None:
            pytest.fail(f"server died: {proc.stdout.read()[-2000:]}")
        try:
            return get(url, "/healthz", timeout=2)[0] == 200
        except OSError:
            return False

    try:
        assert wait_for(up, 120, 0.2), "server never answered /healthz"
        yield url
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_readyz_flips_on_a_ttft_breach_and_recovers(base):
    code, ready = get_json(base, "/readyz")
    assert code == 200 and ready["ready"] is True  # no data is not a breach
    # the evaluator's windows start at its first evaluation: an
    # observation made before it lands in the baseline, unseen
    assert wait_for(lambda: get_json(base, "/readyz")[1]["slo"].get("evaluated_at"), 10)
    time.sleep(0.3)
    code, g = post(base, "/generate", {"prompt_ids": [2, 9], "max_new_tokens": 4})
    assert code == 200 and len(g["tokens"]) == 4

    def ttft_breach():
        code, ready = get_json(base, "/readyz")
        return code == 503 and any(s["name"] == "ttft_p99" and s["status"] == "breach"
                                   for s in ready["slo"]["slos"]) and ready

    ready = wait_for(ttft_breach, 10)
    assert ready and ready["ready"] is False
    code, health = get_json(base, "/healthz")
    assert code == 200 and health["slo"]["status"] == "breach"  # liveness unaffected
    assert wait_for(lambda: get_json(base, "/readyz")[0] == 200, 20, 0.2)


def test_events_cross_reference_request_traces(base):
    code, g = post(base, "/generate", {"prompt_ids": [5, 1, 4], "max_new_tokens": 3},
                   headers={"traceparent": TRACEPARENT})
    assert code == 200
    code, events = get_json(base, "/debug/events?subsystem=engine&limit=500")
    assert code == 200 and events["events_enabled"] and "engine" in events["subsystems"]
    code, reqs = get_json(base, "/debug/requests?limit=100&outcome=completed")
    assert code == 200 and reqs["metrics_enabled"]
    req_traces = {r["trace_id"] for r in reqs["requests"]}
    assert TRACE_ID in req_traces
    admits = [e for e in events["events"] if e["event"] == "admit"]
    assert admits and {e["trace_id"] for e in admits} <= req_traces | {None}
    assert TRACE_ID in {e["trace_id"] for e in admits}
    code, spans = get_json(base, f"/debug/spans?trace_id={TRACE_ID}")
    assert code == 200 and spans["spans"]
    assert all(s["trace_id"] == TRACE_ID for s in spans["spans"])
    assert get_json(base, "/debug/requests?limit=x")[0] == 400
    assert get_json(base, "/debug/events?limit=x")[0] == 400
    code, none = get_json(base, "/debug/requests?outcome=failed")
    assert code == 200 and none["requests"] == []


def test_metrics_prometheus_and_openmetrics(base):
    post(base, "/generate", {"prompt_ids": [7, 7, 7], "max_new_tokens": 2},
         headers={"traceparent": TRACEPARENT})
    code, ctype, body = get(base, "/metrics")
    assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
    snap = parse_exposition(body.decode())
    for name in ("engine_tokens_generated_total", "engine_max_slots", "ttft_seconds",
                 "engine_dispatch_depth_occupancy", "slo_status"):
        assert name in snap, name
    assert snap["engine_max_slots"]["samples"][0][1] == 2
    assert snap["engine_tokens_generated_total"]["samples"][0][1] >= 2
    code, ctype, body = get(base, "/metrics",
                            headers={"Accept": "application/openmetrics-text"})
    text = body.decode()
    assert code == 200 and ctype.startswith("application/openmetrics-text")
    assert text.count("# EOF") == 1 and text.rstrip().endswith("# EOF")
    assert f'trace_id="{TRACE_ID}"' in text


def test_config_and_trace_endpoints(base):
    code, cfg = get_json(base, "/debug/config")
    assert code == 200 and cfg["model"] == "tiny" and cfg["max_slots"] == 2
    assert cfg["device"] == "cpu" and cfg["events_enabled"] is True
    assert any(s["name"] == "ttft_p99" for s in cfg["slos"])
    assert get_json(base, "/debug/trace?seconds=0")[0] == 400
    assert get_json(base, "/debug/trace?seconds=x")[0] == 400
    code, trace = get_json(base, "/debug/trace?seconds=0.3")
    assert code == 200 and "traceEvents" in trace


def test_jax_cli_reads_a_torch_replica(base, tmp_path):
    from devspace_tpu.cli.main import main as cli_main

    post(base, "/generate", {"prompt_ids": [3, 1], "max_new_tokens": 2})
    out = str(tmp_path / "bundle.tar.gz")
    assert cli_main(["debug", "bundle", "--url", base, "--out", out, "--seconds", "0"]) == 0
    with tarfile.open(out, "r:gz") as tar:
        names = set(tar.getnames())
        assert {"bundle/manifest.json", "bundle/metrics.txt", "bundle/healthz.json",
                "bundle/config.json", "bundle/requests.json", "bundle/events.json"} <= names
        manifest = json.load(tar.extractfile("bundle/manifest.json"))
        config = json.load(tar.extractfile("bundle/config.json"))
    assert not manifest["errors"] and config["model"] == "tiny"
    # the CLI's logger keeps the stream it found at import: run it apart
    out = subprocess.run(
        [sys.executable, "-m", "devspace_tpu", "status", "serving", "--url", base],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "tokens" in out.stdout + out.stderr
