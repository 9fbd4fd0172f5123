"""The serving operator's commands of the port's CLI against the JAX
CLI's: ``status serving``, ``profile serving``, ``top`` (one frame and
``--fleet``), ``fleet status``, ``debug bundle`` (one server, ``--fleet``,
``--target``, a partial failure), ``collector serve`` and the Prometheus
text helpers, each run by both ``main``s on the same in-process stub
servers (a port of tests/test_cli_incident.py and tests/test_cli_fleet.py).
Stdout must be equal line for line, with clock times masked; bundles must
hold the same members and manifests. Last, ``from_workers`` on the port's
fake cluster resolves the targets the reference's resolves on its own."""

import json
import re
import sys
import tarfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from devspace_tpu.cli import main as jcli
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch.cli import main as tcli
from devspace_tpu_torch.obs.metrics import Registry
from devspace_tpu_torch.serving.fleet import free_port
from devspace_tpu_torch.utils import log as logutil

TRACE = "ab" * 16

METRICS_TEXT = """\
# HELP engine_tokens_per_sec_10s Tokens per second.
# TYPE engine_tokens_per_sec_10s gauge
engine_tokens_per_sec_10s 42.5
engine_active_slots 3
engine_max_slots 4
engine_queued_requests 1
engine_prefilling_slots 1
engine_free_kv_blocks 10
engine_kv_blocks 64
engine_dispatch_depth_occupancy 1.71
engine_kv_tier_resident_bytes 1048576
engine_kv_spill_blocks_total 12
engine_requests_completed_total 100
engine_requests_failed_total 2
slo_status{slo="ttft_p99"} 2
slo_burn_ratio{slo="ttft_p99",window="short"} 8.0
"""

HEALTHZ = {
    "status": "ok", "model": "tiny", "active_slots": 3, "queued": 1,
    "requests_completed": 100, "requests_failed": 2, "tokens_generated": 777,
    "tokens_per_sec": 12.25, "free_blocks": 10, "kv_tier": "off", "uptime_s": 31.5,
    "slo": {
        "ready": False, "status": "breach",
        "slos": [
            {"name": "ttft_p99", "status": "breach", "burn_short": 8.0, "burn_long": 8.0},
            {"name": "error_rate", "status": "ok", "burn_short": 0.1, "burn_long": 0.2},
        ],
    },
}

EVENTS = {"events_enabled": True, "subsystems": ["engine"], "events": [
    {"time": 1754500000.0, "seq": 3, "level": "error", "subsystem": "engine",
     "event": "request_failed", "trace_id": TRACE, "span_id": "12" * 8,
     "reason": "decode failed"},
]}

REQUESTS = {"metrics_enabled": True, "requests": [
    {"id": 1, "trace_id": TRACE, "outcome": "failed", "prompt_len": 7,
     "tokens_generated": 3, "queue_wait_s": 0.001, "ttft_s": 0.25, "tpot_s": None,
     "e2e_s": 0.5, "preemptions": 0},
    {"id": 2, "trace_id": "cd" * 16, "outcome": None, "prompt_len": 12,
     "tokens_generated": 0},
]}

CONFIG = {"model": "tiny", "max_slots": 4, "events_enabled": True}

TIMELINE = {"traceEvents": [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "host schedule"}},
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "device decode/0"}},
    {"ph": "X", "name": "decode chunk", "pid": 1, "tid": 2, "ts": 10, "dur": 5},
], "metadata": {"events": 1, "dropped": 0}}


class StubHandler(BaseHTTPRequestHandler):
    """A serving replica's endpoints with canned payloads."""

    omit = ()  # paths to 404
    metrics_text = METRICS_TEXT

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?")[0]
        payloads = {
            "/metrics": self.metrics_text.encode(),
            "/healthz": json.dumps(HEALTHZ).encode(),
            "/debug/events": json.dumps(EVENTS).encode(),
            "/debug/requests": json.dumps(REQUESTS).encode(),
            "/debug/config": json.dumps(CONFIG).encode(),
            "/debug/spans": json.dumps({"process": "serve:1", "spans": [
                {"name": "generate", "trace_id": TRACE, "span_id": "11" * 8,
                 "start": 10.0, "duration_s": 0.5, "track": "http"}]}).encode(),
            "/debug/trace": json.dumps(TIMELINE).encode(),
        }
        if path in self.omit or path not in payloads:
            self.send_error(404)
            return
        body = payloads[path]
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass


FLEET_DOC = {
    "fleet": {"targets": 3, "up": 2, "quarantined": 1, "tok_s": 85.0,
              "active_slots": 4.0, "max_slots": 8.0, "queued": 2.0},
    "targets": [
        {"target": "replica0:8000", "url": "http://replica0:8000", "up": True,
         "staleness_s": 1.2, "tok_s": 42.5, "active_slots": 2.0, "max_slots": 4.0,
         "queued": 1.0, "occupancy": 1.71, "slo": "ok"},
        {"target": "replica1:8000", "url": "http://replica1:8000", "up": True,
         "staleness_s": 0.8, "tok_s": 42.5, "active_slots": 2.0, "max_slots": 4.0,
         "queued": 1.0, "occupancy": 0.4, "slo": "warn"},
        {"target": "replica2:8000", "url": "http://replica2:8000", "up": False,
         "quarantined": True, "staleness_s": 93.0, "tok_s": None, "slo": None},
    ],
    "slo": {"ready": False, "status": "breach", "slos": [
        {"name": "ttft_p99", "status": "breach", "burn_short": 8.0, "burn_long": 7.0}]},
    "notes": ["histogram bucket-edge mismatch for ttft_seconds"],
    "hpa": {"metrics": [{"type": "Pods", "pods": {
        "metric": {"name": "engine_dispatch_depth_occupancy"},
        "target": {"type": "AverageValue", "averageValue": "1.055"}}}]},
}

FLEET_EVENTS = {"events": [
    {"time": 1754500000.0, "seq": 4, "level": "error", "subsystem": "engine",
     "event": "request_failed", "target": "replica1:8000", "reason": "decode failed"},
]}


class CollectorHandler(BaseHTTPRequestHandler):
    """A collector's endpoints; ``doc`` is its ``/debug/fleet``."""

    omit = ()
    doc = FLEET_DOC

    def do_GET(self):  # noqa: N802
        path = self.path.split("?")[0]
        payloads = {
            "/debug/fleet": json.dumps(self.doc).encode(),
            "/debug/events": json.dumps(FLEET_EVENTS).encode(),
            "/metrics": b"collector_fleet_targets 3\n",
            "/debug/trace": json.dumps({"traceEvents": [], "stitched": True}).encode(),
        }
        if path in self.omit or path not in payloads:
            self.send_error(404)
            return
        body = payloads[path]
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture
def servers():
    """Two replicas and a collector; the handlers' class attributes set
    per test (``omit``, ``doc``)."""
    started = {name: _serve(handler) for name, handler in
               (("r0", StubHandler), ("r1", StubHandler), ("collector", CollectorHandler))}
    try:
        yield {name: url for name, (_, url) in started.items()}
    finally:
        for server, _ in started.values():
            server.shutdown()
            server.server_close()


class _Stdout:
    """Whatever ``sys.stdout`` is when a line is written (capture swaps it
    between a fixture's set-up and the test)."""

    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture(autouse=True)
def loggers():
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))


CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")


def both(capsys, argv: list) -> list:
    """``[(rc, stdout lines)]`` of the reference's and the port's CLI on
    ``argv``, clock times masked."""
    runs = []
    for cli in (jcli, tcli):
        capsys.readouterr()
        rc = cli.main(list(argv))
        out = capsys.readouterr().out
        runs.append((rc, CLOCK.sub("HH:MM:SS", out).splitlines()))
    return runs


# -- the Prometheus text helpers ------------------------------------------------
def test_parse_prom_text_equals_the_reference():
    r = Registry()
    r.counter("engine_requests_completed_total", "done").inc(7)
    h = r.histogram("ttft_seconds", "ttft")
    for v in (0.01, 0.2, 3.0):
        h.observe(v)
    r.gauge("slo_burn_ratio", "burn", labels=("slo", "window")).labels(
        slo="ttft_p99", window="short").set(2.5)
    for text in (METRICS_TEXT, r.render(), "garbage line\n# only a comment\n\nx 1 2\n"):
        assert tcli._parse_prom_text(text) == jcli._parse_prom_text(text)
    fams = tcli._parse_prom_text(METRICS_TEXT)
    assert fams["slo_burn_ratio"] == [({"slo": "ttft_p99", "window": "short"}, 8.0)]
    for name in ("engine_requests_completed_total", "missing_family"):
        assert tcli._prom_value(fams, name) == jcli._prom_value(fams, name)
    for n in (None, "x", 0, 512, 2048, 1048576, 3 * 1024 ** 3, 5 * 1024 ** 4):
        assert tcli._human_bytes(n) == jcli._human_bytes(n)


# -- one server -------------------------------------------------------------------
@pytest.mark.parametrize("argv, omit", [
    (["status", "serving"], ()),
    (["status", "serving"], ("/debug/requests",)),
    (["top", "--iterations", "1"], ()),
    (["top", "--iterations", "1", "--events", "1"], ("/debug/events",)),
], ids=["status", "status-no-requests", "top", "top-no-events"])
def test_single_server_commands_print_what_the_reference_prints(servers, capsys, monkeypatch,
                                                                argv, omit):
    monkeypatch.setattr(StubHandler, "omit", omit)
    (jrc, jout), (rc, out) = both(capsys, argv + ["--url", servers["r0"]])
    assert rc == jrc == 0
    assert out == jout
    if argv[0] == "top":
        assert any("42.5" in ln for ln in out) and any("1.0MiB" in ln for ln in out)
    else:
        assert any(ln.split()[:2] == ["tokens", "777"] for ln in out), out


def test_status_serving_without_metrics_on_the_server(servers, capsys, monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "REQUESTS", {"metrics_enabled": False})
    (jrc, jout), (rc, out) = both(capsys, ["status", "serving", "--url", servers["r0"]])
    assert rc == jrc == 0 and out == jout
    assert "metrics disabled" in out[-1]


def test_profile_serving_writes_the_same_trace(servers, capsys, tmp_path):
    outs = []
    for cli, name in ((jcli, "j.json"), (tcli, "t.json")):
        capsys.readouterr()
        assert cli.main(["profile", "serving", "--url", servers["r0"], "--seconds", "1",
                         "--out", str(tmp_path / name)]) == 0
        outs.append(capsys.readouterr().out.replace(name, "OUT"))
    assert outs[0] == outs[1]
    assert "lanes: device decode/0, host schedule" in outs[1]
    assert json.loads((tmp_path / "t.json").read_text()) == TIMELINE == \
        json.loads((tmp_path / "j.json").read_text())


# -- a fleet ------------------------------------------------------------------------
@pytest.mark.parametrize("argv, omit", [
    (["top", "--fleet", "--iterations", "1"], ()),
    (["top", "--fleet", "--iterations", "1"], ("/debug/events",)),
    (["fleet", "status"], ()),
], ids=["top-fleet", "top-fleet-no-events", "fleet-status"])
def test_fleet_commands_print_what_the_reference_prints(servers, capsys, monkeypatch, argv,
                                                       omit):
    monkeypatch.setattr(CollectorHandler, "omit", omit)
    (jrc, jout), (rc, out) = both(capsys, argv + ["--url", servers["collector"]])
    assert rc == jrc == 0
    assert out == jout
    if argv[0] == "fleet":
        assert out[0] == "fleet: 2/3 replica(s) up"
        assert out[-1] == "hpa signal: engine_dispatch_depth_occupancy averageValue=1.055"
    else:
        assert "  FLEET  2/3 up  (1 quarantined)    tok/s 85.0   slots 4/8   queued 2" in out
        assert ("RECENT EVENTS" in "\n".join(out)) == (not omit)


@pytest.mark.parametrize("argv, says", [
    (["status", "serving"], "no serving endpoint"),
    (["top", "--iterations", "1"], "no serving endpoint"),
    (["top", "--fleet", "--iterations", "1"], "no collector endpoint"),
    (["fleet", "status", "--timeout", "1"], "no fleet collector endpoint"),
    (["profile", "serving", "--seconds", "1", "--out", "never.json"], "no serving endpoint"),
    (["profile", "serving", "--seconds", "0", "--out", "never.json"], "--seconds must be"),
    (["profile", "serving", "--seconds", "61", "--out", "never.json"], "--seconds must be"),
    (["debug", "bundle", "--seconds", "0", "--out", "never.tar.gz"], "no serving endpoint"),
    (["debug", "bundle", "--seconds", "999", "--out", "never.tar.gz"], "--seconds must be"),
    (["debug", "bundle", "--fleet", "--seconds", "0", "--out", "never.tar.gz"],
     "no collector endpoint"),
    (["collector", "serve"], "no targets"),
], ids=lambda v: "-".join(v) if isinstance(v, list) else None)
def test_error_exits_match_the_reference(capsys, tmp_path, monkeypatch, argv, says):
    monkeypatch.chdir(tmp_path)
    dead = f"http://127.0.0.1:{free_port()}"
    url = [] if argv[0] == "collector" else ["--url", dead]
    (jrc, jout), (rc, out) = both(capsys, argv + url)
    assert rc == jrc == 1
    assert out == jout and says in "\n".join(out)
    assert not list(tmp_path.iterdir())


# -- debug bundle -------------------------------------------------------------------
def _bundle(cli, argv, path) -> dict:
    assert cli.main(argv + ["--out", str(path), "--seconds", "0"]) == 0
    with tarfile.open(path, "r:gz") as tar:
        manifest = json.load(tar.extractfile("bundle/manifest.json"))
        members = {n: tar.extractfile(n).read() for n in sorted(tar.getnames())
                   if n != "bundle/manifest.json"}
    manifest.pop("created")
    return {"names": sorted(members) + ["bundle/manifest.json"], "manifest": manifest,
            "members": members}


@pytest.mark.parametrize("mode", ["single", "single-partial", "fleet", "targets",
                                  "targets-partial"])
def test_debug_bundle_holds_what_the_reference_holds(servers, tmp_path, capsys, monkeypatch,
                                                    mode):
    if mode.endswith("partial"):
        monkeypatch.setattr(StubHandler, "omit", ("/debug/events", "/debug/spans"))
    if mode == "fleet":
        monkeypatch.setattr(CollectorHandler, "doc", {**FLEET_DOC, "targets": [
            {"target": f"replica{i}", "url": servers[f"r{i}"], "up": True} for i in (0, 1)]})
    argv = {"single": ["debug", "bundle", "--url", servers["r0"]],
            "fleet": ["debug", "bundle", "--fleet", "--url", servers["collector"]],
            "targets": ["debug", "bundle", "--target", servers["r0"],
                        "--target", servers["r1"]]}[mode.split("-")[0]]
    got = [_bundle(cli, argv, tmp_path / f"{i}.tar.gz") for i, cli in enumerate((jcli, tcli))]
    assert got[1]["names"] == got[0]["names"]
    assert got[1]["manifest"] == got[0]["manifest"]
    assert got[1]["members"] == got[0]["members"]
    names = got[1]["names"]
    if mode == "fleet":
        assert {"bundle/fleet.json", "bundle/fleet_metrics.txt", "bundle/fleet_trace.json",
                "bundle/replica0/metrics.txt", "bundle/replica1/metrics.txt"} <= set(names)
    elif mode.startswith("targets"):
        assert len(got[1]["manifest"]["targets"]) == 2
        for entry in got[1]["manifest"]["targets"].values():
            assert set(entry["errors"]) == ({"events.json", "spans.json"}
                                            if mode.endswith("partial") else set())
    else:
        errors = got[1]["manifest"]["errors"]
        assert list(errors) == (["events.json"] if mode.endswith("partial") else [])
        assert b"engine_tokens_per_sec_10s 42.5" in got[1]["members"]["bundle/metrics.txt"]


# -- collector serve ------------------------------------------------------------------
def _replica_metrics(tok_s: float, completed: int, ttft) -> str:
    r = Registry()
    r.gauge("engine_tokens_per_sec_10s", "rate").set(tok_s)
    r.gauge("engine_active_slots", "a").set(2)
    r.gauge("engine_max_slots", "m").set(4)
    r.gauge("engine_queued_requests", "q").set(1)
    r.counter("engine_requests_completed_total", "done").inc(completed)
    h = r.histogram("ttft_seconds", "ttft")
    for v in ttft:
        h.observe(v)
    return r.render()


def _collector_views(cli, urls: list, paths: list) -> dict:
    port = free_port()
    rc = []
    argv = ["collector", "serve", "--port", str(port), "--iterations", str(len(paths))]
    t = threading.Thread(target=lambda: rc.append(cli.main(
        argv + [f for u in urls for f in ("--target", u)])), daemon=True)
    t.start()
    got = {}
    for path in paths:
        deadline = time.monotonic() + 10
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                    got[path] = r.read()
                break
            except OSError:
                assert time.monotonic() < deadline, f"the collector never answered {path}"
                time.sleep(0.05)
    t.join(timeout=10)
    assert rc == [0]
    return got


def test_collector_serve_federates_as_the_reference(servers, monkeypatch):
    monkeypatch.setattr(StubHandler, "metrics_text", _replica_metrics(40.0, 10, [0.01, 0.02]))
    urls = [servers["r0"], servers["r1"]]
    paths = ["/metrics", "/healthz", "/debug/fleet", "/debug/events?limit=10",
             f"/debug/trace?trace_id={TRACE}"]
    jgot, got = (_collector_views(cli, urls, paths) for cli in (jcli, tcli))
    # what the collector's clock decides: its scrape rounds, their
    # durations and the targets' staleness
    timed = re.compile(r"^collector_(scrape|target_staleness_seconds).*$", re.M)
    assert timed.sub("", got["/metrics"].decode()) == timed.sub("", jgot["/metrics"].decode())
    assert "engine_requests_completed_total 20" in got["/metrics"].decode()
    for path in paths[1:]:
        view, jview = settled(json.loads(got[path])), settled(json.loads(jgot[path]))
        assert view == jview, path
    fleet = json.loads(got["/debug/fleet"])
    assert fleet["fleet"]["tok_s"] == pytest.approx(80.0) and len(fleet["slo"]["slos"]) == 4


def settled(doc: dict) -> dict:
    """A collector's JSON view without what its clock decides: the SLO
    windows (they count scrape rounds) but for each objective's status,
    and each target's staleness."""
    if "slo" in doc:
        doc["slo"] = [(s["name"], s["status"]) for s in doc["slo"]["slos"]]
    if isinstance(doc.get("targets"), list):
        for row in doc["targets"]:
            row.pop("staleness_s")
    return doc


# -- from_workers on the fake clusters ----------------------------------------------
def test_from_workers_resolves_the_reference_targets(tmp_path):
    from devspace_tpu.config import latest as jlatest
    from devspace_tpu.kube.fake import FakeCluster as JFake
    from devspace_tpu.obs.collector import TelemetryCollector as JCollector
    from devspace_tpu_torch.config import latest
    from devspace_tpu_torch.kube.fake import FakeCluster
    from devspace_tpu_torch.obs.collector import TelemetryCollector

    sts = {"apiVersion": "apps/v1", "kind": "StatefulSet",
           "metadata": {"name": "serve", "namespace": "default"},
           "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "serve"}},
                    "template": {"metadata": {"labels": {"app": "serve"}},
                                 "spec": {"containers": [{"name": "main", "image": "x"}]}}}}
    targets = []
    for fake, lat, collector, block in (
            (JFake, jlatest, JCollector, {"tpu": jlatest.TPUConfig(workers=2)}),
            (FakeCluster, latest, TelemetryCollector, {"gpu": latest.GPUConfig(workers=2)})):
        fc = fake(str(tmp_path / fake.__module__))
        fc.apply(sts, "default")
        cfg = lat.Config(version=lat.VERSION, deployments=[
            lat.DeploymentConfig(name="serve", chart=lat.ChartConfig(path="./chart"))],
            **block)
        c = collector.from_workers(fc, cfg, port=8123, timeout=5, interval_s=30.0)
        targets.append([(t.name, t.url) for t in c.targets])
    assert targets[1] == targets[0]
    assert [name for name, _ in targets[1]] == ["serve-0", "serve-1"]
    assert all(url.endswith(":8123") for _, url in targets[1])
