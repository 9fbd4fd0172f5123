"""The port's ``fleet serve`` live, with the stub replicas
(``devspace_tpu_torch.serving.stub``) and ``--duration`` (a port of
tests/test_fleet_live.py onto the fleet command): ``collector serve
--iterations``, ``fleet status`` and ``top --fleet`` against it, the last
two from both CLIs with equal output; one short case each of
``--autoscale`` and ``--route prefix``; and ``--ready-timeout`` reaching
the replicas' ``ReplicaSpec``. ``main`` runs in a thread, its replicas
are processes."""

import json
import re
import socket
import sys
import threading
import time
import urllib.request

import pytest

from devspace_tpu.cli import main as jcli
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch import serving
from devspace_tpu_torch.cli import main as tcli
from devspace_tpu_torch.serving.fleet import free_port
from devspace_tpu_torch.serving.stub import token_at
from devspace_tpu_torch.utils import log as logutil


class _Lines:
    """A log stream that keeps its lines (the fleet logs from its thread)."""

    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s

    def flush(self):
        pass

    def isatty(self):
        return False


class _Stdout:
    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture
def log():
    lines = _Lines()
    logutil.set_logger(logutil.StdoutLogger(stream=lines))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    return lines


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def wait_for(cond, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def closed(port: int) -> bool:
    with socket.socket() as s:
        return s.connect_ex(("127.0.0.1", port)) != 0


class FleetThread:
    """``fleet serve`` of the port's CLI in a thread."""

    def __init__(self, *argv):
        self.port = free_port()
        self.rc = []
        self.thread = threading.Thread(target=lambda: self.rc.append(tcli.main(
            ["fleet", "serve", "--port", str(self.port), *argv])), daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def up(self, n: int) -> dict:
        """The collector's view once it shows ``n`` targets up."""
        return wait_for(lambda: (lambda doc: doc if doc["fleet"]["up"] == n else None)(
            get_json(self.url + "/debug/fleet")), 30, f"{n} replica(s) up")

    def join(self, timeout_s: float = 30) -> int:
        self.thread.join(timeout_s)
        assert not self.thread.is_alive(), "fleet serve did not end after its duration"
        return self.rc[0]


def both(capsys, argv: list) -> list:
    """``[(rc, lines)]`` of the reference's and the port's CLI, with clock
    times and staleness masked."""
    runs = []
    for cli in (jcli, tcli):
        capsys.readouterr()
        rc = cli.main(list(argv))
        out = re.sub(r"\b\d\d:\d\d:\d\d\b", "HH:MM:SS", capsys.readouterr().out)
        runs.append((rc, re.sub(r"\b\d+\.\ds\b", "S.Ss", out).splitlines()))
    return runs


def test_fleet_serve_and_the_commands_against_it(log, capsys):
    fleet = FleetThread("--replicas", "2", "--interval", "0.5", "--duration", "10")
    doc = fleet.up(2)
    urls = [t["url"] for t in doc["targets"]]
    assert [t["target"] for t in doc["targets"]] == ["replica-0", "replica-1"]
    ports = [int(u.rsplit(":", 1)[1]) for u in urls]

    # a second collector over the same replicas, for three requests
    port = free_port()
    rc = []
    t = threading.Thread(target=lambda: rc.append(tcli.main(
        ["collector", "serve", "--port", str(port), "--interval", "0.5", "--iterations", "3",
         "--target", urls[0], "--target", urls[1]])), daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    health = wait_for(lambda: get_json(base + "/healthz"), 10, "the second collector")
    fleet_view = get_json(base + "/debug/fleet")
    metrics = urllib.request.urlopen(base + "/metrics", timeout=5).read().decode()
    t.join(10)
    assert rc == [0] and health["up"] == 2
    assert sorted(r["url"] for r in fleet_view["targets"]) == sorted(urls)
    assert "collector_fleet_targets_up 2" in metrics

    # fleet status and top --fleet, from both CLIs, against the fleet's collector
    (jrc, jout), (trc, out) = both(capsys, ["fleet", "status", "--url", fleet.url])
    assert trc == jrc == 0 and out == jout
    assert out[0] == "fleet: 2/2 replica(s) up"
    assert [r.split()[:2] for r in out[2:4]] == [["replica-0", "yes"], ["replica-1", "yes"]]
    assert out[-1].startswith("hpa signal: ")
    (jrc, jout), (trc, out) = both(capsys, ["top", "--fleet", "--url", fleet.url,
                                            "--iterations", "1"])
    assert trc == jrc == 0 and out == jout
    assert any(ln.startswith("  FLEET  2/2 up") for ln in out)
    assert any("replica-0" in ln for ln in out) and any("replica-1" in ln for ln in out)

    assert fleet.join() == 0
    assert "fleet of 2 replica(s) up (module devspace_tpu_torch.serving.stub)" in log.text
    assert "fleet stopped" in log.text
    assert all(closed(p) for p in ports + [fleet.port])


def test_fleet_serve_autoscale(log):
    fleet = FleetThread("--replicas", "1", "--autoscale", "--min-replicas", "1",
                        "--max-replicas", "2", "--interval", "0.5", "--duration", "2")
    fleet.up(1)
    assert fleet.join() == 0
    assert "autoscaling 1-2 on engine_dispatch_depth_occupancy<=0.75" in log.text
    assert "fleet stopped" in log.text


def test_fleet_serve_route_prefix(log):
    gw = free_port()
    fleet = FleetThread("--replicas", "2", "--route", "prefix", "--gateway-port", str(gw),
                        "--interval", "0.5", "--duration", "5")
    fleet.up(2)
    prompt = [5, 1, 4, 9, 2, 6, 5, 3, 5]
    req = urllib.request.Request(f"http://127.0.0.1:{gw}/generate", data=json.dumps(
        {"prompt_ids": prompt, "max_new_tokens": 6}).encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        got = json.loads(resp.read())
    assert got["tokens"] == [token_at(prompt, i) for i in range(6)]
    assert fleet.join() == 0
    assert f"prefix gateway on http://127.0.0.1:{gw}" in log.text
    assert closed(gw)


def test_fleet_serve_env_must_be_key_value(capsys):
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    (jrc, jout), (trc, out) = both(capsys, ["fleet", "serve", "--env", "NOVALUE"])
    assert trc == jrc == 1 and out == jout and "--env wants KEY=VALUE" in out[0]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv, want", [([], 15.0), (["--ready-timeout", "120"], 120.0)])
def test_ready_timeout_reaches_the_replica_spec(monkeypatch, argv, want):
    specs = []

    class Recording:
        def __init__(self, spec, **kw):
            specs.append((spec, kw))
            raise _Stop

    monkeypatch.setattr(serving, "ReplicaFleet", Recording)
    with pytest.raises(_Stop):
        tcli.main(["fleet", "serve", "--module", "devspace_tpu_torch.serve",
                   "--env", "MODEL=tiny", *argv])
    ((spec, kw),) = specs
    assert spec.ready_timeout_s == want and spec.module == "devspace_tpu_torch.serve"
    assert spec.env == {"MODEL": "tiny"} and spec.probe_timeout_s == 0.75
    assert kw == {"replicas": 2, "restart_budget": None, "healthy_window_s": 60.0}
