"""The port's fleet, gateway and collector on the CPU.

- The fleet over its deterministic stub replicas, as
  tests/test_serving_fleet.py drives the reference's: it starts healthy
  on distinct ports, scales up, drains a replica before it kills it (an
  in-flight stream completes), keeps a draining replica alive without
  restarting it, and restarts a SIGKILLed one with its events.
- The gateway (policy ``prefix``) in front of two torch TINY replicas
  (``python -m devspace_tpu_torch.serve --device cpu``): a grown prompt
  sticks to the replica holding its prefix, whose engine counts the hit,
  and the streams equal a request served directly; a request routed to a
  dead address is rerouted before its first byte.
- Slow: one JAX TINY replica and one torch TINY replica serving one
  checkpoint (converted by scripts/convert_checkpoint.py) behind the
  port's gateway give equal streams, and the port's collector merges
  both expositions.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from devspace_tpu_torch.obs import events as obs_events
from devspace_tpu_torch.obs.collector import TelemetryCollector
from devspace_tpu_torch.obs.fleet import parse_exposition
from devspace_tpu_torch.resilience import ServiceState
from devspace_tpu_torch.serving import PROBE_ALIVE, PROBE_READY, ReplicaFleet, ReplicaSpec
from devspace_tpu_torch.serving.gateway import RoutingGateway
from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig, fingerprint_chain
from devspace_tpu_torch.serving.stub import token_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(cond, timeout=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def stub_fleet(replicas=2, **kw):
    kw.setdefault("spec", ReplicaSpec(env={"STUB_TOKEN_DELAY_S": "0.002"}))
    kw.setdefault("poll_interval", 0.1)
    return ReplicaFleet(replicas=replicas, **kw)


def stream(url, prompt, n, delay=None, headers=None):
    body = {"prompt_ids": prompt, "max_new_tokens": n, "stream": True}
    if delay is not None:
        body["token_delay_s"] = delay
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return [json.loads(line) for line in resp]


def tokens_of(lines):
    assert lines[-1] == {"done": True}, lines[-3:]
    return [m["token"] for m in lines if "token" in m]


def get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


# -- the fleet over stub replicas ---------------------------------------------
def test_stub_fleet_starts_and_scales_up():
    fleet = stub_fleet(replicas=2)
    assert fleet.spec.module == "devspace_tpu_torch.serving.stub"
    fleet.start()
    try:
        assert fleet.all_healthy()
        targets = fleet.targets()
        assert sorted(targets) == ["replica-0", "replica-1"]
        assert len(set(targets.values())) == 2
        assert all(r["state"] == ServiceState.RUNNING and r["probe"] == PROBE_READY
                   for r in fleet.statuses())
        assert fleet.scale_to(3, reason="test") == ["replica-2"]
        wait_for(fleet.all_healthy, msg="scaled-up fleet healthy")
        assert len(fleet.targets()) == 3 and fleet.scale_to(3) == []
        with pytest.raises(ValueError):
            fleet.scale_to(0)
    finally:
        fleet.stop()
    assert all(not r.alive() for r in fleet.handles())


def test_stub_fleet_drains_before_it_kills():
    fleet = stub_fleet(replicas=2)
    fleet.start()
    try:
        victim = "replica-1"
        url = fleet.replica(victim).base_url
        prompt, box = [5, 6, 7], {}
        th = threading.Thread(target=lambda: box.update(lines=stream(url, prompt, 30, 0.02)),
                              daemon=True)
        th.start()
        wait_for(lambda: fleet.replica(victim).in_flight() > 0, msg="stream in flight")
        assert fleet.scale_to(1, reason="drain test") == [victim]
        th.join(timeout=30)
        assert tokens_of(box["lines"]) == [token_at(prompt, i) for i in range(30)]
        assert list(fleet.targets()) == ["replica-0"]
        # a draining replica is alive, not dead: the supervisor keeps it
        replica = fleet.replica("replica-0")
        pid = replica.pid
        assert replica.request_drain()
        wait_for(lambda: replica.probe() == PROBE_ALIVE, msg="drain visible")
        time.sleep(0.5)
        assert fleet.replica("replica-0").pid == pid
        assert replica.request_drain(off=True)
        wait_for(lambda: replica.probe() == PROBE_READY, msg="undrain")
    finally:
        fleet.stop()


def test_stub_fleet_restarts_a_killed_replica():
    flight = obs_events.add_sink(obs_events.FlightRecorder())
    fleet = stub_fleet(replicas=2)
    fleet.start()
    try:
        victim = fleet.names()[0]
        old_pid = fleet.replica(victim).pid
        fleet.kill(victim)
        wait_for(lambda: fleet.replica(victim).pid != old_pid, msg="respawn")
        wait_for(fleet.all_healthy, msg="fleet recovery")
        names = [(e.subsystem, e.name) for e in flight.dump()]
        assert ("fleet", "replica_started") in names
        assert ("fleet", "replica_restarted") in names
        row = next(r for r in fleet.supervisor.status() if r["service"] == victim)
        assert row["restarts"] == 1
        lines = stream(fleet.replica(victim).base_url, [1, 2], 4)
        assert tokens_of(lines) == [token_at([1, 2], i) for i in range(4)]
    finally:
        obs_events.remove_sink(flight)
        fleet.stop()


@dataclasses.dataclass
class SlowRestartSpec(ReplicaSpec):
    """The stub at first; every later launch a process that writes its pid
    to ``pid_file`` and never becomes ready (a restart still loading)."""

    pid_file: str = ""
    launches: int = 0

    def command(self, port: int) -> list:
        self.launches += 1
        if self.launches == 1:
            return super().command(port)
        return [sys.executable, "-c",
                "import os, sys, time; open(sys.argv[1], 'w').write(str(os.getpid())); "
                "time.sleep(120)", self.pid_file]


def process_gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_stub_fleet_stop_ends_a_restart_in_flight(tmp_path):
    """A replica SIGKILLed just before stop(): its restart is still waiting
    for /readyz when stop() comes, and stop() ends that process too."""
    pid_file = tmp_path / "pid"
    spec = SlowRestartSpec(env={"STUB_TOKEN_DELAY_S": "0.002"}, ready_timeout_s=60.0,
                           pid_file=str(pid_file))
    fleet = stub_fleet(replicas=1, spec=spec, poll_interval=0.05)
    fleet.start()
    try:
        fleet.kill(fleet.names()[0])
        wait_for(lambda: pid_file.exists() and pid_file.read_text(), msg="the restart's launch")
        pid = int(pid_file.read_text())
        assert not process_gone(pid)
    finally:
        t0 = time.monotonic()
        fleet.stop()
    wait_for(lambda: process_gone(pid), timeout=10.0, msg="the restart's process to end")
    assert time.monotonic() - t0 < 15.0


# a replica that writes 200 KB to its stderr on each GET /noisy
NOISY_SERVER = """
import http.server, json, sys
class H(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass
    def do_GET(self):
        if self.path == "/noisy":
            sys.stderr.write("noise " * 34000 + "\\n")
            sys.stderr.flush()
        body = json.dumps({"ok": True}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
http.server.ThreadingHTTPServer(("127.0.0.1", int(sys.argv[1])), H).serve_forever()
"""


@dataclasses.dataclass
class NoisySpec(ReplicaSpec):
    def command(self, port: int) -> list:
        return [sys.executable, "-c", NOISY_SERVER, str(port)]


def test_replica_output_is_read_while_it_runs():
    """A replica's output pipe is read as it comes: past the pipe's 64 KiB
    an unread replica's next write blocks, and so does the request that
    makes it. The fleet keeps the output's first and last 64 KiB."""
    fleet = ReplicaFleet(spec=NoisySpec(), replicas=1, poll_interval=0.1)
    fleet.start()
    try:
        replica = fleet.replica(fleet.names()[0])
        for _ in range(3):
            with urllib.request.urlopen(replica.base_url + "/noisy", timeout=5) as resp:
                assert json.loads(resp.read()) == {"ok": True}
        wait_for(lambda: replica.output_bytes >= 3 * 204001, msg="the output read")
        out = replica.output()
        assert out.startswith("noise noise") and out.endswith("noise \n")
        assert "bytes left out]" in out and len(out) < 140000
    finally:
        fleet.stop()


# -- torch replicas behind the gateway ----------------------------------------
@dataclasses.dataclass
class CpuReplicaSpec(ReplicaSpec):
    """A torch replica on the CPU: the server's ``--device cpu``."""

    def command(self, port: int) -> list:
        return super().command(port) + ["--device", "cpu"]


def torch_spec():
    return CpuReplicaSpec(module="devspace_tpu_torch.serve",
                          env={"MODEL": "tiny", "SPEC": "0", "MAX_SLOTS": "2",
                               "PYTHONPATH": REPO},
                          ready_timeout_s=120.0, probe_timeout_s=5.0)


@pytest.fixture(scope="module")
def torch_fleet():
    fleet = ReplicaFleet(spec=torch_spec(), replicas=2, poll_interval=0.5)
    fleet.start()
    try:
        yield fleet
    finally:
        fleet.stop()


def test_gateway_sticks_to_the_prefix_holder(torch_fleet):
    router = PrefixRouter(replicas_fn=torch_fleet.targets,
                          config=RouterConfig(policy="prefix", block_size=64))
    gw = RoutingGateway(router, port=0)
    gw.start()
    try:
        prompt = [(7 * i) % 250 + 3 for i in range(70)]  # one full 64-token block
        first = tokens_of(stream(gw.base_url, prompt, 6))
        grown = prompt + first + [9, 9, 9]
        second = tokens_of(stream(gw.base_url, grown, 5))
        dbg = get_json(gw.base_url + "/debug/router")
        picks = [d["replica"] for d in dbg["recent_decisions"]]
        assert len(picks) == 2 and len(set(picks)) == 1
        assert dbg["recent_decisions"][-1]["overlap_tokens"] >= 64
        holder = torch_fleet.targets()[picks[0]]
        with urllib.request.urlopen(holder + "/metrics", timeout=10) as r:
            snap = parse_exposition(r.read().decode())
        assert snap["engine_prefix_hit_tokens_total"]["samples"][0][1] >= 64
        # the same weights serve the same greedy streams on either replica
        other = next(u for n, u in torch_fleet.targets().items() if n != picks[0])
        assert tokens_of(stream(other, prompt, 6)) == first
        assert tokens_of(stream(other, grown, 5)) == second
        with urllib.request.urlopen(gw.base_url + "/metrics", timeout=10) as r:
            assert "serving_router_requests_total 2" in r.read().decode()
    finally:
        gw.stop()


def test_gateway_reroutes_a_dead_replica_before_the_first_byte(torch_fleet):
    def targets():
        return {**torch_fleet.targets(), "dead": "http://127.0.0.1:9"}

    router = PrefixRouter(replicas_fn=targets, config=RouterConfig(block_size=64))
    prompt = list(range(3, 73))
    router.shadow.observe("dead", fingerprint_chain(prompt, 64))
    gw = RoutingGateway(router, port=0)
    gw.start()
    try:
        got = tokens_of(stream(gw.base_url, prompt, 4))
        assert got == tokens_of(stream(next(iter(torch_fleet.targets().values())), prompt, 4))
        snap = router.registry.snapshot()
        assert snap["serving_router_retries_total"]["samples"][0][1] == 1
        assert router.shadow.blocks("dead") == 0
    finally:
        gw.stop()


# -- a mixed fleet: one JAX replica, one torch replica ---------------------------
@dataclasses.dataclass
class JaxReplicaSpec(ReplicaSpec):
    """The JAX package's example server, which reads its port from PORT."""

    def command(self, port: int) -> list:
        return [sys.executable, os.path.join(REPO, "examples", "llama-inference", "serve.py")]


@pytest.mark.slow
def test_mixed_jax_and_torch_replicas_behind_the_gateway(tmp_path):
    """One TINY checkpoint made by the JAX package, converted for the
    port; the JAX example server and the port's server each serve it.
    Greedy streams through the gateway equal each replica's own, the two
    replicas' streams are equal, and the collector merges both
    expositions (tokens summed)."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import convert_checkpoint
    from devspace_tpu.models import transformer as jtfm
    from devspace_tpu.training.checkpoint import save_checkpoint

    orbax = str(tmp_path / "orbax")
    save_checkpoint(orbax, jtfm.init_params(jtfm.TINY, jax.random.PRNGKey(0)))
    converted = convert_checkpoint.orbax_to_torch(orbax, str(tmp_path / "torch"))
    env = {"MODEL": "tiny", "SPEC": "0", "MAX_SLOTS": "2", "PYTHONPATH": REPO}
    jax_fleet = ReplicaFleet(spec=JaxReplicaSpec(
        env={**env, "JAX_PLATFORMS": "cpu", "CHECKPOINT": orbax}, ready_timeout_s=300.0,
        probe_timeout_s=5.0), replicas=1, name_prefix="jax")
    torch_fleet = ReplicaFleet(spec=dataclasses.replace(
        torch_spec(), env={**env, "CHECKPOINT": converted}), replicas=1, name_prefix="torch")
    jax_fleet.start()
    torch_fleet.start()
    gw = None
    try:
        def targets():
            return {**jax_fleet.targets(), **torch_fleet.targets()}

        router = PrefixRouter(replicas_fn=targets, config=RouterConfig(policy="round_robin"))
        gw = RoutingGateway(router, port=0, request_timeout_s=300)
        gw.start()
        prompts = [[5, 1, 4], list(range(1, 17))]
        sent = 0
        for prompt in prompts:
            direct = [tokens_of(stream(u, prompt, 24)) for u in targets().values()]
            assert direct[0] == direct[1], (prompt, direct)
            for _ in range(2):
                assert tokens_of(stream(gw.base_url, prompt, 24)) == direct[0]
            sent += 4 * 24
        collector = TelemetryCollector(sorted(targets().items()), interval_s=60)
        collector.scrape_once()
        fleet = collector.fleet_snapshot()
        assert fleet["engine_tokens_generated_total"]["samples"][0][1] == sent
        assert all(t.up for t in collector.targets)
        (_, ttft), = fleet["ttft_seconds"]["samples"]
        assert ttft["count"] == 4 * len(prompts)
    finally:
        if gw is not None:
            gw.stop()
        jax_fleet.stop()
        torch_fleet.stop()
