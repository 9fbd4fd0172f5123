"""Replica fleet manager: N serving processes under one supervisor.

``ReplicaFleet`` turns the single-process serving example into a
production-shaped unit: it spawns N replica subprocesses on free local
ports, health-checks them through the serving endpoints, restarts the
dead under the session :class:`RetryPolicy`, and scales the set up and
down with graceful drains. It owns no scheduling policy of its own —
the supervisor (devspace_tpu_torch/resilience/supervisor.py) provides the
restart ladder and the degradation semantics; the autoscaler
(devspace_tpu_torch/serving/autoscale.py) provides the *when*; this module
provides the *how*.

Probe contract (the subtle part — three different 503s):

- process exited → **dead** → restart;
- ``/readyz`` 200 → **ready** (routable);
- ``/readyz`` 503 → **alive** but not routable — this is a drain or an
  SLO brownout, and restarting a draining replica would turn every
  graceful scale-down into a crash, so the supervisor leaves it alone;
- both ``/readyz`` and ``/healthz`` unresponsive (timeout/conn-refused)
  while the process still runs → **dead** (wedged) → restart.

Scale-down never kills a serving request: the victim is put into drain
mode (``POST /drain`` — ``/readyz`` flips 503 so routers stop sending),
the fleet waits for its in-flight count to hit zero (bounded by
``drain_timeout_s``), and only then is the process terminated.

Restarts respect the replica's cumulative ``restart_budget`` with a
``healthy_window_s`` reset, so a crash-looping replica degrades (the
fleet keeps serving on the survivors) instead of flapping forever.

The port's copy of ``devspace_tpu/serving/fleet.py``, with the same behaviour; it
imports nothing of the JAX package. A torch replica is ``ReplicaSpec(module="devspace_tpu_torch.serve",
env={"MODEL": ..., "CHECKPOINT": ..., "PREWARM": "1"})`` with a
``ready_timeout_s`` that covers its weights' load and prewarm.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..obs import events as obs_events
from ..obs.metrics import Registry
from ..resilience.policy import RetryPolicy
from ..resilience.supervisor import (
    RESTART_ALWAYS,
    ServiceState,
    SessionSupervisor,
)

# Lint catalog (OBS7xx): every family the fleet manager exposes. Gauges
# use the _replicas suffix (unitless whitelist); counters aggregate by
# sum across fleet managers, point-in-time gauges by last.
FLEET_METRIC_FAMILIES = (
    ("fleet_desired_replicas", "gauge",
     "Replica count the fleet is converging to", "last"),
    ("fleet_live_replicas", "gauge",
     "Replica processes currently running", "last"),
    ("fleet_ready_replicas", "gauge",
     "Replicas whose /readyz answers 200", "last"),
    ("fleet_replica_restarts_total", "counter",
     "Replica processes respawned after a death", "sum"),
    ("fleet_scale_ups_total", "counter",
     "Scale-up decisions applied", "sum"),
    ("fleet_scale_downs_total", "counter",
     "Scale-down decisions applied (all victims drained first)", "sum"),
)

PROBE_READY = "ready"
PROBE_ALIVE = "alive"  # running but not routable: draining or SLO brownout
PROBE_DEAD = "dead"


def free_port() -> int:
    """An OS-assigned free TCP port. Racy by nature (the port is free
    *now*); replica spawn retries on bind failure absorb the race."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


@dataclass
class ReplicaSpec:
    """How to run one replica. ``module`` is launched as
    ``python -m module --port N``; the default is the deterministic stub
    (devspace_tpu_torch/serving/stub.py) — tests and the chaos gate use it,
    a live fleet points at the real server entrypoint instead."""

    module: str = "devspace_tpu_torch.serving.stub"
    env: dict = field(default_factory=dict)
    ready_timeout_s: float = 15.0
    probe_timeout_s: float = 0.75
    drain_timeout_s: float = 10.0
    stop_grace_s: float = 5.0

    def command(self, port: int) -> list:
        return [sys.executable, "-m", self.module, "--port", str(port)]


class Replica:
    """One serving subprocess: process handle + HTTP probe surface."""

    def __init__(self, name: str, spec: ReplicaSpec, port: int,
                 proc: subprocess.Popen):
        self.name = name
        self.spec = spec
        self.port = port
        self.proc = proc

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    # -- http ---------------------------------------------------------------
    def _request(self, path: str, body: Optional[dict] = None,
                 timeout: Optional[float] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base_url + path, data=data)
        with urllib.request.urlopen(
            req, timeout=timeout or self.spec.probe_timeout_s
        ) as resp:
            return resp.status, json.loads(resp.read())

    def probe(self) -> str:
        """PROBE_READY / PROBE_ALIVE / PROBE_DEAD per the module-docstring
        contract. Never raises."""
        if not self.alive():
            return PROBE_DEAD
        try:
            self._request("/readyz")
            return PROBE_READY
        except urllib.error.HTTPError as e:
            # a well-formed 503 is a live process saying "not routable"
            return PROBE_ALIVE if e.code == 503 else PROBE_DEAD
        except Exception:  # noqa: BLE001 — timeout / conn refused
            pass
        try:
            self._request("/healthz")
            return PROBE_ALIVE
        except Exception:  # noqa: BLE001
            return PROBE_DEAD

    def in_flight(self) -> Optional[int]:
        """active + queued requests from /healthz; None when unreachable."""
        try:
            _, h = self._request("/healthz")
            return int(h.get("active_requests", 0)) + int(
                h.get("queued_requests", 0))
        except Exception:  # noqa: BLE001
            return None

    def request_drain(self, off: bool = False) -> bool:
        try:
            self._request("/drain", body={"off": off})
            return True
        except Exception:  # noqa: BLE001
            return False

    # -- teardown / chaos ---------------------------------------------------
    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Chaos hook: signal the replica by PID (never by name match)."""
        if self.alive():
            os.kill(self.proc.pid, sig)

    def shutdown(self, grace_s: Optional[float] = None) -> None:
        """SIGTERM, wait up to ``grace_s``, then SIGKILL."""
        if not self.alive():
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=(
                self.spec.stop_grace_s if grace_s is None else grace_s))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)


def spawn_replica(name: str, spec: ReplicaSpec) -> Replica:
    """Launch one replica on a free port and wait for /readyz. Raises
    ``RuntimeError`` (with captured process output) on startup failure —
    the supervisor's restart ladder owns retrying."""
    port = free_port()
    env = dict(os.environ)
    env.update(spec.env)
    env["PORT"] = str(port)
    proc = subprocess.Popen(
        spec.command(port), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    replica = Replica(name, spec, port, proc)
    deadline = time.monotonic() + spec.ready_timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out = (proc.stdout.read() or b"").decode(errors="replace")
            raise RuntimeError(
                f"replica {name} exited during startup "
                f"(code {proc.returncode}): {out[-500:]}")
        if replica.probe() == PROBE_READY:
            return replica
        time.sleep(0.02)
    replica.shutdown(grace_s=1.0)
    raise RuntimeError(
        f"replica {name} not ready after {spec.ready_timeout_s:.1f}s")


class ReplicaFleet:
    """N replicas under one :class:`SessionSupervisor`.

    The supervisor owns restart mechanics (ladder, cumulative budget,
    degraded/failed states); the fleet owns replica identity (names are
    stable across restarts, ports are not), the drain-before-kill
    scale-down discipline, and the ``targets()`` view the telemetry
    collector refreshes from.
    """

    def __init__(
        self,
        spec: Optional[ReplicaSpec] = None,
        replicas: int = 1,
        name_prefix: str = "replica",
        policy: Optional[RetryPolicy] = None,
        restart_budget: Optional[int] = None,
        healthy_window_s: Optional[float] = None,
        poll_interval: float = 0.2,
        registry: Optional[Registry] = None,
        on_event: Optional[Callable[[object], None]] = None,
        logger=None,
    ):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.spec = spec or ReplicaSpec()
        self.name_prefix = name_prefix
        self.restart_budget = restart_budget
        self.healthy_window_s = healthy_window_s
        self._desired = replicas
        self._next_idx = 0
        self._replicas: dict = {}  # name -> Replica (live handles)
        self._started: set = set()  # names that started at least once
        self._lock = threading.RLock()
        self.supervisor = SessionSupervisor(
            restart=RESTART_ALWAYS,
            poll_interval=poll_interval,
            default_policy=policy or RetryPolicy(
                max_attempts=4, base_delay=0.1, max_delay=1.0,
                jitter=0.1, seed=0,
            ),
            on_event=on_event,
            logger=logger,
        )
        self.registry = registry or Registry()
        self.m_restarts = self.registry.counter(
            "fleet_replica_restarts_total",
            "Replica processes respawned after a death")
        self.m_scale_ups = self.registry.counter(
            "fleet_scale_ups_total", "Scale-up decisions applied")
        self.m_scale_downs = self.registry.counter(
            "fleet_scale_downs_total",
            "Scale-down decisions applied (all victims drained first)")
        self.registry.register_callback(
            "fleet_desired_replicas", "gauge",
            "Replica count the fleet is converging to",
            lambda: self._desired)
        self.registry.register_callback(
            "fleet_live_replicas", "gauge",
            "Replica processes currently running",
            lambda: sum(1 for r in self.handles() if r.alive()))
        self.registry.register_callback(
            "fleet_ready_replicas", "gauge",
            "Replicas whose /readyz answers 200",
            lambda: self.ready_count())

    # -- service wiring ------------------------------------------------------
    def _add_service(self, name: str) -> None:
        def factory():
            replica = spawn_replica(name, self.spec)
            with self._lock:
                restart = name in self._started
                self._started.add(name)
                self._replicas[name] = replica
            if restart:
                self.m_restarts.inc()
            obs_events.emit(
                "fleet",
                "replica_restarted" if restart else "replica_started",
                level="warn" if restart else "info",
                replica=name, port=replica.port, pid=replica.pid,
            )
            return replica

        def probe(replica) -> bool:
            return replica is not None and replica.probe() != PROBE_DEAD

        def stop(replica) -> None:
            if replica is not None:
                replica.shutdown()

        def failure(replica) -> Optional[str]:
            if replica is None:
                return "no replica handle"
            rc = replica.proc.poll()
            if rc is not None:
                return f"replica process exited with code {rc}"
            return "replica unresponsive on /readyz and /healthz"

        self.supervisor.add(
            name, factory, probe=probe, stop=stop, failure=failure,
            restart_budget=self.restart_budget,
            healthy_window_s=self.healthy_window_s,
        )

    def _new_name(self) -> str:
        with self._lock:
            name = f"{self.name_prefix}-{self._next_idx}"
            self._next_idx += 1
        return name

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for _ in range(self._desired):
            self._add_service(self._new_name())
        self.supervisor.start()

    def stop(self) -> None:
        self.supervisor.stop()
        # supervisor.stop() tears down RUNNING/RESTARTING services; sweep
        # anything it missed (e.g. degraded replicas keep a dead handle)
        for replica in self.handles():
            replica.shutdown(grace_s=1.0)

    # -- views ---------------------------------------------------------------
    def names(self) -> list:
        with self._lock:
            return list(self._replicas)

    def handles(self) -> list:
        with self._lock:
            return list(self._replicas.values())

    def replica(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(name)

    def targets(self) -> dict:
        """{replica name: base URL} for the telemetry collector. Names
        are stable across restarts; URLs change (fresh port per spawn) —
        exactly the shape ``TelemetryCollector.refresh`` preserves
        quarantine/staleness state across."""
        rows = self.supervisor.status()
        managed = {
            r["service"] for r in rows
            if r["state"] in (ServiceState.RUNNING, ServiceState.RESTARTING)
        }
        with self._lock:
            return {
                name: rep.base_url
                for name, rep in self._replicas.items()
                if name in managed
            }

    def ready_count(self) -> int:
        return sum(
            1 for r in self.handles() if r.probe() == PROBE_READY)

    def all_healthy(self) -> bool:
        rows = self.supervisor.status()
        if len(rows) != self._desired:
            return False
        if any(r["state"] != ServiceState.RUNNING for r in rows):
            return False
        return self.ready_count() == self._desired

    def statuses(self) -> list:
        out = []
        for row in self.supervisor.status():
            replica = self.replica(row["service"])
            row = dict(row)
            if replica is not None:
                row.update(
                    port=replica.port, pid=replica.pid,
                    probe=replica.probe(),
                )
            out.append(row)
        return out

    # -- scaling -------------------------------------------------------------
    @property
    def desired(self) -> int:
        return self._desired

    def scale_to(self, n: int, reason: str = "") -> list:
        """Converge the fleet to ``n`` replicas. Scale-up spawns and
        readiness-gates new replicas; scale-down drains victims (newest
        first), waits for in-flight to hit zero (bounded by the spec's
        ``drain_timeout_s``), then terminates. Returns the affected
        replica names."""
        if n < 1:
            raise ValueError("cannot scale below 1 replica")
        with self._lock:
            current = self._desired
            self._desired = n
        if n == current:
            return []
        if n > current:
            added = []
            for _ in range(n - current):
                name = self._new_name()
                self._add_service(name)
                self.supervisor.start_service(name)
                added.append(name)
            self.m_scale_ups.inc()
            obs_events.emit(
                "fleet", "scale_up", level="info",
                from_replicas=current, to_replicas=n,
                added=",".join(added), reason=reason,
            )
            return added
        victims = self._pick_victims(current - n)
        for name in victims:
            self._drain_and_remove(name)
        self.m_scale_downs.inc()
        obs_events.emit(
            "fleet", "scale_down", level="info",
            from_replicas=current, to_replicas=n,
            removed=",".join(victims), reason=reason,
        )
        return victims

    def _pick_victims(self, k: int) -> list:
        """Newest replicas first — the oldest have the longest proven
        healthy run, so survivors skew stable."""
        order = [r["service"] for r in self.supervisor.status()]
        return list(reversed(order))[:k]

    def _drain_and_remove(self, name: str) -> None:
        replica = self.replica(name)
        if replica is not None and replica.alive():
            replica.request_drain()
            deadline = time.monotonic() + self.spec.drain_timeout_s
            while time.monotonic() < deadline:
                n = replica.in_flight()
                if n == 0:
                    break
                if n is None and not replica.alive():
                    break  # died mid-drain; nothing left to wait for
                time.sleep(0.05)
        try:
            self.supervisor.remove(name, stop=True)
        except KeyError:
            pass  # already removed (e.g. concurrent stop)
        with self._lock:
            self._replicas.pop(name, None)
        obs_events.emit(
            "fleet", "replica_removed", level="info", replica=name)

    # -- chaos ---------------------------------------------------------------
    def kill(self, name: str, sig: int = signal.SIGKILL) -> None:
        """Kill one replica by PID (chaos hook; the supervisor notices
        the death on its next probe pass and restarts under policy)."""
        replica = self.replica(name)
        if replica is None:
            raise KeyError(f"unknown replica {name!r}")
        replica.kill(sig)
