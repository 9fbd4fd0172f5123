"""Session supervision: one owner for every dev-session service lifecycle.

The dev loop runs several long-lived services at once (sync sessions,
port-forwarders, the log mux). Before the supervisor each failure path was
local and ad-hoc: a dead sync session surfaced only through a polling check
in ``DevLoop._interact``, a dead port-forward not at all. The supervisor
centralizes it (reference analogue: DevSpace restarts services inside
``RestartOnError`` wrappers scattered through pkg/devspace/services; here it
is one component with one policy):

- every service registers a **factory** (creates + starts it), a **probe**
  (liveness) and a **stop**;
- a monitor thread polls probes; a dead service is restarted under a
  :class:`~devspace_tpu_torch.resilience.policy.RetryPolicy` according to the
  session restart policy (``always`` | ``on-failure`` | ``never``);
- failures degrade gracefully: a non-critical service that exhausts its
  restart budget goes ``degraded`` and the session continues; a critical
  one (sync — it owns correctness of the slice state) escalates: the
  supervisor records a fatal error and the dev loop exits.

Two budgets bound restarts:

- **per-episode**: consecutive *failed* restart attempts after one death
  are bounded by the policy's ``max_attempts`` (a service whose factory
  keeps raising gives up after the backoff ladder);
- **cumulative** (opt-in via ``restart_budget``): *successful* restarts
  also count, so a crash-looping service that restarts cleanly every
  time still degrades instead of flapping forever. Staying continuously
  healthy past ``healthy_window_s`` resets the cumulative count — a
  replica that crashes once a day is never marked failed, only one that
  crashes faster than it can prove itself healthy.

Services may also be added (``add`` + ``start_service``) and removed
(``remove``) while the monitor is running — the seam the replica fleet
manager (devspace_tpu_torch/serving/fleet.py) scales through.

State machine per service::

    starting -> running -> (probe fails) -> restarting -> running
                                |                |
                                | policy=never   | budget exhausted
                                v                v
                        degraded/failed    degraded (non-critical)
                                           failed   (critical)
    running -> (clean exit, policy!=always) -> stopped

The port's copy of ``devspace_tpu/resilience/supervisor.py``, with the same behaviour; it
imports nothing of the JAX package. It logs through ``logging``, where the
reference has its CLI logger.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from ..obs import events as _obs_events
from .policy import RetryPolicy

RESTART_ALWAYS = "always"
RESTART_ON_FAILURE = "on-failure"
RESTART_NEVER = "never"
RESTART_POLICIES = (RESTART_ALWAYS, RESTART_ON_FAILURE, RESTART_NEVER)


class ServiceState:
    STARTING = "starting"
    RUNNING = "running"
    RESTARTING = "restarting"
    DEGRADED = "degraded"  # gave up restarting a non-critical service
    FAILED = "failed"  # gave up restarting a critical service
    STOPPED = "stopped"  # clean exit / supervisor shutdown


@dataclass
class SupervisorEvent:
    at: float
    service: str
    kind: str  # started | died | restarting | restarted | degraded | failed | exited | stopped
    detail: str = ""


def format_ready_timeout(
    what: str, target: str, elapsed: float, detail: str = ""
) -> str:
    """One message format for every 'X not ready in time' error — used by
    the port-forward readiness check and the supervisor's restart reporting
    so operators grep for a single shape."""
    suffix = f" ({detail})" if detail else ""
    return f"{what} to {target} not ready after {elapsed:.1f}s{suffix}"


class _Service:
    def __init__(
        self,
        name: str,
        factory: Callable[[], object],
        probe: Optional[Callable[[object], bool]],
        stop: Optional[Callable[[object], None]],
        failure: Optional[Callable[[object], Optional[str]]],
        critical: bool,
        policy: RetryPolicy,
        restart_budget: Optional[int] = None,
        healthy_window_s: Optional[float] = None,
    ):
        self.name = name
        self.factory = factory
        self.probe = probe
        self.stop_fn = stop
        self.failure = failure
        self.critical = critical
        self.policy = policy
        self.restart_budget = restart_budget
        self.healthy_window_s = healthy_window_s
        self.handle: object = None
        self.state = ServiceState.STARTING
        self.restarts = 0
        self.budget_used = 0  # successful restarts since the last reset
        self.running_since: Optional[float] = None
        self.removed = False
        self.last_error: Optional[str] = None
        self._delays: Optional[Iterator[float]] = None
        self._attempts = 0
        self._next_attempt_at = 0.0

    # -- probing -----------------------------------------------------------
    def healthy(self) -> bool:
        if self.probe is not None:
            try:
                return bool(self.probe(self.handle))
            except Exception:  # noqa: BLE001 — a broken probe means dead
                return False
        alive = getattr(self.handle, "alive", None)
        if callable(alive):
            try:
                return bool(alive())
            except Exception:  # noqa: BLE001
                return False
        return True

    def failure_reason(self) -> Optional[str]:
        """Error string when the service died of a failure; None means it
        exited cleanly (distinction drives ``on-failure`` vs ``always``)."""
        if self.failure is not None:
            try:
                reason = self.failure(self.handle)
            except Exception as e:  # noqa: BLE001
                return str(e)
            return str(reason) if reason is not None else None
        err = getattr(self.handle, "error", None)
        return str(err) if err is not None else "liveness probe failed"

    def stop_handle(self) -> None:
        if self.handle is None:
            return
        try:
            if self.stop_fn is not None:
                self.stop_fn(self.handle)
            else:
                stop = getattr(self.handle, "stop", None)
                if callable(stop):
                    stop()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


class SessionSupervisor:
    """Owns dev-session service lifecycles: probe, restart, degrade,
    escalate. Thread-safe; one monitor thread for all services."""

    def __init__(
        self,
        restart: str = RESTART_ON_FAILURE,
        poll_interval: float = 0.2,
        logger: Optional[logging.Logger] = None,
        default_policy: Optional[RetryPolicy] = None,
        on_event: Optional[Callable[[SupervisorEvent], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if restart not in RESTART_POLICIES:
            raise ValueError(
                f"unknown restart policy {restart!r} (want one of {RESTART_POLICIES})"
            )
        self.restart = restart
        self.poll_interval = poll_interval
        self.log = logger or logging.getLogger(__name__)
        self.default_policy = default_policy or RetryPolicy(
            max_attempts=4, base_delay=0.5, max_delay=8.0, jitter=0.2, seed=0
        )
        self.on_event = on_event
        self._clock = clock
        self._services: list[_Service] = []
        self._lock = threading.RLock()
        self._stopped = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self.events: list[SupervisorEvent] = []
        self.failed = threading.Event()
        self.error: Optional[str] = None

    # -- registration ------------------------------------------------------
    def add(
        self,
        name: str,
        factory: Callable[[], object],
        probe: Optional[Callable[[object], bool]] = None,
        stop: Optional[Callable[[object], None]] = None,
        failure: Optional[Callable[[object], Optional[str]]] = None,
        critical: bool = False,
        policy: Optional[RetryPolicy] = None,
        restart_budget: Optional[int] = None,
        healthy_window_s: Optional[float] = None,
    ) -> None:
        """Register a service. ``factory`` creates AND starts it, returning
        a handle; ``probe(handle)`` is its liveness check (defaults to
        ``handle.alive()`` when present, else always-healthy);
        ``failure(handle)`` classifies a death (error string, or None for a
        clean exit); ``stop(handle)`` tears it down (defaults to
        ``handle.stop()``).

        ``restart_budget`` caps *cumulative* successful restarts (None =
        unlimited, the historical behavior): a service that keeps crash-
        looping exhausts it and degrades/fails instead of flapping
        forever. ``healthy_window_s`` resets that budget once the service
        stays continuously healthy that long — an occasional crash never
        accumulates toward the cap."""
        with self._lock:
            if any(s.name == name for s in self._services):
                raise ValueError(f"duplicate service name {name!r}")
            self._services.append(
                _Service(
                    name,
                    factory,
                    probe,
                    stop,
                    failure,
                    critical,
                    policy or self.default_policy,
                    restart_budget,
                    healthy_window_s,
                )
            )

    def start_service(self, name: str) -> object:
        """Start one registered-but-unstarted service (the scale-up path:
        ``add`` then ``start_service`` on a supervisor whose monitor is
        already running). Factory exceptions propagate — startup failures
        are loud here exactly like in :meth:`start`. Returns the handle."""
        with self._lock:
            svc = next(
                (s for s in self._services if s.name == name), None)
        if svc is None:
            raise KeyError(f"unknown service {name!r}")
        if svc.handle is not None or svc.state != ServiceState.STARTING:
            raise ValueError(f"service {name!r} already started")
        svc.handle = svc.factory()
        svc.state = ServiceState.RUNNING
        svc.running_since = self._clock()
        self._emit(svc.name, "started")
        return svc.handle

    def remove(self, name: str, stop: bool = True) -> object:
        """Deregister a service (the scale-down path). The monitor stops
        probing it immediately; with ``stop`` (default) its handle is torn
        down too. Callers that drain before terminating pass
        ``stop=False`` and own the handle's shutdown. Returns the handle."""
        with self._lock:
            svc = next(
                (s for s in self._services if s.name == name), None)
            if svc is None:
                raise KeyError(f"unknown service {name!r}")
            svc.removed = True
            self._services = [s for s in self._services if s is not svc]
        if stop and svc.state in (
            ServiceState.RUNNING, ServiceState.RESTARTING
        ):
            svc.stop_handle()
        svc.state = ServiceState.STOPPED
        self._emit(svc.name, "stopped", "removed")
        return svc.handle

    def handle(self, name: str) -> object:
        """The current handle for ``name`` (None while restarting after a
        failed attempt)."""
        with self._lock:
            for s in self._services:
                if s.name == name:
                    return s.handle
        return None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start every registered service, then the monitor thread. A
        factory that raises during initial start propagates — startup
        failures are loud; only steady-state deaths are supervised."""
        # capture the starting thread's trace context: the monitor thread
        # emits from outside any request/session span stack, and its
        # structured events should land on the session trace
        from ..obs.tracing import get_tracer

        self._trace_ctx = get_tracer().current_context()
        with self._lock:
            services = list(self._services)
        for svc in services:
            svc.handle = svc.factory()
            svc.state = ServiceState.RUNNING
            svc.running_since = self._clock()
            self._emit(svc.name, "started")
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="session-supervisor"
        )
        self._monitor_thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        with self._lock:
            services = list(self._services)
        for svc in services:
            if svc.state in (ServiceState.RUNNING, ServiceState.RESTARTING):
                svc.stop_handle()
                svc.state = ServiceState.STOPPED
        self._emit("supervisor", "stopped")

    # -- monitor -----------------------------------------------------------
    def _monitor(self) -> None:
        while not self._stopped.wait(self.poll_interval):
            with self._lock:
                services = list(self._services)
            for svc in services:
                try:
                    self._check(svc)
                except Exception as e:  # noqa: BLE001 — monitor must survive
                    self.log.warning(
                        "[supervisor] check of %s raised: %s", svc.name, e
                    )

    def _check(self, svc: _Service) -> None:
        if svc.removed:
            return
        if svc.state == ServiceState.RUNNING:
            if svc.healthy():
                # cumulative-budget reset: continuously healthy past the
                # window proves the service stable again, so an
                # occasional crash (once a day, say) never accumulates
                # toward the restart_budget cap
                if (
                    svc.healthy_window_s is not None
                    and svc.budget_used
                    and svc.running_since is not None
                    and self._clock() - svc.running_since
                    >= svc.healthy_window_s
                ):
                    svc.budget_used = 0
                    self._emit(
                        svc.name, "budget_reset",
                        f"healthy for {svc.healthy_window_s:g}s",
                    )
                return
            reason = svc.failure_reason()
            if reason is None:
                # clean exit
                if self.restart == RESTART_ALWAYS:
                    self._emit(svc.name, "died", "clean exit")
                    self._begin_restart(svc)
                else:
                    svc.state = ServiceState.STOPPED
                    self._emit(svc.name, "exited")
                return
            svc.last_error = reason
            self._emit(svc.name, "died", reason)
            if self.restart == RESTART_NEVER:
                self._give_up(svc, reason)
            else:  # always | on-failure both restart failures
                self._begin_restart(svc)
        elif svc.state == ServiceState.RESTARTING:
            if self._clock() >= svc._next_attempt_at:
                self._attempt_restart(svc)

    def _begin_restart(self, svc: _Service) -> None:
        if (
            svc.restart_budget is not None
            and svc.budget_used >= svc.restart_budget
        ):
            self._give_up(
                svc,
                f"{svc.last_error or 'died'} (cumulative restart budget "
                f"of {svc.restart_budget} exhausted without a "
                f"{svc.healthy_window_s or 0:g}s healthy window)",
            )
            return
        svc.state = ServiceState.RESTARTING
        svc._delays = svc.policy.delays()
        svc._attempts = 0
        svc._next_attempt_at = self._clock()  # first attempt immediately

    def _attempt_restart(self, svc: _Service) -> None:
        svc.stop_handle()
        svc._attempts += 1
        self._emit(
            svc.name, "restarting", f"attempt {svc._attempts}/{svc.policy.max_attempts}"
        )
        try:
            svc.handle = svc.factory()
        except Exception as e:  # noqa: BLE001 — a failed restart is the normal path here
            svc.last_error = str(e)
            try:
                delay = next(svc._delays)
            except StopIteration:
                self._give_up(svc, str(e))
                return
            svc._next_attempt_at = self._clock() + delay
            return
        svc.state = ServiceState.RUNNING
        svc.restarts += 1
        svc.budget_used += 1
        svc.running_since = self._clock()
        svc._delays = None
        self._emit(svc.name, "restarted", f"restart #{svc.restarts}")

    def _give_up(self, svc: _Service, reason: str) -> None:
        if svc.critical:
            svc.state = ServiceState.FAILED
            self.error = f"critical service {svc.name!r} lost: {reason}"
            self._emit(svc.name, "failed", reason)
            self.failed.set()
        else:
            svc.state = ServiceState.DEGRADED
            self._emit(svc.name, "degraded", reason)

    # -- events / status ----------------------------------------------------
    def _emit(self, service: str, kind: str, detail: str = "") -> None:
        ev = SupervisorEvent(time.time(), service, kind, detail)
        with self._lock:
            self.events.append(ev)
            del self.events[:-200]  # bounded history
        ctx = getattr(self, "_trace_ctx", None)
        _obs_events.emit(
            "supervisor", kind,
            level=(
                "error" if kind in ("died", "failed")
                else "warn" if kind in ("restarting", "degraded")
                else "info"
            ),
            trace_id=ctx.trace_id if ctx is not None else None,
            span_id=ctx.span_id if ctx is not None else None,
            service=service, detail=detail,
        )
        if kind in ("died", "degraded", "failed"):
            self.log.warning("[supervisor] %s %s %s", service, kind, detail)
        elif kind in ("restarted",):
            self.log.info("[supervisor] %s %s %s", service, kind, detail)
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:  # noqa: BLE001 — observer must not kill monitor
                pass

    def status(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "service": s.name,
                    "state": s.state,
                    "critical": s.critical,
                    "restarts": s.restarts,
                    "budget_used": s.budget_used,
                    "restart_budget": s.restart_budget,
                    "last_error": s.last_error,
                }
                for s in self._services
            ]

    def status_line(self) -> str:
        """One-line session health for the CLI status line."""
        rows = self.status()
        running = sum(1 for r in rows if r["state"] == ServiceState.RUNNING)
        parts = [f"{running}/{len(rows)} services up"]
        for r in rows:
            if r["state"] != ServiceState.RUNNING:
                parts.append(f"{r['service']}:{r['state']}")
        restarts = sum(r["restarts"] for r in rows)
        if restarts:
            parts.append(f"{restarts} restart(s)")
        return " | ".join(parts)
