"""Dev-session services: sync, port-forward, logs, attach, terminal.

Reference: pkg/devspace/services/{sync,port_forwarding,logs,attach,
terminal}.go — each service resolves its target pods, starts, and can be
stopped independently (SURVEY §7 design stance (c)). All of them fan out
across the job's workers; logs are multiplexed with a per-worker prefix
(SURVEY §7 step 7: "aggregated terminal/logs — worker-prefixed log mux").

The port's copy of ``devspace_tpu/services/sessions.py``, with two
differences: ``worker_prefix`` reads :attr:`kube.client.Pod.worker_id`
(``NODE_RANK``, the pod-index label, the name's ordinal), where the
reference reads ``TPU_WORKER_ID``; and a project with a ``gpu`` block
waits as long for its terminal's pods as for sync's, where the reference
does so for a ``tpu`` block.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from ..config import latest
from ..kube.portforward import PortForwarder
from ..resilience.policy import IdleBackoff, RetryPolicy
from ..resilience.supervisor import format_ready_timeout
from ..sync.session import SyncOptions, SyncSession
from ..utils import log as logutil
from .selectors import resolve_workers

POD_WAIT_SYNC = 120.0  # reference: services/sync.go:70
POD_WAIT_PORTFORWARD = 120.0  # reference: services/port_forwarding.go:53
POD_WAIT_TERMINAL = 5.0  # reference: services/terminal.go:65
POD_WAIT_ATTACH = 60.0  # reference: services/attach.go:26
PORTFORWARD_READY_TIMEOUT = 20.0  # reference: port_forwarding.go:86-93


def start_sync(
    backend,
    config: latest.Config,
    base_dir: str = ".",
    logger: Optional[logutil.Logger] = None,
    verbose: bool = False,
    digest: bool = True,
) -> list[SyncSession]:
    """Start every dev.sync entry (reference: services/sync.go StartSync)."""
    import os

    log = logger or logutil.get_logger()
    sessions: list[SyncSession] = []
    for sc in (config.dev.sync if config.dev else None) or []:
        workers, ns, container = resolve_workers(
            backend,
            config,
            sc.selector,
            sc.label_selector,
            sc.namespace,
            sc.container_name,
            timeout=POD_WAIT_SYNC,
        )
        local = os.path.join(base_dir, sc.local_sub_path or ".")
        opts = SyncOptions(
            local_path=os.path.abspath(local),
            container_path=sc.container_path or "/app",
            exclude_paths=sc.exclude_paths or [],
            download_exclude_paths=sc.download_exclude_paths or [],
            upload_exclude_paths=sc.upload_exclude_paths or [],
            upload_limit_kbs=(
                sc.bandwidth_limits.upload if sc.bandwidth_limits else None
            ),
            download_limit_kbs=(
                sc.bandwidth_limits.download if sc.bandwidth_limits else None
            ),
            container=container,
            fan_out=sc.fan_out or "all",
            verbose=verbose,
            verify_interval=(
                sc.verify_interval if sc.verify_interval is not None else 30.0
            ),
            # off if either the CLI (--sync-digest off) or this sync
            # entry (digest: false) disables it
            digest_gating=digest and sc.digest is not False,
            status_path=os.path.join(
                base_dir, ".devspace", "logs", "sync-status.json"
            ),
        )
        mirror = logutil.get_file_logger("sync", root=os.path.join(base_dir, ".devspace"))
        session_logger = log
        log.add_mirror(mirror)
        session = SyncSession(backend, workers, opts, session_logger)
        session.start()
        sessions.append(session)
        log.done(
            "[sync] session ready: %s <-> %d worker(s):%s",
            opts.local_path,
            len(session.workers),
            opts.container_path,
        )
    return sessions


def start_port_forwarding(
    backend,
    config: latest.Config,
    logger: Optional[logutil.Logger] = None,
) -> list[PortForwarder]:
    """Start every dev.ports entry (reference:
    services/port_forwarding.go). Multi-host twist: ``workers: all`` forwards every
    worker, offsetting local ports by worker index (worker i reachable at
    localPort + i)."""
    log = logger or logutil.get_logger()
    forwarders: list[PortForwarder] = []
    for pc in (config.dev.ports if config.dev else None) or []:
        workers, ns, _ = resolve_workers(
            backend,
            config,
            pc.selector,
            pc.label_selector,
            pc.namespace,
            timeout=POD_WAIT_PORTFORWARD,
        )
        targets = workers if (pc.workers == "all") else workers[:1]
        for i, pod in enumerate(targets):
            ports = []
            for pm in pc.port_mappings or []:
                local = (pm.local_port or pm.remote_port or 0) + i
                remote = pm.remote_port or pm.local_port or 0
                ports.append((local, remote))
            fw = backend.portforward(
                pod,
                ports,
                namespace=ns,
                bind_address=(pc.port_mappings or [latest.PortMapping()])[0].bind_address
                or "127.0.0.1",
            )
            started = time.monotonic()
            fw.start()
            if not fw.ready.wait(PORTFORWARD_READY_TIMEOUT):
                # Same message shape as the supervisor's restart reporting
                # (resilience.supervisor.format_ready_timeout) so operators
                # grep one format for every not-ready-in-time failure.
                raise TimeoutError(
                    format_ready_timeout(
                        "port-forward",
                        f"worker {pod.name}",
                        time.monotonic() - started,
                        "ports " + ",".join(f"{lp}->{rp}" for lp, rp in ports),
                    )
                )
            forwarders.append(fw)
            for (lp, rp) in ports:
                log.done(
                    "[ports] %s:%d -> %s:%d", "127.0.0.1", lp, pod.name, rp
                )
    return forwarders


def _resolve_terminal_workers(backend, config, timeout: Optional[float] = None):
    """Shared terminal-target resolution (terminal, attach, enter --all):
    dev.terminal config decides selector/namespace/container; one site so
    the three commands can never target different pods."""
    tc = (config.dev.terminal if config.dev else None) or latest.TerminalConfig()
    if timeout is None:
        timeout = POD_WAIT_TERMINAL if not config.gpu else POD_WAIT_SYNC
    workers, ns, container = resolve_workers(
        backend,
        config,
        tc.selector,
        tc.label_selector,
        tc.namespace,
        tc.container_name,
        timeout=timeout,
    )
    return tc, workers, ns, container


def worker_prefix(pod) -> str:
    """One prefix convention for all fan-out output (`logs`,
    `enter --all`): `[worker-N]` when the pod has a worker id
    (:attr:`kube.client.Pod.worker_id`), else the pod name."""
    wid = getattr(pod, "worker_id", None)
    return f"[worker-{wid}] " if wid is not None else f"[{getattr(pod, 'name', pod)}] "


def _default_logmux_policy() -> RetryPolicy:
    """Log streams drop whenever a pod restarts or the API server rotates
    the connection; reconnecting is cheap and the tail dedups nothing, so
    be generous with attempts but cap the wait. No jitter: one policy is
    shared across per-pod follow threads, and jitter would draw from the
    shared RNG in thread order — nondeterministic under chaos tests."""
    return RetryPolicy(
        max_attempts=5,
        base_delay=0.2,
        max_delay=5.0,
        jitter=0.0,
        seed=0,
        retry_on=(Exception,),
    )


class LogMux:
    """Worker-prefixed log streaming across the slice
    (replaces the reference's single-pod log follow). A dropped follow
    stream reconnects under ``retry_policy``; data on the new stream
    refills the attempt budget."""

    def __init__(
        self,
        backend,
        workers: list,
        namespace: str,
        container: Optional[str] = None,
        tail: Optional[int] = 100,
        out=None,
        logger: Optional[logutil.Logger] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.backend = backend
        self.workers = workers
        self.namespace = namespace
        self.container = container
        self.tail = tail
        self.out = out or sys.stdout
        self.log = logger or logutil.get_logger()
        self.retry_policy = retry_policy or _default_logmux_policy()
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()
        self._write_lock = threading.Lock()
        # observability for tests/status: reconnects per pod name
        self.reconnects: dict[str, int] = {}

    def _prefix(self, pod) -> str:
        return worker_prefix(pod)

    def run_once(self) -> None:
        """Print the last `tail` lines of every worker (no follow)."""
        for pod in self.workers:
            prefix = self._prefix(pod)
            for line in self.backend.logs(
                pod, namespace=self.namespace, container=self.container, tail=self.tail
            ):
                with self._write_lock:
                    self.out.write(prefix + line.decode("utf-8", "replace") + "\n")
        if hasattr(self.out, "flush"):
            self.out.flush()

    def follow(self) -> None:
        for pod in self.workers:
            t = threading.Thread(target=self._follow_one, args=(pod,), daemon=True)
            t.start()
            self._threads.append(t)

    def _follow_one(self, pod) -> None:
        prefix = self._prefix(pod)
        name = getattr(pod, "name", str(pod))
        delays = self.retry_policy.delays()
        # Once lines have been printed, reconnects re-tail with 0 so a
        # mid-flight drop does not replay them; until then keep the
        # configured tail — the history was never shown.
        tail = self.tail
        got_any = False
        while not self._stopped.is_set():
            got_data = False
            try:
                for line in self.backend.logs(
                    pod,
                    namespace=self.namespace,
                    container=self.container,
                    tail=tail,
                    follow=True,
                ):
                    if self._stopped.is_set():
                        return
                    got_data = got_any = True
                    with self._write_lock:
                        self.out.write(prefix + line.decode("utf-8", "replace") + "\n")
                        if hasattr(self.out, "flush"):
                            self.out.flush()
                return  # clean EOF — pod gone for good, nothing to chase
            except Exception as e:  # noqa: BLE001 — stream dropped mid-follow
                if self._stopped.is_set():
                    return
                if got_data:
                    delays = self.retry_policy.delays()  # progress refills budget
                try:
                    delay = next(delays)
                except StopIteration:
                    self.log.warn(
                        "[logs] stream from %s ended (reconnect budget "
                        "exhausted): %s", name, e,
                    )
                    return
                self.reconnects[name] = self.reconnects.get(name, 0) + 1
                self.log.warn(
                    "[logs] stream from %s dropped, reconnecting in %.1fs: %s",
                    name, delay, e,
                )
                if got_any:
                    tail = 0
                if self._stopped.wait(delay):
                    return

    def stop(self) -> None:
        self._stopped.set()


def start_terminal(
    backend,
    config: latest.Config,
    command: Optional[list[str]] = None,
    worker_index: Optional[int] = None,
    stdin=None,
    stdout=None,
    logger: Optional[logutil.Logger] = None,
) -> int:
    """Interactive shell on one slice worker (reference:
    services/terminal.go StartTerminal; command precedence args > config >
    ``sh -c "bash || sh"``, terminal.go:29-33). Returns the exit code."""
    log = logger or logutil.get_logger()
    tc, workers, ns, container = _resolve_terminal_workers(backend, config)
    idx = worker_index if worker_index is not None else (tc.worker or 0)
    idx = max(0, min(idx, len(workers) - 1))
    pod = workers[idx]
    cmd = command or tc.command or ["sh", "-c", "bash || sh"]
    log.info("[terminal] opening shell on %s (worker %d)", pod.name, idx)
    use_tty = stdin is None and sys.stdin.isatty()
    proc = backend.exec_stream(pod, cmd, container=container, tty=use_tty)
    return _pump_terminal(proc, stdin=stdin, stdout=stdout, tty=use_tty)


def _pump_terminal(proc, stdin=None, stdout=None, tty: bool = False) -> int:
    """Bidirectional pump between the local terminal and the remote shell;
    raw-TTY passthrough when interactive (reference: pkg/util/terminal)."""
    stdout = stdout or sys.stdout
    stop = threading.Event()

    # Idle-adaptive polling (was a fixed timeout=0.2, waking 5x/s on
    # streams quiet for hours): the wait doubles while idle up to 1s and
    # snaps back to 50ms the moment data arrives, so interactive latency
    # is unchanged but an idle session barely wakes.
    def pump_out():
        idle = IdleBackoff(initial=0.05, maximum=1.0)
        while not stop.is_set():
            try:
                data = proc.stdout.read_available(timeout=idle.next_wait())
            except Exception:  # noqa: BLE001 — stream closed
                return
            if data:
                idle.reset()
                text = data.decode("utf-8", "replace")
                stdout.write(text)
                if hasattr(stdout, "flush"):
                    stdout.flush()

    def pump_err():
        idle = IdleBackoff(initial=0.05, maximum=1.0)
        while not stop.is_set():
            try:
                data = proc.stderr.read_available(timeout=idle.next_wait())
            except Exception:  # noqa: BLE001
                return
            if data:
                idle.reset()
                sys.stderr.write(data.decode("utf-8", "replace"))
                sys.stderr.flush()

    threads = [threading.Thread(target=pump_out, daemon=True)]
    if not tty:
        threads.append(threading.Thread(target=pump_err, daemon=True))
    for t in threads:
        t.start()

    raw_ctx = None
    if tty:
        raw_ctx = _raw_tty()
        raw_ctx.__enter__()
    try:
        import time as _time

        source = stdin if stdin is not None else sys.stdin.buffer

        # stdin forwarding runs on its own daemon thread: a blocked
        # readline() must never keep the session alive after the remote
        # command exits.
        def pump_in():
            while not stop.is_set() and proc.poll() is None:
                try:
                    data = source.read(1) if tty else source.readline()
                except (OSError, ValueError):
                    return
                if not data:
                    return  # stdin EOF
                if isinstance(data, str):
                    data = data.encode()
                try:
                    proc.write_stdin(data)
                except Exception:  # noqa: BLE001 — remote ended
                    return

        threading.Thread(target=pump_in, daemon=True).start()
        while proc.poll() is None and not stop.is_set():
            _time.sleep(0.05)
        _time.sleep(0.1)  # let the output pumps drain the tail
        rc = proc.poll()
        return rc if rc is not None else 0
    finally:
        stop.set()
        if raw_ctx is not None:
            raw_ctx.__exit__(None, None, None)
        proc.terminate()


def _raw_tty():
    import contextlib

    @contextlib.contextmanager
    def ctx():
        import termios
        import tty as ttymod

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            ttymod.setraw(fd)
            yield
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return ctx()


def start_attach(
    backend,
    config: latest.Config,
    worker_index: int = 0,
    stdout=None,
    logger: Optional[logutil.Logger] = None,
) -> int:
    """Attach to a worker's main process (reference: services/attach.go —
    the fallback when the terminal is disabled)."""
    _, workers, ns, container = _resolve_terminal_workers(
        backend, config, timeout=POD_WAIT_ATTACH
    )
    pod = workers[max(0, min(worker_index, len(workers) - 1))]
    proc = backend.attach_stream(pod, container=container)
    return _pump_terminal(proc, stdin=_EmptyStdin(), stdout=stdout, tty=False)


class _EmptyStdin:
    def readline(self):
        import time

        time.sleep(0.2)
        return b""

    def read(self, n):
        return b""


def broadcast_exec(
    backend,
    config,
    command: list[str],
    timeout: float = 300.0,
    logger=None,
) -> int:
    """Run ``command`` on EVERY slice worker concurrently, with worker-
    prefixed output (the N-worker generalization of `enter -- <cmd>`;
    SURVEY §7 hard part #3 — terminal UX across N workers). Targets the
    same pods/container as ``start_terminal`` (dev.terminal config).
    Returns the first non-zero exit code, else 0."""
    import concurrent.futures

    log = logger or logutil.get_logger()
    _, workers, ns, container = _resolve_terminal_workers(backend, config)

    def run(w):
        return backend.exec_buffered(
            w, command, namespace=ns, container=container, timeout=timeout
        )

    rc = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(workers)) as pool:
        futures = {pool.submit(run, w): w for w in workers}
        for fut in concurrent.futures.as_completed(futures):
            w = futures[fut]
            prefix = worker_prefix(w)
            try:
                out, err, code = fut.result()
            except Exception as e:  # noqa: BLE001 — report per worker
                log.error("%sexec failed: %s", prefix, e)
                rc = rc or 1
                continue
            for line in out.decode(errors="replace").splitlines():
                print(f"{prefix}{line}")
            for line in err.decode(errors="replace").splitlines():
                print(f"{prefix}{line}", file=sys.stderr)
            if code:
                log.error("%sexit code %d", prefix, code)
                rc = rc or code
    return rc
