"""The shared build -> deploy pipeline and the dev loop.

The port's copy of ``devspace_tpu/cli/pipeline.py``, with the same
behaviour (reference: cmd/dev.go buildAndDeploy 185, startServices 243,
reload on watcher change 230-234; cmd/deploy.go, CI-style, no dev
overrides). ``DevLoop`` runs sync, port forwarding, the terminal or the
log mux, and auto-reload under the port's session supervisor.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..builder.images import build_all
from ..builder.registry import init_registries
from ..config import latest
from ..deploy.manifests import deploy_all
from ..resilience.supervisor import SessionSupervisor, SupervisorEvent
from ..services import sessions as svc
from ..services.watch import GlobWatcher
from ..utils import log as logutil
from ..utils.trace import span
from .context import Context


def inject_default_image(config: latest.Config, image_tags: dict[str, str]) -> None:
    """Charts default to ``values.image``; point it at the freshly built
    image when the user didn't set one explicitly (the reference injects
    a .Values.images map the same way, deploy/helm/deploy.go:154-161)."""
    if not image_tags:
        return
    default_ref = image_tags.get("default") or next(iter(image_tags.values()))
    for d in config.deployments or []:
        if d.chart is not None:
            values = dict(d.chart.values or {})
            values.setdefault("image", default_ref)
            d.chart.values = values


def build_and_deploy(
    ctx: Context,
    dev_mode: bool,
    force_build: bool = False,
    force_deploy: bool = False,
    logger: Optional[logutil.Logger] = None,
) -> dict[str, str]:
    """Reference: cmd/dev.go buildAndDeploy / cmd/deploy.go Run."""
    log = logger or ctx.log
    config = ctx.config
    backend = ctx.backend
    with span("pipeline", dev_mode=dev_mode):
        backend.ensure_namespace(ctx.namespace)
        if getattr(backend, "ensure_cluster_admin_binding", None) and ctx.is_gke:
            backend.ensure_cluster_admin_binding()
        with span("registries"):
            pull_secrets = init_registries(backend, config, ctx.namespace, log)
        cache = ctx.loader.generated.get_cache(dev_mode)
        with span("build", images=len(config.images or {})) as s:
            image_tags = build_all(
                config,
                cache,
                backend=backend,
                dev_mode=dev_mode,
                force=force_build,
                base_dir=ctx.root,
                logger=log,
            )
            s["built"] = len(image_tags)
        ctx.save_generated()
        inject_default_image(config, image_tags)
        with span("deploy", deployments=len(config.deployments or [])):
            deploy_all(
                backend,
                config,
                ctx.namespace,
                image_tags=image_tags,
                pull_secrets=pull_secrets,
                force=force_deploy,
                cache=cache,
                base_dir=ctx.root,
                logger=log,
            )
        ctx.save_generated()
    return image_tags


class DevLoop:
    """The live dev session: services + auto-reload + interaction
    (reference: cmd/dev.go startServices + reload loop)."""

    def __init__(self, ctx: Context, args):
        self.ctx = ctx
        self.args = args
        self.log = ctx.log
        self.sync_sessions: list = []
        self.forwarders: list = []
        self.watcher: Optional[GlobWatcher] = None
        self.logmux: Optional[svc.LogMux] = None
        self.supervisor: Optional[SessionSupervisor] = None
        self.reload_requested = threading.Event()
        self.reload_count = 0  # cumulative reloads (event is cleared fast)
        self.stop_requested = threading.Event()
        self.services_ready = threading.Event()

    # -- services ----------------------------------------------------------
    def start_services(self) -> None:
        """Start dev services under the session supervisor: port-forwards
        are non-critical (a dead forwarder is restarted; an unrestartable
        one degrades the session but sync continues), sync is critical (an
        unrestartable sync session ends the dev loop — it owns slice-state
        correctness)."""
        config = self.ctx.config
        backend = self.ctx.backend
        self.supervisor = SessionSupervisor(
            restart=getattr(self.args, "restart_policy", None) or "on-failure",
            logger=self.log,
            on_event=self._on_supervisor_event,
        )

        def make_forwarders() -> list:
            with span("portforward.start"):
                self.forwarders = svc.start_port_forwarding(backend, config, self.log)
            return self.forwarders

        def make_sync() -> list:
            with span("sync.start") as s:
                self.sync_sessions = svc.start_sync(
                    backend,
                    config,
                    base_dir=self.ctx.root,
                    logger=self.log,
                    verbose=getattr(self.args, "verbose_sync", False),
                    digest=getattr(self.args, "sync_digest", "on") != "off",
                )
                s["sessions"] = len(self.sync_sessions)
            return self.sync_sessions

        if not getattr(self.args, "no_portforwarding", False):
            self.supervisor.add(
                "ports",
                make_forwarders,
                probe=lambda fws: all(fw.alive() for fw in fws),
                stop=lambda fws: [fw.stop() for fw in fws],
                failure=lambda fws: next(
                    (
                        f"forwarder for ports {fw.ports} died"
                        for fw in fws
                        if not fw.alive()
                    ),
                    "port-forward liveness probe failed",
                ),
                critical=False,
            )
        if not getattr(self.args, "no_sync", False):
            self.supervisor.add(
                "sync",
                make_sync,
                probe=lambda sessions: all(s.alive() for s in sessions),
                stop=lambda sessions: [s.stop() for s in sessions],
                failure=lambda sessions: next(
                    (str(s.error) for s in sessions if s.error is not None),
                    "sync liveness probe failed",
                ),
                critical=True,
            )
        self.supervisor.start()
        auto_reload = (config.dev.auto_reload if config.dev else None)
        if auto_reload and not auto_reload.disabled and auto_reload.paths:
            self.watcher = GlobWatcher(
                auto_reload.paths,
                callback=lambda changed: self._on_reload(changed),
                base_dir=self.ctx.root,
            )
            self.watcher.start()
        self.services_ready.set()

    def _on_reload(self, changed: list[str]) -> None:
        self.log.info("[dev] change in %s — redeploying", ", ".join(changed[:3]))
        self.reload_count += 1
        self.reload_requested.set()

    def _on_supervisor_event(self, ev: SupervisorEvent) -> None:
        """Live status line: any state change prints session health
        (the `dev` status surface the supervisor owns)."""
        if ev.kind in ("died", "restarted", "degraded", "failed") and self.supervisor:
            self.log.info("[dev] %s", self.supervisor.status_line())

    def stop_services(self) -> None:
        self.services_ready.clear()
        if self.supervisor:
            self.supervisor.stop()  # stops registered handles via their stop fns
            self.supervisor = None
        # Direct stops stay as a belt-and-braces fallback (idempotent; also
        # covers services that never made it under the supervisor).
        for session in self.sync_sessions:
            session.stop()
        for fw in self.forwarders:
            fw.stop()
        if self.watcher:
            self.watcher.stop()
        if self.logmux:
            self.logmux.stop()
        self.sync_sessions, self.forwarders, self.watcher = [], [], None
        # Force-close any exec/attach stream a service left hanging — a
        # half-open terminal or sync shell must not outlive the session
        # (reference: kubectl/upgrade_wrapper.go via services/terminal.go:113).
        tracker = getattr(self.ctx.backend, "connections", None)
        if tracker is not None:
            closed = tracker.close_all()
            if closed:
                self.log.debug("[dev] force-closed %d remote streams", closed)

    # -- the loop ----------------------------------------------------------
    def run(self) -> int:
        """Build, deploy, serve; rebuild on reload; exit on interrupt
        or terminal exit."""
        first = True
        while not self.stop_requested.is_set():
            build_and_deploy(
                self.ctx,
                dev_mode=True,
                force_build=getattr(self.args, "force_build", False) and first,
                force_deploy=(
                    getattr(self.args, "force_deploy", False) and first
                )
                or not first,
            )
            self.start_services()
            self.reload_requested.clear()
            rc = self._interact()
            if rc is not None:
                self.stop_services()
                return rc
            # reload: teardown and loop again
            self.stop_services()
            first = False
        return 0

    def _interact(self) -> Optional[int]:
        """Block until reload (returns None), stop, or terminal exit
        (returns exit code)."""
        import sys

        config = self.ctx.config
        terminal_conf = config.dev.terminal if config.dev else None
        want_terminal = (
            not getattr(self.args, "no_terminal", False)
            and terminal_conf is not None
            and not terminal_conf.disabled
            and sys.stdin.isatty()
        )
        if want_terminal:
            rc = svc.start_terminal(self.ctx.backend, config, logger=self.log)
            if self.reload_requested.is_set():
                return None
            return rc
        # Non-interactive: worker-prefixed log mux until reload/stop.
        try:
            from ..services.selectors import resolve_workers

            workers, ns, container = resolve_workers(
                self.ctx.backend, config, timeout=svc.POD_WAIT_ATTACH
            )
            self.logmux = svc.LogMux(
                self.ctx.backend, workers, ns, container=container, logger=self.log
            )
            self.logmux.follow()
        except Exception as e:  # noqa: BLE001 — logs are best-effort here
            self.log.warn("[dev] log streaming unavailable: %s", e)
        self.log.done(
            "[dev] session live — sync + forward running; press Ctrl-C to stop"
        )
        while not self.stop_requested.is_set():
            if self.reload_requested.is_set():
                return None
            if self.supervisor is not None:
                # The supervisor owns failure semantics: a dying sync
                # session is restarted under the policy first; only an
                # exhausted critical service ends the loop.
                if self.supervisor.failed.is_set():
                    self.log.error("[dev] %s", self.supervisor.error)
                    return 1
            else:
                fatal = [s for s in self.sync_sessions if s.error is not None]
                if fatal:
                    self.log.error("[dev] sync failed: %s", fatal[0].error)
                    return 1
            time.sleep(0.2)
        return 0

    def stop(self) -> None:
        self.stop_requested.set()
