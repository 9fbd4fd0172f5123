"""The port's CLI: ``python -m devspace_tpu_torch <command>``.

The port's copy of ``devspace_tpu/cli/main.py`` (reference: cmd/, the
cobra root and subcommands, SURVEY §2.1), with the reference's flags,
output and exit codes:

- the commands that apply a project to a cluster and develop in it:
  ``init`` (a torch project: the CUDA Dockerfile, chart-gpu and a ``gpu``
  block), ``deploy`` (lint preflight, build, apply), ``dev`` (the live
  session: sync across the job's workers, port forwarding, the terminal
  or the log mux, auto-reload), ``enter`` (``--worker N``, ``--all``),
  ``logs``, ``purge``, ``reset``, ``analyze``,
  ``status deployments``/``sync``/``trace``, ``print`` (``--manifests``)
  and ``lint``;
- the serving operator's commands, over running servers
  (``python -m devspace_tpu_torch.serve``) and their collector:
  ``status serving``, ``profile serving``, ``top`` (``--fleet``),
  ``debug bundle`` (``--fleet``, ``--target``), ``collector serve``
  (``--target`` or ``--workers``) and ``fleet serve|status``, whose
  replicas default to the stub (``devspace_tpu_torch.serving.stub``) and
  which adds one flag, ``--ready-timeout`` (the reference's fixed 15 s,
  which a 7B server's load and prewarm outlast);
- the project-editing commands: ``add``/``remove``
  ``sync|port|selector|deployment|image``, ``list
  deployments|images|ports|sync|selectors|vars|configs``, ``use
  config|context|namespace`` and ``update config``;
- the cloud commands, over the port's ``cloud/`` and the same
  ``~/.devspace/clouds.yaml`` as the reference's: ``add|remove
  provider``, ``login``, ``create space``, ``use space|registry``, ``list
  spaces|providers``, ``remove space`` and ``remove context [--all]``;
- the package commands, over ``deploy/packages.py``: ``add|remove
  package``, ``list packages``, ``search`` and ``update packages
  [--apply]``;
- ``upgrade`` and ``install`` and the start-up version notice, which act
  on the port alone: ``upgrade --archive`` reads and swaps
  ``devspace_tpu_torch/`` only, ``install`` writes a launcher named
  ``devspace-tpu-torch``, and the notice stamps its daily check in
  ``~/.devspace/version_check_torch.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import yaml

from .. import __version__
from ..config import latest
from ..config.loader import ConfigLoader, config_exists, find_root
from ..config.structs import to_dict
from ..utils import log as logutil
from ..utils import stdinutil
from ..utils.dockerfile import get_ports
from ..utils.ignoreutil import get_ignore_rules
from .context import CLIError, Context
from .pipeline import DevLoop, build_and_deploy, inject_default_image


def _ask(question: str, default: str = "", pattern: Optional[str] = None) -> str:
    return stdinutil.ask(
        stdinutil.Question(question=question, default=default, validation_pattern=pattern)
    )


# -- init -------------------------------------------------------------------
def cmd_init(args) -> int:
    """Reference: cmd/init.go — scaffold Dockerfile + chart + config. A
    project importing torch gets the CUDA Dockerfile, chart-gpu and a
    ``gpu`` block (the reference: jax, chart-tpu and a ``tpu`` block)."""
    from ..generator.generator import create_chart, create_dockerfile, detect_language

    log = logutil.get_logger()
    root = os.getcwd()
    if config_exists(root) and not args.reconfigure:
        log.warn("config already exists — use --reconfigure to overwrite")
        return 1
    name = _ask("Project name", os.path.basename(root) or "app", r"[a-z0-9-]+")
    language = args.language or detect_language(root)
    language = _ask("Project language (torch/python/node/go)", language)
    dockerfile = create_dockerfile(root, language, log)
    chart_existed = os.path.isdir(os.path.join(root, "chart"))
    create_chart(root, language, log)
    image = _ask("Container image to build (e.g. gcr.io/proj/app)", f"registry.local/{name}")

    cfg = latest.new()
    cfg.images = {
        "default": latest.ImageConfig(
            image=image, dockerfile="Dockerfile", context=".", create_pull_secret=True
        )
    }
    chart_values = None
    if args.volume:
        # --volume NAME:SIZE[:MOUNTPATH] — persistence through the chart
        # engine's persistence.* convention (Deployment: standalone PVC;
        # GPU StatefulSet: per-worker volumeClaimTemplates)
        vols, mounts = [], []
        for spec in args.volume:
            parts = spec.split(":")
            if (
                len(parts) not in (2, 3)
                or not all(parts)  # every present field must be non-empty
            ):
                log.warn(
                    "[init] bad --volume %r (want NAME:SIZE[:MOUNTPATH])",
                    spec,
                )
                return 1
            vols.append({"name": parts[0], "size": parts[1]})
            if len(parts) == 3:
                mounts.append({"name": parts[0], "mountPath": parts[2]})
        chart_values = {"persistence": {"volumes": vols, "mounts": mounts}}
        # a kept pre-existing chart may predate the persistence plumbing:
        # values would then render nothing — data silently non-durable
        kept_values = os.path.join(root, "chart", "values.yaml")
        if chart_existed and (
            not os.path.isfile(kept_values)
            or "persistence" not in open(kept_values, encoding="utf-8").read()
        ):
            log.warn(
                "[init] --volume set but the existing chart/ has no "
                "persistence support — re-scaffold the chart (move it "
                "aside and rerun init) or add persistence.* plumbing "
                "to its templates, or no PVC will be created"
            )
    cfg.deployments = [
        latest.DeploymentConfig(
            name=name,
            chart=latest.ChartConfig(path="./chart", values=chart_values),
        )
    ]
    if language == "torch":
        workers = int(_ask("GPU worker hosts in the job", "2", r"[0-9]+"))
        per_worker = int(_ask("GPUs per host", "8", r"[0-9]+"))
        product = _ask("GPU product (node label)", latest.DEFAULT_GPU_PRODUCT)
        cfg.gpu = latest.GPUConfig(
            workers=workers, per_worker=per_worker, product=product
        )
    ports = get_ports(dockerfile) or [8080]
    excludes = ["chart/", ".devspace/", ".git/"] + get_ignore_rules(
        os.path.join(root, ".dockerignore")
    )
    cfg.dev = latest.DevConfig(
        selectors=[
            latest.SelectorConfig(name="default", label_selector={"app": name})
        ],
        ports=[
            latest.PortForwardingConfig(
                selector="default",
                port_mappings=[
                    latest.PortMapping(local_port=p, remote_port=p) for p in ports
                ],
            )
        ],
        sync=[
            latest.SyncConfig(
                selector="default",
                local_sub_path=".",
                container_path="/app",
                exclude_paths=excludes,
                fan_out="all",
            )
        ],
        terminal=latest.TerminalConfig(selector="default"),
        auto_reload=latest.AutoReloadConfig(paths=["Dockerfile", "chart/**"]),
        override_images=[
            latest.ImageOverrideConfig(
                name="default", entrypoint=["sleep", "999999999"]
            )
        ],
    )
    loader = ConfigLoader(root, log)
    loader.save(cfg)
    log.done("[init] project ready — next: 'python -m devspace_tpu_torch deploy'")
    return 0


# -- pipeline commands ------------------------------------------------------
def cmd_deploy(args) -> int:
    """Reference: cmd/deploy.go — CI-style build+deploy, no dev overrides."""
    ctx = Context(args)
    if not getattr(args, "skip_lint", False):
        # preflight: a chart that renders broken objects must not reach
        # the cluster — abort on lint ERRORS (warnings pass through)
        from ..lint import ERROR
        from ..lint.project import collect_project_findings

        findings, _ = collect_project_findings(ctx)
        errors = [f for f in findings if f.severity == ERROR]
        if errors:
            for f in sorted(errors, key=lambda f: f.sort_key()):
                where = " ".join(p for p in (f.artifact, f.location) if p)
                ctx.log.error(
                    "[deploy] lint %s %s%s",
                    f.rule_id,
                    where + ": " if where else "",
                    f.message,
                )
            ctx.log.error(
                "[deploy] aborted: %d lint error(s) — fix them or rerun "
                "with --skip-lint",
                len(errors),
            )
            return 1
    build_and_deploy(
        ctx,
        dev_mode=False,
        force_build=args.force_build,
        force_deploy=args.force_deploy,
    )
    ctx.log.done(
        "[deploy] done — run 'python -m devspace_tpu_torch analyze' if pods misbehave"
    )
    return 0


def cmd_dev(args) -> int:
    """Reference: cmd/dev.go — THE dev loop."""
    ctx = Context(args)
    loop = DevLoop(ctx, args)
    try:
        return loop.run()
    except KeyboardInterrupt:
        ctx.log.info("[dev] interrupted — tearing down services")
        loop.stop()
        loop.stop_services()
        return 0


def cmd_purge(args) -> int:
    """Reference: cmd/purge.go — delete deployments in reverse order."""
    from ..deploy.manifests import purge_all

    ctx = Context(args)
    purge_all(ctx.backend, ctx.config, ctx.namespace, base_dir=ctx.root, logger=ctx.log)
    return 0


def cmd_reset(args) -> int:
    """Reference: cmd/reset.go — remove everything devspace created."""
    from ..deploy.manifests import purge_all

    ctx = Context(args)
    try:
        purge_all(ctx.backend, ctx.config, ctx.namespace, base_dir=ctx.root, logger=ctx.log)
    except Exception as e:  # noqa: BLE001 — cluster may be gone already
        ctx.log.warn("[reset] purge failed: %s", e)
    import shutil

    devspace_dir = os.path.join(ctx.root, ".devspace")
    if os.path.isdir(devspace_dir):
        shutil.rmtree(devspace_dir)
        ctx.log.done("[reset] removed .devspace/")
    if args.all:
        for extra in ("chart", "Dockerfile"):
            path = os.path.join(ctx.root, extra)
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.isfile(path):
                os.unlink(path)
        ctx.log.done("[reset] removed generated chart/ and Dockerfile")
    return 0


# -- session commands -------------------------------------------------------
def cmd_enter(args) -> int:
    """Reference: cmd/enter.go — shell into a slice worker; --all runs the
    command on every worker with prefixed output (slice generalization)."""
    from ..services.sessions import broadcast_exec, start_terminal

    ctx = Context(args)
    command = args.command if args.command else None
    if getattr(args, "all", False):
        if args.worker is not None:
            ctx.log.error("[enter] --all and --worker are mutually exclusive")
            return 1
        if not command:
            ctx.log.error("[enter] --all requires a command (no interactive fan-out TTY)")
            return 1
        return broadcast_exec(ctx.backend, ctx.config, command, logger=ctx.log)
    # None falls through to the dev.terminal.worker config (precedence
    # args > config > 0, resolved in start_terminal)
    return start_terminal(
        ctx.backend, ctx.config, command=command, worker_index=args.worker, logger=ctx.log
    )


def cmd_logs(args) -> int:
    """Reference: cmd/logs.go — now worker-prefix-muxed across the slice."""
    from ..services.selectors import resolve_workers
    from ..services.sessions import LogMux

    ctx = Context(args)
    workers, ns, container = resolve_workers(
        ctx.backend, ctx.config, selector_name=args.selector, timeout=60.0
    )
    if args.worker is not None:
        workers = [workers[min(args.worker, len(workers) - 1)]]
    mux = LogMux(ctx.backend, workers, ns, container=container, tail=args.lines)
    mux.run_once()
    if args.follow:
        mux.follow()
        try:
            import time

            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            mux.stop()
    return 0


def cmd_analyze(args) -> int:
    """Reference: cmd/analyze.go."""
    from ..analyze.analyze import create_report

    ctx = Context(args)
    report = create_report(
        ctx.backend, ctx.namespace, config=ctx.config, wait=not args.no_wait
    )
    print(report)
    return 0


# -- status ---------------------------------------------------------------
def _status_serving(args) -> int:
    """Render a running inference server's telemetry snapshot: engine
    stats from /healthz plus the recent-request ring from /debug/requests
    (``python -m devspace_tpu_torch.serve``)."""
    import json as _json
    import urllib.error
    import urllib.request

    log = logutil.get_logger()
    url = args.url.rstrip("/")

    def fetch(path):
        with urllib.request.urlopen(url + path, timeout=5) as resp:
            return _json.loads(resp.read())

    try:
        health = fetch("/healthz")
    except (urllib.error.URLError, OSError, ValueError) as e:
        log.error("no serving endpoint at %s: %s", url, e)
        return 1
    stat_keys = [
        ("model", "model"),
        ("active_slots", "active slots"),
        ("queued", "queued"),
        ("requests_completed", "completed"),
        ("requests_failed", "failed"),
        ("requests_preempted", "preempted"),
        ("tokens_generated", "tokens"),
        ("tokens_per_sec", "tok/s (lifetime)"),
        ("tokens_per_sec_10s", "tok/s (10s)"),
        ("free_blocks", "free kv blocks"),
        # the host KV tier (inference/kv_tier.py): "off" with the tier
        # disabled, restore/spill traffic when chains cycle
        ("kv_tier", "kv tier"),
        ("kv_tier_resident_bytes", "kv tier resident bytes"),
        ("kv_spill_blocks", "kv blocks spilled"),
        ("kv_restore_hits", "kv restore hits"),
        ("kv_restore_fallbacks", "kv restore fallbacks"),
        ("recompute_tokens_saved", "recompute tokens saved"),
        ("uptime_s", "uptime (s)"),
    ]
    log.print_table(
        ["STAT", "VALUE"],
        [[label, str(health.get(k, "-"))] for k, label in stat_keys],
    )
    # SLO burn-rate statuses (obs/slo.py); absent on a server without them
    slo = health.get("slo")
    if slo is not None:
        if slo.get("slos"):
            log.print_table(
                ["SLO", "STATUS", "BURN(SHORT)", "BURN(LONG)"],
                [
                    [
                        s.get("name", "?"),
                        s.get("status", "?"),
                        f"{s.get('burn_short', 0):.2f}",
                        f"{s.get('burn_long', 0):.2f}",
                    ]
                    for s in slo["slos"]
                ],
            )
            if not slo.get("ready", True):
                log.warn("NOT READY: an SLO is in breach (/readyz -> 503)")
        else:
            log.info("slo: no evaluation yet (server just started)")
    try:
        debug = fetch("/debug/requests")
    except (urllib.error.URLError, OSError, ValueError):
        debug = None
    if debug is None:
        log.warn("no /debug/requests endpoint at %s (older server?)", url)
        return 0
    if not debug.get("metrics_enabled", False):
        log.warn("metrics disabled on the server (DEVSPACE_ENGINE_METRICS=off)")
        return 0

    def ms(v):
        return f"{v * 1000:.1f}ms" if v is not None else "-"

    rows = [
        [
            str(r.get("id", "?")),
            r.get("outcome") or "in-flight",
            str(r.get("prompt_len", "-")),
            str(r.get("tokens_generated", 0)),
            ms(r.get("queue_wait_s")),
            ms(r.get("ttft_s")),
            ms(r.get("tpot_s")),
            ms(r.get("e2e_s")),
            str(r.get("preemptions", 0)),
        ]
        for r in (debug.get("requests") or [])[-15:]
    ]
    log.print_table(
        ["REQ", "OUTCOME", "PROMPT", "TOKENS", "QUEUE", "TTFT", "TPOT", "E2E", "PREEMPTS"],
        rows,
    )
    return 0


def cmd_status(args) -> int:
    """Reference: cmd/status/{deployments,sync}.go, the span trace of
    the pipeline's phases, and a running server's telemetry."""
    if args.what == "serving":
        # scrapes a RUNNING server over HTTP: needs --url, not a project
        # config, so this branch runs before Context() (which needs one)
        return _status_serving(args)
    ctx = Context(args)
    log = ctx.log
    if args.what == "deployments":
        import time as _time

        from ..deploy.manifests import create_deployer

        rows = []
        for d in ctx.config.deployments or []:
            deployer = create_deployer(ctx.backend, d, ctx.namespace, ctx.root, log)
            info = (
                deployer.release_info()
                if hasattr(deployer, "release_info")
                else {"revision": "-", "deployed_at": None}
            )
            age = "-"
            if info.get("deployed_at"):
                age = f"{(_time.time() - info['deployed_at'])/60:.0f}m ago"
            for s in deployer.status():
                rows.append(
                    [
                        d.name,
                        str(info.get("revision", "-")),
                        age,
                        s["kind"],
                        s["name"],
                        s["namespace"],
                        s.get(
                            "rollout",
                            "Deployed" if s["found"] else "Missing",
                        ),
                    ]
                )
        log.print_table(
            ["DEPLOYMENT", "REVISION", "DEPLOYED", "KIND", "NAME", "NAMESPACE", "STATUS"],
            rows,
        )
    elif args.what == "trace":
        from ..utils import trace

        spans = trace.load(os.path.join(ctx.root, ".devspace"))
        if getattr(args, "export", None):
            n = trace.export_chrome(
                os.path.join(ctx.root, ".devspace"), args.export
            )
            log.done("[trace] wrote %d events to %s (chrome://tracing)", n, args.export)
            return 0
        rows = [
            [
                s.get("name", "?"),
                f"{s.get('duration_s', 0)*1000:.0f}ms",
                "ok" if s.get("ok") else s.get("error", "?")[:40],
                s.get("parent") or "-",
            ]
            for s in spans[-30:]
        ]
        log.print_table(["SPAN", "DURATION", "RESULT", "PARENT"], rows)
        if len(spans) > 30:
            log.info(
                "[trace] showing 30 of %d spans (full trace in "
                ".devspace/logs/trace.jsonl)",
                len(spans),
            )
        if trace.dropped():
            log.warn(
                "[trace] %d span(s) evicted from the in-memory ring "
                "(trace_spans_dropped_total)",
                trace.dropped(),
            )
    else:  # sync — structured status file + sync.log scrape fallback
        import json as _json
        import time as _time

        # Live per-session/per-worker view from the session-published
        # status file (richer than the reference's sync.log regex scrape,
        # cmd/status/sync.go:19-21,56-110).
        status_file = os.path.join(ctx.root, ".devspace", "logs", "sync-status.json")
        published: dict = {}
        try:
            with open(status_file, "r", encoding="utf-8") as fh:
                published = _json.load(fh)
        except (OSError, ValueError):
            published = {}
        if published:
            rows = []
            worker_rows = []
            for key, st in sorted(published.items()):
                stats = st.get("stats") or {}
                age = _time.time() - (st.get("updated_at") or 0)
                if st.get("error"):
                    state = "Error"
                elif st.get("running") and age < 600:
                    state = "Active"  # age guard: killed -9 never unpublishes
                elif st.get("running"):
                    # claims running but stale despite the session's 120s
                    # heartbeat — likely a killed process, but don't assert
                    # what we can't know
                    state = "Unknown"
                else:
                    state = "Stopped"
                rows.append(
                    [
                        st.get("local_path", "?"),
                        st.get("container_path", "?"),
                        state,
                        f"{age:.0f}s ago",
                        str(stats.get("uploaded", 0)),
                        str(stats.get("downloaded", 0)),
                        str(
                            stats.get("removed_remote", 0)
                            + stats.get("removed_local", 0)
                        ),
                        str(stats.get("repaired", 0)),
                    ]
                )
                for w in st.get("workers") or []:
                    worker_rows.append(
                        [
                            w.get("worker", "?"),
                            w.get("state", "?"),
                            str(w.get("repairs", 0)),
                            f"{w['verified_ago']:.0f}s ago"
                            if w.get("verified_ago") is not None
                            else "-",
                            (w.get("last_error") or "-")[:60],
                        ]
                    )
            log.print_table(
                ["LOCAL", "CONTAINER", "STATUS", "ACTIVITY", "UP", "DOWN", "RM", "REPAIRED"],
                rows,
            )
            log.print_table(
                ["WORKER", "STATE", "REPAIRS", "VERIFIED", "LAST ERROR"],
                worker_rows,
            )
            errs = [st["error"] for st in published.values() if st.get("error")]
            if errs:
                log.error("last error: %s", errs[-1])
            return 0
        # Fallback: scrape sync.log (sessions from older runs / no file)
        sync_log = os.path.join(ctx.root, ".devspace", "logs", "sync.log")
        entries = []
        try:
            with open(sync_log, "r", encoding="utf-8") as fh:
                for line in fh:
                    try:
                        entries.append(_json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            log.warn("no sync log found at %s", sync_log)
            return 1
        uploads = sum(1 for e in entries if "Uploaded" in e.get("msg", ""))
        downloads = sum(1 for e in entries if "Downloaded" in e.get("msg", ""))
        started = [e for e in entries if "starting" in e.get("msg", "")]
        errors = [e for e in entries if e.get("level") in ("error", "fatal")]
        status = "Error" if errors else ("Active" if started else "Stopped")
        log.print_table(
            ["STATUS", "SESSIONS", "UPLOAD BATCHES", "DOWNLOAD BATCHES", "ERRORS"],
            [[status, str(len(started)), str(uploads), str(downloads), str(len(errors))]],
        )
        if errors:
            log.error("last error: %s", errors[-1].get("msg", ""))
    return 0


# -- profile ----------------------------------------------------------------
def cmd_profile(args) -> int:
    """``profile serving``: ask a running inference server to record its
    engine timeline for N seconds (/debug/trace?seconds=N on
    ``python -m devspace_tpu_torch.serve``) and save the Chrome-trace JSON —
    load it in chrome://tracing or Perfetto to see device decode chunks
    overlapping host scheduling."""
    import json as _json
    import urllib.error
    import urllib.parse
    import urllib.request

    log = logutil.get_logger()
    url = args.url.rstrip("/")
    seconds = args.seconds
    if not 0 < seconds <= 60:
        log.error("--seconds must be in (0, 60], got %s", seconds)
        return 1
    qs = urllib.parse.urlencode({"seconds": seconds})
    log.info("recording %ss of engine timeline from %s ...", seconds, url)
    try:
        # the server blocks for the full capture window before replying,
        # so the client timeout must comfortably exceed --seconds
        with urllib.request.urlopen(
            f"{url}/debug/trace?{qs}", timeout=seconds + 30
        ) as resp:
            trace = _json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError) as e:
        log.error("no serving endpoint at %s: %s", url, e)
        return 1
    if "error" in trace:
        log.error("server rejected the capture: %s", trace["error"])
        return 1
    events = trace.get("traceEvents") or []
    lanes = sorted(
        {
            e["args"]["name"]
            for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
        }
    )
    with open(args.out, "w", encoding="utf-8") as fh:
        _json.dump(trace, fh)
    meta = trace.get("metadata") or {}
    log.done(
        "wrote %s (%d events, %d dropped) — open in chrome://tracing",
        args.out,
        meta.get("events", sum(1 for e in events if e.get("ph") == "X")),
        meta.get("dropped", 0),
    )
    if lanes:
        log.info("lanes: %s", ", ".join(lanes))
    return 0


def _parse_prom_text(text: str) -> dict:
    """Prometheus text exposition -> ``{name: [(labels, value)]}`` —
    just enough parsing for ``top`` (scalar samples; histogram series
    appear under their ``_bucket``/``_sum``/``_count`` names)."""
    import re as _re

    label_re = _re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, sval = line.rpartition(" ")
        if not head:
            continue
        try:
            value = float(sval)
        except ValueError:
            continue
        name, _, rest = head.partition("{")
        labels = dict(label_re.findall(rest)) if rest else {}
        out.setdefault(name, []).append((labels, value))
    return out


def _prom_value(fams: dict, name: str, default=None):
    """Sum of a family's samples (scalar for unlabeled metrics)."""
    samples = fams.get(name)
    if not samples:
        return default
    return sum(v for _labels, v in samples)


def _human_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _fleet_frame_lines(fleet: dict, events, args, url: str, tick: int) -> list:
    """One ``top --fleet`` frame: fleet summary, per-target matrix,
    fleet SLO table and merged recent events (rows carry their origin
    target)."""
    import time as _time

    lines = []
    stamp = _time.strftime("%H:%M:%S")
    lines.append(f"devspace-tpu top — fleet @ {url}   {stamp}   frame {tick}")
    lines.append("")
    f = fleet.get("fleet") or {}

    def num(v, fmt="{:.0f}"):
        return fmt.format(v) if isinstance(v, (int, float)) else "-"

    lines.append(
        f"  FLEET  {f.get('up', 0)}/{f.get('targets', 0)} up"
        f"  ({f.get('quarantined', 0)} quarantined)"
        f"    tok/s {num(f.get('tok_s'), '{:.1f}')}"
        f"   slots {num(f.get('active_slots'))}/{num(f.get('max_slots'))}"
        f"   queued {num(f.get('queued'))}"
    )
    lines.append("")
    rows = [["TARGET", "UP", "STALE", "TOK/S", "SLOTS", "QUEUED", "OCC",
             "SLO"]]
    for t in fleet.get("targets") or []:
        slots = (
            f"{num(t.get('active_slots'))}/{num(t.get('max_slots'))}"
            if t.get("max_slots") is not None else "-"
        )
        stale = t.get("staleness_s")
        rows.append([
            str(t.get("target", "?")),
            ("QUAR" if t.get("quarantined")
             else "up" if t.get("up") else "DOWN"),
            f"{stale:.1f}s" if isinstance(stale, (int, float)) else "-",
            num(t.get("tok_s"), "{:.1f}"),
            slots,
            num(t.get("queued")),
            num(t.get("occupancy"), "{:.2f}"),
            str(t.get("slo") or "-"),
        ])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        lines.append(
            "  " + "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
        )
    lines.append("")

    slo = fleet.get("slo") or {}
    if slo.get("slos"):
        lines.append("  FLEET SLO         STATUS  BURN(S)  BURN(L)")
        for s in slo["slos"]:
            lines.append(
                f"  {s.get('name', '?'):<17} "
                f"{s.get('status', '?'):<7} "
                f"{s.get('burn_short', 0):>7.2f} "
                f"{s.get('burn_long', 0):>8.2f}"
            )
        if not slo.get("ready", True):
            lines.append("  !! FLEET NOT READY")
        lines.append("")
    for note in fleet.get("notes") or []:
        lines.append(f"  note: {note}")

    if events is not None and events.get("events"):
        lines.append("  RECENT EVENTS")
        for e in events["events"][-args.events:]:
            ts = _time.strftime(
                "%H:%M:%S", _time.localtime(e.get("time", 0))
            )
            attrs = " ".join(
                f"{k}={v2}"
                for k, v2 in e.items()
                if k not in (
                    "time", "seq", "level", "subsystem", "event",
                    "span_id", "target",
                )
            )
            lines.append(
                f"  {ts}  [{e.get('target', '?')}] "
                f"{e.get('level', '?'):<5} "
                f"{e.get('subsystem', '?')}.{e.get('event', '?')}  {attrs}"
            )
    return lines


def cmd_top(args) -> int:
    """``top``: live serving dashboard. Polls ``/metrics``
    (windowed tok/s, dispatch occupancy, KV-tier bytes, queue depth, SLO
    gauges) and ``/debug/events`` (recent structured events) from a
    running inference server, redrawing every ``--interval`` seconds.
    With ``--fleet`` the URL names a ``collector serve`` endpoint and
    each frame renders the per-target health/occupancy matrix, the
    fleet SLO table over the *merged* distribution, and merged events.
    ``--iterations N`` renders N frames and exits
    (scripting/tests); the default 0 runs until Ctrl-C."""
    import json as _json
    import time as _time
    import urllib.error
    import urllib.request

    log = logutil.get_logger()
    url = args.url.rstrip("/")

    def fetch(path, parse_json):
        with urllib.request.urlopen(url + path, timeout=5) as resp:
            body = resp.read()
        return _json.loads(body) if parse_json else body.decode()

    tick = 0
    try:
        while True:
            tick += 1
            if getattr(args, "fleet", False):
                try:
                    fleet = fetch("/debug/fleet", True)
                except (urllib.error.URLError, OSError, ValueError) as e:
                    log.error("no collector endpoint at %s: %s", url, e)
                    return 1
                try:
                    events = fetch(
                        f"/debug/events?limit={args.events}", True
                    )
                except (urllib.error.URLError, OSError, ValueError):
                    events = None
                lines = _fleet_frame_lines(fleet, events, args, url, tick)
                import sys as _sys

                if _sys.stdout.isatty() and args.iterations != 1:
                    _sys.stdout.write("\x1b[2J\x1b[H")
                print("\n".join(lines))
                if args.iterations and tick >= args.iterations:
                    return 0
                _time.sleep(args.interval)
                continue
            try:
                fams = _parse_prom_text(fetch("/metrics", False))
                health = fetch("/healthz", True)
            except (urllib.error.URLError, OSError, ValueError) as e:
                log.error("no serving endpoint at %s: %s", url, e)
                return 1
            try:
                events = fetch(
                    f"/debug/events?limit={args.events}", True
                )
            except (urllib.error.URLError, OSError, ValueError):
                events = None  # older server: dashboard still useful

            lines = []
            stamp = _time.strftime("%H:%M:%S")
            lines.append(
                f"devspace-tpu top — {url}   {stamp}   frame {tick}"
            )
            lines.append("")

            def v(name, fmt="{:.0f}", default="-"):
                val = _prom_value(fams, name)
                return fmt.format(val) if val is not None else default

            slots = (
                f"{v('engine_active_slots')}"
                f"/{v('engine_max_slots')}"
            )
            blocks = (
                f"{v('engine_free_kv_blocks')}"
                f"/{v('engine_kv_blocks')}"
            )
            rows = [
                ["tok/s (10s)", v("engine_tokens_per_sec_10s", "{:.1f}"),
                 "active slots", slots],
                ["dispatch occupancy",
                 v("engine_dispatch_depth_occupancy", "{:.2f}"),
                 "prefilling", v("engine_prefilling_slots")],
                ["queue depth", v("engine_queued_requests"),
                 "free kv blocks", blocks],
                ["kv tier resident",
                 _human_bytes(_prom_value(fams, "engine_kv_tier_resident_bytes")),
                 "spilled blocks", v("engine_kv_spill_blocks_total")],
                ["requests completed", v("engine_requests_completed_total"),
                 "failed", v("engine_requests_failed_total")],
            ]
            w0 = max(len(r[0]) for r in rows)
            w1 = max(len(r[1]) for r in rows)
            w2 = max(len(r[2]) for r in rows)
            for r in rows:
                lines.append(
                    f"  {r[0]:<{w0}}  {r[1]:>{w1}}    {r[2]:<{w2}}  {r[3]}"
                )
            lines.append("")

            slo = (health or {}).get("slo") or {}
            if slo.get("slos"):
                lines.append("  SLO               STATUS  BURN(S)  BURN(L)")
                for s in slo["slos"]:
                    lines.append(
                        f"  {s.get('name', '?'):<17} "
                        f"{s.get('status', '?'):<7} "
                        f"{s.get('burn_short', 0):>7.2f} "
                        f"{s.get('burn_long', 0):>8.2f}"
                    )
                if not slo.get("ready", True):
                    lines.append("  !! NOT READY (/readyz -> 503)")
                lines.append("")

            if events is not None and events.get("events"):
                lines.append("  RECENT EVENTS")
                for e in events["events"][-args.events:]:
                    ts = _time.strftime(
                        "%H:%M:%S", _time.localtime(e.get("time", 0))
                    )
                    attrs = " ".join(
                        f"{k}={v2}"
                        for k, v2 in e.items()
                        if k not in (
                            "time", "seq", "level", "subsystem", "event",
                            "span_id",
                        )
                    )
                    lines.append(
                        f"  {ts}  {e.get('level', '?'):<5} "
                        f"{e.get('subsystem', '?')}.{e.get('event', '?')}"
                        f"  {attrs}"
                    )
            elif events is not None:
                lines.append("  RECENT EVENTS: none recorded yet")

            import sys as _sys

            if _sys.stdout.isatty() and args.iterations != 1:
                _sys.stdout.write("\x1b[2J\x1b[H")
            print("\n".join(lines))
            if args.iterations and tick >= args.iterations:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_debug(args) -> int:
    """``debug bundle``: one incident-triage artifact: a
    .tar.gz of everything a running server can tell us: metrics
    snapshot, health+SLO state, effective config, recent request traces,
    flight-recorder events and (unless ``--seconds 0``) a Chrome
    timeline capture. Endpoints that fail are recorded in the manifest
    instead of aborting — partial evidence beats none mid-incident."""
    import io as _io
    import json as _json
    import tarfile
    import time as _time
    import urllib.error
    import urllib.request

    log = logutil.get_logger()
    url = args.url.rstrip("/")
    if not 0 <= args.seconds <= 60:
        log.error("--seconds must be in [0, 60], got %s", args.seconds)
        return 1
    if getattr(args, "fleet", False) or getattr(args, "target", None):
        return _debug_bundle_fleet(args, log)

    def fetch(path, timeout):
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            return resp.read()

    plan = [
        ("metrics.txt", "/metrics", 10),
        ("healthz.json", "/healthz", 10),
        ("config.json", "/debug/config", 10),
        ("requests.json", "/debug/requests?limit=500", 10),
        ("events.json", "/debug/events?limit=2000", 10),
    ]
    if args.seconds > 0:
        # the server blocks for the capture window before replying
        plan.append(
            ("timeline.json", f"/debug/trace?seconds={args.seconds}",
             args.seconds + 30)
        )
    members: dict = {}
    errors: dict = {}
    for name, path, timeout in plan:
        log.info("fetching %s ...", path)
        try:
            members[name] = fetch(path, timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            errors[name] = str(e)
    if not members:
        log.error(
            "no serving endpoint at %s: %s", url,
            "; ".join(sorted(errors.values())) or "all fetches failed",
        )
        return 1
    manifest = {
        "url": url,
        "created": _time.time(),
        "members": sorted(members),
        "errors": errors,
    }
    with tarfile.open(args.out, "w:gz") as tar:
        def add(name, data):
            info = tarfile.TarInfo("bundle/" + name)
            info.size = len(data)
            info.mtime = int(_time.time())
            tar.addfile(info, _io.BytesIO(data))

        add("manifest.json", _json.dumps(manifest, indent=2).encode())
        for name in sorted(members):
            add(name, members[name])
    log.done(
        "wrote %s (%d member(s)%s)", args.out, len(members) + 1,
        f", {len(errors)} failed" if errors else "",
    )
    for name, err in sorted(errors.items()):
        log.warn("  missing %s: %s", name, err)
    return 0


def _debug_bundle_fleet(args, log) -> int:
    """``debug bundle --fleet``: one tar over every target.

    Targets come from repeatable ``--target URL`` flags, or — with bare
    ``--fleet`` — from the collector at ``--url`` (its ``/debug/fleet``
    matrix names every replica). Each target's evidence lands under
    ``bundle/<target>/``; per-target fetch failures are recorded in the
    manifest exactly like the single-server bundle's per-member errors —
    partial evidence beats none mid-incident."""
    import io as _io
    import json as _json
    import re as _re
    import tarfile
    import time as _time
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/")

    def fetch(base, path, timeout=10):
        with urllib.request.urlopen(base + path, timeout=timeout) as resp:
            return resp.read()

    fleet_doc = None
    targets: list[tuple[str, str]] = []
    if getattr(args, "target", None):
        targets = [(t.rstrip("/"), t.rstrip("/")) for t in args.target]
    else:
        try:
            fleet_doc = _json.loads(fetch(url, "/debug/fleet"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.error("no collector endpoint at %s: %s", url, e)
            return 1
        for row in fleet_doc.get("targets") or []:
            if row.get("url"):
                targets.append((row.get("target") or row["url"], row["url"]))
    if not targets:
        log.error("no fleet targets (pass --target URL or point --url at "
                  "a collector)")
        return 1

    plan = [
        ("metrics.txt", "/metrics"),
        ("healthz.json", "/healthz"),
        ("config.json", "/debug/config"),
        ("requests.json", "/debug/requests?limit=500"),
        ("events.json", "/debug/events?limit=2000"),
        ("spans.json", "/debug/spans?limit=1024"),
    ]
    manifest_targets: dict = {}
    members: dict = {}  # tar path -> bytes
    if fleet_doc is not None:
        members["fleet.json"] = _json.dumps(fleet_doc, indent=2).encode()
        try:
            members["fleet_metrics.txt"] = fetch(url, "/metrics")
            members["fleet_trace.json"] = fetch(url, "/debug/trace")
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.warn("collector evidence incomplete: %s", e)
    fetched_any = bool(members)
    for name, base in targets:
        safe = _re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_") or "target"
        entry: dict = {"url": base, "members": [], "errors": {}}
        for member, path in plan:
            log.info("fetching %s%s ...", base, path)
            try:
                members[f"{safe}/{member}"] = fetch(base, path)
                entry["members"].append(member)
                fetched_any = True
            except (urllib.error.URLError, OSError, ValueError) as e:
                entry["errors"][member] = str(e)
        manifest_targets[safe] = entry
    if not fetched_any:
        log.error("no target answered; nothing to bundle")
        return 1
    manifest = {
        "fleet": True,
        "url": url,
        "created": _time.time(),
        "targets": manifest_targets,
        "members": sorted(members),
    }
    with tarfile.open(args.out, "w:gz") as tar:
        def add(name, data):
            info = tarfile.TarInfo("bundle/" + name)
            info.size = len(data)
            info.mtime = int(_time.time())
            tar.addfile(info, _io.BytesIO(data))

        add("manifest.json", _json.dumps(manifest, indent=2).encode())
        for name in sorted(members):
            add(name, members[name])
    failed = sum(len(t["errors"]) for t in manifest_targets.values())
    log.done(
        "wrote %s (%d member(s) from %d target(s)%s)", args.out,
        len(members) + 1, len(targets),
        f", {failed} fetch(es) failed" if failed else "",
    )
    for safe, entry in sorted(manifest_targets.items()):
        for member, err in sorted(entry["errors"].items()):
            log.warn("  missing %s/%s: %s", safe, member, err)
    return 0


def cmd_collector(args) -> int:
    """``collector serve``: run the fleet telemetry collector:
    scrape every target's ``/metrics``/``/healthz``/``/debug/*``
    on an interval, federate them (counters summed, gauges per their
    aggregation hints, latency histograms merged bucket-exactly) and
    serve the fleet view: ``/metrics``, ``/debug/fleet``,
    ``/debug/events`` (merged), ``/debug/trace`` (stitched). Targets
    are repeatable ``--target URL`` flags or ``--workers`` (resolve the
    job's worker pods through the selector layer)."""
    from ..obs.collector import TelemetryCollector, make_http_server
    log = logutil.get_logger()
    if args.target:
        collector = TelemetryCollector.from_replicas(
            args.target, interval_s=args.interval,
        )
    elif args.workers:
        ctx = Context(args)
        collector = TelemetryCollector.from_workers(
            ctx.backend, ctx.config, port=args.scrape_port,
            selector_name=getattr(args, "selector", None),
            interval_s=args.interval,
        )
    else:
        log.error("no targets: pass --target URL (repeatable) or --workers")
        return 1
    collector.scrape_once()  # first federated view before we listen
    httpd = make_http_server(collector, args.host, args.port)
    collector.start()
    up = sum(1 for t in collector.targets if t.up)
    log.done(
        "collector serving on http://%s:%d (%d target(s), %d up; "
        "scrape interval %.1fs)",
        args.host, httpd.server_address[1], len(collector.targets), up,
        args.interval,
    )
    try:
        if getattr(args, "iterations", 0):
            # test/scripting mode: handle N requests then exit
            for _ in range(args.iterations):
                httpd.handle_request()
            return 0
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        collector.stop()
        httpd.server_close()
    return 0


def cmd_fleet(args) -> int:
    """``fleet serve``: run a local replica fleet: N serving
    subprocesses under the session supervisor (health-probed, restarted
    under the retry ladder, drained before any scale-down kill), an
    embedded telemetry collector federating them on ``--port``, and —
    with ``--autoscale`` — the closed autoscale loop driving replica
    count from the collector's HPA signals. ``fleet status`` renders a
    running fleet's collector view (``/debug/fleet``) as a table."""
    import json as _json
    import time as _time
    import urllib.request

    log = logutil.get_logger()
    if args.what == "status":
        url = args.url.rstrip("/") + "/debug/fleet"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                doc = _json.loads(resp.read())
        except (OSError, ValueError) as e:
            log.error("no fleet collector endpoint at %s: %s", args.url, e)
            return 1
        rows = doc.get("targets", [])
        up = sum(1 for r in rows if r.get("up"))
        print(f"fleet: {up}/{len(rows)} replica(s) up")
        fmt = "%-14s %-4s %-11s %9s %9s %7s"
        print(fmt % ("REPLICA", "UP", "QUARANTINED", "TOK/S", "OCCUP", "QUEUED"))
        for r in rows:
            def num(v, spec="%.2f"):
                return spec % v if isinstance(v, (int, float)) else "-"

            print(fmt % (
                r.get("target"), "yes" if r.get("up") else "NO",
                "yes" if r.get("quarantined") else "no",
                num(r.get("tok_s"), "%.1f"), num(r.get("occupancy")),
                num(r.get("queued"), "%.0f"),
            ))
        for sig in (doc.get("hpa") or {}).get("metrics", []):
            pods = sig.get("pods") or {}
            print("hpa signal: %s averageValue=%s" % (
                (pods.get("metric") or {}).get("name"),
                (pods.get("target") or {}).get("averageValue"),
            ))
        return 0

    from ..obs.collector import TelemetryCollector, make_http_server
    from ..serving import ReplicaFleet, ReplicaSpec
    from ..serving.autoscale import AutoscaleLoop, AutoscalerConfig

    env = {}
    for kv in args.env or []:
        if "=" not in kv:
            log.error("--env wants KEY=VALUE, got %r", kv)
            return 1
        k, _, v = kv.partition("=")
        env[k] = v
    spec = ReplicaSpec(
        module=args.module, env=env, ready_timeout_s=args.ready_timeout
    )
    fleet = ReplicaFleet(
        spec=spec, replicas=args.replicas,
        restart_budget=args.restart_budget,
        healthy_window_s=args.healthy_window,
    )
    fleet.start()
    collector = TelemetryCollector.from_replicas([], interval_s=args.interval)
    collector.refresh(sorted(fleet.targets().items()))
    collector.scrape_once()
    httpd = make_http_server(collector, args.host, args.port)
    loop = None
    if args.autoscale:
        loop = AutoscaleLoop(
            fleet, collector,
            AutoscalerConfig(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                targets={args.metric: args.target_value},
                scale_down_stabilization_s=args.scale_down_window,
            ),
            interval_s=args.interval,
            on_decision=lambda d: (
                log.info(
                    "[autoscale] %d -> %d (%s)", d.current, d.desired, d.reason
                ) if d.desired != d.current else None
            ),
        )
    gateway = None
    if getattr(args, "route", None):
        from ..serving.gateway import RoutingGateway
        from ..serving.router import (
            PrefixRouter,
            RouterConfig,
            loads_from_collector,
        )

        raw_pool = (getattr(args, "prefill_pool", "") or "").strip()
        if raw_pool.isdigit():
            pool = tuple(sorted(fleet.targets())[: int(raw_pool)])
        else:
            pool = tuple(
                p.strip() for p in raw_pool.split(",") if p.strip())
        router = PrefixRouter(
            replicas_fn=fleet.targets,
            loads_fn=lambda: loads_from_collector(collector),
            config=RouterConfig(
                policy=args.route,
                prefill_pool=pool,
                disagg_threshold_tokens=getattr(
                    args, "disagg_threshold", 0),
                disagg_occupancy_band=getattr(
                    args, "disagg_occupancy_band", 0.85),
            ),
        )
        gateway = RoutingGateway(
            router, host=args.host, port=args.gateway_port)
        gateway.start()
    collector.start()
    if loop is not None:
        loop.start()
    log.done(
        "fleet of %d replica(s) up (module %s); collector on "
        "http://%s:%d%s%s",
        args.replicas, args.module, args.host, httpd.server_address[1],
        f"; autoscaling {args.min_replicas}-{args.max_replicas} on "
        f"{args.metric}<={args.target_value:g}" if args.autoscale else "",
        f"; {args.route} gateway on {gateway.base_url}" if gateway else "",
    )
    import threading

    server_thread = threading.Thread(
        target=httpd.serve_forever, daemon=True)
    server_thread.start()
    try:
        if args.duration:
            _time.sleep(args.duration)
        else:
            while True:
                _time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if loop is not None:
            loop.stop()
        if gateway is not None:
            gateway.stop()
        collector.stop()
        httpd.shutdown()
        httpd.server_close()
        fleet.stop()
        log.done("fleet stopped (%s)", fleet.supervisor.status_line())
    return 0


# -- config mutation (add/remove) ------------------------------------------
def _load_for_edit(args) -> tuple[Context, latest.Config]:
    ctx = Context(args)
    return ctx, ctx.config


def cmd_add(args) -> int:
    """Reference: cmd/add/*.go -> pkg/devspace/configure."""
    ctx, cfg = _load_for_edit(args)
    if cfg.dev is None:
        cfg.dev = latest.DevConfig()
    if args.kind == "sync":
        cfg.dev.sync = (cfg.dev.sync or []) + [
            latest.SyncConfig(
                selector=args.selector,
                local_sub_path=args.local,
                container_path=args.container,
                exclude_paths=args.exclude.split(",") if args.exclude else None,
            )
        ]
    elif args.kind == "port":
        cfg.dev.ports = (cfg.dev.ports or []) + [
            latest.PortForwardingConfig(
                selector=args.selector,
                port_mappings=[
                    latest.PortMapping(
                        local_port=args.local_port,
                        remote_port=args.remote_port or args.local_port,
                    )
                ],
            )
        ]
    elif args.kind == "selector":
        labels = dict(kv.split("=", 1) for kv in args.label_selector.split(","))
        cfg.dev.selectors = (cfg.dev.selectors or []) + [
            latest.SelectorConfig(name=args.name, label_selector=labels)
        ]
    elif args.kind == "deployment":
        if args.manifests:
            dep = latest.DeploymentConfig(
                name=args.name,
                manifests=latest.ManifestsConfig(paths=args.manifests.split(",")),
            )
        else:
            dep = latest.DeploymentConfig(
                name=args.name, chart=latest.ChartConfig(path=args.chart or "./chart")
            )
        cfg.deployments = (cfg.deployments or []) + [dep]
    elif args.kind == "image":
        cfg.images = cfg.images or {}
        cfg.images[args.name] = latest.ImageConfig(
            image=args.image, dockerfile=args.dockerfile, context=args.context
        )
    ctx.loader.validate(cfg)
    ctx.loader.save(cfg)
    ctx.log.done("[add] %s added", args.kind)
    return 0


def cmd_remove(args) -> int:
    """Reference: cmd/remove/*.go."""
    ctx, cfg = _load_for_edit(args)
    removed = False
    if args.kind == "sync" and cfg.dev and cfg.dev.sync:
        before = len(cfg.dev.sync)
        cfg.dev.sync = [
            s
            for s in cfg.dev.sync
            if not (args.all or s.container_path == args.container)
        ] or None
        removed = before != len(cfg.dev.sync or [])
    elif args.kind == "port" and cfg.dev and cfg.dev.ports:
        before = len(cfg.dev.ports)
        cfg.dev.ports = [
            p
            for p in cfg.dev.ports
            if not (
                args.all
                or any(
                    pm.local_port == args.local_port for pm in p.port_mappings or []
                )
            )
        ] or None
        removed = before != len(cfg.dev.ports or [])
    elif args.kind == "selector" and cfg.dev and cfg.dev.selectors:
        before = len(cfg.dev.selectors)
        cfg.dev.selectors = [
            s for s in cfg.dev.selectors if not (args.all or s.name == args.name)
        ] or None
        removed = before != len(cfg.dev.selectors or [])
    elif args.kind == "deployment" and cfg.deployments:
        before = len(cfg.deployments)
        cfg.deployments = [
            d for d in cfg.deployments if not (args.all or d.name == args.name)
        ] or None
        removed = before != len(cfg.deployments or [])
    elif args.kind == "image" and cfg.images:
        removed = cfg.images.pop(args.name, None) is not None
        cfg.images = cfg.images or None
    ctx.loader.save(cfg)
    ctx.log.done("[remove] %s %s", args.kind, "removed" if removed else "not found")
    return 0 if removed else 1


# -- list -------------------------------------------------------------------
def cmd_list(args) -> int:
    """Reference: cmd/list/*.go."""
    if args.what == "spaces":
        return cmd_list_spaces(args)
    if args.what == "providers":
        return cmd_list_providers(args)
    if args.what == "packages":
        return cmd_list_packages(args)
    ctx = Context(args)
    cfg = ctx.config
    log = ctx.log
    what = args.what
    if what == "deployments":
        log.print_table(
            ["NAME", "TYPE", "NAMESPACE"],
            [
                [
                    d.name,
                    "chart" if d.chart else "manifests",
                    d.namespace or ctx.namespace,
                ]
                for d in cfg.deployments or []
            ],
        )
    elif what == "images":
        log.print_table(
            ["NAME", "IMAGE", "DOCKERFILE"],
            [
                [name, i.image, i.dockerfile or "Dockerfile"]
                for name, i in (cfg.images or {}).items()
            ],
        )
    elif what == "ports":
        rows = []
        for p in (cfg.dev.ports if cfg.dev else None) or []:
            for pm in p.port_mappings or []:
                rows.append(
                    [p.selector or "-", str(pm.local_port), str(pm.remote_port), p.workers or "worker0"]
                )
        log.print_table(["SELECTOR", "LOCAL", "REMOTE", "WORKERS"], rows)
    elif what == "sync":
        log.print_table(
            ["SELECTOR", "LOCAL", "CONTAINER", "FAN-OUT"],
            [
                [s.selector or "-", s.local_sub_path or ".", s.container_path, s.fan_out or "all"]
                for s in (cfg.dev.sync if cfg.dev else None) or []
            ],
        )
    elif what == "selectors":
        log.print_table(
            ["NAME", "NAMESPACE", "LABELS"],
            [
                [
                    s.name,
                    s.namespace or ctx.namespace,
                    ",".join(f"{k}={v}" for k, v in (s.label_selector or {}).items()),
                ]
                for s in (cfg.dev.selectors if cfg.dev else None) or []
            ],
        )
    elif what == "vars":
        cache = ctx.loader.generated.get_active()
        log.print_table(
            ["NAME", "VALUE"], [[k, v] for k, v in cache.vars.items()]
        )
    elif what == "configs":
        configs_path = os.path.join(ctx.root, ".devspace", "configs.yaml")
        if os.path.isfile(configs_path):
            with open(configs_path, "r", encoding="utf-8") as fh:
                names = list((yaml.safe_load(fh) or {}).keys())
        else:
            names = ["default"]
        active = ctx.loader.generated.active_config
        log.print_table(
            ["NAME", "ACTIVE"], [[n, "*" if n == active else ""] for n in names]
        )
    return 0


# -- use --------------------------------------------------------------------
def cmd_use(args) -> int:
    """Reference: cmd/use/*.go."""
    log = logutil.get_logger()
    if args.kind == "config":
        ctx = Context(args, require_config=False)
        ctx.loader.generated.active_config = args.name
        ctx.loader.generated.save()
        log.done("[use] active config: %s", args.name)
    elif args.kind == "context":
        from ..kube.kubeconfig import KubeConfig

        kc = KubeConfig.load()
        if args.name not in kc.contexts:
            log.error("unknown kube context '%s'", args.name)
            return 1
        kc.current_context = args.name
        kc.save()
        log.done("[use] kube context: %s", args.name)
    elif args.kind == "namespace":
        ctx = Context(args)
        cfg = ctx.config
        if cfg.cluster is None:
            cfg.cluster = latest.Cluster()
        cfg.cluster.namespace = args.name
        ctx.loader.save(cfg)
        log.done("[use] namespace: %s", args.name)
    return 0


# -- packages ---------------------------------------------------------------
def _chart_dir(ctx: Context) -> str:
    """The first chart deployment's chart dir (default ./chart)."""
    for d in ctx.config.deployments or []:
        if d.chart and d.chart.path:
            return os.path.join(ctx.root, d.chart.path)
    return os.path.join(ctx.root, "chart")


def _package_repo(args) -> str:
    repo = getattr(args, "repo", None) or os.environ.get("DEVSPACE_CHART_REPO")
    if not repo:
        raise CLIError(
            "no chart repo — pass --repo or set DEVSPACE_CHART_REPO"
        )
    return repo


def cmd_add_package(args) -> int:
    """Reference: cmd/add/package.go -> configure/package.go."""
    from ..deploy.packages import PackageError, add_package, search_charts

    ctx = Context(args)
    try:
        add_package(
            _chart_dir(ctx), _package_repo(args), args.name, args.version, ctx.log
        )
    except PackageError as e:
        ctx.log.error(str(e))
        try:
            hits = search_charts(_package_repo(args), args.name)
            if hits:
                ctx.log.info(
                    "did you mean: %s", ", ".join(h.name for h in hits[:5])
                )
        except (PackageError, CLIError):
            pass
        return 1
    return 0


def cmd_remove_package(args) -> int:
    from ..deploy.packages import remove_package

    ctx = Context(args)
    return 0 if remove_package(_chart_dir(ctx), args.name, ctx.log) else 1


def cmd_list_packages(args) -> int:
    from ..deploy.packages import list_packages

    ctx = Context(args)
    ctx.log.print_table(
        ["NAME", "VERSION", "REPOSITORY", "VENDORED"],
        [
            [p["name"], p["version"], p["repository"], "yes" if p["vendored"] else "MISSING"]
            for p in list_packages(_chart_dir(ctx))
        ],
    )
    return 0


def cmd_search(args) -> int:
    """Reference: helm/search.go — chart repo search."""
    from ..deploy.packages import PackageError, search_charts

    log = logutil.get_logger()
    try:
        hits = search_charts(_package_repo(args), args.query or "")
    except PackageError as e:
        log.error(str(e))
        return 1
    log.print_table(
        ["NAME", "VERSION", "DESCRIPTION"],
        [[h.name, h.version, h.description] for h in hits],
    )
    return 0


# -- cloud ------------------------------------------------------------------
def _provider(args):
    """Build a Provider from the registry honoring --provider."""
    from ..cloud.config import ProviderRegistry
    from ..cloud.provider import Provider

    registry = ProviderRegistry.load()
    try:
        entry = registry.get(getattr(args, "provider", None))
    except KeyError as e:
        raise CLIError(str(e.args[0])) from e
    return Provider(entry, registry, logutil.get_logger()), registry


def cmd_login(args) -> int:
    """Reference: cmd/login.go — store a cloud access key."""
    from ..cloud.provider import CloudError

    provider, _ = _provider(args)
    try:
        provider.login(key=args.key, open_browser=not args.no_browser)
    except CloudError as e:
        logutil.get_logger().error(str(e))
        return 1
    return 0


def cmd_create(args) -> int:
    """Reference: cmd/create/space.go — create and bind a cloud Space."""
    from ..cloud.configure import bind_space
    from ..cloud.provider import CloudError

    log = logutil.get_logger()
    provider, _ = _provider(args)
    try:
        provider.ensure_logged_in()
        space = provider.create_space(args.name)
        log.done("[cloud] created space '%s' (id %d)", space.name, space.space_id)
        if not args.no_use:
            ctx = Context(args, require_config=False)
            context = bind_space(provider, space, ctx.loader.generated)
            log.done("[cloud] switched kube context to %s", context)
    except CloudError as e:
        log.error(str(e))
        return 1
    return 0


def cmd_use_space(args) -> int:
    """Reference: cmd/use/space.go — bind an existing Space."""
    from ..cloud.configure import bind_space
    from ..cloud.provider import CloudError

    log = logutil.get_logger()
    provider, _ = _provider(args)
    try:
        provider.ensure_logged_in()
        space = provider.get_space(args.name)
        ctx = Context(args, require_config=False)
        context = bind_space(provider, space, ctx.loader.generated)
        log.done("[cloud] using space '%s' (kube context %s)", space.name, context)
    except CloudError as e:
        log.error(str(e))
        return 1
    return 0


def cmd_remove_space(args) -> int:
    """Reference: cmd/remove/space.go — delete Space + local binding."""
    from ..cloud.configure import remove_kube_context
    from ..cloud.provider import CloudError

    log = logutil.get_logger()
    provider, _ = _provider(args)
    try:
        space = provider.get_space(args.name)
        provider.delete_space(space.space_id)
        remove_kube_context(space.name)
        ctx = Context(args, require_config=False)
        gen = ctx.loader.generated
        if gen.space and gen.space.name == space.name:
            gen.space = None
            gen.save()
        log.done("[cloud] removed space '%s'", space.name)
    except CloudError as e:
        log.error(str(e))
        return 1
    return 0


def cmd_remove_context(args) -> int:
    """Reference: cmd/remove/context.go — delete devspace-created kube
    contexts (one space's, or --all). Purely local: --all scans the
    kubeconfig for the devspace- prefix, so stale contexts of
    already-deleted spaces are cleaned up too and no login is needed."""
    from ..cloud.configure import kube_context_name, remove_kube_context
    from ..kube.kubeconfig import KubeConfig

    log = logutil.get_logger()
    if args.all:
        prefix = kube_context_name("")
        names = [
            c[len(prefix):]
            for c in KubeConfig.load().contexts
            if c.startswith(prefix)
        ]
        for name in names:
            remove_kube_context(name)
            log.done("[cloud] deleted kube context for space '%s'", name)
        if not names:
            log.info("no devspace kube contexts found")
        return 0
    if not args.name:
        log.error("specify a space name or --all")
        return 1
    remove_kube_context(args.name)
    log.done("[cloud] deleted kube context for space '%s'", args.name)
    return 0


def cmd_use_registry(args) -> int:
    """Reference: cmd/use/registry.go — docker login into the provider's
    registry with cloud credentials."""
    from ..builder.dockerclient import save_docker_auth
    from ..cloud.provider import CloudError

    log = logutil.get_logger()
    provider, _ = _provider(args)
    try:
        provider.ensure_logged_in()
        auth = provider.get_registry_auth()
    except CloudError as e:
        log.error(str(e))
        return 1
    if not auth:
        log.error("provider has no registry credentials")
        return 1
    registry = args.name or auth.get("registry")
    if not registry:
        log.error("provider did not name a registry; pass one explicitly")
        return 1
    save_docker_auth(registry, auth["username"], auth["password"])
    log.done("[cloud] logged into registry %s", registry)
    return 0


def cmd_add_provider(args) -> int:
    """Reference: cmd/add/provider.go."""
    from ..cloud.config import CloudProvider, ProviderRegistry

    registry = ProviderRegistry.load()
    existing = registry.providers.get(args.name)
    if existing is not None:
        # Re-adding updates the host but keeps the stored credentials.
        existing.host = args.host
    else:
        registry.providers[args.name] = CloudProvider(name=args.name, host=args.host)
    if args.use_as_default:
        registry.default = args.name
    registry.save()
    logutil.get_logger().done("[cloud] provider '%s' added", args.name)
    return 0


def cmd_remove_provider(args) -> int:
    """Reference: cmd/remove/provider.go."""
    from ..cloud.config import ProviderRegistry

    log = logutil.get_logger()
    registry = ProviderRegistry.load()
    if args.name not in registry.providers:
        log.error("unknown provider '%s'", args.name)
        return 1
    del registry.providers[args.name]
    if registry.default == args.name:
        from ..cloud.config import DEFAULT_PROVIDER_NAME

        registry.default = DEFAULT_PROVIDER_NAME
    registry.save()
    log.done("[cloud] provider '%s' removed", args.name)
    return 0


def cmd_list_spaces(args) -> int:
    """Reference: cmd/list/spaces.go."""
    from ..cloud.provider import CloudError

    log = logutil.get_logger()
    provider, _ = _provider(args)
    try:
        spaces = provider.get_spaces()
    except CloudError as e:
        log.error(str(e))
        return 1
    root = find_root(os.getcwd())
    bound = None
    if root:
        from ..config.generated import GeneratedConfig

        gen = GeneratedConfig.load(root)
        bound = gen.space.name if gen.space else None
    log.print_table(
        ["NAME", "ID", "NAMESPACE", "DOMAIN", "ACTIVE"],
        [
            [s.name, str(s.space_id), s.namespace, s.domain or "-",
             "*" if s.name == bound else ""]
            for s in spaces
        ],
    )
    return 0


def cmd_list_providers(args) -> int:
    """Reference: cmd/list/providers (v4) — provider registry table."""
    from ..cloud.config import ProviderRegistry

    registry = ProviderRegistry.load()
    logutil.get_logger().print_table(
        ["NAME", "HOST", "LOGGED IN", "DEFAULT"],
        [
            [p.name, p.host, "yes" if p.key else "no",
             "*" if p.name == registry.default else ""]
            for p in registry.providers.values()
        ],
    )
    return 0


# -- update ---------------------------------------------------------------
def cmd_update(args) -> int:
    """Reference: cmd/update/config.go — rewrite config at latest schema."""
    ctx = Context(args)
    ctx.loader.save(ctx.config)
    ctx.log.done("[update] config rewritten at schema %s", latest.VERSION)
    return 0


def _chart_deployers(ctx):
    """(deployment, ChartDeployer) for every chart deployment."""
    from ..deploy.chart import ChartDeployer
    from ..deploy.manifests import create_deployer

    out = []
    for d in ctx.config.deployments or []:
        deployer = create_deployer(ctx.backend, d, ctx.namespace, ctx.root, ctx.log)
        if isinstance(deployer, ChartDeployer):
            out.append((d, deployer))
    return out


def cmd_update_packages(args) -> int:
    """Refresh package repo indexes and report/apply newer vendored chart
    versions (reference: helm/client.go:169 UpdateRepos; vendoring makes
    the refresh an explicit command)."""
    from ..deploy.packages import PackageError, check_updates, upgrade_package

    ctx = Context(args)
    log = ctx.log
    rows = []
    rc = 0
    index_cache: dict = {}
    matched = False
    for d, deployer in _chart_deployers(ctx):
        chart_dir = deployer.chart_path
        for row in check_updates(chart_dir, index_cache=index_cache):
            if args.name and row["name"] != args.name:
                continue
            matched = True
            state = (
                row["error"]
                or ("update available" if row["update"] else "up to date")
            )
            current = row["current"]
            if row["error"]:
                rc = 1
            elif row["update"] and getattr(args, "apply", False):
                try:
                    upgrade_package(
                        chart_dir, row["name"], logger=log,
                        index_cache=index_cache,
                    )
                    current = row["latest"]
                    state = f"upgraded from {row['current']}"
                except PackageError as e:
                    log.error("[update] %s: %s", row["name"], e)
                    state = f"upgrade failed: {e}"
                    rc = 1
            rows.append(
                [d.name, row["name"], current, row["latest"], state]
            )
    if args.name and not matched:
        log.error("[update] package '%s' is not vendored here", args.name)
        return 1
    if not rows:
        log.info("[update] no vendored packages found")
        return 0
    logutil.get_logger().print_table(
        ["DEPLOYMENT", "PACKAGE", "CURRENT", "LATEST", "STATE"], rows
    )
    return rc


# -- lint -----------------------------------------------------------------
def _lint_exit_code(findings, strict: bool) -> int:
    """Pinned semantics: 0 clean, 1 on errors; warnings exit 0 unless
    --strict promotes them."""
    from ..lint import ERROR, WARNING

    if any(f.severity == ERROR for f in findings):
        return 1
    if strict and any(f.severity == WARNING for f in findings):
        return 1
    return 0


def _emit_lint_report(log, findings, fmt: str, n_objects: int) -> None:
    from ..lint import ERROR, count_by_severity, reporters

    if fmt != "text":
        # machine formats go to stdout verbatim — logger decoration would
        # corrupt the JSON/SARIF document
        print(reporters.render(findings, fmt))
        return
    for f in sorted(findings, key=lambda f: f.sort_key()):
        where = " ".join(p for p in (f.artifact, f.location) if p)
        line = f"{f.rule_id} {where + ': ' if where else ''}{f.message}"
        (log.warn if f.severity != ERROR else log.error)("[lint] %s", line)
    counts = count_by_severity(findings)
    if counts[ERROR]:
        log.error(
            "[lint] %d error(s), %d warning(s) across %d object(s)",
            counts[ERROR],
            counts["warning"],
            n_objects,
        )
    elif findings:
        log.warn(
            "[lint] %d warning(s) across %d object(s)",
            len(findings),
            n_objects,
        )
    else:
        log.done("[lint] %d object(s), no issues", n_objects)


def cmd_lint(args) -> int:
    """Validate charts/manifests without applying: render every deployment
    with its configured values (the exact deploy render path), run the
    rule engine over the rendered objects (structure, GPU job
    invariants, image hygiene), and report as text, JSON, or SARIF."""
    from ..lint import (
        filter_findings,
        lint_chart_findings,
        parse_rule_filter,
    )
    from ..lint.project import collect_project_findings

    fmt = getattr(args, "format", None) or "text"
    strict = bool(getattr(args, "strict", False))
    select = parse_rule_filter(getattr(args, "select", None))
    ignore = parse_rule_filter(getattr(args, "ignore", None))
    if fmt != "text":
        # machine formats own stdout: push incidental log lines (backend
        # banner, render warnings) to stderr so the document stays valid
        logutil.set_logger(logutil.StdoutLogger(stream=sys.stderr))
    log = logutil.get_logger()
    if getattr(args, "chart", None):
        # standalone chart dir (no project config needed)
        findings = filter_findings(
            lint_chart_findings(args.chart), select, ignore
        )
        for f in findings:
            if not f.artifact:
                f.artifact = args.chart
        if findings or fmt != "text":
            _emit_lint_report(log, findings, fmt, 0)
        else:
            log.done("[lint] %s clean", args.chart)
        return _lint_exit_code(findings, strict)

    ctx = Context(args)
    findings, n_objects = collect_project_findings(ctx)
    findings = filter_findings(findings, select, ignore)
    _emit_lint_report(log, findings, fmt, n_objects)
    return _lint_exit_code(findings, strict)


def _checkout_root() -> str:
    """Checkout containing the devspace_tpu_torch package (cli/ ->
    package -> checkout)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


_VERSION_RE = r"__version__\s*=\s*[\"']([^\"']+)[\"']"


def _archive_version(tf) -> tuple[Optional[str], Optional[str]]:
    """(version, package_root) read from devspace_tpu_torch/__init__.py
    inside a release tarball. The SHALLOWEST match wins — a
    vendored/fixture copy deeper in the tree
    (tests/fixtures/devspace_tpu_torch/...) must never be mistaken for
    the real package. A reference archive, which holds no
    devspace_tpu_torch/, gives (None, None)."""
    import re as _re

    best: tuple[int, str, str] = None
    for m in tf.getmembers():
        parts = m.name.split("/")
        if parts[-2:] == ["devspace_tpu_torch", "__init__.py"]:
            text = tf.extractfile(m).read().decode("utf-8", "replace")
            found = _re.search(_VERSION_RE, text)
            if found and (best is None or len(parts) < best[0]):
                best = (len(parts), found.group(1), "/".join(parts[:-1]))
    if best is None:
        return None, None
    return best[1], best[2]


def _installed_version(checkout: str) -> Optional[str]:
    """Version of the package INSTALLED at the target checkout (which is
    not necessarily the running module's __version__)."""
    import re as _re

    try:
        with open(
            os.path.join(checkout, "devspace_tpu_torch", "__init__.py"),
            encoding="utf-8",
        ) as fh:
            found = _re.search(_VERSION_RE, fh.read())
            return found.group(1) if found else None
    except OSError:
        return None


def cmd_upgrade(args) -> int:
    """Reference: cmd/upgrade.go — self-update via a release artifact
    (upstream downloads a GitHub release binary and swaps it in). This
    build's artifact is a source tarball: ``upgrade --archive PATH``
    validates it, compares versions, and atomically replaces the
    ``devspace_tpu_torch`` package (backup + rollback on failure) — the
    egress-free equivalent of the release flow. Only that directory is
    read from the archive and swapped; the checkout's ``devspace_tpu/``
    is never touched. ``--apply`` keeps the git-checkout pull for
    development installs. Git checkouts REFUSE --archive without
    --force: swapping the package inside a working repo destroys
    uncommitted work (development installs upgrade via git; release
    installs have no .git)."""
    import tarfile as _tarfile

    log = logutil.get_logger()
    checkout = _checkout_root()
    archive = getattr(args, "archive", None)
    if archive:
        if os.path.exists(os.path.join(checkout, ".git")) and not getattr(
            args, "force", False
        ):
            log.error(
                "[upgrade] %s is a git checkout — use 'upgrade --apply' "
                "(git pull) for development installs, or --force to "
                "overwrite the package anyway (uncommitted changes in "
                "devspace_tpu_torch/ WILL be lost)",
                checkout,
            )
            return 1
        pkg_dir = os.path.join(checkout, "devspace_tpu_torch")
        import shutil as _shutil
        import tempfile as _tempfile

        current = _installed_version(checkout) or __version__
        force = getattr(args, "force", False)
        try:
            with _tarfile.open(archive, "r:*") as tf:
                new_version, pkg_root = _archive_version(tf)
                if new_version is None:
                    log.error(
                        "[upgrade] %s contains no devspace_tpu_torch/__init__.py "
                        "with a __version__", archive,
                    )
                    return 1
                if new_version == current and not force:
                    log.info(
                        "[upgrade] already at %s (use --force to reinstall)",
                        current,
                    )
                    return 0
                from ..deploy.packages import _version_key

                if _version_key(new_version) < _version_key(current) and not force:
                    log.error(
                        "[upgrade] %s is OLDER than the installed %s — "
                        "refusing to downgrade (use --force to override)",
                        new_version, current,
                    )
                    return 1
                # stage INSIDE the checkout: same filesystem, so both
                # swaps below are atomic os.rename (a cross-device move
                # could fail half-copied)
                staging = _tempfile.mkdtemp(
                    prefix=".devspace-upgrade-", dir=checkout
                )
                try:
                    members = [
                        m
                        for m in tf.getmembers()
                        if m.name == pkg_root
                        or m.name.startswith(pkg_root + "/")
                    ]
                    for m in members:  # refuse path escapes
                        target = os.path.normpath(os.path.join(staging, m.name))
                        if not target.startswith(os.path.abspath(staging)):
                            log.error(
                                "[upgrade] archive member escapes: %s", m.name
                            )
                            return 1
                    tf.extractall(staging, members=members, filter="data")
                    new_pkg = os.path.join(staging, pkg_root)
                    backup = pkg_dir + ".bak"
                    if os.path.isdir(backup):
                        _shutil.rmtree(backup)
                    os.rename(pkg_dir, backup)
                    try:
                        os.rename(new_pkg, pkg_dir)
                    except BaseException:
                        # clear any partial state, then restore
                        if os.path.isdir(pkg_dir):
                            _shutil.rmtree(pkg_dir, ignore_errors=True)
                        os.rename(backup, pkg_dir)
                        raise
                    _shutil.rmtree(backup)
                finally:
                    _shutil.rmtree(staging, ignore_errors=True)
        except (OSError, _tarfile.TarError, EOFError) as e:
            # tarfile.open only reads the header: a truncated body fails
            # later in getmembers/extractall — catch the whole flow
            log.error("[upgrade] cannot read archive %s: %s", archive, e)
            return 1
        log.done("[upgrade] %s -> %s (from %s)", current, new_version, archive)
        return 0
    if not getattr(args, "apply", False):
        log.info(
            "devspace-tpu-torch %s — run 'devspace-tpu-torch upgrade --apply' "
            "to git pull %s, or 'upgrade --archive <release.tgz>' to install "
            "a release artifact",
            __version__,
            checkout,
        )
        return 0
    import subprocess

    # .git is a FILE for worktrees/submodules — only absence means non-git
    if not os.path.exists(os.path.join(checkout, ".git")):
        # degrade gracefully outside a git checkout (tarball installs)
        # instead of letting git error out confusingly
        log.warn(
            "[upgrade] %s is not a git checkout — self-update is only "
            "supported for git installs; re-install from a release "
            "artifact instead",
            checkout,
        )
        return 1
    try:
        out = subprocess.run(
            ["git", "-C", checkout, "pull", "--ff-only"],
            capture_output=True,
            text=True,
            timeout=120,
            check=True,
        )
        lines = (out.stdout or "").strip().splitlines()
        log.done("[upgrade] %s", lines[-1] if lines else "up to date")
        return 0
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        log.error("[upgrade] git pull failed: %s", detail.strip())
        return 1


def cmd_install(args) -> int:
    """Reference: cmd/install.go — put a launcher on PATH. It is named
    ``devspace-tpu-torch`` and runs ``python -m devspace_tpu_torch``, so it
    never overwrites the reference's ``devspace-tpu``."""
    log = logutil.get_logger()
    checkout = _checkout_root()
    bin_dir = args.bin_dir or os.path.join(os.path.expanduser("~"), ".local", "bin")
    os.makedirs(bin_dir, exist_ok=True)
    launcher = os.path.join(bin_dir, "devspace-tpu-torch")
    with open(launcher, "w", encoding="utf-8") as fh:
        fh.write(
            "#!/bin/sh\n"
            f'export PYTHONPATH="{checkout}${{PYTHONPATH:+:$PYTHONPATH}}"\n'
            f'exec "{sys.executable}" -m devspace_tpu_torch "$@"\n'
        )
    os.chmod(launcher, 0o755)
    log.done("[install] wrote %s", launcher)
    if getattr(args, "update_path", False):
        # Persist the PATH addition to the shell rc — keyed off the rc
        # file's content, not the live PATH, which may only transiently
        # contain bin_dir (reference: pkg/util/envutil via cmd/install.go).
        shell = os.path.basename(os.environ.get("SHELL", "sh"))
        rc = {
            "bash": "~/.bashrc",
            "zsh": "~/.zshrc",
            "fish": "~/.config/fish/config.fish",
        }.get(shell, "~/.profile")
        rc_path = os.path.expanduser(rc)
        if shell == "fish":
            line = f'set -gx PATH "{bin_dir}" $PATH'
        else:
            line = f'export PATH="{bin_dir}:$PATH"'
        existing = ""
        if os.path.isfile(rc_path):
            with open(rc_path, "r", encoding="utf-8") as fh:
                existing = fh.read()
        if line not in existing:
            os.makedirs(os.path.dirname(rc_path), exist_ok=True)
            with open(rc_path, "a", encoding="utf-8") as fh:
                fh.write(f"\n# added by devspace-tpu-torch install\n{line}\n")
            log.done("[install] added %s to PATH via %s", bin_dir, rc)
    elif bin_dir not in os.environ.get("PATH", "").split(os.pathsep):
        log.warn(
            "[install] %s is not on PATH — rerun with --update-path or add it manually",
            bin_dir,
        )
    return 0


def cmd_print_config(args) -> int:
    ctx = Context(args)
    if getattr(args, "manifests", False):
        # `helm template` equivalent: render every deployment's manifests
        # without touching the cluster. Charts go through the SAME
        # ChartDeployer.render_manifests the deploy path uses (identical
        # context, paths resolved against the project root), with the
        # last-built images from the generated cache (``<image>:dev``
        # where none was built) and the default image injected into the
        # chart values as deploy injects it, so the documents are what
        # deploy applied. The reference passes the cached bare tags and
        # injects nothing: its print shows the chart's default image.
        from ..deploy.chart import ChartDeployer, ChartError
        from ..deploy.manifests import create_deployer

        cache = ctx.loader.generated.get_active().deploy
        image_tags = {}
        for k, v in (ctx.config.images or {}).items():
            if v.image and not (v.build and v.build.disabled):
                image_tags[k] = f"{v.image}:{(cache.image_tags or {}).get(k) or 'dev'}"
        # as deploy does: charts default to the built image
        inject_default_image(ctx.config, image_tags)
        docs: list[dict] = []
        for d in ctx.config.deployments or []:
            deployer = create_deployer(None, d, ctx.namespace, ctx.root, ctx.log)
            try:
                if isinstance(deployer, ChartDeployer):
                    docs.extend(
                        deployer.render_manifests(
                            image_tags=image_tags, gpu=ctx.config.gpu
                        )
                    )
                else:
                    docs.extend(deployer.render_manifests(image_tags=image_tags))
            except ChartError as e:
                ctx.log.error("[print] %s: %s", d.name, e)
                return 1
        print(yaml.safe_dump_all(docs, sort_keys=False), end="")
        return 0
    print(yaml.safe_dump(to_dict(ctx.config), sort_keys=False))
    return 0


# -- parser -----------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m devspace_tpu_torch",
        description="GPU developer loop: init, deploy and live-dev PyTorch "
        "workloads on NVIDIA GPU hosts of a Kubernetes cluster.",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("--namespace", "-n", help="override namespace")
    p.add_argument("--kube-context", help="kubeconfig context to use")
    p.add_argument("--config", help="named config from configs.yaml")
    p.add_argument("--debug", action="store_true", help="verbose logging")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="scaffold Dockerfile, chart and config")
    sp.add_argument("--language", choices=["torch", "python", "node", "go"])
    sp.add_argument("--reconfigure", action="store_true")
    sp.add_argument(
        "--volume",
        action="append",
        default=[],
        metavar="NAME:SIZE[:MOUNTPATH]",
        help="declare a persistent volume (repeatable); rendered as a "
        "PVC (cpu chart) or per-worker volumeClaimTemplate (GPU chart)",
    )
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("dev", help="build, deploy and start the live dev session")
    sp.add_argument("--force-build", "-b", action="store_true")
    sp.add_argument("--force-deploy", "-d", action="store_true")
    sp.add_argument("--no-sync", action="store_true")
    sp.add_argument("--no-portforwarding", action="store_true")
    sp.add_argument("--no-terminal", action="store_true")
    sp.add_argument("--verbose-sync", action="store_true")
    sp.add_argument(
        "--sync-digest",
        choices=["on", "off"],
        default="on",
        help="content-digest gating for sync uploads: unchanged bytes "
        "(touch/checkout) become a remote mtime fix instead of a "
        "re-upload (default: on)",
    )
    sp.add_argument(
        "--restart-policy",
        choices=["always", "on-failure", "never"],
        default="on-failure",
        help="supervisor restart policy for dev-session services "
        "(sync, port-forward): restart on any exit, only on failure, "
        "or never (default: on-failure)",
    )
    sp.set_defaults(fn=cmd_dev)

    sp = sub.add_parser("deploy", help="build and deploy (CI mode)")
    sp.add_argument("--force-build", "-b", action="store_true")
    sp.add_argument("--force-deploy", "-d", action="store_true")
    sp.add_argument(
        "--skip-lint",
        action="store_true",
        help="skip the lint preflight (errors normally abort the deploy)",
    )
    sp.set_defaults(fn=cmd_deploy)

    sp = sub.add_parser("enter", help="open a shell in a slice worker")
    sp.add_argument(
        "--worker", "-w", type=int, default=None, help="worker index (default 0)"
    )
    sp.add_argument(
        "--all",
        action="store_true",
        help="run the command on EVERY worker, output prefixed per worker",
    )
    sp.add_argument("command", nargs="*", help="command to run instead of a shell")
    sp.set_defaults(fn=cmd_enter)

    sp = sub.add_parser("logs", help="print worker-prefixed logs")
    sp.add_argument("--selector", "-s")
    sp.add_argument("--lines", "-l", type=int, default=100)
    sp.add_argument("--follow", "-f", action="store_true")
    sp.add_argument("--worker", "-w", type=int, help="only this worker")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("analyze", help="diagnose problems in the namespace")
    sp.add_argument("--no-wait", action="store_true")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("purge", help="delete all deployments")
    sp.set_defaults(fn=cmd_purge)

    sp = sub.add_parser("reset", help="purge and remove local devspace state")
    sp.add_argument("--all", action="store_true", help="also remove chart/ and Dockerfile")
    sp.set_defaults(fn=cmd_reset)

    sp = sub.add_parser("status", help="deployment / sync / trace / serving status")
    sp.add_argument("what", choices=["deployments", "sync", "trace", "serving"])
    sp.add_argument("--export", help="(trace) write chrome://tracing JSON here")
    sp.add_argument(
        "--url",
        default="http://127.0.0.1:8000",
        help="(serving) base URL of a running inference server",
    )
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "profile", help="capture an engine timeline from a running server"
    )
    sp.add_argument(
        "what",
        choices=["serving"],
        help="what to profile (serving: the inference engine timeline)",
    )
    sp.add_argument(
        "--url",
        default="http://127.0.0.1:8000",
        help="base URL of a running inference server",
    )
    sp.add_argument(
        "--seconds",
        type=float,
        default=2.0,
        help="capture window in seconds (0 < N <= 60)",
    )
    sp.add_argument(
        "--out",
        default="serving-timeline.json",
        help="destination for the Chrome-trace JSON",
    )
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser(
        "top", help="live dashboard for a running inference server"
    )
    sp.add_argument(
        "--url",
        default="http://127.0.0.1:8000",
        help="base URL of a running inference server",
    )
    sp.add_argument(
        "--interval",
        type=float,
        default=2.0,
        help="seconds between dashboard refreshes",
    )
    sp.add_argument(
        "--iterations",
        type=int,
        default=0,
        help="render N frames then exit (0 = run until Ctrl-C)",
    )
    sp.add_argument(
        "--events",
        type=int,
        default=8,
        help="recent structured events to show per frame",
    )
    sp.add_argument(
        "--fleet",
        action="store_true",
        help="the URL names a `collector serve` endpoint: render the "
        "per-target matrix, fleet SLO table and merged events",
    )
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser(
        "debug", help="incident tooling for a running inference server"
    )
    debug_sub = sp.add_subparsers(dest="what", required=True)
    q = debug_sub.add_parser(
        "bundle",
        help="tar.gz of metrics, health/SLO, config, request traces, "
        "flight-recorder events and a timeline capture",
    )
    q.add_argument(
        "--url",
        default="http://127.0.0.1:8000",
        help="base URL of a running inference server",
    )
    q.add_argument(
        "--out",
        default="debug-bundle.tar.gz",
        help="destination archive path",
    )
    q.add_argument(
        "--seconds",
        type=float,
        default=2.0,
        help="timeline capture window in seconds (0 skips the capture)",
    )
    q.add_argument(
        "--fleet",
        action="store_true",
        help="bundle every target of the collector at --url (per-target "
        "subdirectories + per-target error records in the manifest)",
    )
    q.add_argument(
        "--target",
        action="append",
        default=None,
        metavar="URL",
        help="explicit fleet target (repeatable; implies --fleet)",
    )
    q.set_defaults(fn=cmd_debug)

    sp = sub.add_parser(
        "collector",
        help="fleet telemetry: scrape N servers, serve the federated view",
    )
    coll_sub = sp.add_subparsers(dest="what", required=True)
    q = coll_sub.add_parser(
        "serve",
        help="scrape every target on an interval and serve the merged "
        "/metrics, /debug/fleet, /debug/events and stitched /debug/trace",
    )
    q.add_argument(
        "--target",
        action="append",
        default=None,
        metavar="URL",
        help="scrape target base URL (repeatable)",
    )
    q.add_argument(
        "--workers",
        action="store_true",
        help="discover targets by resolving the job's worker pods "
        "through the selector layer",
    )
    q.add_argument(
        "--scrape-port",
        type=int,
        default=8000,
        help="serving port on discovered workers (with --workers)",
    )
    q.add_argument("--host", default="127.0.0.1", help="bind address")
    q.add_argument("--port", type=int, default=9090, help="listen port")
    q.add_argument(
        "--interval",
        type=float,
        default=5.0,
        help="seconds between scrape rounds",
    )
    q.add_argument(
        "--iterations",
        type=int,
        default=0,
        help="serve N HTTP requests then exit (0 = run until Ctrl-C)",
    )
    q.set_defaults(fn=cmd_collector)

    sp = sub.add_parser(
        "fleet",
        help="replica fleet: N supervised serving processes with "
        "drain-aware scaling and an embedded collector",
    )
    fleet_sub = sp.add_subparsers(dest="what", required=True)
    q = fleet_sub.add_parser(
        "serve",
        help="run N replicas under the supervisor, federate them via an "
        "embedded collector, optionally autoscale from its HPA signals",
    )
    q.add_argument(
        "--replicas", type=int, default=2, help="initial replica count",
    )
    q.add_argument(
        "--module",
        default="devspace_tpu_torch.serving.stub",
        help="replica entrypoint, launched as `python -m MODULE --port N`",
    )
    q.add_argument(
        "--env",
        action="append",
        metavar="KEY=VALUE",
        help="extra environment for replica processes (repeatable)",
    )
    q.add_argument(
        "--restart-budget",
        type=int,
        default=None,
        help="cumulative replica restarts before degrading (default "
        "unlimited)",
    )
    q.add_argument(
        "--healthy-window",
        type=float,
        default=60.0,
        help="seconds of continuous health that reset the restart budget",
    )
    q.add_argument(
        "--ready-timeout",
        type=float,
        default=15.0,
        help="seconds a replica may take to answer /readyz after its "
        "start before it is stopped and restarted (a 7B server loads and "
        "prewarms for longer than the default)",
    )
    q.add_argument("--host", default="127.0.0.1", help="collector bind address")
    q.add_argument("--port", type=int, default=9090, help="collector port")
    q.add_argument(
        "--interval",
        type=float,
        default=2.0,
        help="scrape + autoscale evaluation interval (seconds)",
    )
    q.add_argument(
        "--autoscale",
        action="store_true",
        help="drive replica count from the collector's HPA signals",
    )
    q.add_argument("--min-replicas", type=int, default=1)
    q.add_argument("--max-replicas", type=int, default=4)
    q.add_argument(
        "--metric",
        default="engine_dispatch_depth_occupancy",
        help="HPA signal to track (autoscaling/v2 Pods metric name)",
    )
    q.add_argument(
        "--target-value",
        type=float,
        default=0.75,
        help="target per-replica average for --metric",
    )
    q.add_argument(
        "--scale-down-window",
        type=float,
        default=30.0,
        help="scale-down stabilization window (seconds)",
    )
    q.add_argument(
        "--duration",
        type=float,
        default=0,
        help="run N seconds then exit (0 = run until Ctrl-C)",
    )
    q.add_argument(
        "--route",
        choices=("prefix", "round_robin", "least_loaded"),
        default=None,
        help="front the fleet with a routing gateway using this policy "
        "(prefix = cache-locality scoring blended with load; omit for "
        "no gateway)",
    )
    q.add_argument(
        "--gateway-port",
        type=int,
        default=8080,
        help="routing gateway port (with --route; 0 picks a free port)",
    )
    q.add_argument(
        "--prefill-pool",
        default="",
        metavar="N|NAMES",
        help="(with --route) reserve replicas for disaggregated prefill: "
        "a count (the first N by name) or comma-separated replica names; "
        "pool members take phase-1 prefills but no decode streams",
    )
    q.add_argument(
        "--disagg-threshold",
        type=int,
        default=0,
        metavar="TOKENS",
        help="(with --route) uncached-prompt-token threshold that "
        "triggers two-phase placement: prefill elsewhere, then decode "
        "with a kv_source KV-chain pull (0 = disabled)",
    )
    q.add_argument(
        "--disagg-occupancy-band",
        type=float,
        default=0.85,
        metavar="FRAC",
        help="decode-target occupancy at/above which even short prompts "
        "prefill elsewhere (with --disagg-threshold)",
    )
    q.set_defaults(fn=cmd_fleet)
    q = fleet_sub.add_parser(
        "status",
        help="one-shot fleet table from a running fleet's collector "
        "(/debug/fleet)",
    )
    q.add_argument(
        "--url",
        default="http://127.0.0.1:9090",
        help="fleet collector base URL",
    )
    q.add_argument("--timeout", type=float, default=3.0)
    q.set_defaults(fn=cmd_fleet)

    sp = sub.add_parser("add", help="add config entries")
    add_sub = sp.add_subparsers(dest="kind", required=True)
    q = add_sub.add_parser("sync")
    q.add_argument("--selector", default="default")
    q.add_argument("--local", default=".")
    q.add_argument("--container", required=True)
    q.add_argument("--exclude")
    q = add_sub.add_parser("port")
    q.add_argument("--selector", default="default")
    q.add_argument("local_port", type=int)
    q.add_argument("remote_port", type=int, nargs="?")
    q = add_sub.add_parser("selector")
    q.add_argument("name")
    q.add_argument("--label-selector", required=True, help="k=v,k2=v2")
    q = add_sub.add_parser("deployment")
    q.add_argument("name")
    q.add_argument("--chart")
    q.add_argument("--manifests")
    q = add_sub.add_parser("image")
    q.add_argument("name")
    q.add_argument("--image", required=True)
    q.add_argument("--dockerfile", default="Dockerfile")
    q.add_argument("--context", default=".")
    sp.set_defaults(fn=cmd_add)
    q = add_sub.add_parser("provider", help="register a cloud provider")
    q.add_argument("name")
    q.add_argument("--host", required=True)
    q.add_argument("--use-as-default", action="store_true")
    q.set_defaults(fn=cmd_add_provider)
    q = add_sub.add_parser("package", help="vendor a chart from a repo")
    q.add_argument("name")
    q.add_argument("--repo", help="chart repo (dir, file:// or http(s)://)")
    q.add_argument("--version")
    q.set_defaults(fn=cmd_add_package)

    sp = sub.add_parser("remove", help="remove config entries")
    rm_sub = sp.add_subparsers(dest="kind", required=True)
    q = rm_sub.add_parser("sync")
    q.add_argument("--container")
    q.add_argument("--all", action="store_true")
    q = rm_sub.add_parser("port")
    q.add_argument("local_port", type=int, nargs="?")
    q.add_argument("--all", action="store_true")
    q = rm_sub.add_parser("selector")
    q.add_argument("name", nargs="?")
    q.add_argument("--all", action="store_true")
    q = rm_sub.add_parser("deployment")
    q.add_argument("name", nargs="?")
    q.add_argument("--all", action="store_true")
    q = rm_sub.add_parser("image")
    q.add_argument("name")
    sp.set_defaults(fn=cmd_remove)
    q = rm_sub.add_parser("space", help="delete a cloud space")
    q.add_argument("name")
    q.add_argument("--provider")
    q.set_defaults(fn=cmd_remove_space)
    q = rm_sub.add_parser("provider", help="deregister a cloud provider")
    q.add_argument("name")
    q.set_defaults(fn=cmd_remove_provider)
    q = rm_sub.add_parser("package", help="remove a vendored chart")
    q.add_argument("name")
    q.set_defaults(fn=cmd_remove_package)
    q = rm_sub.add_parser("context", help="remove a space's kube context")
    q.add_argument("name", nargs="?")
    q.add_argument("--all", action="store_true")
    q.set_defaults(fn=cmd_remove_context)

    sp = sub.add_parser("list", help="list config entries")
    sp.add_argument(
        "what",
        choices=[
            "deployments", "images", "ports", "sync", "selectors", "vars",
            "configs", "spaces", "providers", "packages",
        ],
    )
    sp.add_argument("--provider")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("search", help="search a chart repo")
    sp.add_argument("query", nargs="?")
    sp.add_argument("--repo", help="chart repo (dir, file:// or http(s)://)")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("use", help="select config/context/namespace/space")
    use_sub = sp.add_subparsers(dest="kind", required=True)
    for kind in ("config", "context", "namespace"):
        q = use_sub.add_parser(kind)
        q.add_argument("name")
    q = use_sub.add_parser("space", help="bind a cloud space")
    q.add_argument("name")
    q.add_argument("--provider")
    q.set_defaults(fn=cmd_use_space)
    q = use_sub.add_parser("registry", help="docker login via cloud creds")
    q.add_argument("name", nargs="?")
    q.add_argument("--provider")
    q.set_defaults(fn=cmd_use_registry)
    sp.set_defaults(fn=cmd_use)

    sp = sub.add_parser("login", help="log in to a cloud provider")
    sp.add_argument("--key", help="access key (skips the browser flow)")
    sp.add_argument("--provider")
    sp.add_argument("--no-browser", action="store_true")
    sp.set_defaults(fn=cmd_login)

    sp = sub.add_parser("create", help="create cloud resources")
    create_sub = sp.add_subparsers(dest="kind", required=True)
    q = create_sub.add_parser("space")
    q.add_argument("name")
    q.add_argument("--provider")
    q.add_argument("--no-use", action="store_true", help="create without binding")
    q.set_defaults(fn=cmd_create)

    sp = sub.add_parser(
        "update", help="update config schema / refresh package indexes"
    )
    up_sub = sp.add_subparsers(dest="kind")
    q = up_sub.add_parser("config", help="rewrite config at the latest schema")
    q.set_defaults(fn=cmd_update)
    q = up_sub.add_parser(
        "packages", help="check chart repos for newer vendored versions"
    )
    q.add_argument("name", nargs="?", help="limit to one package")
    q.add_argument(
        "--apply", action="store_true", help="re-vendor newer versions"
    )
    q.set_defaults(fn=cmd_update_packages)
    sp.set_defaults(fn=cmd_update)

    sp = sub.add_parser(
        "lint", help="validate charts/manifests without applying"
    )
    sp.add_argument(
        "--chart", help="lint a standalone chart dir instead of the project"
    )
    sp.add_argument(
        "--format",
        choices=["text", "json", "sarif"],
        default="text",
        help="report format (sarif suits CI code-scanning upload)",
    )
    sp.add_argument(
        "--strict",
        action="store_true",
        help="exit non-zero on warnings too, not just errors",
    )
    sp.add_argument(
        "--select",
        help="only report these rule ids / family prefixes "
        "(comma-separated, e.g. DS1,TPU205)",
    )
    sp.add_argument(
        "--ignore",
        help="drop these rule ids / family prefixes (applied after "
        "--select; ignore wins on overlap)",
    )
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser("upgrade", help="upgrade the framework checkout")
    sp.add_argument("--apply", action="store_true", help="run git pull")
    sp.add_argument(
        "--archive", help="install a release tarball (source artifact)"
    )
    sp.add_argument(
        "--force",
        action="store_true",
        help="reinstall same version / overwrite a git checkout",
    )
    sp.set_defaults(fn=cmd_upgrade)

    sp = sub.add_parser(
        "install", help="install a devspace-tpu-torch launcher on PATH"
    )
    sp.add_argument("--bin-dir", help="target dir (default ~/.local/bin)")
    sp.add_argument(
        "--update-path",
        action="store_true",
        help="append an export PATH line to your shell rc if the dir is not on PATH",
    )
    sp.set_defaults(fn=cmd_install)

    sp = sub.add_parser("print", help="print the resolved config")
    sp.add_argument(
        "--manifests",
        action="store_true",
        help="render every deployment's manifests without applying "
        "(helm template equivalent)",
    )
    sp.set_defaults(fn=cmd_print_config)

    return p


def _maybe_warn_newer_version(command: str) -> None:
    """Startup newer-version notice (reference: cmd/root.go:42 ->
    upgrade.CheckForNewerVersion — every invocation warns when a newer
    CLI exists; upstream asks the GitHub releases API and skips
    alpha/beta builds). Zero-egress equivalent: scan the release-channel
    directory (``DEVSPACE_RELEASE_DIR``, the same artifacts ``upgrade
    --archive`` consumes) for a newer stable archive, at most once per
    day (stamped in ``~/.devspace/version_check_torch.json``, apart from
    the reference's ``version_check.json``, so one package's check never
    silences the other's notice), and print the reference's hint naming
    the port's launcher. Only archives holding ``devspace_tpu_torch/``
    count. Never raises — a broken channel must not break the command
    being run."""
    import json as _json
    import tarfile as _tarfile
    import time as _time

    from .. import __version__

    if command in ("upgrade", "print"):
        return  # upgrade IS the action; print output is parsed by tools
    if os.environ.get("DEVSPACE_SKIP_VERSION_CHECK") == "1":
        return
    if "-" in __version__:
        return  # pre-release builds don't nag (reference: root.go:38)
    release_dir = os.environ.get("DEVSPACE_RELEASE_DIR")
    if not release_dir or not os.path.isdir(release_dir):
        return
    stamp_path = os.path.join(
        os.path.expanduser("~"), ".devspace", "version_check_torch.json"
    )
    now = _time.time()
    # the "never raises" guarantee is structural, not per-site: any
    # surprise in the stamp file, a hostile tarball member, or the
    # channel dir itself must degrade to "no notice", not a traceback
    # before the user's actual command runs
    try:
        try:
            with open(stamp_path, encoding="utf-8") as fh:
                stamp = _json.load(fh)
            if (
                isinstance(stamp, dict)
                and stamp.get("release_dir") == release_dir
                and now - float(stamp.get("checked_at") or 0) < 86400
            ):
                return  # warned (or found nothing) within the last day
        except (OSError, ValueError, TypeError):
            pass
        from ..deploy.packages import _version_key

        import re as _re

        newest: Optional[tuple] = None  # (key, version, path)
        cur_key = _version_key(__version__)
        for name in sorted(os.listdir(release_dir)):
            if not name.endswith((".tar.gz", ".tgz")):
                continue
            path = os.path.join(release_dir, name)
            # filename-first screening: decompressing every archive in
            # the channel just to read __init__.py would stall the first
            # command of the day on a channel of multi-hundred-MB
            # tarballs; a version-looking filename that is not an
            # upgrade skips the open. Only the LEADING numeric version
            # is compared — a dash suffix may be a platform/build tag
            # (2.0.0-linux-x86_64), not a pre-release, so anything
            # numerically newer is opened and the archive's embedded
            # version stays the truth (it rejects pre-releases below).
            m = _re.search(r"(\d+(?:\.\d+)+)[^/]*\.(tar\.gz|tgz)$", name)
            if m and _version_key(m.group(1)) <= cur_key:
                continue
            try:
                with _tarfile.open(path, "r:gz") as tf:
                    version, _ = _archive_version(tf)
            except Exception:  # noqa: BLE001 — any malformed archive
                continue
            if not version or "-" in version:
                continue  # pre-releases never count as upgrades
            key = _version_key(version)
            if key > cur_key and (newest is None or key > newest[0]):
                newest = (key, version, path)
        try:
            os.makedirs(os.path.dirname(stamp_path), exist_ok=True)
            with open(stamp_path, "w", encoding="utf-8") as fh:
                _json.dump(
                    {"checked_at": now, "release_dir": release_dir}, fh
                )
        except OSError:
            pass  # stampless: worst case the scan repeats next run
        if newest is not None:
            logutil.get_logger().warn(
                "There is a newer version of devspace-tpu-torch v%s. Run "
                "`devspace-tpu-torch upgrade --archive %s` to update the cli.",
                newest[1],
                newest[2],
            )
    except Exception:  # noqa: BLE001
        return


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug:
        logutil.get_logger().level = "debug"
    _maybe_warn_newer_version(args.cmd)
    root = find_root(os.getcwd())
    if root is not None:
        # Mirror everything into .devspace/logs/default.log (reference:
        # log.StartFileLogging at the top of every command, cmd/dev.go:139),
        # and record phase spans (the reference has no tracing).
        logutil.start_file_logging(os.path.join(root, ".devspace"))
        from ..utils import trace

        trace.enable(os.path.join(root, ".devspace"))
    try:
        return args.fn(args)
    except CLIError as e:
        logutil.get_logger().error(str(e))
        return 1
    except logutil.FatalError:
        return 1


if __name__ == "__main__":
    sys.exit(main())
