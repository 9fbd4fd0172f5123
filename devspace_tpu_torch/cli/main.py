"""The port's CLI: ``python -m devspace_tpu_torch <command>``.

The port's copy of ``devspace_tpu/cli/main.py`` (reference: cmd/, the
cobra root and subcommands, SURVEY §2.1), with the commands that apply a
project to a cluster and develop in it: ``init`` (a torch project: the
CUDA Dockerfile, chart-gpu and a ``gpu`` block), ``deploy`` (lint
preflight, build, apply), ``dev`` (the live session: sync across the
job's workers, port forwarding, the terminal or the log mux,
auto-reload), ``enter`` (``--worker N``, ``--all``), ``logs``, ``purge``,
``reset``, ``analyze``, ``status deployments``/``sync``/``trace``,
``print`` (``--manifests``) and ``lint``, with the reference's flags.
``status serving``, ``top``, ``debug``, ``collector``, ``fleet``,
``add``/``remove``/``list``/``use``, the cloud commands, ``update``,
``upgrade``, ``install`` and the start-up version notice are not ported
yet.
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
def cmd_status(args) -> int:
    """Reference: cmd/status/{deployments,sync}.go, and the span trace of
    the pipeline's phases. ``status serving`` is not ported yet."""
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

    sp = sub.add_parser("status", help="deployment / sync / trace status")
    sp.add_argument("what", choices=["deployments", "sync", "trace"])
    sp.add_argument("--export", help="(trace) write chrome://tracing JSON here")
    sp.set_defaults(fn=cmd_status)

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

    sp = sub.add_parser("print", help="print the resolved config")
    sp.add_argument(
        "--manifests",
        action="store_true",
        help="render every deployment's manifests without applying "
        "(helm template equivalent)",
    )
    sp.set_defaults(fn=cmd_print_config)

    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug:
        logutil.get_logger().level = "debug"
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
