"""Cluster diagnosis: "why is my app broken" report + GPU job checks.

Reference: pkg/devspace/analyze/ — waits up to 120s for pods to settle
(pods.go:19,63-99), then reports abnormal events grouped per object
(events.go), pod statuses against known-bad sets (pods.go:28-44), container
restarts within 2h / terminations / last log tail (pods.go:120-270), as a
bordered text report (analyze.go:74-105).

The port's copy of ``devspace_tpu/analyze/analyze.py``: the pod, event and
report functions are the reference's; its TPU slice checks become
``analyze_gpu_slice``, over the config's ``gpu`` block, and the report's
section is titled ``GPU job``.
"""

from __future__ import annotations

import time
from typing import Optional

from ..config import latest
from ..kube.client import CRITICAL_STATUS, get_pod_status

SETTLE_TIMEOUT = 120.0  # reference: analyze/pods.go:19
IGNORE_POD_STATUS = {"Running", "Succeeded", "Completed", "Terminating"}


def wait_for_settle(backend, namespace: str, timeout: float = SETTLE_TIMEOUT, interval: float = 2.0) -> list:
    """Wait until no pod is mid-transition (reference: pods.go:63-99)."""
    deadline = time.monotonic() + timeout
    pods = backend.list_pods(namespace)
    while time.monotonic() < deadline:
        pods = backend.list_pods(namespace)
        pending = [
            p
            for p in pods
            if get_pod_status(p) not in IGNORE_POD_STATUS | CRITICAL_STATUS
        ]
        if not pending:
            break
        time.sleep(interval)
    return pods


def analyze_pods(backend, namespace: str, wait: bool = True) -> list[str]:
    problems: list[str] = []
    pods = wait_for_settle(backend, namespace) if wait else backend.list_pods(namespace)
    for pod in pods:
        status = get_pod_status(pod)
        if status in ("Running", "Succeeded", "Completed"):
            restarts = sum(
                cs.get("restartCount", 0)
                for cs in pod.raw.get("status", {}).get("containerStatuses") or []
            )
            if restarts > 0:
                problems.append(
                    f"Pod {pod.name}: {restarts} container restart(s) — check logs"
                )
            continue
        lines = [f"Pod {pod.name}: status {status}"]
        for cs in pod.raw.get("status", {}).get("containerStatuses") or []:
            state = cs.get("state") or {}
            waiting = state.get("waiting") or {}
            term = state.get("terminated") or {}
            if waiting.get("message"):
                lines.append(f"  container {cs.get('name')}: {waiting['message']}")
            if term:
                lines.append(
                    f"  container {cs.get('name')} terminated: "
                    f"reason={term.get('reason')} exit={term.get('exitCode')}"
                )
        try:
            tail = list(backend.logs(pod, namespace=namespace, tail=5))
            if tail:
                lines.append("  last log lines:")
                lines.extend(
                    "    " + ln.decode("utf-8", "replace") for ln in tail[-5:]
                )
        except Exception:  # noqa: BLE001 — logs unavailable for broken pods
            pass
        problems.append("\n".join(lines))
    return problems


def analyze_events(backend, namespace: str) -> list[str]:
    problems: list[str] = []
    by_object: dict[str, list[dict]] = {}
    try:
        events = backend.list_events(namespace)
    except Exception:  # noqa: BLE001
        return problems
    for ev in events:
        if ev.get("type") in (None, "Normal"):
            continue
        obj = ev.get("involvedObject", {})
        key = f"{obj.get('kind', '?')}/{obj.get('name', '?')}"
        by_object.setdefault(key, []).append(ev)
    for key, evs in by_object.items():
        latest_ev = max(evs, key=lambda e: e.get("lastTimestamp") or "")
        problems.append(
            f"{key}: {len(evs)} warning event(s); latest: "
            f"[{latest_ev.get('reason', '?')}] {latest_ev.get('message', '')}"
        )
    return problems


def analyze_gpu_slice(
    backend, config: latest.Config, namespace: str
) -> list[str]:
    """GPU job preflight over the config's ``gpu`` block, the port's
    counterpart of the reference's ``analyze_tpu_slice``: ``gpu.workers``
    workers Running, no missing or duplicate worker index (torchrun's node
    rank, :attr:`Pod.worker_id`), and the headless service through which
    ``--master-addr`` (worker 0) resolves. Auxiliary deployments, whose
    pods carry no job wiring, are skipped. The ``gpu`` block has no
    topology, so there is no chip-product check."""
    problems: list[str] = []
    if not config.gpu or not config.deployments:
        return problems
    want = config.gpu.workers or 1
    matched_any = False
    for d in config.deployments:
        if not d.name:
            continue
        pods = backend.list_pods(
            d.namespace or namespace, label_selector={"app": d.name}
        )
        if not pods:
            continue
        # The job checks apply to the GPU deployment only — auxiliary
        # deployments (a vendored DB, a sidecar service) must not be
        # measured against the job's size. A deployment is the job when
        # its pods carry explicit wiring: NODE_RANK in any container
        # (NOT the pod-index label or the pod-name ordinal, which every
        # StatefulSet pod has).
        if not any(p.has_explicit_worker_identity for p in pods):
            continue
        matched_any = True
        running = [p for p in pods if get_pod_status(p) == "Running"]
        if len(running) != want:
            problems.append(
                f"GPU job {d.name}: {len(running)}/{want} workers Running"
            )
        ids = [p.worker_id for p in running]
        missing = [i for i in range(want) if i not in ids]
        if running and missing:
            problems.append(
                f"GPU job {d.name}: missing worker index(es) {missing} "
                f"(got {sorted(i for i in ids if i is not None)})"
            )
        dupes = {i for i in ids if i is not None and ids.count(i) > 1}
        if dupes:
            problems.append(
                f"GPU job {d.name}: duplicate worker index(es) {sorted(dupes)}"
            )
        # rendezvous: torchrun's --master-addr is worker 0's hostname,
        # which resolves through the chart's headless service
        svc = backend.get_object(
            "v1", "Service", d.name, d.namespace or namespace
        )
        if svc is None:
            problems.append(
                f"GPU job {d.name}: headless service '{d.name}' missing — "
                f"the torchrun master address {d.name}-0.{d.name} cannot "
                f"resolve"
            )
    if not matched_any and want > 1:
        problems.append(
            f"GPU config requests {want} workers but no deployment's pods "
            "carry NODE_RANK — the job chart is not deployed (or its env "
            "wiring is missing)"
        )
    return problems


def create_report(
    backend,
    namespace: str,
    config: Optional[latest.Config] = None,
    wait: bool = True,
) -> str:
    """Bordered text report (reference: analyze.go:44 CreateReport)."""
    sections = [
        ("Pods", analyze_pods(backend, namespace, wait=wait)),
        ("Events", analyze_events(backend, namespace)),
    ]
    if config is not None:
        sections.append(("GPU job", analyze_gpu_slice(backend, config, namespace)))
    problems_total = sum(len(p) for _, p in sections)
    width = 72
    lines = ["=" * width, f"Analysis of namespace '{namespace}'".center(width), "=" * width]
    if problems_total == 0:
        lines.append("No problems found.".center(width))
    else:
        for title, problems in sections:
            if not problems:
                continue
            lines.append(f"--- {title} " + "-" * (width - len(title) - 5))
            for p in problems:
                lines.append(p)
    lines.append("=" * width)
    return "\n".join(lines)
