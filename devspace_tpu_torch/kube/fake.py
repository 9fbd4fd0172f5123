"""Fake local backend: a "cluster" made of local processes and temp dirs.

Generalizes the reference's key test trick (SURVEY §4): SyncConfig.testing
spawns a local ``exec.Command("sh")`` instead of kubectl-exec, so the whole
remote protocol runs against a local temp dir standing in for the container.
Here the fake is a full backend: a pod store, exec via local subprocesses,
logs, port-forward to local sockets, and apply() that synthesizes Running
pods from workload manifests — enough to run init→deploy→status→purge
end-to-end with zero Kubernetes (N fake job workers = N local dirs).

The port's copy of ``devspace_tpu/kube/fake.py``, with the same state file
(``cluster-state.json``) and the same pod synthesis, and one intended
difference. Where the reference stamps ``TPU_WORKER_ID`` on the pods of a
multi-replica workload, the port does what a StatefulSet controller does
for chart-gpu: pod ``<name>-<i>`` of a StatefulSet or a multi-replica
workload carries the pod-index label ``i``, and an env entry whose
``valueFrom.fieldRef`` is that label (chart-gpu's ``NODE_RANK``) is
resolved to ``"i"`` on the pod. Env entries with a literal ``value`` are
copied as in the reference.
"""

from __future__ import annotations

import copy
import datetime
import os
import shlex
import subprocess
import threading
from typing import Iterator, Optional

from ..resilience.chaos import ByteBudgetStream, ChaosConfig
from ..utils import log as logutil
from .client import (
    CRITICAL_STATUS,
    NODE_RANK_ENV,
    POD_INDEX_FIELD,
    POD_INDEX_LABEL,
    Pod,
    get_pod_status,
    selector_string,
)
from .portforward import LocalPortTunnel, PortForwarder
from .streams import ConnectionTracker, RemoteProcess, SubprocessRemoteProcess


class FakeCluster:
    """Mirrors KubeClient's surface against local state."""

    is_fake = True  # build pipeline picks the fake builder for fake clusters

    def __init__(
        self,
        root: str,
        logger: Optional[logutil.Logger] = None,
        persist: bool = False,
    ):
        self.root = os.path.abspath(root)  # holds per-pod "filesystems"
        self.log = logger or logutil.get_logger()
        self.default_namespace = "default"
        self._lock = threading.RLock()
        self.pods: dict[tuple[str, str], dict] = {}
        self.objects: dict[tuple[str, str, str], dict] = {}  # (kind, ns, name)
        self._events: list[dict] = []
        self.namespaces: set[str] = {"default"}
        self.pod_logs: dict[tuple[str, str], list[bytes]] = {}
        self.pod_ports: dict[tuple[str, str, int], int] = {}  # remote -> local
        self.connections = ConnectionTracker()
        # Fault injection (docs/resilience.md): tests attach a ChaosConfig
        # and the hooks below consult it before each operation. None = off.
        self.chaos: Optional[ChaosConfig] = None
        # Live exec streams per pod, so kill_pod can tear down a pod's
        # connections the way a real pod deletion severs its exec sessions.
        self._pod_procs: dict[tuple[str, str], list[RemoteProcess]] = {}
        # Persistence lets separate CLI invocations (deploy, then dev) share
        # one fake cluster, like a real API server would.
        self._persist = persist
        if persist:
            self._load_state()

    # -- persistence -------------------------------------------------------
    @property
    def _state_path(self) -> str:
        return os.path.join(self.root, "cluster-state.json")

    def _load_state(self) -> None:
        import json

        try:
            with open(self._state_path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        for entry in data.get("pods", []):
            self.pods[(entry["ns"], entry["name"])] = entry["manifest"]
        for entry in data.get("objects", []):
            self.objects[(entry["kind"], entry["ns"], entry["name"])] = entry[
                "manifest"
            ]
        self.namespaces.update(data.get("namespaces", []))

    def _save_state(self) -> None:
        if not self._persist:
            return
        import json
        import tempfile

        with self._lock:
            data = {
                "pods": [
                    {"ns": ns, "name": name, "manifest": m}
                    for (ns, name), m in self.pods.items()
                ],
                "objects": [
                    {"kind": k, "ns": ns, "name": name, "manifest": m}
                    for (k, ns, name), m in self.objects.items()
                ],
                "namespaces": sorted(self.namespaces),
            }
            os.makedirs(self.root, exist_ok=True)
            # Atomic replace: cross-process readers (deploy, then dev) must
            # never observe a truncated file.
            fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".state-")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(data, fh)
                os.replace(tmp, self._state_path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # -- fixture helpers ---------------------------------------------------
    def pod_dir(self, name: str, namespace: str = "default") -> str:
        d = os.path.join(self.root, namespace, name)
        os.makedirs(d, exist_ok=True)
        return d

    def add_pod(
        self,
        name: str,
        namespace: str = "default",
        labels: Optional[dict[str, str]] = None,
        worker_id: Optional[int] = None,
        containers: Optional[list[str]] = None,
        phase: str = "Running",
        env: Optional[dict[str, str]] = None,
    ) -> Pod:
        env_list = [{"name": k, "value": v} for k, v in (env or {}).items()]
        labels = dict(labels or {})
        if worker_id is not None:
            # a worker of a chart-gpu job: its ordinal as the pod-index
            # label and as NODE_RANK
            labels.setdefault(POD_INDEX_LABEL, str(worker_id))
            if not any(e["name"] == NODE_RANK_ENV for e in env_list):
                env_list.append({"name": NODE_RANK_ENV, "value": str(worker_id)})
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "labels": labels,
                "creationTimestamp": datetime.datetime.now(
                    datetime.timezone.utc
                ).isoformat(),
            },
            "spec": {
                "containers": [
                    {"name": c, "env": env_list}
                    for c in (containers or ["main"])
                ]
            },
            "status": {
                "phase": phase,
                "containerStatuses": [
                    {"name": c, "ready": phase == "Running", "state": {}}
                    for c in (containers or ["main"])
                ],
            },
        }
        with self._lock:
            self.pods[(namespace, name)] = manifest
        self.pod_dir(name, namespace)
        self._save_state()
        return Pod(manifest)

    def set_pod_phase(self, name: str, phase: str, namespace: str = "default") -> None:
        with self._lock:
            self.pods[(namespace, name)]["status"]["phase"] = phase
            for cs in self.pods[(namespace, name)]["status"].get(
                "containerStatuses", []
            ):
                cs["ready"] = phase == "Running"

    def set_logs(self, name: str, lines: list[str], namespace: str = "default") -> None:
        self.pod_logs[(namespace, name)] = [ln.encode() for ln in lines]

    def expose_port(
        self, pod: str, remote_port: int, local_port: int, namespace: str = "default"
    ) -> None:
        """Declare that 'remote_port' inside the fake pod is actually served
        by a local server on local_port (test fixture for port-forward)."""
        self.pod_ports[(namespace, pod, remote_port)] = local_port

    def kill_pod(self, name: str, namespace: str = "default") -> int:
        """Chaos fixture: the pod vanishes mid-session — it is removed from
        the store AND every live exec stream into it is torn down (a real
        deletion severs exec/attach connections the same way). Returns the
        number of streams killed. Re-create with add_pod to simulate a
        controller bringing the worker back."""
        with self._lock:
            self.pods.pop((namespace, name), None)
            procs = self._pod_procs.pop((namespace, name), [])
        killed = 0
        for p in procs:
            try:
                if p.poll() is None:
                    p.terminate()
                    killed += 1
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._save_state()
        return killed

    def _chaos(self, op: str, **context) -> None:
        if self.chaos is not None:
            self.chaos.before(op, **context)

    # -- namespaces --------------------------------------------------------
    def ensure_namespace(self, namespace: str) -> None:
        with self._lock:
            self.namespaces.add(namespace)

    # -- pods --------------------------------------------------------------
    def list_pods(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        ns = namespace or self.default_namespace
        with self._lock:
            out = []
            for (pns, _), manifest in self.pods.items():
                if pns != ns:
                    continue
                labels = manifest["metadata"].get("labels") or {}
                if label_selector and any(
                    labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                out.append(Pod(copy.deepcopy(manifest)))
            return out

    def get_pod(self, name: str, namespace: Optional[str] = None) -> Optional[Pod]:
        ns = namespace or self.default_namespace
        with self._lock:
            m = self.pods.get((ns, name))
            return Pod(copy.deepcopy(m)) if m else None

    def get_newest_running_pod(
        self,
        label_selector: dict[str, str],
        namespace: Optional[str] = None,
        timeout: float = 120.0,
        interval: float = 0.05,
    ) -> Pod:
        import time

        deadline = time.monotonic() + timeout
        last = "NotFound"
        while time.monotonic() < deadline:
            pods = self.list_pods(namespace, label_selector)
            if pods:
                newest = max(pods, key=lambda p: p.creation_timestamp)
                last = get_pod_status(newest)
                if last == "Running":
                    return newest
                if last in CRITICAL_STATUS:
                    raise RuntimeError(f"pod {newest.name} has critical status: {last}")
            time.sleep(interval)
        raise TimeoutError(
            f"no running pod for selector {selector_string(label_selector)} "
            f"(last status: {last})"
        )

    def slice_workers(
        self,
        label_selector: dict[str, str],
        namespace: Optional[str] = None,
        expected: Optional[int] = None,
        timeout: float = 120.0,
        interval: float = 0.05,
    ) -> list[Pod]:
        import time

        self._chaos("slice_workers", selector=selector_string(label_selector))
        deadline = time.monotonic() + timeout
        while True:
            pods = self.list_pods(namespace, label_selector)
            running = [p for p in pods if get_pod_status(p) == "Running"]
            want = expected if expected is not None else (len(pods) or 1)
            if running and len(running) >= want:
                running.sort(
                    key=lambda p: (
                        p.worker_id if p.worker_id is not None else 1 << 30,
                        p.name,
                    )
                )
                return running
            if time.monotonic() >= deadline:
                raise TimeoutError(f"only {len(running)}/{want} fake workers Running")
            time.sleep(interval)

    # -- streams -----------------------------------------------------------
    def exec_stream(
        self,
        pod: Pod | str,
        command: list[str],
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        tty: bool = False,
        stdin: bool = True,
    ) -> RemoteProcess:
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        self._require_pod(name, ns)
        self._chaos("exec_stream", pod=name)
        workdir = self.pod_dir(name, ns)
        proc: RemoteProcess = SubprocessRemoteProcess(command, cwd=workdir)
        budget = self.chaos.stream_budget("exec_stream") if self.chaos else None
        if budget is not None:
            proc = ByteBudgetStream(proc, budget)
        with self._lock:
            live = self._pod_procs.setdefault((ns, name), [])
            live[:] = [p for p in live if ConnectionTracker._alive(p)]
            live.append(proc)
        return self.connections.track(proc)

    def _require_pod(self, name: str, ns: str) -> None:
        with self._lock:
            if (ns, name) not in self.pods:
                raise LookupError(f"fake pod {ns}/{name} does not exist")

    def exec_buffered(
        self,
        pod: Pod | str,
        command: list[str],
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        timeout: float = 60.0,
    ) -> tuple[bytes, bytes, int]:
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        self._require_pod(name, ns)
        self._chaos("exec_buffered", pod=name)
        proc = subprocess.run(
            command,
            cwd=self.pod_dir(name, ns),
            capture_output=True,
            timeout=timeout,
        )
        return proc.stdout, proc.stderr, proc.returncode

    def attach_stream(
        self,
        pod: Pod | str,
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        tty: bool = False,
        stdin: bool = False,
    ) -> RemoteProcess:
        # Attaching to the fake pod's PID-1: tail its stored logs.
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        lines = self.pod_logs.get((ns, name), [])
        script = "".join(
            f"echo {shlex.quote(ln.decode('utf-8', 'replace'))}\n" for ln in lines
        ) + "sleep 3600\n"
        return SubprocessRemoteProcess(["sh", "-c", script])

    def logs(
        self,
        pod: Pod | str,
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        tail: Optional[int] = None,
        follow: bool = False,
        previous: bool = False,
    ) -> Iterator[bytes]:
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        self._chaos("logs", pod=name)
        lines = self.pod_logs.get((ns, name), [])
        if tail is not None:
            # tail=0 means "no history" (k8s tailLines=0), not lines[-0:]
            lines = lines[-tail:] if tail > 0 else []
        yield from lines

    def portforward(
        self,
        pod: Pod | str,
        ports: list[tuple[int, int]],
        namespace: Optional[str] = None,
        bind_address: str = "127.0.0.1",
    ) -> PortForwarder:
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )

        def dial(remote: int):
            self._chaos("portforward_dial", pod=name, port=remote)
            target = self.pod_ports.get((ns, name, remote))
            if target is None:
                raise ConnectionRefusedError(
                    f"fake pod {name} has no server on port {remote}"
                )
            return LocalPortTunnel("127.0.0.1", target)

        return PortForwarder(dial, ports, bind_address, self.log)

    # -- path translation --------------------------------------------------
    def translate_path(self, pod: Pod | str, container_path: str, namespace: Optional[str] = None) -> str:
        """Map an absolute in-container path onto the fake pod's local dir.
        The real backend's translate_path is the identity."""
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        return os.path.join(self.pod_dir(name, ns), container_path.lstrip("/"))

    # -- generic objects + workload synthesis ------------------------------
    def apply(self, manifest: dict, namespace: Optional[str] = None) -> dict:
        kind = manifest.get("kind", "")
        meta = manifest.setdefault("metadata", {})
        ns = meta.get("namespace") or namespace or self.default_namespace
        meta.setdefault("namespace", ns)
        name = meta.get("name", "")
        # synthesize BEFORE storing: _synthesize_pods stamps the rollout
        # status onto workload manifests and the stored copy must carry it
        self._synthesize_pods(manifest, ns)
        with self._lock:
            self.objects[(kind, ns, name)] = copy.deepcopy(manifest)
        self._save_state()
        return manifest

    def _synthesize_pods(self, manifest: dict, ns: str) -> None:
        """Applying a workload makes its pods 'Running' immediately (and
        stamps a fully-ready rollout status, like a settled controller)."""
        kind = manifest.get("kind", "")
        name = manifest.get("metadata", {}).get("name", "")
        spec = manifest.get("spec") or {}
        template = spec.get("template") or {}
        if kind in ("Deployment", "StatefulSet", "ReplicaSet"):
            replicas = spec.get("replicas")
            if replicas is None:  # explicit 0 means scale-to-zero: no pods
                replicas = 1
        elif kind == "Job":
            replicas = spec.get("completions", spec.get("parallelism", 1)) or 1
        else:
            return
        # API-server semantics: each apply bumps metadata.generation; the
        # (settled) fake controller immediately observes it — real clusters
        # lag here, which is what ChartDeployer._wait_ready guards against.
        with self._lock:
            prev = self.objects.get(
                (kind, manifest["metadata"].get("namespace", ns), name)
            )
        prev_gen = ((prev or {}).get("metadata") or {}).get("generation", 0)
        generation = prev_gen + 1
        manifest["metadata"]["generation"] = generation
        manifest.setdefault("status", {}).update(
            {
                "replicas": replicas,
                "readyReplicas": replicas,
                "updatedReplicas": replicas,
                "observedGeneration": generation,
            }
        )
        labels = (template.get("metadata") or {}).get("labels") or {}
        containers = [
            c.get("name", "main")
            for c in (template.get("spec") or {}).get("containers") or []
        ] or ["main"]
        tpl_env: dict[str, Optional[str]] = {}  # None: the pod index
        for c in (template.get("spec") or {}).get("containers") or []:
            for e in c.get("env") or []:
                field = ((e.get("valueFrom") or {}).get("fieldRef") or {}).get(
                    "fieldPath"
                )
                if "name" in e and "value" in e:
                    tpl_env[e["name"]] = e["value"]
                elif "name" in e and field == POD_INDEX_FIELD:
                    tpl_env[e["name"]] = None
        # pods with a stable ordinal: a StatefulSet's, and (as the
        # reference's worker ids) any multi-replica workload's
        indexed = kind == "StatefulSet" or replicas > 1
        for i in range(replicas):
            pod_name = f"{name}-{i}"
            env = {
                k: (str(i) if v is None else v)
                for k, v in tpl_env.items()
                if v is not None or indexed
            }
            self.add_pod(
                pod_name,
                namespace=ns,
                labels={**labels, POD_INDEX_LABEL: str(i)} if indexed else labels,
                containers=containers,
                env=env,
            )

    def delete_object(self, manifest: dict, namespace: Optional[str] = None) -> bool:
        kind = manifest.get("kind", "")
        meta = manifest.get("metadata", {})
        ns = meta.get("namespace") or namespace or self.default_namespace
        name = meta.get("name", "")
        with self._lock:
            found = self.objects.pop((kind, ns, name), None)
            # Cascade: remove synthesized pods.
            for key in [k for k in self.pods if k[0] == ns and k[1].startswith(name + "-")]:
                del self.pods[key]
        self._save_state()
        return found is not None

    def get_object(
        self, api_version: str, kind: str, name: str, namespace: Optional[str] = None
    ) -> Optional[dict]:
        ns = namespace or self.default_namespace
        with self._lock:
            m = self.objects.get((kind, ns, name))
            return copy.deepcopy(m) if m else None

    def create_pod(self, manifest: dict, namespace: Optional[str] = None) -> Pod:
        meta = manifest.get("metadata", {})
        ns = meta.get("namespace") or namespace or self.default_namespace
        name = meta.get("name", "pod")
        containers = [
            c.get("name", "main")
            for c in (manifest.get("spec") or {}).get("containers") or []
        ] or ["main"]
        return self.add_pod(name, namespace=ns, containers=containers)

    def delete_pod(self, name: str, namespace: Optional[str] = None) -> None:
        ns = namespace or self.default_namespace
        with self._lock:
            self.pods.pop((ns, name), None)
        self._save_state()

    def add_event(
        self,
        message: str,
        reason: str = "FailedScheduling",
        type: str = "Warning",
        involved: str = "Pod/w-0",
        namespace: str = "default",
        count: int = 1,
    ) -> None:
        """Record a synthetic cluster event (for analyze tests)."""
        kind, _, name = involved.partition("/")
        with self._lock:
            self._events.append(
                {
                    "type": type,
                    "reason": reason,
                    "message": message,
                    "count": count,
                    "involvedObject": {
                        "kind": kind,
                        "name": name,
                        "namespace": namespace,
                    },
                    "metadata": {"namespace": namespace},
                }
            )

    def list_events(
        self, namespace: Optional[str] = None, field_selector: Optional[str] = None
    ) -> list[dict]:
        # None means the default namespace, matching the real client
        # (kube/client.py list_events: ns = namespace or default_namespace)
        ns = namespace or self.default_namespace
        with self._lock:
            return [
                e for e in self._events if e["metadata"]["namespace"] == ns
            ]
