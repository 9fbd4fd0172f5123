"""High-level Kubernetes client: pods, status, apply, GPU job resolution.

The port's copy of ``devspace_tpu/kube/client.py`` (reference:
pkg/devspace/kubectl/client.go — NewClient (34), pod status derivation
ported from kubectl printers (GetPodStatus, 224), newest-running-pod
polling selector (GetNewestRunningPod, 171), EnsureDefaultNamespace
(util.go:22)). A selector can resolve to the *ordered* worker pod list of
a multi-host job. Where the reference orders a TPU slice by
``TPU_WORKER_ID``, the port orders a torchrun job by what chart-gpu
wires: ``NODE_RANK`` (from the pod index), the StatefulSet pod-index
label, then the pod name's ordinal (:attr:`Pod.worker_id`).
"""

from __future__ import annotations

import re
import subprocess
import time
from typing import Any, Iterator, Optional

from ..utils import log as logutil
from . import exec as kexec
from .portforward import PortForwarder, WSPortTunnel
from .streams import ConnectionTracker, RemoteProcess
from .transport import ApiError, KubeTransport

# The label a StatefulSet controller puts on each pod (its ordinal), and
# the fieldRef through which chart-gpu hands it to the container as
# NODE_RANK.
POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
POD_INDEX_FIELD = f"metadata.labels['{POD_INDEX_LABEL}']"
NODE_RANK_ENV = "NODE_RANK"

OK_POD_STATUS = {"Running", "Completed", "Succeeded"}
CRITICAL_STATUS = {
    "Error",
    "CrashLoopBackOff",
    "ImagePullBackOff",
    "ErrImagePull",
    "CreateContainerConfigError",
    "InvalidImageName",
    "OOMKilled",
    "RunContainerError",
}


class Pod:
    """Thin wrapper over a v1.Pod manifest dict."""

    def __init__(self, manifest: dict):
        self.raw = manifest

    @property
    def name(self) -> str:
        return self.raw.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str:
        return self.raw.get("metadata", {}).get("namespace", "default")

    @property
    def labels(self) -> dict[str, str]:
        return self.raw.get("metadata", {}).get("labels") or {}

    @property
    def phase(self) -> str:
        return self.raw.get("status", {}).get("phase", "Unknown")

    @property
    def creation_timestamp(self) -> str:
        return self.raw.get("metadata", {}).get("creationTimestamp", "")

    @property
    def containers(self) -> list[str]:
        return [
            c.get("name", "")
            for c in self.raw.get("spec", {}).get("containers") or []
        ]

    def container_env(self, container: Optional[str] = None) -> dict[str, str]:
        for c in self.raw.get("spec", {}).get("containers") or []:
            if container is None or c.get("name") == container:
                return {
                    e["name"]: e.get("value", "")
                    for e in c.get("env") or []
                    if "name" in e
                }
        return {}

    @property
    def _pod_index(self) -> Optional[str]:
        """The pod-index label, or the annotation of the same key."""
        meta = self.raw.get("metadata", {})
        for where in ("labels", "annotations"):
            value = (meta.get(where) or {}).get(POD_INDEX_LABEL)
            if value is not None:
                return str(value)
        return None

    @property
    def has_explicit_worker_identity(self) -> bool:
        """True when this pod carries the job's wiring: a ``NODE_RANK``
        env entry in any container, literal or from a fieldRef, which
        chart-gpu wires — NOT the pod-index label or the pod name's
        ordinal, which a StatefulSet controller gives every StatefulSet
        pod. Used to decide whether a deployment IS the job (analyze
        preflights)."""
        return any(
            e.get("name") == NODE_RANK_ENV
            for c in self.raw.get("spec", {}).get("containers") or []
            for e in c.get("env") or []
        )

    @property
    def worker_id(self) -> Optional[int]:
        """Worker index within a multi-host GPU job (torchrun's node
        rank). Sources, in order: a literal ``NODE_RANK`` in the
        container env, the pod-index label or annotation (chart-gpu's
        ``NODE_RANK`` comes from it), or a trailing ordinal in the pod
        name (StatefulSet style)."""
        env = self.container_env()
        for raw in (env.get(NODE_RANK_ENV), self._pod_index):
            if raw:
                try:
                    return int(raw)
                except ValueError:
                    pass
        tail = self.name.rsplit("-", 1)
        if len(tail) == 2 and tail[1].isdigit():
            return int(tail[1])
        return None


def get_pod_status(pod: Pod) -> str:
    """Derive the kubectl-printer style status string
    (reference: kubectl/client.go:224 GetPodStatus)."""
    raw = pod.raw
    status = raw.get("status", {})
    reason = status.get("reason") or status.get("phase", "Unknown")
    if raw.get("metadata", {}).get("deletionTimestamp"):
        return "Terminating"
    init_statuses = status.get("initContainerStatuses") or []
    for cs in init_statuses:
        state = cs.get("state") or {}
        term = state.get("terminated")
        waiting = state.get("waiting")
        if term and term.get("exitCode", 0) != 0:
            return "Init:" + (term.get("reason") or f"ExitCode:{term['exitCode']}")
        if waiting and waiting.get("reason") not in (None, "", "PodInitializing"):
            return "Init:" + waiting["reason"]
    for cs in reversed(status.get("containerStatuses") or []):
        state = cs.get("state") or {}
        waiting = state.get("waiting")
        term = state.get("terminated")
        if waiting and waiting.get("reason"):
            reason = waiting["reason"]
        elif term:
            reason = term.get("reason") or (
                f"ExitCode:{term.get('exitCode', '?')}"
                if term.get("exitCode", 0) != 0
                else "Completed"
            )
    if status.get("phase") == "Running":
        statuses = status.get("containerStatuses") or []
        # No reported container statuses yet => kubelet hasn't confirmed the
        # containers are up; not Running-ready.
        ready = bool(statuses) and all((cs or {}).get("ready") for cs in statuses)
        if reason in ("Running", pod.phase) and ready:
            return "Running"
        if reason in ("Running", pod.phase) and not ready:
            return "ContainersNotReady"
    return reason


def selector_string(label_selector: dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))


class KubeClient:
    """The real backend. The fake backend (fake.py) mirrors this surface."""

    def __init__(
        self,
        transport: KubeTransport,
        logger: Optional[logutil.Logger] = None,
    ):
        self.transport = transport
        self.log = logger or logutil.get_logger()
        # Tracks live exec/attach streams so `dev` teardown can force-close
        # hung connections (reference: kubectl/upgrade_wrapper.go).
        self.connections = ConnectionTracker()
        self._rbac_ensured = False

    @property
    def default_namespace(self) -> str:
        return self.transport.default_namespace

    @classmethod
    def from_kubeconfig(
        cls,
        context: Optional[str] = None,
        namespace: Optional[str] = None,
        logger=None,
    ) -> "KubeClient":
        return cls(
            KubeTransport.from_kubeconfig(context=context, namespace=namespace),
            logger,
        )

    # -- namespaces --------------------------------------------------------
    def ensure_namespace(self, namespace: str) -> None:
        """Create the namespace if missing (reference:
        kubectl/util.go:22 EnsureDefaultNamespace)."""
        if not namespace or namespace == "default":
            return
        try:
            self.transport.request("GET", f"/api/v1/namespaces/{namespace}")
        except ApiError as e:
            if e.status != 404:
                raise
            self.transport.request(
                "POST",
                "/api/v1/namespaces",
                body={
                    "apiVersion": "v1",
                    "kind": "Namespace",
                    "metadata": {"name": namespace},
                },
            )
            self.log.done(f"Created namespace {namespace}")

    def ensure_cluster_admin_binding(self, account: Optional[str] = None) -> None:
        """On GKE, grant the active gcloud account cluster-admin so RBAC
        objects (e.g. chart-rendered Roles) can be created (reference:
        kubectl/util.go:46 EnsureGoogleCloudClusterRoleBinding).

        Best-effort: no-op when the account can't be determined, the
        binding exists, or the API is unreachable. Attempted once per
        client — success or failure — so dev-loop reloads never re-pay
        the gcloud subprocess or the API round-trip.
        """
        if self._rbac_ensured:
            return
        self._rbac_ensured = True
        if account is None:
            try:
                out = subprocess.run(
                    ["gcloud", "config", "list", "account", "--format", "value(core.account)"],
                    capture_output=True,
                    text=True,
                    timeout=10,
                    check=False,
                )
                account = (out.stdout or "").strip()
            except (OSError, subprocess.SubprocessError):
                account = ""
        if not account:
            return
        name = "devspace-user-" + re.sub(r"[^a-z0-9.-]", "-", account.lower())
        try:
            self.transport.request(
                "GET",
                f"/apis/rbac.authorization.k8s.io/v1/clusterrolebindings/{name}",
            )
            return
        except ApiError as e:
            if e.status != 404:
                return  # forbidden etc. — best-effort, as in the reference
        except OSError:
            return  # connection-level failure must never block the deploy
        try:
            self.transport.request(
                "POST",
                "/apis/rbac.authorization.k8s.io/v1/clusterrolebindings",
                body={
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "kind": "ClusterRoleBinding",
                    "metadata": {"name": name},
                    "roleRef": {
                        "apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole",
                        "name": "cluster-admin",
                    },
                    "subjects": [
                        {
                            "apiGroup": "rbac.authorization.k8s.io",
                            "kind": "User",
                            "name": account,
                        }
                    ],
                },
            )
            self.log.done(f"Created ClusterRoleBinding {name}")
        except (ApiError, OSError):
            pass

    # -- pods --------------------------------------------------------------
    def list_pods(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        ns = namespace or self.default_namespace
        query = {}
        if label_selector:
            query["labelSelector"] = selector_string(label_selector)
        data = self.transport.request(
            "GET", f"/api/v1/namespaces/{ns}/pods", query=query or None
        )
        return [Pod(item) for item in data.get("items", [])]

    def get_pod(self, name: str, namespace: Optional[str] = None) -> Optional[Pod]:
        ns = namespace or self.default_namespace
        try:
            return Pod(self.transport.request("GET", f"/api/v1/namespaces/{ns}/pods/{name}"))
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def get_newest_running_pod(
        self,
        label_selector: dict[str, str],
        namespace: Optional[str] = None,
        timeout: float = 120.0,
        interval: float = 2.0,
    ) -> Pod:
        """Poll until the newest pod matching the selector is Running;
        short-circuits on critical statuses (reference:
        kubectl/client.go:171 GetNewestRunningPod)."""
        deadline = time.monotonic() + timeout
        last_status = "NotFound"
        while time.monotonic() < deadline:
            pods = self.list_pods(namespace, label_selector)
            if pods:
                newest = max(pods, key=lambda p: p.creation_timestamp)
                last_status = get_pod_status(newest)
                if last_status == "Running":
                    return newest
                if last_status in CRITICAL_STATUS:
                    raise RuntimeError(
                        f"pod {newest.name} has critical status: {last_status}"
                    )
            time.sleep(interval)
        raise TimeoutError(
            f"no running pod for selector {selector_string(label_selector)} "
            f"within {timeout}s (last status: {last_status})"
        )

    # -- GPU job -----------------------------------------------------------
    def slice_workers(
        self,
        label_selector: dict[str, str],
        namespace: Optional[str] = None,
        expected: Optional[int] = None,
        timeout: float = 120.0,
        interval: float = 2.0,
    ) -> list[Pod]:
        """Resolve the ordered worker pod list of a multi-host job: all
        Running pods matching the selector, sorted by
        :attr:`Pod.worker_id`. Waits until ``expected`` workers (or at
        least one) are Running."""
        deadline = time.monotonic() + timeout
        while True:
            pods = self.list_pods(namespace, label_selector)
            running = [p for p in pods if get_pod_status(p) == "Running"]
            # Only pods that can still become Running count toward the target
            # (a Completed init Job or Terminating predecessor must not).
            active = [
                p
                for p in pods
                if get_pod_status(p)
                not in ("Succeeded", "Completed", "Terminating")
            ]
            want = expected if expected is not None else (len(active) or 1)
            if len(running) >= want and running:
                running.sort(
                    key=lambda p: (
                        p.worker_id if p.worker_id is not None else 1 << 30,
                        p.name,
                    )
                )
                return running
            for p in pods:
                st = get_pod_status(p)
                if st in CRITICAL_STATUS:
                    raise RuntimeError(f"slice worker {p.name} is {st}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {len(running)}/{want} slice workers Running "
                    f"after {timeout}s"
                )
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
        return self.connections.track(
            kexec.exec_stream(
                self.transport, name, ns, command,
                container=container, tty=tty, stdin=stdin,
            )
        )

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
        return kexec.exec_buffered(
            self.transport, name, ns, command, container=container, timeout=timeout
        )

    def attach_stream(
        self,
        pod: Pod | str,
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        tty: bool = False,
        stdin: bool = False,
    ) -> RemoteProcess:
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        return self.connections.track(
            kexec.attach_stream(
                self.transport, name, ns, container=container, tty=tty, stdin=stdin
            )
        )

    def logs(
        self,
        pod: Pod | str,
        namespace: Optional[str] = None,
        container: Optional[str] = None,
        tail: Optional[int] = None,
        follow: bool = False,
        previous: bool = False,
    ) -> Iterator[bytes]:
        """Stream pod logs (reference: kubectl/logs.go)."""
        name = pod.name if isinstance(pod, Pod) else pod
        ns = (
            pod.namespace
            if isinstance(pod, Pod)
            else (namespace or self.default_namespace)
        )
        query: dict[str, str] = {}
        if container:
            query["container"] = container
        if tail is not None:
            query["tailLines"] = str(tail)
        if follow:
            query["follow"] = "true"
        if previous:
            query["previous"] = "true"
        return self.transport.stream_lines(
            f"/api/v1/namespaces/{ns}/pods/{name}/log", query=query or None
        )

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
        fw = PortForwarder(
            dial=lambda remote: WSPortTunnel(self.transport, name, ns, remote),
            ports=ports,
            bind_address=bind_address,
            logger=self.log,
        )
        return fw

    # -- path translation --------------------------------------------------
    def translate_path(
        self, pod: Pod | str, container_path: str, namespace: Optional[str] = None
    ) -> str:
        """Identity for the real backend; the fake backend maps container
        paths onto per-pod local dirs."""
        return container_path

    # -- generic objects (used by the deploy engines) ----------------------
    def apply(self, manifest: dict, namespace: Optional[str] = None) -> dict:
        """Server-side apply (the modern 'kubectl apply'; reference shells
        out to kubectl apply --force -f -, deploy/kubectl/kubectl.go:105)."""
        api, kind, name, ns = _object_coords(manifest, namespace or self.default_namespace)
        path = _object_path(api, kind, name, ns)
        import json as _json

        return self.transport.request(
            "PATCH",
            path,
            query={"fieldManager": "devspace", "force": "true"},
            body=_json.dumps(manifest),
            content_type="application/apply-patch+yaml",
        )

    def delete_object(self, manifest: dict, namespace: Optional[str] = None) -> bool:
        api, kind, name, ns = _object_coords(manifest, namespace or self.default_namespace)
        try:
            self.transport.request("DELETE", _object_path(api, kind, name, ns))
            return True
        except ApiError as e:
            if e.status == 404:
                return False
            raise

    def get_object(
        self, api_version: str, kind: str, name: str, namespace: Optional[str] = None
    ) -> Optional[dict]:
        ns = namespace or self.default_namespace
        try:
            return self.transport.request(
                "GET", _object_path(api_version, kind, name, ns)
            )
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def create_pod(self, manifest: dict, namespace: Optional[str] = None) -> Pod:
        ns = manifest.get("metadata", {}).get("namespace") or namespace or self.default_namespace
        return Pod(
            self.transport.request("POST", f"/api/v1/namespaces/{ns}/pods", body=manifest)
        )

    def delete_pod(self, name: str, namespace: Optional[str] = None) -> None:
        ns = namespace or self.default_namespace
        try:
            self.transport.request("DELETE", f"/api/v1/namespaces/{ns}/pods/{name}")
        except ApiError as e:
            if e.status != 404:
                raise

    def list_events(
        self, namespace: Optional[str] = None, field_selector: Optional[str] = None
    ) -> list[dict]:
        ns = namespace or self.default_namespace
        query = {"fieldSelector": field_selector} if field_selector else None
        data = self.transport.request(
            "GET", f"/api/v1/namespaces/{ns}/events", query=query
        )
        return data.get("items", [])


# Cluster-scoped kinds we may touch; everything else is namespaced.
_CLUSTER_SCOPED = {
    "Namespace",
    "ClusterRole",
    "ClusterRoleBinding",
    "CustomResourceDefinition",
    "PersistentVolume",
    "StorageClass",
    "PriorityClass",
}

_KIND_PLURALS = {
    "Endpoints": "endpoints",
    "NetworkPolicy": "networkpolicies",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "Ingress": "ingresses",
    "ConfigMap": "configmaps",
}


def _plural(kind: str) -> str:
    if kind in _KIND_PLURALS:
        return _KIND_PLURALS[kind]
    lower = kind.lower()
    if lower.endswith("s") or lower.endswith("x") or lower.endswith("ch"):
        return lower + "es"
    if lower.endswith("y"):
        return lower[:-1] + "ies"
    return lower + "s"


def _object_coords(manifest: dict, default_ns: str) -> tuple[str, str, str, Optional[str]]:
    api = manifest.get("apiVersion", "v1")
    kind = manifest.get("kind", "")
    meta = manifest.get("metadata", {})
    name = meta.get("name", "")
    if not kind or not name:
        raise ValueError(f"manifest missing kind or metadata.name: {manifest.get('kind')}")
    ns = None if kind in _CLUSTER_SCOPED else (meta.get("namespace") or default_ns)
    return api, kind, name, ns


def _object_path(api: str, kind: str, name: str, ns: Optional[str]) -> str:
    prefix = f"/api/{api}" if "/" not in api else f"/apis/{api}"
    if ns:
        return f"{prefix}/namespaces/{ns}/{_plural(kind)}/{name}"
    return f"{prefix}/{_plural(kind)}/{name}"
