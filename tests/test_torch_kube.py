"""The port's kube/ against the JAX package's: the websocket frames, the
kubeconfig parse, pod statuses, the requests the REST transport sends,
and the fake cluster's state file, each on the same inputs in both; the
JAX package's own kube tests run on the port; and the port's one
intended difference, the fake's NODE_RANK and pod-index synthesis for a
chart-gpu StatefulSet."""

import copy
import dataclasses
import http.server
import json
import socket
import threading

import pytest

from devspace_tpu.kube import fake as jfake
from devspace_tpu.kube import kubeconfig as jkubeconfig
from devspace_tpu.kube import websocket as jws
from devspace_tpu.kube.client import KubeClient as JKubeClient
from devspace_tpu.kube.client import Pod as JPod
from devspace_tpu.kube.client import get_pod_status as jget_pod_status
from devspace_tpu.kube.transport import KubeTransport as JKubeTransport
from devspace_tpu_torch.kube import websocket as ws
from devspace_tpu_torch.kube.client import (
    POD_INDEX_FIELD,
    POD_INDEX_LABEL,
    KubeClient,
    Pod,
    get_pod_status,
)
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.kube.kubeconfig import ClusterInfo, ContextInfo, KubeConfig, UserInfo
from devspace_tpu_torch.kube.streams import StreamBuffer, StreamClosed, SubprocessRemoteProcess
from devspace_tpu_torch.kube.transport import ApiError, KubeTransport
from devspace_tpu_torch.resilience.chaos import ChaosConfig, ChaosError


# -- websocket: the same frames --------------------------------------------------
@pytest.mark.parametrize("size", [0, 5, 125, 126, 65535, 65536, 70000])
@pytest.mark.parametrize("opcode,mask,fin", [(jws.OP_BINARY, True, True),
                                             (jws.OP_TEXT, False, True),
                                             (jws.OP_PING, True, False)])
def test_websocket_frames_equal_the_reference(monkeypatch, size, opcode, mask, fin):
    """Byte-equal frames for the same payload, the mask key fixed in both
    (``os.urandom`` is the one source of it)."""
    payload = bytes(i * 7 % 251 for i in range(size))
    monkeypatch.setattr(jws.os, "urandom", lambda n: bytes(range(1, n + 1)))
    want = jws.encode_frame(opcode, payload, mask=mask, fin=fin)
    got = ws.encode_frame(opcode, payload, mask=mask, fin=fin)
    assert got == want
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == jws.accept_key(
        "dGhlIHNhbXBsZSBub25jZQ==")


def _ws_pair():
    """Connected (client WebSocket, server WebSocket) over a local TCP
    connection with a real handshake."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    result = {}

    def server():
        conn, _ = lsock.accept()
        _, rest = ws.server_handshake(conn)
        result["server"] = ws.WebSocket(conn, is_client=False, prebuffer=rest)

    t = threading.Thread(target=server)
    t.start()
    csock = socket.create_connection(("127.0.0.1", port))
    proto, rest = ws.client_handshake(csock, "127.0.0.1", "/", subprotocols=["v4.channel.k8s.io"])
    t.join()
    lsock.close()
    assert proto == "v4.channel.k8s.io"
    return ws.WebSocket(csock, is_client=True, prebuffer=rest), result["server"]


def test_websocket_echo_large_frames_and_ping():
    client, server = _ws_pair()
    client.send(b"hello")
    assert server.recv_message()[1] == b"hello"
    big = bytes(range(256)) * 1024  # 256 KiB: the 64-bit length path
    server.send(big)
    assert client.recv_message()[1] == big
    server.send(b"ping-me", ws.OP_PING)
    server.send(b"data")
    assert client.recv_message()[1] == b"data"
    op, payload, _ = server.recv_frame()  # the client answered the ping
    assert op == ws.OP_PONG and payload == b"ping-me"
    client.close()
    server.close()


def test_ws_exec_channel_demux():
    """v4.channel.k8s.io: stdout, stderr and the exit status demuxed by
    ``WSRemoteProcess``; stdin leaves on channel 0."""
    from devspace_tpu_torch.kube.exec import WSRemoteProcess

    client, server = _ws_pair()
    proc = WSRemoteProcess(client)
    server.send(bytes([1]) + b"out-data")
    server.send(bytes([2]) + b"err-data")
    proc.write_stdin(b"input")
    assert server.recv_message()[1] == bytes([0]) + b"input"
    status = json.dumps({"status": "Failure", "reason": "NonZeroExitCode",
                         "details": {"causes": [{"reason": "ExitCode", "message": "42"}]}})
    server.send(bytes([3]) + status.encode())
    assert proc.stdout.read_exact(8, timeout=5) == b"out-data"
    assert proc.stderr.read_exact(8, timeout=5) == b"err-data"
    server.close()
    assert proc.wait(5) == 42


# -- streams ---------------------------------------------------------------------
def test_stream_buffer_and_subprocess_remote_process():
    buf = StreamBuffer()
    buf.feed(b"abcSTART123")
    assert buf.read_until([b"START"], timeout=1) == (b"abc", b"START")
    assert buf.read_exact(3, timeout=1) == b"123"
    with pytest.raises(TimeoutError):
        buf.read_until([b"X"], timeout=0.05)
    buf.close()
    with pytest.raises(StreamClosed):
        buf.read_exact(1, timeout=1)
    proc = SubprocessRemoteProcess(["sh"])
    proc.write_stdin(b"echo hello; echo err >&2\n")
    assert proc.stdout.read_until([b"\n"], timeout=5)[0] == b"hello"
    assert proc.stderr.read_until([b"\n"], timeout=5)[0] == b"err"
    proc.write_stdin(b"exit 3\n")
    assert proc.wait(5) == 3


# -- kubeconfig ------------------------------------------------------------------
KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: dev
clusters:
- name: c1
  cluster:
    server: https://1.2.3.4:6443
    certificate-authority-data: UEVN
- name: c2
  cluster:
    server: http://127.0.0.1:8001
    insecure-skip-tls-verify: true
users:
- name: u1
  user:
    token: tok123
- name: u2
  user:
    username: admin
    password: secret
contexts:
- name: dev
  context: {cluster: c1, user: u1, namespace: ns1}
- name: local
  context: {cluster: c2, user: u2}
"""


def test_kubeconfig_parses_to_the_same_contexts(tmp_path):
    path = tmp_path / "config"
    path.write_text(KUBECONFIG)
    want, got = jkubeconfig.KubeConfig.load(str(path)), KubeConfig.load(str(path))
    assert got.current_context == want.current_context == "dev"
    for field in ("clusters", "users", "contexts"):
        assert ({k: dataclasses.asdict(v) for k, v in getattr(got, field).items()}
                == {k: dataclasses.asdict(v) for k, v in getattr(want, field).items()})
    for name in (None, "dev", "local"):
        assert ([dataclasses.asdict(p) for p in got.resolve(name)]
                == [dataclasses.asdict(p) for p in want.resolve(name)])
    with pytest.raises(KeyError):
        got.resolve("nope")


def test_kubeconfig_roundtrip(tmp_path):
    kc = KubeConfig(path=str(tmp_path / "config"))
    kc.clusters["c1"] = ClusterInfo(server="https://1.2.3.4:6443", ca_data=b"PEM")
    kc.users["u1"] = UserInfo(token="tok123")
    kc.contexts["ctx1"] = ContextInfo(cluster="c1", user="u1", namespace="ns1")
    kc.current_context = "ctx1"
    kc.save()
    cluster, user, ctx = KubeConfig.load(str(tmp_path / "config")).resolve()
    assert (cluster.server, cluster.ca_data) == ("https://1.2.3.4:6443", b"PEM")
    assert (user.token, ctx.namespace) == ("tok123", "ns1")
    # and the reference reads what the port wrote
    assert jkubeconfig.KubeConfig.load(str(tmp_path / "config")).resolve()[0].ca_data == b"PEM"


# -- pod status ------------------------------------------------------------------
def _status(**status):
    return {"metadata": {"name": "p"}, "spec": {}, "status": status}


POD_TABLE = [
    _status(phase="Pending"),
    _status(phase="Running", containerStatuses=[{"ready": True, "state": {"running": {}}}]),
    _status(phase="Running", containerStatuses=[{"ready": False, "state": {"running": {}}}]),
    _status(phase="Running"),
    _status(phase="Running", containerStatuses=[
        {"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]),
    _status(phase="Pending", containerStatuses=[
        {"ready": False, "state": {"waiting": {"reason": "ImagePullBackOff"}}}]),
    _status(phase="Failed", containerStatuses=[
        {"state": {"terminated": {"exitCode": 137, "reason": "OOMKilled"}}}]),
    _status(phase="Failed", containerStatuses=[{"state": {"terminated": {"exitCode": 2}}}]),
    _status(phase="Succeeded", containerStatuses=[{"state": {"terminated": {"exitCode": 0}}}]),
    _status(phase="Pending", initContainerStatuses=[
        {"state": {"terminated": {"exitCode": 1, "reason": "Error"}}}]),
    _status(phase="Pending", initContainerStatuses=[
        {"state": {"waiting": {"reason": "PodInitializing"}}}]),
    _status(phase="Pending", initContainerStatuses=[
        {"state": {"waiting": {"reason": "ErrImagePull"}}}]),
    _status(phase="Failed", reason="Evicted"),
    {"metadata": {"name": "p", "deletionTimestamp": "2026-01-01T00:00:00Z"},
     "status": {"phase": "Running"}},
    {"metadata": {"name": "p"}},
]


@pytest.mark.parametrize("i", range(len(POD_TABLE)))
def test_pod_status_equals_the_reference(i):
    manifest = POD_TABLE[i]
    assert get_pod_status(Pod(copy.deepcopy(manifest))) == jget_pod_status(JPod(manifest))


def test_pod_status_derivation():
    assert get_pod_status(Pod(POD_TABLE[0])) == "Pending"
    assert get_pod_status(Pod(POD_TABLE[1])) == "Running"
    assert get_pod_status(Pod(POD_TABLE[4])) == "CrashLoopBackOff"
    assert get_pod_status(Pod(POD_TABLE[13])) == "Terminating"


@pytest.mark.parametrize("manifest,want", [
    ({"metadata": {"name": "w-7"}, "spec": {"containers": [
        {"name": "main", "env": [{"name": "NODE_RANK", "value": "3"}]}]}}, (3, True)),
    ({"metadata": {"name": "w-7", "labels": {POD_INDEX_LABEL: "2"}},
      "spec": {"containers": [{"name": "main", "env": [
          {"name": "NODE_RANK", "valueFrom": {"fieldRef": {"fieldPath": POD_INDEX_FIELD}}}]}]}},
     (2, True)),
    ({"metadata": {"name": "w-7", "labels": {POD_INDEX_LABEL: "4"}}}, (4, False)),
    ({"metadata": {"name": "w-7", "annotations": {POD_INDEX_LABEL: "5"}}}, (5, False)),
    ({"metadata": {"name": "w-7"}}, (7, False)),
    ({"metadata": {"name": "worker"}}, (None, False)),
])
def test_worker_id_reads_what_chart_gpu_wires(manifest, want):
    """NODE_RANK from the env, then the pod-index label or annotation,
    then the name's ordinal; only a NODE_RANK entry (chart-gpu's wiring)
    is an explicit identity, since every StatefulSet pod has the label
    and the ordinal."""
    pod = Pod(manifest)
    assert (pod.worker_id, pod.has_explicit_worker_identity) == want


# -- the REST transport ----------------------------------------------------------
def _pod_item(name, rank):
    return {"metadata": {"name": name, "namespace": "default", "labels": {"app": "x"},
                         "creationTimestamp": f"2026-01-01T00:00:0{rank}Z"},
            "status": {"phase": "Running", "containerStatuses": [{"ready": True, "state": {}}]},
            "spec": {"containers": [{"name": "main", "env": [
                {"name": "NODE_RANK", "value": str(rank)}]}]}}


class _Recorder(http.server.BaseHTTPRequestHandler):
    """An API server that records every request and answers GET pod
    lists with two workers, a missing path with a 404, anything else
    with an echo."""

    log: list = []

    def log_message(self, *a):
        pass

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        self.log.append((self.command, self.path, self.headers.get("Authorization"),
                         self.headers.get("Content-Type"), self.headers.get("Accept"), body))
        if self.path.startswith("/api/v1/namespaces/default/pods"):
            status, out = 200, {"items": [_pod_item("w-1", 1), _pod_item("w-0", 0)]}
        elif self.path.startswith("/nope"):
            status, out = 404, {"message": "not found"}
        else:
            status, out = 200, {"echo": self.path}
        data = json.dumps(out).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = do_PATCH = do_DELETE = _answer


@pytest.fixture
def http_api():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    _Recorder.log = []
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def _drive(client_cls, transport_cls, url):
    """The same calls through one package's client; what it returned."""
    client = client_cls(transport_cls(url, token="t", default_namespace="default"))
    out = [sorted(p.name for p in client.list_pods(label_selector={"app": "x", "tier": "a"}))]
    out.append(client.apply({"apiVersion": "apps/v1", "kind": "StatefulSet",
                             "metadata": {"name": "job"}, "spec": {"replicas": 2}}))
    out.append(client.get_object("v1", "ConfigMap", "devspace-release-job", "ns2"))
    out.append(client.delete_object({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                                     "metadata": {"name": "job"}}))
    out.append(client.create_pod({"metadata": {"name": "k"}, "spec": {}}).name)
    out.append(client.list_events(field_selector="type=Warning"))
    with pytest.raises(Exception) as ei:
        client.transport.request("GET", "/nope")
    out.append((type(ei.value).__name__, ei.value.status))
    return out


def test_transport_sends_the_same_requests(http_api):
    want = _drive(JKubeClient, JKubeTransport, http_api)
    sent_by_reference = list(_Recorder.log)
    _Recorder.log.clear()
    got = _drive(KubeClient, KubeTransport, http_api)
    assert _Recorder.log == sent_by_reference and len(sent_by_reference) == 7
    assert got == want


def test_transport_rest_and_slice_ordering(http_api):
    client = KubeClient(KubeTransport(http_api, token="t"))
    assert {p.name for p in client.list_pods()} == {"w-0", "w-1"}
    workers = client.slice_workers({"app": "x"}, timeout=5)
    assert [p.name for p in workers] == ["w-0", "w-1"]
    assert [p.worker_id for p in workers] == [0, 1]
    with pytest.raises(ApiError) as ei:
        client.transport.request("GET", "/nope")
    assert ei.value.status == 404


class _RecordingTransport:
    default_namespace = "default"

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def request(self, method, path, body=None, **kw):
        self.calls.append((method, path, body))
        resp = self.responses.pop(0)
        if isinstance(resp, Exception):
            raise resp
        return resp


def test_ensure_cluster_admin_binding():
    """GET 404 -> POST a sanitised binding; an existing binding, a 403 or
    no account -> nothing more; a connection failure is swallowed and the
    attempt, like success, made once per client."""
    transport = _RecordingTransport([ApiError(404, "nf"), {}])
    client = KubeClient(transport)
    client.ensure_cluster_admin_binding(account="Dev@Example.com")
    client.ensure_cluster_admin_binding(account="Dev@Example.com")
    assert [c[0] for c in transport.calls] == ["GET", "POST"]
    body = transport.calls[1][2]
    assert body["metadata"]["name"] == "devspace-user-dev-example.com"
    assert body["subjects"][0]["name"] == "Dev@Example.com"
    assert body["roleRef"]["name"] == "cluster-admin"
    for responses, account, want in (([{}], "a@b.c", ["GET"]),
                                     ([ApiError(403, "forbidden")], "a@b.c", ["GET"]),
                                     ([OSError("unreachable")], "a@b.c", ["GET"]),
                                     ([], "", [])):
        transport = _RecordingTransport(responses)
        KubeClient(transport).ensure_cluster_admin_binding(account=account)
        assert [c[0] for c in transport.calls] == want


# -- the fake cluster ------------------------------------------------------------
def test_fake_cluster_pods_and_exec(tmp_path):
    fc = FakeCluster(str(tmp_path))
    fc.add_pod("w-1", labels={"app": "t"}, worker_id=1)
    fc.add_pod("w-0", labels={"app": "t"}, worker_id=0)
    workers = fc.slice_workers({"app": "t"}, expected=2, timeout=5)
    assert [p.worker_id for p in workers] == [0, 1]
    assert workers[0].labels == {"app": "t", POD_INDEX_LABEL: "0"}
    assert workers[1].container_env() == {"NODE_RANK": "1"}
    out, _, rc = fc.exec_buffered("w-0", ["sh", "-c", "echo hi"])
    assert rc == 0 and out.strip() == b"hi"
    out, _, _ = fc.exec_buffered("w-0", ["pwd"])
    assert out.decode().strip() == fc.pod_dir("w-0")
    proc = fc.exec_stream("w-0", ["sh", "-c", "sleep 60"])
    assert proc.poll() is None
    assert fc.connections.close_all() == 1
    assert proc.wait(5) is not None and fc.connections.close_all() == 0


def test_fake_portforward_roundtrip(tmp_path):
    echo = socket.socket()
    echo.bind(("127.0.0.1", 0))
    echo.listen(1)

    def serve():
        conn, _ = echo.accept()
        conn.sendall(b"echo:" + conn.recv(1024))
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    fc = FakeCluster(str(tmp_path))
    fc.add_pod("srv")
    fc.expose_port("srv", 8080, echo.getsockname()[1])
    fw = fc.portforward("srv", [(0, 8080)])
    fw.start()
    assert fw.ready.wait(5)
    with socket.create_connection(("127.0.0.1", fw.local_ports[0]), timeout=5) as s:
        s.sendall(b"ping")
        assert s.recv(1024) == b"echo:ping"
    fw.stop()
    echo.close()


def test_fake_cluster_chaos_hooks(tmp_path):
    """A scheduled failure raises ``ChaosError`` once, then the op runs; a
    killed pod takes its live streams with it."""
    fc = FakeCluster(str(tmp_path))
    fc.chaos = ChaosConfig()
    fc.add_pod("w-0", worker_id=0)
    fc.chaos.fail_next("exec_buffered")
    with pytest.raises(ChaosError):
        fc.exec_buffered("w-0", ["true"])
    assert fc.exec_buffered("w-0", ["true"])[2] == 0
    assert fc.chaos.calls["exec_buffered"] == ["fail", "ok"]
    proc = fc.exec_stream("w-0", ["sh", "-c", "sleep 60"])
    assert fc.kill_pod("w-0") == 1 and proc.wait(5) is not None
    assert fc.get_pod("w-0") is None


def _statefulset(name, replicas, env):
    return {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": name},
            "spec": {"replicas": replicas, "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {"containers": [{"name": "main", "env": env}]}}}}


NODE_RANK_FROM_INDEX = {"name": "NODE_RANK",
                        "valueFrom": {"fieldRef": {"fieldPath": POD_INDEX_FIELD}}}


def test_fake_synthesizes_node_rank_for_a_gpu_job(tmp_path):
    """chart-gpu's StatefulSet at ``gpu.workers: 2``: pod ``job-<i>``
    carries the pod-index label ``i`` and ``NODE_RANK=i``, as a
    StatefulSet controller and the kubelet give it; a literal env entry
    is copied; ``slice_workers`` orders by the index."""
    fc = FakeCluster(str(tmp_path))
    fc.apply(_statefulset("job", 2, [NODE_RANK_FROM_INDEX, {"name": "MODE", "value": "x"}]))
    workers = fc.slice_workers({"app": "job"}, expected=2, timeout=5)
    assert [p.name for p in workers] == ["job-0", "job-1"]
    assert [p.container_env() for p in workers] == [{"NODE_RANK": "0", "MODE": "x"},
                                                    {"NODE_RANK": "1", "MODE": "x"}]
    assert [p.labels[POD_INDEX_LABEL] for p in workers] == ["0", "1"]
    assert all(p.has_explicit_worker_identity for p in workers)
    # a one-worker job is a StatefulSet too: worker 0 is NODE_RANK 0
    fc.apply(_statefulset("solo", 1, [NODE_RANK_FROM_INDEX]))
    (solo,) = fc.slice_workers({"app": "solo"}, expected=1, timeout=5)
    assert solo.container_env() == {"NODE_RANK": "0"} and solo.worker_id == 0
    # a StatefulSet without the wiring gets its pod index, no NODE_RANK
    fc.apply(_statefulset("db", 2, []))
    assert not any(p.has_explicit_worker_identity
                   for p in fc.list_pods(label_selector={"app": "db"}))
    # a one-replica Deployment has no pod index: the fieldRef stays unresolved
    fc.apply({**_statefulset("web", 1, [NODE_RANK_FROM_INDEX]), "kind": "Deployment"})
    (web,) = fc.list_pods(label_selector={"app": "web"})
    assert web.container_env() == {} and POD_INDEX_LABEL not in web.labels
    fc.delete_object({"kind": "StatefulSet", "metadata": {"name": "job"}})
    assert fc.list_pods(label_selector={"app": "job"}) == []


def _state(fc):
    """A fake's pods and objects without the pods' creation times."""
    pods = copy.deepcopy(fc.pods)
    for m in pods.values():
        m["metadata"].pop("creationTimestamp")
    return pods, fc.objects, fc.namespaces


def _populate(fc):
    fc.ensure_namespace("ns2")
    fc.apply(_statefulset("trainer", 1, [{"name": "MODE", "value": "x"}]))
    fc.apply({"apiVersion": "v1", "kind": "Service", "metadata": {"name": "trainer"},
              "spec": {"clusterIP": "None"}})
    fc.apply({"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": "cm", "namespace": "ns2"}, "data": {"a": "1"}})
    fc.add_pod("solo", labels={"app": "solo"}, phase="Pending")


def test_fake_state_file_loads_in_both_directions(tmp_path):
    """``cluster-state.json`` written by the reference's fake loads in the
    port's with the same pods and objects, and the other way round."""
    ref = jfake.FakeCluster(str(tmp_path / "a"), persist=True)
    _populate(ref)
    ref.apply({"apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "web"},
               "spec": {"replicas": 2, "template": {"metadata": {"labels": {"app": "web"}},
                                                    "spec": {"containers": [{"name": "m"}]}}}})
    port = FakeCluster(str(tmp_path / "a"), persist=True)
    assert (port.pods, port.objects, port.namespaces) == (ref.pods, ref.objects, ref.namespaces)
    # the reference's worker ids live in TPU_WORKER_ID; the port orders the
    # same pods by their names' ordinals
    assert [p.name for p in port.slice_workers({"app": "web"}, expected=2, timeout=5)] == \
        [p.name for p in ref.slice_workers({"app": "web"}, expected=2, timeout=5)]

    port2 = FakeCluster(str(tmp_path / "b"), persist=True)
    _populate(port2)
    ref2 = jfake.FakeCluster(str(tmp_path / "b"), persist=True)
    assert (ref2.pods, ref2.objects, ref2.namespaces) == \
        (port2.pods, port2.objects, port2.namespaces)
    # both fakes synthesize the same pods from the same objects, but for
    # the port's pod index on the StatefulSet's pod (the reference stamps
    # a worker id only on multi-replica workloads)
    ref3 = jfake.FakeCluster(str(tmp_path / "c"))
    _populate(ref3)
    pods, objects, namespaces = _state(port2)
    assert objects == ref3.objects and namespaces == ref3.namespaces
    pods[("default", "trainer-0")]["metadata"]["labels"].pop(POD_INDEX_LABEL)
    assert pods == _state(ref3)[0]
