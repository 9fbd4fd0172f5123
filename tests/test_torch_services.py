"""The port's dev-session services (devspace_tpu_torch/services/) on its
fake cluster: the cases of tests/test_resilience_chaos.py for pod
resolution, port forwarding, the log mux and sync under injected faults
(each ``chaos``-marked, as there), then ``resolve_workers`` waiting for
the ``gpu`` block's worker count and ordering by ``Pod.worker_id``,
``worker_prefix`` on that id, and ``broadcast_exec`` across the workers."""

import io
import os
import socket
import threading
import time

import pytest

from devspace_tpu_torch.config import latest
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.resilience import ChaosConfig, ChaosError, RetryPolicy
from devspace_tpu_torch.resilience.chaos import ByteBudgetStream
from devspace_tpu_torch.services.selectors import resolve_workers
from devspace_tpu_torch.services.sessions import LogMux
from devspace_tpu_torch.sync.session import SyncOptions, SyncSession
from devspace_tpu_torch.sync.shell import SyncError
from devspace_tpu_torch.utils.fsutil import write_file


def wait_for(cond, timeout=15.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def cluster(tmp_path):
    return FakeCluster(str(tmp_path / "cluster"))


def make_session(tmp_path, cluster, n_workers=2, **opt_kw):
    local = tmp_path / "local"
    local.mkdir(exist_ok=True)
    workers = [
        cluster.add_pod(f"w-{i}", labels={"app": "t"}, worker_id=i)
        for i in range(n_workers)
    ]
    opts = SyncOptions(
        local_path=str(local),
        container_path="/app",
        upstream_quiet=0.15,
        upstream_tick=0.05,
        downstream_interval=0.05,
        **opt_kw,
    )
    return SyncSession(cluster, workers, opts), local, workers


def remote_path(cluster, worker, rel):
    return os.path.join(cluster.translate_path(worker, "/app"), rel)


# -- pod resolution under chaos -------------------------------------------
@pytest.mark.chaos
def test_resolve_workers_retries_transient_chaos(cluster):
    for i in range(2):
        cluster.add_pod(f"w-{i}", labels={"app": "t"}, worker_id=i)
    cluster.chaos = ChaosConfig()
    cluster.chaos.fail_next("slice_workers", count=2)
    policy = RetryPolicy(max_attempts=3, base_delay=0.01, retry_on=(ConnectionError,))
    workers, ns, _ = resolve_workers(
        cluster, latest.Config(), label_selector={"app": "t"}, retry_policy=policy
    )
    assert [w.name for w in workers] == ["w-0", "w-1"]
    assert cluster.chaos.calls["slice_workers"] == ["fail", "fail", "ok"]


@pytest.mark.chaos
def test_resolve_workers_permanent_failure_raises_original_type(cluster):
    cluster.add_pod("w-0", labels={"app": "t"}, worker_id=0)
    cluster.chaos = ChaosConfig()
    cluster.chaos.fail_always("slice_workers")
    policy = RetryPolicy(max_attempts=2, base_delay=0.01, retry_on=(ConnectionError,))
    with pytest.raises(ChaosError):  # reraise=True keeps the original type
        resolve_workers(
            cluster, latest.Config(), label_selector={"app": "t"}, retry_policy=policy
        )
    assert cluster.chaos.failures_injected("slice_workers") == 2


# -- port-forward under chaos ----------------------------------------------
def _echo_server():
    """Local TCP server answering echo:<payload> once per connection."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            data = conn.recv(1024)
            if data:
                conn.sendall(b"echo:" + data)
            conn.close()

    threading.Thread(target=serve, daemon=True).start()

    def close():
        stop.set()
        srv.close()

    return srv.getsockname()[1], close


@pytest.mark.chaos
def test_portforward_dial_recovers_from_transient_drops(cluster):
    port, close_srv = _echo_server()
    try:
        cluster.add_pod("srv")
        cluster.expose_port("srv", 8080, port)
        cluster.chaos = ChaosConfig()
        # dial policy allows 3 attempts: 2 injected failures still succeed
        cluster.chaos.fail_next("portforward_dial", count=2)
        fw = cluster.portforward("srv", [(0, 8080)])
        fw.start()
        assert fw.ready.wait(5)
        with socket.create_connection(
            ("127.0.0.1", fw.local_ports[0]), timeout=5
        ) as s:
            s.sendall(b"ping")
            assert s.recv(1024) == b"echo:ping"
        assert cluster.chaos.calls["portforward_dial"] == ["fail", "fail", "ok"]
        assert fw.alive()
        fw.stop()
    finally:
        close_srv()


@pytest.mark.chaos
def test_portforward_permanent_dial_failure_degrades_not_crashes(cluster):
    port, close_srv = _echo_server()
    try:
        cluster.add_pod("srv")
        cluster.expose_port("srv", 8080, port)
        cluster.chaos = ChaosConfig()
        cluster.chaos.fail_always("portforward_dial")
        fw = cluster.portforward("srv", [(0, 8080)])
        fw.start()
        assert fw.ready.wait(5)
        # Documented degraded outcome: the local connection is closed after
        # the dial budget is spent; the listener itself stays up.
        with socket.create_connection(
            ("127.0.0.1", fw.local_ports[0]), timeout=5
        ) as s:
            s.settimeout(5)
            try:
                assert s.recv(1024) == b""
            except (ConnectionResetError, BrokenPipeError):
                pass
        assert cluster.chaos.failures_injected("portforward_dial") == 3
        assert fw.alive()  # listener still accepting — not dead, degraded
        # and a later connection recovers once the fault clears
        cluster.chaos.clear("portforward_dial")
        with socket.create_connection(
            ("127.0.0.1", fw.local_ports[0]), timeout=5
        ) as s:
            s.sendall(b"back")
            assert s.recv(1024) == b"echo:back"
        fw.stop()
    finally:
        close_srv()


# -- log mux under chaos ---------------------------------------------------
@pytest.mark.chaos
def test_logmux_reconnects_after_stream_drops(cluster):
    pod = cluster.add_pod("w-0", labels={"app": "t"}, worker_id=0)
    cluster.set_logs("w-0", ["line1", "line2"])
    cluster.chaos = ChaosConfig()
    cluster.chaos.fail_next("logs", count=2)
    out = io.StringIO()
    mux = LogMux(
        cluster,
        [pod],
        "default",
        out=out,
        retry_policy=RetryPolicy(max_attempts=4, base_delay=0.01, max_delay=0.02),
    )
    mux.follow()
    wait_for(lambda: "line2" in out.getvalue(), msg="lines after reconnects")
    mux.stop()
    assert mux.reconnects.get("w-0") == 2
    assert out.getvalue().count("line1") == 1  # no replay duplication
    assert "[worker-0]" in out.getvalue()


@pytest.mark.chaos
def test_logmux_gives_up_after_reconnect_budget(cluster):
    pod = cluster.add_pod("w-0", labels={"app": "t"}, worker_id=0)
    cluster.set_logs("w-0", ["never seen"])
    cluster.chaos = ChaosConfig()
    cluster.chaos.fail_always("logs")
    out = io.StringIO()
    mux = LogMux(
        cluster,
        [pod],
        "default",
        out=out,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.01),
    )
    mux.follow()
    # budget: 1 reconnect after the initial attempt, then give up
    wait_for(
        lambda: cluster.chaos.failures_injected("logs") == 2,
        msg="both attempts consumed",
    )
    time.sleep(0.1)
    mux.stop()
    assert out.getvalue() == ""
    assert mux.reconnects.get("w-0") == 1


# -- sync upstream under chaos ---------------------------------------------
@pytest.mark.chaos
def test_sync_upstream_drop_mid_upload_recovers(tmp_path, cluster):
    """A mirror worker's upstream connection drops mid-upload (byte budget
    spent): the fan-out revives the shell and the upload lands anyway."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    session.start()
    try:
        write_file(str(local / "warm.txt"), "warm")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "warm.txt")),
                msg="warm-up fan-out",
            )
        # Arm the drop on worker 1's live shell: the very next stdin write
        # kills the connection, exactly like a transport drop mid-upload.
        session._shells[1].proc = ByteBudgetStream(session._shells[1].proc, 0)
        write_file(str(local / "after_drop.txt"), "recovered")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(
                    remote_path(cluster, w, "after_drop.txt")
                ),
                msg="upload after drop",
            )
        assert session.error is None
        assert 1 not in session.worker_errors  # revived, not quarantined
    finally:
        session.stop()
    assert session.error is None


@pytest.mark.chaos
def test_kill_pod_quarantines_mirror_session_continues(tmp_path, cluster):
    """kill_pod mid-session: the mirror's streams die AND the pod is gone,
    so revive fails — documented outcome is quarantine + degraded fan-out,
    never a dead session."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    session.start()
    try:
        write_file(str(local / "base.txt"), "v1")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "base.txt")),
                msg="initial fan-out",
            )
        killed = cluster.kill_pod("w-1")
        assert killed >= 1  # its exec stream(s) were severed
        write_file(str(local / "later.txt"), "still flowing")
        wait_for(
            lambda: os.path.exists(remote_path(cluster, workers[0], "later.txt")),
            msg="upload to surviving authority",
        )
        wait_for(lambda: 1 in session.worker_errors, msg="mirror quarantined")
        assert session.error is None
    finally:
        session.stop()
    assert session.error is None


# -- sync downstream poll under chaos --------------------------------------
@pytest.mark.chaos
def test_downstream_poll_transient_failures_recover(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=1)
    session.start()
    try:
        orig = session._down_shell.snapshot
        calls = {"n": 0}

        def flaky(path):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise SyncError("chaos: poll dropped")
            return orig(path)

        session._down_shell.snapshot = flaky
        w0 = cluster.translate_path(workers[0], "/app")
        write_file(os.path.join(w0, "from_remote.txt"), "hello")
        wait_for(
            lambda: (local / "from_remote.txt").exists(),
            msg="download despite poll failures",
        )
        assert calls["n"] >= 3
        assert session.error is None
    finally:
        session.stop()
    assert session.error is None


@pytest.mark.chaos
def test_downstream_poll_exhaustion_is_fatal(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=1)
    session.start()
    try:
        def always_fail(path):
            raise SyncError("chaos: poll dropped for good")

        session._down_shell.snapshot = always_fail
        # policy budget: 5 attempts with interval-derived backoff, then the
        # session dies with the underlying error (documented fatal outcome)
        wait_for(
            lambda: session.error is not None,
            timeout=20.0,
            msg="fatal after poll budget",
        )
        assert "poll dropped" in str(session.error)
        assert session._stopped.is_set()
    finally:
        session.stop()


# -- the port's job: the gpu block's worker count, Pod.worker_id --------------
def test_resolve_workers_waits_for_the_gpu_blocks_workers_in_worker_id_order(cluster):
    """``resolve_workers`` waits for ``gpu.workers`` Running pods and orders
    them by ``Pod.worker_id`` (``NODE_RANK``), not by name."""
    cfg = latest.Config(gpu=latest.GPUConfig(workers=3),
                        deployments=[latest.DeploymentConfig(name="t")])
    cluster.add_pod("b-0", labels={"app": "t"}, worker_id=1)
    cluster.add_pod("a-1", labels={"app": "t"}, worker_id=0)
    once = RetryPolicy(max_attempts=1)
    with pytest.raises(TimeoutError):
        resolve_workers(cluster, cfg, timeout=0.3, retry_policy=once)
    timer = threading.Timer(0.2, cluster.add_pod, ("c-9",),
                            {"labels": {"app": "t"}, "worker_id": 2})
    timer.start()
    try:
        workers, ns, container = resolve_workers(cluster, cfg, timeout=10, retry_policy=once)
    finally:
        timer.join()
    assert [w.name for w in workers] == ["a-1", "b-0", "c-9"]
    assert [w.worker_id for w in workers] == [0, 1, 2]
    assert (ns, container) == ("default", None)


def test_worker_prefix_reads_the_pods_worker_id(cluster):
    """``[worker-N]`` from ``NODE_RANK``, from the pod-index label alone
    (a StatefulSet pod the job did not wire), from the name's ordinal;
    the pod's name where it has none. A JAX-package pod with the same
    worker id gets the same prefix from the JAX package."""
    from devspace_tpu.kube.fake import FakeCluster as JFakeCluster
    from devspace_tpu.services.sessions import worker_prefix as jworker_prefix
    from devspace_tpu_torch.kube.client import POD_INDEX_LABEL
    from devspace_tpu_torch.services.sessions import worker_prefix

    ranked = cluster.add_pod("job-a", worker_id=3)
    labelled = cluster.add_pod("job-b", labels={POD_INDEX_LABEL: "5"})
    ordinal = cluster.add_pod("job-7")
    plain = cluster.add_pod("web-abc")
    assert [worker_prefix(p) for p in (ranked, labelled, ordinal, plain)] == [
        "[worker-3] ", "[worker-5] ", "[worker-7] ", "[web-abc] "]
    jcluster = JFakeCluster(str(cluster.root) + "-jax")
    assert jworker_prefix(jcluster.add_pod("job-a", worker_id=3)) == worker_prefix(ranked)
    assert jworker_prefix(jcluster.add_pod("web-abc")) == worker_prefix(plain)


def test_broadcast_exec_runs_on_every_worker_with_prefixed_output(cluster, capsys):
    """``broadcast_exec`` runs the command in every worker (the fake runs it
    in the pod's directory), prefixes each line with the worker, and
    returns the first non-zero exit code."""
    from devspace_tpu_torch.services.sessions import broadcast_exec

    cfg = latest.Config(deployments=[latest.DeploymentConfig(name="t")])
    for i in range(3):
        cluster.add_pod(f"t-{i}", labels={"app": "t"}, worker_id=i)
    assert broadcast_exec(cluster, cfg, ["sh", "-c", "echo hi; pwd; echo oops >&2"]) == 0
    out, err = capsys.readouterr()
    lines = sorted(out.splitlines())
    assert [ln for ln in lines if ln.endswith("hi")] == [
        f"[worker-{i}] hi" for i in range(3)]
    for i in range(3):
        assert f"[worker-{i}] {cluster.pod_dir(f't-{i}')}" in lines
        assert f"[worker-{i}] oops" in err.splitlines()
    assert broadcast_exec(cluster, cfg, ["sh", "-c", "exit 3"]) == 3
    capsys.readouterr()
