"""The port's sync engine (devspace_tpu_torch/sync/) on the port's fake
cluster: the cases of tests/test_sync.py, each worker a pod of a
chart-gpu job (``add_pod(worker_id=i)``: the pod-index label and
``NODE_RANK``); then parity with the JAX package's engine: the same local
tree, excludes and edits through both packages' ``SyncSession``, each
against its own fake, give equal remote trees on every worker and equal
``status_snapshot`` keys; ``build_tar`` gives the same archive as the JAX
package's Python path (``DEVSPACE_NATIVE=0``); ``FileInformation``
digests and the ignore matches are equal.

Mirrors the reference's strategy (sync/sync_config_test.go: TestInitialSync /
TestNormalSync build local+remote temp trees, run the real pipes, and
poll-assert convergence) — generalized to N fake workers per SURVEY §4.
"""

import os
import time

import pytest

from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.sync.session import SyncOptions, SyncSession, copy_to_container
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
    fc = FakeCluster(str(tmp_path / "cluster"))
    yield fc


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
        downstream_interval=0.15,
        **opt_kw,
    )
    session = SyncSession(cluster, workers, opts)
    return session, local, workers


def remote_path(cluster, worker, rel):
    return os.path.join(cluster.translate_path(worker, "/app"), rel)


def test_initial_sync_converges(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    now = time.time()
    # local-only file
    write_file(str(local / "local_only.txt"), "local")
    write_file(str(local / "sub" / "nested.txt"), "nested")
    # remote-only file on worker 0
    w0 = cluster.translate_path(workers[0], "/app")
    write_file(os.path.join(w0, "remote_only.txt"), "remote")
    # conflict: remote newer
    write_file(str(local / "conflict_remote_newer.txt"), "old local")
    os.utime(str(local / "conflict_remote_newer.txt"), (now - 100, now - 100))
    write_file(os.path.join(w0, "conflict_remote_newer.txt"), "new remote")
    # conflict: local newer
    write_file(str(local / "conflict_local_newer.txt"), "new local")
    write_file(os.path.join(w0, "conflict_local_newer.txt"), "old remote")
    os.utime(
        os.path.join(w0, "conflict_local_newer.txt"), (now - 100, now - 100)
    )
    session.start()
    try:
        # both sides converge; all workers mirror local
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "local_only.txt")),
                msg="upload fan-out",
            )
            assert (
                open(remote_path(cluster, w, "sub/nested.txt")).read() == "nested"
            )
            assert (
                open(remote_path(cluster, w, "conflict_local_newer.txt")).read()
                == "new local"
            )
        assert (local / "remote_only.txt").read_text() == "remote"
        assert (local / "conflict_remote_newer.txt").read_text() == "new remote"
    finally:
        session.stop()
    assert session.error is None


def test_upstream_create_modify_delete(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=3)
    session.start()
    try:
        write_file(str(local / "new.py"), "print(1)")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "new.py")),
                msg="create propagated",
            )
        # modify (bump mtime so the 1s-resolution protocol sees it)
        write_file(str(local / "new.py"), "print(2)")
        future = time.time() + 2
        os.utime(str(local / "new.py"), (future, future))
        for w in workers:
            wait_for(
                lambda w=w: open(remote_path(cluster, w, "new.py")).read()
                == "print(2)",
                msg="modify propagated",
            )
        # delete
        os.unlink(str(local / "new.py"))
        for w in workers:
            wait_for(
                lambda w=w: not os.path.exists(remote_path(cluster, w, "new.py")),
                msg="delete propagated",
            )
        # new directory tree
        write_file(str(local / "pkg" / "deep" / "mod.py"), "x = 1")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(
                    remote_path(cluster, w, "pkg/deep/mod.py")
                ),
                msg="dir tree propagated",
            )
    finally:
        session.stop()
    assert session.error is None


def test_downstream_create_modify_delete(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    write_file(str(local / "existing.txt"), "v1")
    session.start()
    try:
        w0 = cluster.translate_path(workers[0], "/app")
        wait_for(lambda: os.path.exists(os.path.join(w0, "existing.txt")))
        # remote create
        write_file(os.path.join(w0, "made_remote.txt"), "hello")
        wait_for(
            lambda: (local / "made_remote.txt").exists(), msg="remote create"
        )
        # ...mirrored to worker 1
        wait_for(
            lambda: os.path.exists(remote_path(cluster, workers[1], "made_remote.txt")),
            msg="mirror to w1",
        )
        # remote modify (newer mtime)
        future = time.time() + 2
        write_file(os.path.join(w0, "existing.txt"), "v2-remote")
        os.utime(os.path.join(w0, "existing.txt"), (future, future))
        wait_for(
            lambda: (local / "existing.txt").read_text() == "v2-remote",
            msg="remote modify",
        )
        # remote delete propagates after stable polls + triple check
        os.unlink(os.path.join(w0, "made_remote.txt"))
        wait_for(
            lambda: not (local / "made_remote.txt").exists(), msg="remote delete"
        )
    finally:
        session.stop()
    assert session.error is None


def test_exclude_rules(tmp_path, cluster):
    session, local, workers = make_session(
        tmp_path,
        cluster,
        n_workers=1,
        exclude_paths=["ignored/"],
        upload_exclude_paths=["*.secret"],
        download_exclude_paths=["logs/"],
    )
    write_file(str(local / "ignored" / "junk.txt"), "x")
    write_file(str(local / "creds.secret"), "shh")
    write_file(str(local / "normal.txt"), "ok")
    w0 = cluster.translate_path(workers[0], "/app")
    write_file(os.path.join(w0, "logs", "app.log"), "remote log")
    session.start()
    try:
        wait_for(lambda: os.path.exists(os.path.join(w0, "normal.txt")))
        time.sleep(1.0)  # give wrong behavior a chance to manifest
        assert not os.path.exists(os.path.join(w0, "ignored/junk.txt"))
        assert not os.path.exists(os.path.join(w0, "creds.secret"))
        assert not (local / "logs").exists()
    finally:
        session.stop()
    assert session.error is None


def test_local_newer_not_clobbered_by_downstream(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=1)
    session.start()
    try:
        w0 = cluster.translate_path(workers[0], "/app")
        # A remote file appears, but the local copy is newer.
        write_file(str(local / "hot.py"), "local newest")
        future = time.time() + 5
        os.utime(str(local / "hot.py"), (future, future))
        write_file(os.path.join(w0, "hot.py"), "remote stale")
        past = time.time() - 100
        os.utime(os.path.join(w0, "hot.py"), (past, past))
        # downstream must NOT overwrite; upstream pushes local over it
        wait_for(
            lambda: open(os.path.join(w0, "hot.py")).read() == "local newest",
            msg="upstream wins",
        )
        assert (local / "hot.py").read_text() == "local newest"
    finally:
        session.stop()
    assert session.error is None


def test_copy_to_container_one_shot(tmp_path, cluster):
    local = tmp_path / "ctx"
    write_file(str(local / "Dockerfile"), "FROM scratch")
    write_file(str(local / "src" / "main.py"), "pass")
    worker = cluster.add_pod("builder")
    n = copy_to_container(cluster, worker, str(local), "/workspace")
    assert n == 3
    root = cluster.translate_path(worker, "/workspace")
    assert open(os.path.join(root, "Dockerfile")).read() == "FROM scratch"
    assert open(os.path.join(root, "src/main.py")).read() == "pass"


def test_rename_propagates(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    write_file(str(local / "old_name.txt"), "data")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "old_name.txt"))
            )
        os.rename(str(local / "old_name.txt"), str(local / "new_name.txt"))
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "new_name.txt"))
                and not os.path.exists(remote_path(cluster, w, "old_name.txt")),
                msg="rename",
            )
    finally:
        session.stop()
    assert session.error is None


def test_rate_limiter_smaller_than_chunk():
    """A limit below the 64KiB chunk size must drain incrementally, not hang."""
    from devspace_tpu_torch.sync.shell import RateLimiter

    rl = RateLimiter(50)  # 50 KB/s < 64 KiB chunk
    t0 = time.monotonic()
    rl.throttle(65536)  # first chunk partially pre-paid by initial allowance
    rl.throttle(65536)
    elapsed = time.monotonic() - t0
    assert 1.0 < elapsed < 10.0  # ~1.3-2.6s expected; must terminate


def test_remote_dir_delete_spares_local_edits(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=1)
    write_file(str(local / "d" / "f.txt"), "v1")
    session.start()
    try:
        w0 = cluster.translate_path(workers[0], "/app")
        wait_for(lambda: os.path.exists(os.path.join(w0, "d/f.txt")))
        # pause upstream by editing right before remote delete
        import shutil

        shutil.rmtree(os.path.join(w0, "d"))
        write_file(str(local / "d" / "f.txt"), "v2-local-edit-longer")
        fut = time.time() + 5
        os.utime(str(local / "d" / "f.txt"), (fut, fut))
        # eventually upstream re-uploads the edited file; it must never be lost
        wait_for(
            lambda: os.path.exists(os.path.join(w0, "d/f.txt"))
            and open(os.path.join(w0, "d/f.txt")).read() == "v2-local-edit-longer",
            msg="local edit survives remote dir delete",
        )
        assert (local / "d" / "f.txt").read_text() == "v2-local-edit-longer"
    finally:
        session.stop()


def test_dropped_worker_does_not_kill_session(tmp_path, cluster, monkeypatch):
    """Graded partial-failure semantics (SURVEY §7 hard part #2): after a
    non-authoritative worker is permanently dropped from the fan-out,
    removes, uploads and downstream mirrors must keep flowing to the
    surviving workers instead of raising through the dead worker's closed
    shell and tearing the session down."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=3)
    write_file(str(local / "keep.txt"), "v1")
    write_file(str(local / "doomed.txt"), "bye")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "doomed.txt")),
                msg="initial fan-out",
            )
        # Permanently lose worker 2: mark it failed and make any revive
        # attempt (a fresh exec) fail like a deleted pod would.
        real_exec = cluster.exec_stream

        def exec_stream(pod, *a, **kw):
            name = getattr(pod, "name", pod)
            if name == workers[2].name:
                raise RuntimeError("pod gone")
            return real_exec(pod, *a, **kw)

        monkeypatch.setattr(cluster, "exec_stream", exec_stream)
        session._mark_worker_failed(2, RuntimeError("pod gone"))

        # upstream remove must fan out to survivors without dying
        os.unlink(str(local / "doomed.txt"))
        for w in workers[:2]:
            wait_for(
                lambda w=w: not os.path.exists(remote_path(cluster, w, "doomed.txt")),
                msg="remove on survivors",
            )
        # downstream change on worker 0 must still mirror to worker 1
        w0 = cluster.translate_path(workers[0], "/app")
        write_file(os.path.join(w0, "from_remote.txt"), "hello")
        wait_for(
            lambda: (local / "from_remote.txt").exists(),
            msg="download from authority",
        )
        wait_for(
            lambda: os.path.exists(remote_path(cluster, workers[1], "from_remote.txt")),
            msg="mirror to surviving worker",
        )
        # upstream create still reaches survivors
        write_file(str(local / "late.txt"), "late")
        for w in workers[:2]:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "late.txt")),
                msg="upload to survivors",
            )
        assert session.error is None
        assert 2 in session.worker_errors
    finally:
        session.stop()
    assert session.error is None


def test_worker_shell_revive_after_exec_death(tmp_path, cluster):
    """A worker whose exec shell dies (container restart) must be revived
    on the next fan-out: fresh shell + index catch-up, no session error
    (SURVEY §7 hard part #2; reference has no equivalent — single pod is
    all-or-nothing, sync_config.go:439)."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=3)
    write_file(str(local / "base.txt"), "v1")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "base.txt")),
                msg="initial fan-out",
            )
        # Simulate container restart: kill worker 1's upstream shell out
        # from under the session (the pod itself stays exec-able).
        session._shells[1].close()
        # While it's dead, change a file so catch-up has work to do.
        write_file(str(local / "base.txt"), "v2-after-restart")
        write_file(str(local / "fresh.txt"), "new")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "fresh.txt"))
                and open(remote_path(cluster, w, "base.txt")).read()
                == "v2-after-restart",
                msg=f"revive catch-up on {w.name}",
            )
        assert session.error is None
        assert 1 not in session.worker_errors
    finally:
        session.stop()
    assert session.error is None


def test_authority_worker_loss_is_fatal(tmp_path, cluster, monkeypatch):
    """Worker 0 is the downstream authority: losing it permanently must
    stop the session with an error (graded semantics stop at the
    authority — there is no one left to define remote truth)."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    write_file(str(local / "a.txt"), "1")
    session.start()
    try:
        wait_for(
            lambda: os.path.exists(remote_path(cluster, workers[0], "a.txt")),
            msg="initial sync",
        )
        real_exec = cluster.exec_stream

        def exec_stream(pod, *a, **kw):
            if getattr(pod, "name", pod) == workers[0].name:
                raise RuntimeError("authority gone")
            return real_exec(pod, *a, **kw)

        monkeypatch.setattr(cluster, "exec_stream", exec_stream)
        session._shells[0].close()
        write_file(str(local / "b.txt"), "2")
        wait_for(lambda: session.error is not None, msg="fatal session error")
        assert "worker 0" in str(session.error)
    finally:
        session.stop()


def test_all_workers_lost_is_fatal(tmp_path, cluster, monkeypatch):
    """Losing EVERY worker permanently must stop the session with an error
    (pins the bottom of the graded-failure ladder: mirror lost -> continue;
    worker 0 or all lost -> fatal)."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    write_file(str(local / "a.txt"), "1")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "a.txt")),
                msg="initial fan-out",
            )
        # Every pod vanishes: all shells die and no revive can succeed.
        monkeypatch.setattr(
            cluster,
            "exec_stream",
            lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("slice gone")),
        )
        for shell in list(session._shells):
            shell.close()
        write_file(str(local / "b.txt"), "2")
        wait_for(lambda: session.error is not None, msg="fatal session error")
        # worker 0 is among the lost, so the authority message wins
        assert "worker 0" in str(session.error) or "every worker" in str(
            session.error
        )
        assert session._stopped.is_set()
    finally:
        session.stop()


def test_concurrent_bidirectional_stress(tmp_path, cluster):
    """Many files changing on both sides at once must converge with no
    lost updates (reference test matrix analogue: TestNormalSync's
    create/modify/rename matrix, run concurrently)."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    session.start()
    w0 = cluster.translate_path(workers[0], "/app")
    n = 25
    try:
        future = time.time() + 5
        for i in range(n):
            write_file(str(local / f"up_{i}.txt"), f"local {i}")
            write_file(os.path.join(w0, f"down_{i}.txt"), f"remote {i}")
            os.utime(os.path.join(w0, f"down_{i}.txt"), (future, future))

        def converged():
            for i in range(n):
                for w in workers:
                    if not os.path.exists(remote_path(cluster, w, f"up_{i}.txt")):
                        return False
                if not (local / f"down_{i}.txt").exists():
                    return False
                if not os.path.exists(remote_path(cluster, workers[1], f"down_{i}.txt")):
                    return False
            return True

        wait_for(converged, timeout=30, msg="bidirectional convergence")
        for i in range(n):
            assert (local / f"down_{i}.txt").read_text() == f"remote {i}"
            assert (
                open(remote_path(cluster, workers[1], f"up_{i}.txt")).read()
                == f"local {i}"
            )
        assert session.error is None
    finally:
        session.stop()


def test_file_index_thread_safety():
    """Hammer the shared FileIndex from concurrent writers/readers —
    the multi-host analogue of the reference's `go test -race` discipline
    over fileMapMutex (SURVEY §5.2)."""
    import threading

    from devspace_tpu_torch.sync.file_info import FileInformation
    from devspace_tpu_torch.sync.index import FileIndex

    index = FileIndex()
    errors = []

    def writer(tid: int):
        try:
            for i in range(300):
                info = FileInformation(
                    name=f"t{tid}/f{i}", size=i, mtime=i, is_directory=False
                )
                index.set(info)
                if i % 3 == 0:
                    index.remove(f"t{tid}/f{i}")
                _ = index.get(f"t{tid}/f{i}")
                if i % 50 == 0:
                    index.transact(lambda m: m.update({}))
                    _ = len(index)
                    _ = index.snapshot()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    # every thread left exactly the non-multiple-of-3 files, plus the
    # auto-created parent-dir entry per thread (CreateDirInFileMap
    # analogue, reference: sync/file_index.go)
    expect_per_thread = len([i for i in range(300) if i % 3 != 0])
    assert len(index) == 8 * expect_per_thread + 8


def test_drift_detection_repairs_corrupted_worker(tmp_path, cluster):
    """A non-authoritative worker whose tree
    diverges WITHOUT its shell dying (in-container rm / rogue write) is
    detected by the verify loop, repaired, and reported."""
    session, local, workers = make_session(
        tmp_path, cluster, n_workers=3, verify_interval=0.2
    )
    write_file(str(local / "train.py"), "x = 1\n")
    write_file(str(local / "lib" / "util.py"), "y = 2\n")
    session.start()
    try:
        w2 = cluster.translate_path(workers[2], "/app")
        wait_for(
            lambda: os.path.exists(os.path.join(w2, "lib", "util.py")),
            msg="initial mirror to worker 2",
        )
        # corrupt worker 2 in-container: delete a synced file, alter
        # another, and drop a rogue file — all without touching the shell
        os.unlink(os.path.join(w2, "train.py"))
        write_file(os.path.join(w2, "lib", "util.py"), "corrupted")
        write_file(os.path.join(w2, "rogue.txt"), "not ours")
        wait_for(
            lambda: (
                os.path.exists(os.path.join(w2, "train.py"))
                and open(os.path.join(w2, "lib", "util.py")).read() == "y = 2\n"
                and not os.path.exists(os.path.join(w2, "rogue.txt"))
            ),
            timeout=10,
            msg="worker 2 repaired",
        )
        # reported: per-worker repair count + session stats
        health = {h["worker"]: h for h in session.worker_health()}
        assert health["w-2"]["state"] == "mirror"
        assert health["w-2"]["repairs"] >= 3
        assert session.stats["repaired"] >= 3
        assert health["w-0"]["state"] == "authority"
        # worker 0 (authority) must never be "repaired" by the verifier:
        # its divergence is the downstream's business
        assert health["w-0"]["repairs"] == 0
        # other workers untouched
        w1 = cluster.translate_path(workers[1], "/app")
        assert open(os.path.join(w1, "train.py")).read() == "x = 1\n"
    finally:
        session.stop()


def test_status_file_published_with_worker_health(tmp_path, cluster):
    status_path = str(tmp_path / "logs" / "sync-status.json")
    session, local, workers = make_session(
        tmp_path, cluster, n_workers=2, verify_interval=0.2,
        status_path=status_path,
    )
    write_file(str(local / "a.txt"), "a")
    session.start()
    try:
        import json

        def published_ok():
            try:
                with open(status_path) as fh:
                    data = json.load(fh)
            except (OSError, ValueError):
                return False
            st = next(iter(data.values()), None)
            return bool(st and st["workers"] and st["stats"]["uploaded"] >= 0)

        wait_for(published_ok, msg="status file published")
        with open(status_path) as fh:
            st = next(iter(json.load(fh).values()))
        states = {w["worker"]: w["state"] for w in st["workers"]}
        assert states == {"w-0": "authority", "w-1": "mirror"}
        assert st["error"] is None
    finally:
        session.stop()
    # stop publishes a final snapshot (updated_at advances)
    with open(status_path) as fh:
        assert next(iter(json.load(fh).values()))["updated_at"] > 0


# -- parity with the JAX package's sync engine ----------------------------------
PARITY_EXCLUDES = {
    "exclude_paths": ["ignored/", "__pycache__/"],
    "upload_exclude_paths": ["*.secret"],
    "download_exclude_paths": ["logs/"],
}
T0 = 1_700_000_000  # fixed mtimes: both trees start byte and stat equal


def parity_tree(root):
    files = {
        "a.txt": "v1\n",
        "sub/b.py": "print('b')\n",
        "sub/deep/c.json": '{"c": 1}\n',
        "ignored/junk.txt": "x",
        "__pycache__/m.pyc": "pyc",
        "creds.secret": "shh",
        "empty.txt": "",
    }
    for rel, text in files.items():
        write_file(str(root / rel), text)
    for path in sorted(root.rglob("*"), reverse=True):
        os.utime(path, (T0, T0))


def tree_of(root) -> dict:
    """{relpath: bytes, or None for a directory} under ``root``."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames:
            out[os.path.relpath(os.path.join(dirpath, name), root)] = None
        for name in filenames:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def drive_parity_session(pkg: str, tmp_path, monkeypatch) -> dict:
    """The parity script through one package's ``SyncSession`` on its own
    fake: initial sync (a remote-only file and an excluded log on worker 0),
    then a local edit, a new directory, a local delete and a file made on
    worker 0. Returns the local tree, every worker's tree and the keys of
    the status snapshot once every change has landed."""
    import importlib

    monkeypatch.setenv("DEVSPACE_NATIVE", "0")  # the JAX package's Python walk
    fake = importlib.import_module(f"{pkg}.kube.fake")
    session_mod = importlib.import_module(f"{pkg}.sync.session")
    base = tmp_path / pkg
    local = base / "local"
    parity_tree(local)
    cluster = fake.FakeCluster(str(base / "cluster"))
    workers = [cluster.add_pod(f"w-{i}", labels={"app": "t"}, worker_id=i) for i in range(3)]
    w0 = cluster.translate_path(workers[0], "/app")
    write_file(os.path.join(w0, "remote_only.txt"), "from worker 0\n")
    write_file(os.path.join(w0, "logs", "app.log"), "remote log\n")
    for rel in ("remote_only.txt", "logs/app.log", "logs"):
        os.utime(os.path.join(w0, rel), (T0 + 5, T0 + 5))
    opts = session_mod.SyncOptions(
        local_path=str(local), container_path="/app", upstream_quiet=0.15,
        upstream_tick=0.05, downstream_interval=0.15, verify_interval=0.2,
        **PARITY_EXCLUDES)
    session = session_mod.SyncSession(cluster, workers, opts)
    session.start()
    remotes = [cluster.translate_path(w, "/app") for w in workers]
    try:
        for r in remotes:
            wait_for(lambda r=r: os.path.exists(os.path.join(r, "remote_only.txt")),
                     msg=f"{pkg}: initial sync")
        write_file(str(local / "a.txt"), "v2, longer\n")
        os.utime(str(local / "a.txt"), (T0 + 100, T0 + 100))
        write_file(str(local / "pkg" / "mod.py"), "x = 1\n")
        os.unlink(str(local / "sub" / "b.py"))
        write_file(os.path.join(w0, "made_remote.txt"), "made on worker 0\n")

        def landed():
            return (local / "made_remote.txt").exists() and all(
                os.path.exists(os.path.join(r, "made_remote.txt"))
                and os.path.exists(os.path.join(r, "pkg", "mod.py"))
                and not os.path.exists(os.path.join(r, "sub", "b.py"))
                and open(os.path.join(r, "a.txt")).read() == "v2, longer\n"
                for r in remotes)

        wait_for(landed, timeout=30, msg=f"{pkg}: every change landed")
        snapshot = session.status_snapshot()
    finally:
        session.stop()
    assert session.error is None
    return {
        "local": tree_of(local),
        "workers": [tree_of(r) for r in remotes],
        "keys": sorted(snapshot),
        "stats_keys": sorted(snapshot["stats"]),
        "worker_keys": [sorted(h) for h in snapshot["workers"]],
        "states": [(h["worker"], h["state"]) for h in snapshot["workers"]],
    }


def test_sessions_of_both_packages_leave_equal_trees(tmp_path, monkeypatch):
    """The same tree, excludes and edits through the JAX package's and the
    port's ``SyncSession``, each on its own fake of three workers: equal
    local trees, equal trees on every worker, and the same keys in
    ``status_snapshot``."""
    jax_side = drive_parity_session("devspace_tpu", tmp_path, monkeypatch)
    port_side = drive_parity_session("devspace_tpu_torch", tmp_path, monkeypatch)
    assert port_side == jax_side
    w0, w1, w2 = port_side["workers"]
    assert w1 == w2 and w0 == {**w1, "logs": None, "logs/app.log": b"remote log\n"}
    assert "creds.secret" not in w1 and "ignored" not in w1 and "sub/b.py" not in w1
    assert port_side["local"]["made_remote.txt"] == b"made on worker 0\n"
    assert "logs" not in port_side["local"]
    assert port_side["states"] == [("w-0", "authority"), ("w-1", "mirror"),
                                   ("w-2", "mirror")]


def parity_entries(root):
    from devspace_tpu_torch.sync.session import walk_local_tree

    parity_tree(root)
    write_file(str(root / "big.bin"), "z" * 70_000)
    os.chmod(str(root / "sub" / "b.py"), 0o750)
    os.utime(str(root / "big.bin"), (T0, T0))
    entries = sorted(walk_local_tree(str(root)).values(), key=lambda e: e.name)
    entries[0].remote_mode, entries[0].remote_uid, entries[0].remote_gid = 0o600, 1000, 1001
    return entries


@pytest.mark.parametrize("n", [3, 64])
def test_build_tar_bytes_equal_the_jax_packages(tmp_path, monkeypatch, n):
    """``build_tar`` of the same entries gives the same gzip stream as the
    JAX package's Python path (``DEVSPACE_NATIVE=0``): every byte but the
    gzip header's timestamp, and the same tar inside. 64 entries is where
    the reference would switch to its native packer."""
    import dataclasses
    import gzip

    from devspace_tpu.sync import shell as jshell
    from devspace_tpu.sync.file_info import FileInformation as JInfo
    from devspace_tpu_torch.sync import shell

    monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    entries = parity_entries(tmp_path)
    for i in range(n - len(entries)):
        name = f"many/f{i:03d}.txt"
        write_file(str(tmp_path / name), f"{i}\n")
        entries.append(shell.FileInformation(name=name, size=len(f"{i}\n"), mtime=T0))
    assert len(entries) == n or n == 3
    entries = entries[:n]
    ours = shell.build_tar(str(tmp_path), entries)
    theirs = jshell.build_tar(str(tmp_path), [JInfo(**dataclasses.asdict(e)) for e in entries])
    assert ours[:4] + ours[8:] == theirs[:4] + theirs[8:]
    assert gzip.decompress(ours) == gzip.decompress(theirs)


def test_file_information_digests_and_ignore_matches_equal_the_jax_packages(tmp_path):
    """``local_file_information``, ``file_digest``, ``DigestCache``, the
    remote stat-line parser and the walk under exclude rules agree with the
    JAX package's."""
    import dataclasses

    from devspace_tpu.sync import file_info as jfi
    from devspace_tpu.sync.session import walk_local_tree as jwalk
    from devspace_tpu.utils.ignoreutil import IgnoreMatcher as JMatcher
    from devspace_tpu_torch.sync import file_info as fi
    from devspace_tpu_torch.sync.session import walk_local_tree
    from devspace_tpu_torch.utils.ignoreutil import IgnoreMatcher

    parity_entries(tmp_path)
    os.symlink("sub", str(tmp_path / "link"))
    rels = ["a.txt", "big.bin", "empty.txt", "sub", "sub/b.py", "link", "link/deep/c.json",
            "missing.txt"]
    for rel in rels:
        ours, theirs = fi.local_file_information(str(tmp_path), rel), \
            jfi.local_file_information(str(tmp_path), rel)
        assert (ours and dataclasses.asdict(ours)) == (theirs and dataclasses.asdict(theirs))
        full = str(tmp_path / rel)
        assert fi.file_digest(full) == jfi.file_digest(full)
        if ours is not None:
            assert fi.DigestCache().digest(str(tmp_path), ours) == \
                jfi.DigestCache().digest(str(tmp_path), theirs)
    assert fi.file_digest(str(tmp_path / "a.txt")) is not None
    assert fi.find_command("/app dir") == jfi.find_command("/app dir")
    for line in ["/app/x.py///12,1700000000,81a4,644,1000,1001",
                 "/app/d///4096,1700000000,41ed,755,0", "/app///0,1,41ed,755,0,0",
                 "garbage", "/app/y///nope,1,2,3,4"]:
        ours, theirs = fi.parse_stat_line(line, "/app"), jfi.parse_stat_line(line, "/app")
        assert (ours and dataclasses.asdict(ours)) == (theirs and dataclasses.asdict(theirs))
    for patterns in (["ignored/", "__pycache__/"], ["*.secret", "!creds.secret"],
                     ["/sub/deep", "**/*.bin"], ["sub/", "!sub/b.py"], []):
        ours = {k: dataclasses.asdict(v)
                for k, v in walk_local_tree(str(tmp_path), IgnoreMatcher(patterns)).items()}
        theirs = {k: dataclasses.asdict(v)
                  for k, v in jwalk(str(tmp_path), JMatcher(patterns)).items()}
        assert ours == theirs, patterns


def test_sync_metric_families_lint_clean_and_merge_under_their_hints(tmp_path, cluster):
    """Sync's families are the JAX package's, pass the port's OBS7xx rules,
    and the fleet merge reads their declared hints: a live session's
    counters, rendered by the port's registry, sum across two scrapes."""
    from devspace_tpu.sync.session import SYNC_METRIC_FAMILIES as JFAMILIES
    from devspace_tpu_torch.lint import lint_obs_catalogs
    from devspace_tpu_torch.obs import fleet
    from devspace_tpu_torch.obs.metrics import get_registry
    from devspace_tpu_torch.sync.session import SYNC_METRIC_FAMILIES

    assert SYNC_METRIC_FAMILIES == JFAMILIES
    assert lint_obs_catalogs({"sync": SYNC_METRIC_FAMILIES}) == []
    hints = fleet.aggregation_hints()
    assert {f[0]: hints.get(f[0]) for f in SYNC_METRIC_FAMILIES} == {
        f[0]: f[-1] for f in SYNC_METRIC_FAMILIES}
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    write_file(str(local / "a.txt"), "a")
    session.start()
    try:
        wait_for(lambda: session.stats["uploaded"] >= 1, msg="an upload")
        snap = fleet.parse_exposition(get_registry().render())
    finally:
        session.stop()
    names = {f[0] for f in SYNC_METRIC_FAMILIES}
    assert names <= set(snap)
    uploaded = snap["sync_uploaded_total"]["samples"][0][1]
    assert uploaded >= 1
    merged, notes = fleet.merge_snapshots([snap, snap])
    assert merged["sync_uploaded_total"]["samples"][0][1] == 2 * uploaded
    assert not [n for n in notes if n.split(":")[0] in names]
