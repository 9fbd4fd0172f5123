"""Content-addressed, pipelined sync fan-out in the port
(devspace_tpu_torch/sync/): the cases of tests/test_sync_pipeline.py on
the port's fake cluster.

Pins three mechanisms — digest gating (touch with unchanged
bytes transfers zero payload), the tar artifact cache (one build per batch
serves every worker), and the bounded pipeline's graded failure semantics
(a worker killed mid-broadcast degrades without wedging the producer) —
plus the RateLimiter lock fix and build_tar's concurrent-writer fix.
"""

import io
import os
import tarfile
import threading
import time

import pytest

import devspace_tpu_torch.sync.session as session_mod
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.resilience.chaos import ByteBudgetStream
from devspace_tpu_torch.sync.artifacts import TarArtifactCache, batch_key
from devspace_tpu_torch.sync.file_info import (
    DigestCache,
    FileInformation,
    file_digest,
)
from devspace_tpu_torch.sync.index import FileIndex
from devspace_tpu_torch.sync.shell import RateLimiter, build_tar
from devspace_tpu_torch.sync.session import SyncOptions, SyncSession
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
        downstream_interval=0.15,
        **opt_kw,
    )
    return SyncSession(cluster, workers, opts), local, workers


def remote_path(cluster, worker, rel):
    return os.path.join(cluster.translate_path(worker, "/app"), rel)


# -- digests ----------------------------------------------------------------
def test_file_digest_and_cache_memoization(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("hello")
    d1 = file_digest(str(p))
    assert d1 is not None and len(d1) == 32  # blake2b-128 hex
    assert file_digest(str(tmp_path / "missing")) is None

    cache = DigestCache()
    info = FileInformation(name="a.txt", size=5, mtime=int(os.stat(p).st_mtime))
    assert cache.digest(str(tmp_path), info) == d1
    # memo hit: content changed on disk but stat identity unchanged -> the
    # cache answers from the memo (this IS the point: no re-hash per event)
    p.write_text("HELLO")
    os.utime(p, (info.mtime, info.mtime))
    assert cache.digest(str(tmp_path), info) == d1
    # stat change -> re-hash
    info2 = FileInformation(name="a.txt", size=5, mtime=info.mtime + 7)
    os.utime(p, (info2.mtime, info2.mtime))
    assert cache.digest(str(tmp_path), info2) == file_digest(str(p)) != d1


def test_index_preserves_digest_on_statless_reindex():
    idx = FileIndex()
    idx.set(FileInformation(name="a", size=3, mtime=100, digest="d" * 32))
    # digest-less re-index with identical stat (remote snapshot echo)
    idx.set(FileInformation(name="a", size=3, mtime=100))
    assert idx.get("a").digest == "d" * 32
    # stat moved -> stale digest must NOT survive
    idx.set(FileInformation(name="a", size=3, mtime=200))
    assert idx.get("a").digest is None


# -- batch key / artifact cache ---------------------------------------------
def _infos(*specs):
    return [
        FileInformation(name=n, size=s, mtime=m, digest=d)
        for (n, s, m, d) in specs
    ]


def test_batch_key_stability_and_sensitivity():
    a = _infos(("x.py", 3, 100, None), ("y.py", 5, 200, "a" * 32))
    assert batch_key(a) == batch_key(_infos(("x.py", 3, 100, None), ("y.py", 5, 200, "a" * 32)))
    assert batch_key(a) != batch_key(_infos(("x.py", 4, 100, None), ("y.py", 5, 200, "a" * 32)))
    assert batch_key(a) != batch_key(_infos(("x.py", 3, 101, None), ("y.py", 5, 200, "a" * 32)))
    assert batch_key(a) != batch_key(_infos(("x.py", 3, 100, "b" * 32), ("y.py", 5, 200, "a" * 32)))
    # order matters: tar member order is part of the artifact
    assert batch_key(a) != batch_key(list(reversed(a)))


def test_artifact_cache_builds_once_and_evicts_by_bytes(tmp_path):
    write_file(str(tmp_path / "a.txt"), "aaaa")
    write_file(str(tmp_path / "b.txt"), "bbbb")
    st_a = os.stat(tmp_path / "a.txt")
    st_b = os.stat(tmp_path / "b.txt")
    batch_a = [FileInformation(name="a.txt", size=4, mtime=int(st_a.st_mtime))]
    batch_b = [FileInformation(name="b.txt", size=4, mtime=int(st_b.st_mtime))]

    cache = TarArtifactCache()
    t1 = cache.get_or_build(str(tmp_path), batch_a)
    t2 = cache.get_or_build(str(tmp_path), batch_a)
    assert t1 == t2 and cache.builds == 1 and cache.hits == 1

    # tiny budget: caching batch_b evicts batch_a (LRU by bytes)
    small = TarArtifactCache(max_bytes=1)
    small.get_or_build(str(tmp_path), batch_a)
    small.get_or_build(str(tmp_path), batch_b)
    small.get_or_build(str(tmp_path), batch_a)
    assert small.builds == 3  # every call rebuilt: nothing fits the budget
    assert small.stats()["artifact_entries"] == 1


# -- mirror pass: one build per batch, byte-identical convergence -----------
@pytest.mark.parametrize("n_workers", [4, 16])
def test_mirror_pass_one_build_per_batch(tmp_path, cluster, monkeypatch, n_workers):
    """Initial-sync mirror: regardless of worker count, each batch is
    tarred ONCE (artifact cache) and every mirrored worker ends up
    byte-identical to worker 0."""
    monkeypatch.setattr(session_mod, "UPLOAD_BATCH_FILES", 5)
    session, local, workers = make_session(
        tmp_path, cluster, n_workers=n_workers, verify_interval=0
    )
    now = int(time.time())
    names = [f"f{i:02d}.py" for i in range(12)]  # 3 batches of <=5
    for i, name in enumerate(names):
        write_file(str(local / name), f"content {i}")
        os.utime(str(local / name), (now, now))
        # worker 0 already matches local exactly -> the authority pass
        # uploads nothing; only the mirror pass moves data
        w0 = os.path.join(cluster.translate_path(workers[0], "/app"), name)
        write_file(w0, f"content {i}")
        os.utime(w0, (now, now))
    session.start()
    try:
        for w in workers[1:]:
            wait_for(
                lambda w=w: all(
                    os.path.exists(remote_path(cluster, w, n)) for n in names
                ),
                msg="mirror fan-out",
            )
        n_batches = 3
        assert session.artifacts.builds == n_batches
        assert session.artifacts.hits == n_batches * (n_workers - 2)
        for w in workers[1:]:
            for name in names:
                assert (
                    open(remote_path(cluster, w, name), "rb").read()
                    == open(remote_path(cluster, workers[0], name), "rb").read()
                )
    finally:
        session.stop()
    assert session.error is None


# -- digest gating: no-op touch moves zero payload bytes --------------------
def test_noop_touch_transfers_zero_payload(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    session.start()
    try:
        # steady-state create: upload computes and indexes the digest
        write_file(str(local / "app.py"), "print('v1')")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "app.py")),
                msg="initial upload",
            )
        wait_for(
            lambda: session.index.get("app.py") is not None
            and session.index.get("app.py").digest is not None,
            msg="digest recorded on upload",
        )
        bytes_before = session.stats["bytes_sent"]
        uploaded_before = session.stats["uploaded"]

        # no-op touch: same bytes, new mtime
        new_mtime = int(time.time()) + 5
        os.utime(str(local / "app.py"), (new_mtime, new_mtime))
        wait_for(
            lambda: session.stats["meta_fixes"] >= 1,
            msg="metadata-only fix",
        )
        # remote mtimes were fixed in place on every worker...
        for w in workers:
            wait_for(
                lambda w=w: int(
                    os.stat(remote_path(cluster, w, "app.py")).st_mtime
                )
                == new_mtime,
                msg="remote mtime fixed",
            )
        # ...the index moved with them (no downstream echo / verify churn)...
        assert session.index.get("app.py").mtime == new_mtime
        assert session.index.get("app.py").digest is not None
        # ...and ZERO payload bytes crossed the wire (the acceptance pin)
        assert session.stats["bytes_sent"] == bytes_before
        assert session.stats["uploaded"] == uploaded_before
        assert session.stats["bytes_saved_digest"] > 0

        # control: a same-size content change MUST still upload
        bytes_before = session.stats["bytes_sent"]
        write_file(str(local / "app.py"), "print('v2')")
        later = new_mtime + 5
        os.utime(str(local / "app.py"), (later, later))
        for w in workers:
            wait_for(
                lambda w=w: open(remote_path(cluster, w, "app.py")).read()
                == "print('v2')",
                msg="content change still uploads",
            )
        assert session.stats["bytes_sent"] > bytes_before
    finally:
        session.stop()
    assert session.error is None


def test_digest_gating_off_reuploads_on_touch(tmp_path, cluster):
    session, local, workers = make_session(
        tmp_path, cluster, n_workers=1, digest_gating=False
    )
    session.start()
    try:
        write_file(str(local / "a.py"), "x = 1")
        wait_for(
            lambda: os.path.exists(remote_path(cluster, workers[0], "a.py")),
            msg="upload",
        )
        wait_for(lambda: session.index.get("a.py") is not None, msg="indexed")
        bytes_before = session.stats["bytes_sent"]
        new_mtime = int(time.time()) + 5
        os.utime(str(local / "a.py"), (new_mtime, new_mtime))
        wait_for(
            lambda: session.index.get("a.py").mtime == new_mtime,
            msg="touch re-synced",
        )
        assert session.stats["meta_fixes"] == 0
        assert session.stats["bytes_sent"] > bytes_before  # full re-upload
    finally:
        session.stop()
    assert session.error is None


# -- pipelined broadcast under failure (chaos) ------------------------------
@pytest.mark.chaos
def test_worker_killed_mid_broadcast_degrades_not_wedges(
    tmp_path, cluster, monkeypatch
):
    """A mirror worker dying mid-broadcast (stream drop + failed revive)
    is quarantined per the graded ladder; the pipeline's producer and the
    surviving consumers keep flowing — later uploads still land."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=3)
    write_file(str(local / "base.py"), "v0")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "base.py")),
                msg="initial fan-out",
            )
        # Kill worker 1 mid-broadcast: its stream dies on the next byte and
        # any revive exec fails like a deleted pod.
        real_exec = cluster.exec_stream

        def exec_stream(pod, *a, **kw):
            if getattr(pod, "name", pod) == workers[1].name:
                raise RuntimeError("pod gone")
            return real_exec(pod, *a, **kw)

        monkeypatch.setattr(cluster, "exec_stream", exec_stream)
        session._shells[1].proc = ByteBudgetStream(session._shells[1].proc, 0)

        write_file(str(local / "during.py"), "v1")
        for w in (workers[0], workers[2]):
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "during.py")),
                msg="broadcast to survivors",
            )
        wait_for(lambda: 1 in session.worker_errors, msg="quarantine")
        assert session.error is None

        # the producer queue is not wedged: a follow-up batch still flows
        write_file(str(local / "after.py"), "v2")
        for w in (workers[0], workers[2]):
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "after.py")),
                msg="pipeline still flowing after quarantine",
            )
        assert session.index.get("after.py") is not None
    finally:
        session.stop()
    assert session.error is None


@pytest.mark.chaos
def test_pod_killed_mid_broadcast_pipeline_completes(tmp_path, cluster):
    """kill_pod (streams die AND pod gone, revive impossible): the
    broadcast completes on survivors and the index still commits."""
    session, local, workers = make_session(tmp_path, cluster, n_workers=3)
    write_file(str(local / "seed.py"), "s")
    session.start()
    try:
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "seed.py")),
                msg="initial fan-out",
            )
        uploaded_before = session.stats["uploaded"]
        cluster.kill_pod("w-2")
        write_file(str(local / "next.py"), "n")
        for w in workers[:2]:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "next.py")),
                msg="broadcast to survivors",
            )
        wait_for(
            lambda: session.stats["uploaded"] > uploaded_before,
            msg="batch committed despite dead worker",
        )
        wait_for(lambda: 2 in session.worker_errors, msg="quarantine")
        assert session.error is None
    finally:
        session.stop()
    assert session.error is None


# -- RateLimiter: sleep outside the lock ------------------------------------
def test_rate_limiter_does_not_serialize_threads():
    """Satellite regression: a large throttled transfer must not block a
    peer that still has budget. Old code slept holding self._lock, so B's
    tiny request waited out A's multi-second drain."""
    limiter = RateLimiter(10)  # 10 KB/s bucket
    t_b = {}

    def big():
        limiter.throttle(30 * 1024)  # ~2s of deficit

    def small():
        time.sleep(0.3)  # let A drain the bucket and start sleeping
        t0 = time.monotonic()
        limiter.throttle(1)
        t_b["elapsed"] = time.monotonic() - t0

    a = threading.Thread(target=big)
    b = threading.Thread(target=small)
    a.start()
    b.start()
    b.join(timeout=10)
    assert t_b["elapsed"] < 1.0, (
        f"B blocked {t_b['elapsed']:.2f}s — limiter slept holding the lock"
    )
    a.join(timeout=10)


# -- build_tar: indexed size/mtime under concurrent writers -----------------
def test_build_tar_records_indexed_stat_not_fresh_stat(tmp_path):
    """Satellite regression: the Python fallback used to re-stat the file,
    so a write between indexing and tarring made the remote copy disagree
    with the index forever (neither side ever sees a further change)."""
    p = tmp_path / "grow.txt"
    p.write_bytes(b"abcd")
    mtime = int(os.stat(p).st_mtime)
    info = FileInformation(name="grow.txt", size=4, mtime=mtime)
    # concurrent writer: file grows and its mtime moves after indexing
    p.write_bytes(b"abcdEFGH")
    os.utime(p, (mtime + 50, mtime + 50))

    data = build_tar(str(tmp_path), [info])  # 1 entry -> Python fallback
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
        ti = tf.getmember("grow.txt")
        assert ti.size == 4  # indexed size, not the fresh 8
        assert int(ti.mtime) == mtime  # indexed mtime, not mtime+50
        assert tf.extractfile(ti).read() == b"abcd"

    # shrink case: deliver exactly info.size, zero-filled
    p.write_bytes(b"ab")
    data = build_tar(str(tmp_path), [info])
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
        ti = tf.getmember("grow.txt")
        assert ti.size == 4
        assert tf.extractfile(ti).read() == b"ab\0\0"


# -- stats surface ----------------------------------------------------------
def test_status_snapshot_surfaces_perf_stats(tmp_path, cluster):
    session, local, workers = make_session(tmp_path, cluster, n_workers=2)
    session.start()
    try:
        write_file(str(local / "m.py"), "pass")
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(remote_path(cluster, w, "m.py")),
                msg="upload",
            )
        snap = session.status_snapshot()
        for key in (
            "bytes_sent",
            "bytes_saved_digest",
            "meta_fixes",
            "pipeline_stall_s",
            "artifact_builds",
            "artifact_hits",
        ):
            assert key in snap["stats"], key
        assert snap["stats"]["bytes_sent"] > 0
    finally:
        session.stop()
    assert session.error is None
