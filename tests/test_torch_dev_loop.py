"""The port's dev loop on its fake cluster: ``DevLoop`` (sync to every
worker of the job, a hot edit, a file made on worker 0 coming back,
``status sync``), ``enter`` on one worker and ``enter --all`` with
``$NODE_RANK`` where the reference's test has ``$TPU_WORKER_ID``, ``logs``
(one worker and all, prefixed ``[worker-N]``), the
redeploy-instead-of-hot-reload example read from ``examples/`` (no sync:
the auto-reload watcher redeploys), and ``KanikoBuilder`` against the fake
(the context uploaded by ``copy_to_container``). ``main([...])`` runs
in-process, as tests/test_cli.py drives the JAX CLI."""

import os
import shutil
import sys
import threading
import time
from pathlib import Path

import pytest

from devspace_tpu_torch.cli.context import Context
from devspace_tpu_torch.cli.main import main
from devspace_tpu_torch.cli.pipeline import DevLoop
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.utils import log as logutil
from devspace_tpu_torch.utils.fsutil import write_file

REPO = Path(__file__).resolve().parent.parent


class _Stdout:
    """Whatever ``sys.stdout`` is when a line is written (capture swaps it
    between a fixture's set-up and the test)."""

    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()


@pytest.fixture
def project(tmp_path, monkeypatch):
    """A torch project (``init`` scaffolds chart-gpu and ``gpu: {workers:
    2}``) against a fake cluster under ``tmp_path``."""
    proj = tmp_path / "proj"
    proj.mkdir()
    monkeypatch.chdir(proj)
    monkeypatch.setenv("DEVSPACE_FAKE_BACKEND", str(tmp_path / "cluster"))
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    write_file(str(proj / "train.py"), "import torch\nprint('step 0')\n")
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    return proj


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out: {msg}")


class Args:
    namespace = None
    kube_context = None
    config = None
    no_sync = False
    no_portforwarding = True  # the fake pods serve no port
    no_terminal = True
    verbose_sync = False
    force_build = False
    force_deploy = False


def test_dev_loop_hot_reload(project, tmp_path, capsys):
    assert main(["init"]) == 0
    ctx = Context(Args())
    loop = DevLoop(ctx, Args())
    t = threading.Thread(target=loop.run, daemon=True)
    t.start()
    try:
        wait_for(loop.services_ready.is_set, msg="services up")
        fc = ctx.backend
        workers = fc.slice_workers({"app": "proj"}, expected=2, timeout=10)
        assert [w.worker_id for w in workers] == [0, 1]
        # initial sync pushed train.py to every worker
        for w in workers:
            wait_for(
                lambda w=w: os.path.exists(
                    os.path.join(fc.translate_path(w, "/app"), "train.py")
                ),
                msg=f"initial sync to {w.name}",
            )
        # the scaffold's excludes hold: no chart/ or .devspace/ on a worker
        app0 = fc.translate_path(workers[0], "/app")
        assert os.path.exists(os.path.join(app0, "Dockerfile"))
        assert not os.path.exists(os.path.join(app0, "chart"))
        assert not os.path.exists(os.path.join(app0, ".devspace"))
        # hot edit -> propagates to all workers
        write_file(str(project / "train.py"), "import torch\nprint('edited')\n")
        future = time.time() + 3
        os.utime(str(project / "train.py"), (future, future))
        for w in workers:
            wait_for(
                lambda w=w: "edited"
                in open(os.path.join(fc.translate_path(w, "/app"), "train.py")).read(),
                msg=f"hot reload on {w.name}",
            )
        # remote-created file comes back (worker 0 authoritative)
        write_file(os.path.join(app0, "ckpt.txt"), "weights")
        wait_for(lambda: (project / "ckpt.txt").exists(), msg="download")
        # status sync from the published status file: both workers healthy
        capsys.readouterr()
        assert main(["status", "sync"]) == 0
        out = capsys.readouterr().out
        assert "Active" in out
        rows = [ln.split() for ln in out.splitlines()]
        assert ["proj-0", "authority"] == next(r[:2] for r in rows if r[:1] == ["proj-0"])
        assert ["proj-1", "mirror"] == next(r[:2] for r in rows if r[:1] == ["proj-1"])
    finally:
        loop.stop()
        loop.stop_services()
        t.join(timeout=5)
    assert not loop.sync_sessions and ctx.backend.connections.close_all() == 0


def test_status_sync_falls_back_to_the_sync_log(project, capsys):
    """Without a status file, ``status sync`` reads ``.devspace/logs/
    sync.log``; without either it exits 1."""
    assert main(["init"]) == 0
    capsys.readouterr()
    assert main(["status", "sync"]) == 1
    assert "no sync log found" in capsys.readouterr().out
    mirror = logutil.get_file_logger("sync", root=str(project / ".devspace"))
    mirror.info("[sync] starting: a <-> /app on 2 worker(s)")
    mirror.info("[sync] Uploaded 3 change(s) to 2 worker(s)")
    mirror.info("[sync] Downloaded 1 change(s)")
    mirror.close()
    assert main(["status", "sync"]) == 0
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    assert ["Active", "1", "1", "1", "0"] in rows


def test_enter_runs_command(project, capsys):
    assert main(["init"]) == 0
    assert main(["deploy"]) == 0
    capsys.readouterr()
    rc = main(["enter", "--worker", "1", "--", "sh", "-c", "echo hello-from-worker; pwd"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "hello-from-worker" in out
    fc = FakeCluster(os.environ["DEVSPACE_FAKE_BACKEND"], persist=True)
    assert fc.pod_dir("proj-1") in out  # ran in worker 1, not worker 0
    assert main(["enter", "--worker", "0", "--", "sh", "-c", "exit 4"]) == 4


def test_enter_all_broadcasts(project, capsys):
    """enter --all runs the command on every worker with worker-prefixed
    output and propagates non-zero exits."""
    assert main(["init"]) == 0
    assert main(["deploy"]) == 0
    # the command must reach EVERY deployed worker, not just one
    fc = FakeCluster(os.environ["DEVSPACE_FAKE_BACKEND"], persist=True)
    n_workers = len(fc.list_pods())
    assert n_workers == 2
    capsys.readouterr()
    rc = main(["enter", "--all", "--", "sh", "-c", "echo hello-$NODE_RANK"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("hello-") == n_workers
    assert {ln.split()[0] for ln in out.splitlines() if "hello-" in ln} == {
        "[worker-0]", "[worker-1]"}
    assert main(["enter", "--all", "--", "sh", "-c", "exit 3"]) == 3
    # --all without a command, or with --worker, is an error
    assert main(["enter", "--all"]) == 1
    assert main(["enter", "--all", "--worker", "0", "--", "true"]) == 1


def test_logs_prefixes_each_worker(project, capsys):
    assert main(["init"]) == 0
    assert main(["deploy"]) == 0
    fc = FakeCluster(os.environ["DEVSPACE_FAKE_BACKEND"], persist=True)
    # fake pod logs live in memory: seed them on the CLI's own backend
    real = Context.__init__

    def seeded(self, args):
        real(self, args)
        for i in range(2):
            self.backend.set_logs(f"proj-{i}", [f"line {j} of {i}" for j in range(5)])

    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Context, "__init__", seeded)
        assert main(["logs"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert "[worker-0] line 4 of 0" in out and "[worker-1] line 0 of 1" in out
        assert main(["logs", "--worker", "1", "--lines", "2"]) == 0
        out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[worker")]
        assert out == ["[worker-1] line 3 of 1", "[worker-1] line 4 of 1"]
    assert len(fc.list_pods()) == 2


def test_redeploy_example_uses_watch_only_loop(tmp_path, monkeypatch):
    """examples/redeploy-instead-of-hot-reload: dev with NO sync config —
    the auto-reload watcher drives a full rebuild+redeploy on change
    (reference: examples/redeploy-instead-of-hot-reload)."""
    example = REPO / "examples" / "redeploy-instead-of-hot-reload"
    proj = tmp_path / "proj"
    shutil.copytree(example, proj, ignore=shutil.ignore_patterns("logs", "generated.json",
                                                                 "trace.jsonl"))
    monkeypatch.chdir(proj)
    monkeypatch.setenv("DEVSPACE_FAKE_BACKEND", str(tmp_path / "cluster"))
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    logutil.set_logger(logutil.DiscardLogger())

    ctx = Context(Args())
    assert not (ctx.config.dev and ctx.config.dev.sync), "example must not sync"
    loop = DevLoop(ctx, Args())
    t = threading.Thread(target=loop.run, daemon=True)
    t.start()
    try:
        wait_for(loop.services_ready.is_set, timeout=30, msg="services up")
        assert loop.sync_sessions == []  # no sync in this mode
        assert loop.watcher is not None  # the watcher IS the loop
        obj = ctx.backend.get_object(
            "apps/v1", "Deployment", "redeploy-example", ctx.namespace
        )
        tag_before = obj["spec"]["template"]["spec"]["containers"][0]["image"]
        # editing baked-in source triggers rebuild + redeploy with a new
        # tag. Wait on DURABLE outcomes (reload counter + deployed tag),
        # not the reload event — it is set and cleared within the fake
        # rebuild, faster than any poll.
        write_file(str(proj / "app.py"), "print('changed')\n")
        wait_for(lambda: loop.reload_count >= 1, timeout=30, msg="watcher fired")

        def redeployed():
            obj = ctx.backend.get_object(
                "apps/v1", "Deployment", "redeploy-example", ctx.namespace
            )
            tag = obj["spec"]["template"]["spec"]["containers"][0]["image"]
            return tag != tag_before and loop.services_ready.is_set()

        wait_for(redeployed, timeout=30, msg="redeployed with a new image tag")
    finally:
        loop.stop()
        loop.stop_services()
        t.join(timeout=5)


def test_kaniko_builder_on_fake_cluster(tmp_path, monkeypatch):
    """In-cluster kaniko build orchestration against the fake backend:
    pod spawn + context upload (sync one-shot) + entrypoint-override
    Dockerfile rewrite + executor invocation + pod cleanup
    (reference behavior: builder/kaniko/kaniko.go:84-255)."""
    from devspace_tpu_torch.builder.builders import KanikoBuilder

    fc = FakeCluster(str(tmp_path / "cluster"))
    ctx = tmp_path / "ctx"
    write_file(str(ctx / "Dockerfile"), "FROM scratch\nENTRYPOINT [\"app\"]\n")
    write_file(str(ctx / "src" / "main.py"), "print('hi')\n")

    seen = {}
    real_exec = fc.exec_stream

    def exec_stream(pod, command, **kw):
        if command and command[0] == "/kaniko/executor":
            seen["args"] = command
            seen["container"] = kw.get("container")
            # inspect the pod fs WHILE the pod is alive (deleted after)
            ctx_arg = next(a for a in command if a.startswith("--context="))
            ctx_dir = fc.translate_path(pod, ctx_arg.split("=", 1)[1])
            seen["uploaded"] = sorted(
                os.path.relpath(os.path.join(dp, f), ctx_dir)
                for dp, _, fns in os.walk(ctx_dir)
                for f in fns
            )
            with open(os.path.join(ctx_dir, "Dockerfile")) as fh:
                seen["dockerfile"] = fh.read()
            return real_exec(pod, ["sh", "-c", "echo pushed"], **kw)
        return real_exec(pod, command, **kw)

    monkeypatch.setattr(fc, "exec_stream", exec_stream)
    builder = KanikoBuilder(fc, namespace="default", pull_secret="regcred")
    builder.build(
        "registry.local/app",
        "t1",
        str(ctx),
        str(ctx / "Dockerfile"),
        entrypoint_override=["sleep", "inf"],
        build_args={"FOO": "bar"},
    )
    assert "--destination=registry.local/app:t1" in seen["args"]
    assert "--build-arg=FOO=bar" in seen["args"] and "--cache=true" in seen["args"]
    assert seen["container"] == "kaniko"
    assert seen["uploaded"] == ["Dockerfile", os.path.join("src", "main.py")]
    # entrypoint override rewrote the remote Dockerfile, not the local one
    assert 'ENTRYPOINT ["sleep", "inf"]' in seen["dockerfile"]
    assert "sleep" not in (ctx / "Dockerfile").read_text()
    # the build pod is cleaned up
    assert fc.list_pods(namespace="default") == []
