"""The port's ``deploy/packages.py`` and ``deploy/lint.py`` held against the
reference's: ``search``/``resolve`` and ``_version_key``; add, list and
remove, whose vendored tree, ``requirements.yaml`` and ``values.yaml``
are byte for byte the reference's; the render of a parent chart with a
package equal to the reference's; ``check_updates`` and
``upgrade_package``; an http repo serving an archive; the archive scheme
restriction; the CLI's ``add|list|remove package``, ``search`` and
``update packages [--apply]`` printing what the reference's CLI prints;
``validate_manifests`` strings equal to the reference's; and
``lint_gpu_consistency``/``lint_chart`` on chart-gpu. Repos and parent
charts are ``test_packages.make_repo``/``make_parent_chart``."""

import functools
import http.server
import io
import os
import re
import sys
import tarfile
import threading
from dataclasses import asdict

import pytest
import yaml

from test_packages import REDIS_TEMPLATE, make_parent_chart, make_repo

from devspace_tpu.cli.main import main as jmain
from devspace_tpu.deploy import chart as jchart
from devspace_tpu.deploy import lint as jlint
from devspace_tpu.deploy import packages as jpackages
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch.cli.main import main
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.deploy import chart, lint, packages
from devspace_tpu_torch.lint import lint_docs
from devspace_tpu_torch.utils import log as logutil

CHART_GPU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "devspace_tpu_torch", "generator", "templates", "chart-gpu")


class _Stdout:
    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture(autouse=True)
def loggers(monkeypatch):
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.delenv("DEVSPACE_CHART_REPO", raising=False)
    monkeypatch.delenv("DEVSPACE_RELEASE_DIR", raising=False)
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))


def tree(root) -> dict:
    """Every file under ``root``: its path relative to it -> its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def publish_v2(repo_root):
    """The repo publishes redis 2.0.0 beside 1.0.0."""
    chart2 = repo_root / "charts" / "redis-2"
    (chart2 / "templates").mkdir(parents=True)
    (chart2 / "chart.yaml").write_text("name: redis\nversion: 2.0.0\n")
    (chart2 / "values.yaml").write_text("replicas: 2\ntag: '7.2'\nnewKey: 1\n")
    (chart2 / "templates" / "deployment.yaml").write_text(REDIS_TEMPLATE)
    (repo_root / "index.yaml").write_text(yaml.safe_dump({"entries": {"redis": [
        {"version": "2.0.0", "path": "charts/redis-2"},
        {"version": "1.0.0", "path": "charts/redis"}]}}))


def test_search_resolve_and_version_order_equal_the_reference(tmp_path):
    repo = make_repo(tmp_path / "repo", with_v2=True)
    for query in ("memory", "redis", "", "nosuch"):
        assert [asdict(h) for h in packages.search_charts(repo, query)] == \
            [asdict(h) for h in jpackages.search_charts(repo, query)]
    assert packages.search_charts(repo, "memory")[0].version == "2.0.0"
    for version in (None, "1.0.0"):
        assert asdict(packages.resolve(repo, "redis", version)) == \
            asdict(jpackages.resolve(repo, "redis", version))
    for args, match in (((repo, "redis", "9"), "no version 9"), ((repo, "postgres"), "not found")):
        with pytest.raises(jpackages.PackageError, match=match) as want:
            jpackages.resolve(*args)
        with pytest.raises(packages.PackageError) as got:
            packages.resolve(*args)
        assert str(got.value) == str(want.value)
    versions = ["1.2.3", "1.2.3-rc1", "v1.10", "1.9", "2", "1.2.3-beta", "0.1.0", "1.x", "10.0"]
    assert sorted(versions, key=packages._version_key) == \
        sorted(versions, key=jpackages._version_key)


def test_add_list_remove_vendor_the_reference_tree(tmp_path):
    repo = make_repo(tmp_path / "repo")
    trees = {}
    for who, mod in (("port", packages), ("reference", jpackages)):
        chart_dir = make_parent_chart(tmp_path / who)
        assert mod.add_package(chart_dir, repo, "redis").version == "1.0.0"
        trees[who] = tree(chart_dir)
        assert mod.list_packages(chart_dir) == [
            {"name": "redis", "version": "1.0.0", "repository": repo, "vendored": True}]
        with pytest.raises(mod.PackageError, match="already added"):
            mod.add_package(chart_dir, repo, "redis")
    assert trees["port"] == trees["reference"]
    assert trees["port"]["requirements.yaml"] == yaml.safe_dump(
        {"dependencies": [{"name": "redis", "version": "1.0.0", "repository": repo}]},
        sort_keys=False).encode()
    assert "packages/redis/templates/deployment.yaml" in trees["port"]
    chart_dir = str(tmp_path / "port" / "chart")
    assert packages.load_requirements(chart_dir) == jpackages.load_requirements(chart_dir)
    assert packages.remove_package(chart_dir, "redis")
    assert jpackages.remove_package(str(tmp_path / "reference" / "chart"), "redis")
    assert tree(chart_dir) == tree(tmp_path / "reference" / "chart")
    assert "requirements.yaml" not in tree(chart_dir)
    assert "packages" not in yaml.safe_load(open(os.path.join(chart_dir, "values.yaml")))
    assert not packages.remove_package(chart_dir, "redis")  # idempotent


def test_render_with_a_package_equals_the_reference(tmp_path):
    repo = make_repo(tmp_path / "repo")
    chart_dir = make_parent_chart(tmp_path)
    packages.add_package(chart_dir, repo, "redis")
    values_path = os.path.join(chart_dir, "values.yaml")
    values = yaml.safe_load(open(values_path))
    values["packages"]["redis"]["replicas"] = 3
    with open(values_path, "w") as fh:
        yaml.safe_dump(values, fh)
    docs = chart.render_chart(chart_dir, "myapp", "default")
    assert docs == jchart.render_chart(chart_dir, "myapp", "default")
    dep = next(m for m in docs if m["kind"] == "Deployment")
    assert dep["metadata"]["name"] == "myapp-redis" and dep["spec"]["replicas"] == 3
    assert dep["spec"]["template"]["spec"]["containers"][0]["image"] == "redis:7.0"


def test_check_updates_and_upgrade_package_equal_the_reference(tmp_path):
    repo_root = tmp_path / "repo"
    repo = make_repo(repo_root)
    dirs = {}
    for who, mod in (("port", packages), ("reference", jpackages)):
        chart_dir = make_parent_chart(tmp_path / who)
        mod.add_package(chart_dir, repo, "redis")
        values_path = os.path.join(chart_dir, "values.yaml")
        vals = yaml.safe_load(open(values_path))
        vals["packages"]["redis"]["tag"] = "custom"
        yaml.safe_dump(vals, open(values_path, "w"), sort_keys=False)
        dirs[who] = chart_dir
    rows = packages.check_updates(dirs["port"])
    assert rows == jpackages.check_updates(dirs["reference"]) == [
        {"name": "redis", "current": "1.0.0", "latest": "1.0.0", "repository": repo,
         "update": False, "error": ""}]
    publish_v2(repo_root)
    cache, jcache = {}, {}
    rows = packages.check_updates(dirs["port"], index_cache=cache)
    assert rows == jpackages.check_updates(dirs["reference"], index_cache=jcache)
    assert rows[0]["latest"] == "2.0.0" and rows[0]["update"] is True and list(cache) == [repo]
    assert packages.upgrade_package(dirs["port"], "redis", index_cache=cache).version == "2.0.0"
    jpackages.upgrade_package(dirs["reference"], "redis", index_cache=jcache)
    assert tree(dirs["port"]) == tree(dirs["reference"])
    vals = yaml.safe_load(open(os.path.join(dirs["port"], "values.yaml")))
    assert vals["packages"]["redis"] == {"replicas": 1, "tag": "custom", "newKey": 1}
    # a second upgrade is a no-op; an unknown package raises
    before = tree(dirs["port"])
    packages.upgrade_package(dirs["port"], "redis")
    assert tree(dirs["port"]) == before
    with pytest.raises(packages.PackageError, match="not in requirements.yaml"):
        packages.upgrade_package(dirs["port"], "postgres")
    # a repo that is gone: the row carries the reference's error
    (repo_root / "index.yaml").unlink()
    assert packages.check_updates(dirs["port"]) == jpackages.check_updates(dirs["reference"])
    assert packages.check_updates(dirs["port"])[0]["error"].startswith("cannot read")


def test_http_repo_with_an_archive(tmp_path):
    src = tmp_path / "src"
    make_repo(src)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        tf.add(str(src / "charts" / "redis"), arcname="redis")
    webroot = tmp_path / "web"
    webroot.mkdir()
    (webroot / "redis-1.0.0.tgz").write_bytes(buf.getvalue())
    (webroot / "index.yaml").write_text(yaml.safe_dump({"entries": {"redis": [
        {"version": "1.0.0", "description": "in-memory store", "archive": "redis-1.0.0.tgz"},
    ]}}))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(webroot))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        repo = f"http://127.0.0.1:{server.server_address[1]}"
        trees = {}
        for who, mod in (("port", packages), ("reference", jpackages)):
            chart_dir = make_parent_chart(tmp_path / who)
            assert mod.add_package(chart_dir, repo, "redis").version == "1.0.0"
            trees[who] = tree(chart_dir)
        assert trees["port"] == trees["reference"]
        assert len(chart.render_chart(str(tmp_path / "port" / "chart"), "app", "default")) == 2
    finally:
        server.shutdown()
        server.server_close()


def test_archive_url_scheme_restricted(tmp_path):
    """An index is outside input: an absolute archive URL of another scheme
    than http(s) (here file://) is refused before anything is read."""
    secret = tmp_path / "secret.tgz"
    secret.write_bytes(b"x")
    entry = packages.ChartEntry(name="evil", version="1.0.0", archive=f"file://{secret}")
    with pytest.raises(packages.PackageError, match="scheme 'file' not allowed"):
        packages._fetch_chart("http://127.0.0.1:9", entry, str(tmp_path / "dest"))
    assert not (tmp_path / "dest").exists()


SHARED = """\
version: tpu/v1
deployments:
  - name: web
    chart: {path: ./chart}
"""
CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")


def _run_package_flow(cli, root, repo_root, monkeypatch, capsys):
    """The package commands through ``cli`` in a project of its own:
    ``[(argv, rc, stdout lines)]`` and the chart dir's files. The repo
    publishes redis 2.0.0 half way."""
    proj = root / "proj"
    (proj / ".devspace").mkdir(parents=True)
    (proj / ".devspace" / "config.yaml").write_text(SHARED)
    make_parent_chart(proj)
    monkeypatch.chdir(proj)
    monkeypatch.setenv("DEVSPACE_FAKE_BACKEND", str(root / "cluster"))
    repo = str(repo_root)
    flow = [["search", "--repo", repo], ["search", "memory", "--repo", repo],
            ["search", "--repo", str(root / "no-repo")], ["search"],
            ["add", "package", "redis", "--repo", repo], ["list", "packages"],
            ["add", "package", "redis", "--repo", repo], ["add", "package", "redi", "--repo", repo],
            ["add", "package", "redis"], ["update", "packages"], ["publish"],
            ["update", "packages"], ["update", "packages", "nosuch"],
            ["update", "packages", "redis", "--apply"], ["update", "packages"],
            ["list", "packages"], ["remove", "package", "redis"],
            ["remove", "package", "redis"], ["list", "packages"], ["update", "packages"]]
    runs = []
    for argv in flow:
        if argv == ["publish"]:
            if not (repo_root / "charts" / "redis-2").exists():
                publish_v2(repo_root)
            continue
        capsys.readouterr()
        rc = cli(list(argv))
        runs.append((argv, rc, CLOCK.sub("HH:MM:SS", capsys.readouterr().out).splitlines()))
    return runs, tree(proj / "chart")


def test_package_commands_print_what_the_reference_prints(tmp_path, monkeypatch, capsys):
    """Each CLI runs the flow in a fresh project and repo at the same
    paths, so that paths and the tables' widths are the same."""
    import shutil

    root = tmp_path / "run"
    results = []
    for cli in (jmain, main):
        shutil.rmtree(root, ignore_errors=True)
        make_repo(root / "repo")
        results.append(_run_package_flow(cli, root, root / "repo", monkeypatch, capsys))
    (jruns, jtree), (runs, ctree) = results
    for (argv, jrc, jout), (_, rc, out) in zip(jruns, runs):
        assert (rc, out) == (jrc, jout), argv
    assert len(runs) == 19 and ctree == jtree
    assert "packages/redis/chart.yaml" not in ctree and "requirements.yaml" not in ctree
    failed = [" ".join(argv[:3]) for argv, rc, _ in runs if rc == 1]
    assert failed == ["search --repo " + str(root / "no-repo"), "search",
                      "add package redis", "add package redi", "add package redis",
                      "update packages nosuch", "remove package redis"]
    assert any("did you mean: redis" in ln for ln in runs[7][2])
    assert any("update available" in ln for ln in runs[10][2])
    assert any("upgraded from 1.0.0" in ln for ln in runs[12][2])


VALIDATE_DOCS = [
    [{"apiVersion": "v1", "kind": "Service", "metadata": {"name": "ok-name"},
      "spec": {"ports": [{"port": 80}]}}],
    [{"kind": "Service", "metadata": {"name": "Bad_Name"}},
     {"apiVersion": "v1", "kind": "Service", "metadata": {"name": "ok"}},
     {"apiVersion": "v1", "kind": "Service", "metadata": {"name": "ok"}},
     {"apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "d"},
      "spec": {"selector": {"matchLabels": {"app": "x"}},
               "template": {"metadata": {"labels": {"app": "y"}},
                            "spec": {"containers": [{"name": "c"}]}}}},
     "not a mapping",
     {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": "s"},
      "spec": {"replicas": "two", "template": {"spec": {"containers": []}}}}],
]


@pytest.mark.parametrize("docs", VALIDATE_DOCS, ids=["clean", "broken"])
def test_validate_manifests_strings_equal_the_reference(docs):
    got = lint.validate_manifests(docs)
    assert got == jlint.validate_manifests(docs)
    if len(docs) > 1:
        text = "\n".join(got)
        for want in ("missing apiVersion", "not DNS-1123", "duplicate object", "no image",
                     "selector.matchLabels not matched"):
            assert want in text, got


def test_lint_gpu_consistency_and_lint_chart_on_chart_gpu(tmp_path):
    import shutil

    gpu = latest.GPUConfig(workers=2, per_worker=8)
    assert lint.lint_chart(CHART_GPU) == [] and lint.lint_chart(CHART_GPU, gpu=gpu) == []
    docs = chart.render_chart(CHART_GPU, "job", "default",
                              extra_context={"gpu": chart.gpu_context(gpu)})
    assert lint.lint_gpu_consistency(docs, gpu) == []
    assert lint.lint_gpu_consistency(docs, None) == []  # no gpu block, no job rules
    # a template that hands torchrun one node for a two-worker job
    broken = tmp_path / "chart-gpu"
    shutil.copytree(CHART_GPU, broken)
    sts = broken / "templates" / "statefulset.yaml"
    sts.write_text(sts.read_text().replace("--nnodes=${{ gpu.workers }}", "--nnodes=1"))
    issues = lint.lint_chart(str(broken), gpu=gpu)
    docs = chart.render_chart(str(broken), "lint", "default",
                              extra_context={"gpu": chart.gpu_context(gpu)})
    assert issues == [f.legacy() for f in lint_docs(docs, gpu=gpu)
                      if f.category in ("manifest", "gpu")]
    assert any("nnodes" in i or "world" in i for i in issues), issues
    assert lint.lint_gpu_consistency(docs, gpu) == issues
    # a chart that does not render is itself the finding
    (broken / "templates" / "bad.yaml").write_text("kind: ${{ values.nope.deeper }}\n")
    (failure,) = lint.lint_chart(str(broken), gpu=gpu)
    assert failure.startswith("render failed: ")
