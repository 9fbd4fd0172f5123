"""The project-editing commands of the port's CLI against the JAX CLI's
(a port of tests/test_cli.py::test_add_remove_list_roundtrip): the same
``add``/``remove`` sequence on the same torch project, which has a ``gpu``
block in the port's copy and the reference's ``tpu`` block of the same
workers in its own (the reference refuses a ``gpu`` block), gives equal
config files but for that block, equal ``list`` output and equal exit
codes; ``use context|namespace|config`` write the same files; ``update
config`` rewrites a ``v1alpha1`` config to the same file. The edited
project still renders through chart-gpu with no lint finding."""

import os
import shutil
import sys

import pytest
import yaml

from devspace_tpu.cli import main as jcli
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch import lint
from devspace_tpu_torch.cli import main as tcli
from devspace_tpu_torch.config.loader import ConfigLoader
from devspace_tpu_torch.deploy.chart import ChartDeployer
from devspace_tpu_torch.utils import log as logutil
from devspace_tpu_torch.utils.fsutil import write_file

EXTRA = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "settings"},
         "data": {"mode": "dev"}}

# (argv, exit code) in order; list output is compared after each step
EDITS = [
    (["add", "port", "9999"], 0),
    (["add", "selector", "extra", "--label-selector", "tier=db,app=proj"], 0),
    (["add", "port", "--selector", "extra", "8081", "9090"], 0),
    (["add", "sync", "--selector", "extra", "--container", "/data", "--exclude", "a/,b.log"], 0),
    (["add", "deployment", "extras", "--manifests", "kube/*.yaml"], 0),
    (["add", "deployment", "second", "--chart", "./chart"], 0),
    (["add", "image", "sidecar", "--image", "registry.local/side", "--dockerfile",
      "Dockerfile"], 0),
    (["remove", "port", "9999"], 0),
    (["remove", "port", "1234"], 1),
    (["remove", "selector", "missing"], 1),
    (["remove", "deployment", "second"], 0),
    (["remove", "image", "sidecar"], 0),
    (["remove", "image", "sidecar"], 1),
    (["remove", "sync", "--container", "/data"], 0),
    (["add", "sync", "--container", "/cache"], 0),
]
LISTS = ["deployments", "images", "ports", "sync", "selectors", "vars", "configs"]


class _Stdout:
    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture
def projects(tmp_path, monkeypatch):
    """``(reference project, port project)``: the port's ``init`` of a
    torch project, and its copy with the ``gpu`` block as a ``tpu`` one."""
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    monkeypatch.delenv("DEVSPACE_FAKE_BACKEND", raising=False)
    monkeypatch.delenv("DEVSPACE_RELEASE_DIR", raising=False)
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    port = tmp_path / "proj"
    port.mkdir()
    write_file(str(port / "train.py"), "import torch\nprint('step 0')\n")
    write_file(str(port / "kube" / "extra.yaml"), yaml.safe_dump(EXTRA))
    monkeypatch.chdir(port)
    assert tcli.main(["init"]) == 0
    ref = tmp_path / "ref" / "proj"
    shutil.copytree(port, ref)
    cfg = yaml.safe_load((ref / ".devspace" / "config.yaml").read_text())
    assert cfg.pop("gpu")["workers"] == 2
    (ref / ".devspace" / "config.yaml").write_text(
        yaml.safe_dump({**cfg, "tpu": {"workers": 2}}, sort_keys=False))
    return ref, port


def run(cli, root, argv, capsys) -> tuple:
    """One CLI call in ``root``; the test has moved with ``monkeypatch.chdir``
    first, so its directory comes back after it."""
    os.chdir(root)
    capsys.readouterr()
    rc = cli.main(list(argv))
    return rc, capsys.readouterr().out


def config_without_block(root, block: str) -> tuple:
    """The saved config file's lines but those of ``block``, and the block."""
    text = (root / ".devspace" / "config.yaml").read_text()
    tree = yaml.safe_load(text)
    lines, skipping = [], False
    for line in text.splitlines():
        if line.startswith(f"{block}:"):
            skipping = True
            continue
        if skipping and line.startswith(" "):
            continue
        skipping = False
        lines.append(line)
    return lines, tree.get(block)


def test_add_remove_list_equal_the_reference(projects, capsys):
    ref, port = projects
    for argv, want in EDITS:
        (jrc, jout), (rc, out) = (run(cli, root, argv, capsys)
                                  for cli, root in ((jcli, ref), (tcli, port)))
        assert rc == jrc == want, (argv, out, jout)
        assert out == jout, argv
        (jlines, tpu), (lines, gpu) = config_without_block(ref, "tpu"), \
            config_without_block(port, "gpu")
        assert lines == jlines, argv
        assert tpu == {"workers": 2} and gpu["workers"] == 2, argv
        for what in LISTS:
            (jrc, jout), (rc, out) = (run(cli, root, ["list", what], capsys)
                                      for cli, root in ((jcli, ref), (tcli, port)))
            assert rc == jrc == 0 and out == jout, (argv, what)
    cfg = ConfigLoader(str(port)).load(interactive=False)
    assert [d.name for d in cfg.deployments] == ["proj", "extras"]
    assert [s.container_path for s in cfg.dev.sync] == ["/app", "/cache"]
    assert (cfg.gpu.workers, cfg.gpu.per_worker) == (2, 8)
    # the edited project still renders through chart-gpu, with no finding
    project = lint.load_project(str(port))
    findings, n_objects = lint.collect_project_findings(project)
    assert findings == [] and n_objects == 4
    chart = next(d for d in project.config.deployments if d.chart)
    docs = ChartDeployer(None, chart, project.namespace, base_dir=project.root) \
        .render_manifests(gpu=project.config.gpu)
    (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
    assert sts["spec"]["replicas"] == 2


def test_use_writes_what_the_reference_writes(projects, tmp_path, monkeypatch, capsys):
    ref, port = projects
    kubeconfig = {"apiVersion": "v1", "kind": "Config", "current-context": "a",
                  "clusters": [{"name": "c", "cluster": {"server": "https://c.invalid"}}],
                  "users": [{"name": "u", "user": {"token": "t"}}],
                  "contexts": [{"name": n, "context": {"cluster": "c", "user": "u"}}
                               for n in ("a", "b")]}
    for root in (ref, port):
        (root / "kubeconfig").write_text(yaml.safe_dump(kubeconfig))
    for argv, want in ((["use", "context", "b"], 0), (["use", "context", "nope"], 1),
                       (["use", "namespace", "team-a"], 0), (["use", "config", "prod"], 0)):
        outs = []
        for cli, root in ((jcli, ref), (tcli, port)):
            monkeypatch.setenv("KUBECONFIG", str(root / "kubeconfig"))
            outs.append(run(cli, root, argv, capsys))
        assert outs[1] == outs[0] and outs[1][0] == want, argv
        assert (port / "kubeconfig").read_text() == (ref / "kubeconfig").read_text()
        assert config_without_block(port, "gpu")[0] == config_without_block(ref, "tpu")[0]
    assert yaml.safe_load((port / "kubeconfig").read_text())["current-context"] == "b"
    assert yaml.safe_load((port / ".devspace" / "config.yaml").read_text())["cluster"] == \
        {"namespace": "team-a"}
    generated = [sorted(os.listdir(root / ".devspace")) for root in (ref, port)]
    assert generated[0] == generated[1]
    for name in generated[1]:
        if name.endswith(".yaml") and name != "config.yaml":
            assert (port / ".devspace" / name).read_text() == \
                (ref / ".devspace" / name).read_text(), name


V1ALPHA1 = {"version": "tpu/v1alpha1",
            "deployments": [{"name": "app", "autoReload": True, "chart": {"path": "chart"}}],
            "sync": [{"selector": "s", "containerPath": "/app", "localSubPath": "."}],
            "ports": [{"selector": "s", "localPort": 1, "remotePort": 2}],
            "terminal": {"selector": "s", "command": ["bash"]}}


def test_update_config_rewrites_v1alpha1_as_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # run() moves between the projects; undone after the test
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    outs = []
    for cli, name, block in ((jcli, "ref", {}), (tcli, "port", {"gpu": {"workers": 2}})):
        root = tmp_path / name
        write_file(str(root / ".devspace" / "config.yaml"),
                   yaml.safe_dump({**V1ALPHA1, **block}, sort_keys=False))
        for argv in (["update", "config"], ["update"]):
            outs.append(run(cli, root, argv, capsys))
    assert outs[2:] == outs[:2] and [rc for rc, _ in outs] == [0, 0, 0, 0]
    lines, gpu = config_without_block(tmp_path / "port", "gpu")
    assert lines == (tmp_path / "ref" / ".devspace" / "config.yaml").read_text().splitlines()
    assert gpu == {"workers": 2} and lines[0] == "version: tpu/v1"
