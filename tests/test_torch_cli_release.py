"""The port's ``install``, ``upgrade`` and start-up version notice.

``install`` writes a launcher named ``devspace-tpu-torch`` that runs
``python -m devspace_tpu_torch`` (never the reference's
``devspace-tpu``), and ``--update-path`` adds its PATH line once.
``upgrade`` prints its instructions without ``--apply``, refuses
``--apply`` outside a git checkout, and with ``--archive`` swaps the
``devspace_tpu_torch/`` of an isolated checkout under ``tmp_path`` for
the one in a release tarball, leaving the checkout's ``devspace_tpu/``
alone: once from the archive ``scripts/make_release_torch.sh`` packs of
this tree, through a copy of the package in a child process, and through
the reference's cases (same version, older, a fixture copy deeper in the
archive, truncated, no package, a member that escapes, a git checkout)
with the reference's exit codes. No test here upgrades this repo: each
points ``_checkout_root`` or ``PYTHONPATH`` at a copy under ``tmp_path``.
The notice fires at most once a day, skips pre-releases and archives
without ``devspace_tpu_torch/``, ignores hostile archives, and keeps its
daily stamp apart from the reference's."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tarfile
import time

import pytest

import devspace_tpu_torch
from devspace_tpu.cli import main as jcli
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch.cli import main as tcli
from devspace_tpu_torch.utils import log as logutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stdout:
    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("DEVSPACE_CLOUD_CONFIG", str(tmp_path / "clouds.yaml"))
    monkeypatch.delenv("DEVSPACE_RELEASE_DIR", raising=False)
    monkeypatch.delenv("DEVSPACE_SKIP_VERSION_CHECK", raising=False)
    monkeypatch.chdir(tmp_path)
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    return home


# -- install ----------------------------------------------------------------------
def test_install_writes_the_ports_launcher(tmp_path, capsys):
    bin_dir = tmp_path / "bin"
    capsys.readouterr()
    assert tcli.main(["install", "--bin-dir", str(bin_dir)]) == 0
    launcher = bin_dir / "devspace-tpu-torch"
    assert os.listdir(bin_dir) == ["devspace-tpu-torch"] and os.access(launcher, os.X_OK)
    assert launcher.read_text() == (
        "#!/bin/sh\n"
        f'export PYTHONPATH="{REPO}${{PYTHONPATH:+:$PYTHONPATH}}"\n'
        f'exec "{sys.executable}" -m devspace_tpu_torch "$@"\n')
    out = capsys.readouterr().out.splitlines()
    assert out == [f"[done] [install] wrote {launcher}",
                   f"[warn] [install] {bin_dir} is not on PATH — rerun with --update-path or "
                   "add it manually"]
    run = subprocess.run([str(launcher), "--version"], capture_output=True, text=True,
                         timeout=60, cwd=tmp_path)
    assert run.returncode == 0 and run.stdout.strip() == devspace_tpu_torch.__version__
    # the reference's install beside it keeps its own launcher
    assert jcli.main(["install", "--bin-dir", str(bin_dir)]) == 0
    assert sorted(os.listdir(bin_dir)) == ["devspace-tpu", "devspace-tpu-torch"]
    assert "-m devspace_tpu_torch" in launcher.read_text()


@pytest.mark.parametrize("shell, rc_name, line", [
    ("/bin/bash", ".bashrc", 'export PATH="{bin}:$PATH"'),
    ("/usr/bin/fish", ".config/fish/config.fish", 'set -gx PATH "{bin}" $PATH'),
])
def test_install_update_path_adds_its_line_once(tmp_path, env, monkeypatch, shell, rc_name,
                                                line):
    monkeypatch.setenv("SHELL", shell)
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    bin_dir = tmp_path / "bin"
    for _ in range(2):
        assert tcli.main(["install", "--bin-dir", str(bin_dir), "--update-path"]) == 0
    assert jcli.main(["install", "--bin-dir", str(bin_dir), "--update-path"]) == 0
    text = (env / rc_name).read_text()
    assert text == f"\n# added by devspace-tpu-torch install\n{line.format(bin=bin_dir)}\n"


# -- upgrade ------------------------------------------------------------------------
def test_upgrade_without_apply_and_outside_git(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tcli, "_checkout_root", lambda: str(tmp_path))
    capsys.readouterr()
    assert tcli.main(["upgrade"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    assert line == (f"devspace-tpu-torch {devspace_tpu_torch.__version__} — run "
                    f"'devspace-tpu-torch upgrade --apply' to git pull {tmp_path}, or "
                    "'upgrade --archive <release.tgz>' to install a release artifact")
    assert tcli.main(["upgrade", "--apply"]) == 1
    assert "is not a git checkout" in capsys.readouterr().out


def _isolated_copy(root, version: str):
    """A checkout under ``root``: a copy of this tree's package at
    ``version`` and, beside it, a ``devspace_tpu/`` that must stay."""
    shutil.copytree(os.path.join(REPO, "devspace_tpu_torch"), root / "devspace_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    init = root / "devspace_tpu_torch" / "__init__.py"
    init.write_text(re.sub(r'__version__ = "[^"]+"', f'__version__ = "{version}"',
                           init.read_text()))
    (root / "devspace_tpu").mkdir()
    (root / "devspace_tpu" / "__init__.py").write_text('__version__ = "0.0.1"\n')
    return root


def test_upgrade_an_isolated_copy_from_the_release_archive_of_this_tree(tmp_path):
    archive = tmp_path / "rel" / "release.tgz"
    archive.parent.mkdir()
    made = subprocess.run(["sh", os.path.join(REPO, "scripts", "make_release_torch.sh"),
                           "rel/release.tgz"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHON": sys.executable})
    assert made.returncode == 0, made.stderr
    version = devspace_tpu_torch.__version__
    with tarfile.open(archive) as tf:
        names = tf.getnames()
    top = f"devspace-tpu-torch-{version}"
    assert {n.split("/")[0] for n in names} == {top}
    for want in ("devspace_tpu_torch/__init__.py", "devspace_tpu_torch/csrc/paged_decode.cu",
                 "docs", "examples", "README.md"):
        assert f"{top}/{want}" in names, want
    assert f"{top}/devspace_tpu_torch/ops/_build.py" in names
    assert not any(n.startswith(f"{top}/devspace_tpu_torch/_build") or "__pycache__" in n
                   or "/devspace_tpu/" in n for n in names)

    install = _isolated_copy(tmp_path / "install", "0.0.1")
    (install / "devspace_tpu_torch" / "stale_marker.py").write_text("OLD = 1\n")
    work = tmp_path / "work"
    work.mkdir()
    child_env = {**os.environ, "PYTHONPATH": str(install), "DEVSPACE_SKIP_VERSION_CHECK": "1"}

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "devspace_tpu_torch", *args], cwd=work,
                              env=child_env, capture_output=True, text=True, timeout=120)

    where = subprocess.run([sys.executable, "-c", "import devspace_tpu_torch as m; "
                            "print(m.__file__)"], cwd=work, env=child_env, capture_output=True,
                           text=True, timeout=60)
    assert where.stdout.strip() == str(install / "devspace_tpu_torch" / "__init__.py")
    up = cli("upgrade", "--archive", str(archive))
    assert up.returncode == 0, up.stdout + up.stderr
    assert f"[upgrade] 0.0.1 -> {version} (from {archive})" in up.stdout
    pkg = install / "devspace_tpu_torch"
    assert f'__version__ = "{version}"' in (pkg / "__init__.py").read_text()
    assert (pkg / "csrc" / "paged_decode.cu").read_bytes() == \
        open(os.path.join(REPO, "devspace_tpu_torch", "csrc", "paged_decode.cu"), "rb").read()
    assert not (pkg / "stale_marker.py").exists()
    assert sorted(os.listdir(install)) == ["devspace_tpu", "devspace_tpu_torch"]  # no .bak
    assert (install / "devspace_tpu" / "__init__.py").read_text() == '__version__ = "0.0.1"\n'
    again = cli("upgrade", "--archive", str(archive))
    assert again.returncode == 0 and f"already at {version}" in again.stdout


def _archive(path, version, pkg, top="x", extra=()):
    """A release tarball at ``path`` holding ``top/<pkg>/__init__.py`` at
    ``version`` and a marker, plus ``extra`` members ``(name, bytes)``."""
    with tarfile.open(path, "w:gz") as tf:
        members = list(extra)
        if version is not None:
            members += [(f"{top}/{pkg}/__init__.py", f'__version__ = "{version}"\n'.encode()),
                        (f"{top}/{pkg}/marker_{version.replace('.', '_')}.py", b"X = 1\n")]
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return path


def _upgrade_cases(root, pkg, other):
    """The reference's upgrade cases against a checkout under ``root``
    holding ``pkg`` at 0.1.0: ``[(case, argv)]``."""
    a = root / "archives"
    a.mkdir()
    return [
        ("newer", ["upgrade", "--archive", str(_archive(a / "n.tgz", "0.2.0", pkg))]),
        ("same", ["upgrade", "--archive", str(_archive(a / "s.tgz", "0.2.0", pkg, top="y"))]),
        ("same-forced", ["upgrade", "--force", "--archive", str(a / "s.tgz")]),
        ("older", ["upgrade", "--archive", str(_archive(a / "o.tgz", "0.1.0", pkg))]),
        ("deeper-fixture", ["upgrade", "--archive", str(_archive(
            a / "d.tgz", "0.3.0", pkg, top="rel",
            extra=[(f"rel/tests/fixtures/{pkg}/__init__.py", b'__version__ = "9.9.9"\n')]))]),
        ("truncated", ["upgrade", "--archive", str(a / "t.tgz")]),
        ("no-package", ["upgrade", "--archive", str(_archive(
            a / "j.tgz", None, pkg, extra=[("junkfile", b"nope")]))]),
        ("other-package", ["upgrade", "--archive", str(_archive(a / "r.tgz", "9.9.9", other))]),
        ("escape", ["upgrade", "--archive", str(_archive(
            a / "e.tgz", "0.4.0", pkg, extra=[(f"x/{pkg}/../../../evil.py", b"E = 1\n")]))]),
        ("missing", ["upgrade", "--archive", str(a / "nothing-here.tgz")]),
    ]


def test_upgrade_archive_cases_exit_as_the_reference(tmp_path, monkeypatch, capsys):
    results = {}
    for who, cli, pkg, other in (("ref", jcli, "devspace_tpu", "devspace_tpu_torch"),
                                 ("prt", tcli, "devspace_tpu_torch", "devspace_tpu")):
        root = tmp_path / who
        checkout = root / "install"
        (checkout / pkg).mkdir(parents=True)
        (checkout / pkg / "__init__.py").write_text('__version__ = "0.1.0"\n')
        (checkout / pkg / "old_marker.py").write_text("OLD = 1\n")
        (checkout / other).mkdir()
        (checkout / other / "__init__.py").write_text("# the other package\n")
        monkeypatch.setattr(cli, "_checkout_root", lambda c=checkout: str(c))
        cases = _upgrade_cases(root, pkg, other)
        (root / "archives" / "t.tgz").write_bytes((root / "archives" / "n.tgz").read_bytes()[:200])
        runs = []
        for case, argv in cases:
            capsys.readouterr()
            rc = cli.main(argv)
            out = capsys.readouterr().out.replace(str(root), "ROOT")
            files = sorted(os.listdir(checkout / pkg))
            runs.append((case, rc, re.sub(r"devspace_tpu(_torch)?\b", "PKG", out), files))
            assert (checkout / other / "__init__.py").read_text() == "# the other package\n"
            assert sorted(os.listdir(checkout)) == sorted([pkg, other]), case
        assert not (root / "evil.py").exists() and not (tmp_path / "evil.py").exists()
        results[who] = runs
    for (case, jrc, jout, jfiles), (_, rc, out, files) in zip(results["ref"], results["prt"]):
        assert (rc, out, files) == (jrc, jout, jfiles), case
    rcs = {case: rc for case, rc, _, _ in results["prt"]}
    assert rcs == {"newer": 0, "same": 0, "same-forced": 0, "older": 1, "deeper-fixture": 0,
                   "truncated": 1, "no-package": 1, "other-package": 1, "escape": 1,
                   "missing": 1}
    final = dict((c, f) for c, _, _, f in results["prt"])["missing"]
    assert final == ["__init__.py", "marker_0_3_0.py"]


def test_upgrade_archive_refuses_a_git_checkout(tmp_path, monkeypatch, capsys):
    checkout = tmp_path / "dev"
    (checkout / "devspace_tpu_torch").mkdir(parents=True)
    (checkout / "devspace_tpu_torch" / "__init__.py").write_text('__version__ = "0.1.0"\n')
    (checkout / ".git").mkdir()
    monkeypatch.setattr(tcli, "_checkout_root", lambda: str(checkout))
    archive = _archive(tmp_path / "r.tgz", "9.9.9", "devspace_tpu_torch")
    capsys.readouterr()
    assert tcli.main(["upgrade", "--archive", str(archive)]) == 1
    assert "is a git checkout" in capsys.readouterr().out
    assert "0.1.0" in (checkout / "devspace_tpu_torch" / "__init__.py").read_text()
    assert tcli.main(["upgrade", "--force", "--archive", str(archive)]) == 0
    assert "9.9.9" in (checkout / "devspace_tpu_torch" / "__init__.py").read_text()


# -- the start-up version notice ----------------------------------------------------
def test_the_notice_once_a_day_stable_port_archives_only(tmp_path, env, monkeypatch, capsys):
    releases = tmp_path / "releases"
    releases.mkdir()
    _archive(releases / "devspace-tpu-torch-9.9.9.tgz", "9.9.9", "devspace_tpu_torch")
    _archive(releases / "devspace-tpu-torch-10.0.0-rc1.tar.gz", "10.0.0-rc1",
             "devspace_tpu_torch")
    _archive(releases / "devspace-tpu-11.0.0.tar.gz", "11.0.0", "devspace_tpu")
    (releases / "devspace-tpu-torch-12.0.0.tgz").write_bytes(b"\x1f\x8b not a tarball")
    link = tarfile.TarInfo("x/devspace_tpu_torch/__init__.py")
    link.type, link.linkname = tarfile.SYMTYPE, "/etc/passwd"
    with tarfile.open(releases / "devspace-tpu-torch-13.0.0.tgz", "w:gz") as tf:
        tf.addfile(link)
    _archive(releases / "devspace-tpu-torch-0.0.9.tgz", "0.0.9", "devspace_tpu_torch")
    monkeypatch.setenv("DEVSPACE_RELEASE_DIR", str(releases))
    notice = (f"[warn] There is a newer version of devspace-tpu-torch v9.9.9. Run "
              f"`devspace-tpu-torch upgrade --archive {releases / 'devspace-tpu-torch-9.9.9.tgz'}`"
              " to update the cli.")
    # a fresh stamp of the reference's does not silence the port's notice
    ref_stamp = env / ".devspace" / "version_check.json"
    ref_stamp.parent.mkdir()
    ref_stamp.write_text(json.dumps({"checked_at": time.time(), "release_dir": str(releases)}))

    def run(argv=("list", "providers")):
        capsys.readouterr()
        assert tcli.main(list(argv)) == 0
        return [ln for ln in capsys.readouterr().out.splitlines() if "newer version" in ln]

    assert run() == [notice]
    stamp = env / ".devspace" / "version_check_torch.json"
    assert json.loads(stamp.read_text())["release_dir"] == str(releases)
    assert run() == []  # within the day
    data = json.loads(stamp.read_text())
    stamp.write_text(json.dumps({**data, "checked_at": 0}))
    assert run() == [notice]  # a stale stamp
    stamp.write_text(json.dumps({**data, "release_dir": str(tmp_path)}))
    assert run() == [notice]  # another channel
    stamp.write_text("{not json")
    assert run() == [notice]  # a broken stamp is no stamp
    stamp.unlink()
    assert run(["upgrade"]) == [] and not stamp.exists()  # upgrade and print never check
    monkeypatch.setenv("DEVSPACE_SKIP_VERSION_CHECK", "1")
    assert run() == [] and not stamp.exists()
    monkeypatch.delenv("DEVSPACE_SKIP_VERSION_CHECK")
    monkeypatch.setattr(devspace_tpu_torch, "__version__", "0.2.0-rc1")
    assert run() == [] and not stamp.exists()  # a pre-release build does not nag
    monkeypatch.setattr(devspace_tpu_torch, "__version__", "9.9.9")
    assert run() == []  # nothing newer and stable
    # the reference's notice reads its own archives and its own stamp
    ref_stamp.unlink()
    capsys.readouterr()
    assert jcli.main(["list", "providers"]) == 0
    assert [ln for ln in capsys.readouterr().out.splitlines() if "newer version" in ln] == [
        "[warn] There is a newer version of devspace-tpu v11.0.0. Run `devspace-tpu upgrade "
        f"--archive {releases / 'devspace-tpu-11.0.0.tar.gz'}` to update the cli."]
    assert json.loads(stamp.read_text())["release_dir"] == str(releases)
