"""The port's native scanner (``devspace_tpu_torch/utils/native.py`` with
``devspace_tpu_torch/native/devsync.cc``) against the JAX package's: the
same walk entries, byte-identical tars and the same prune names; the
port's ``walk_local_tree``, ``build_tar`` and ``directory_hash`` equal the
JAX package's with the library on and with ``DEVSPACE_NATIVE=0``, and
their native and Python paths agree with each other. The loader gives way
to the Python path on a library it cannot use, and processes that reach
the first build at once leave one working library in the build dir
without ever opening the repo-level ``native/``.

The JAX package's library is compiled here from its ``native/devsync.cc``
into a temporary dir, so this file never writes the reference's own
build dir. g++ is needed, as it is for ``tests/test_native.py``.
"""

import ctypes
import dataclasses
import gzip
import io
import json
import os
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path

import pytest

from devspace_tpu.sync import session as jsession
from devspace_tpu.sync import shell as jshell
from devspace_tpu.sync.file_info import FileInformation as JInfo
from devspace_tpu.utils import hashutil as jhashutil
from devspace_tpu.utils import native as jnative
from devspace_tpu_torch.sync import session, shell
from devspace_tpu_torch.sync.file_info import FileInformation
from devspace_tpu_torch.utils import hashutil, native

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "devspace_tpu_torch"
T0 = 1_700_000_000
EXCLUDES = [".git/", "node_modules", "*.bin", "/top"]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both packages' libraries loaded: the port's from its build dir, the
    JAX package's compiled into a temporary dir."""
    ref_so = tmp_path_factory.mktemp("ref") / "libdevsync.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(ref_so),
                    str(REPO / "native" / "devsync.cc")], check=True, timeout=120)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DEVSPACE_NATIVE", raising=False)
        mp.setattr(jnative, "_lib_path", lambda: str(ref_so))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_load_failed", False)
        ours, theirs = native.load(), jnative.load()
        assert ours is not None and theirs is not None
        yield ours, theirs


def build_tree(root: Path, odd_names: bool = True) -> None:
    """A small tree with excluded and pruned dirs, a long name, a symlink
    cycle, links to a file and a dir, a dangling link and (with
    ``odd_names``) a name that is not UTF-8."""
    for d in ("src/nested", ".git/objects", "node_modules/pkg", "top/inner", "deep/top",
              "a/b", "d" * 60 + "/" + "e" * 60):
        (root / d).mkdir(parents=True, exist_ok=True)
    files = {"train.py": b"print('hi')\n", "src/model.py": b"x = 1\n",
             "src/nested/deep.txt": b"deep\n", ".git/objects/blob": b"blob\n",
             "node_modules/pkg/index.js": b"js\n", "data.bin": b"\0" * 1024,
             "top/inner/t.txt": b"t\n", "deep/top/k.txt": b"k\n",
             "d" * 60 + "/" + "e" * 60 + "/" + "f" * 40 + ".txt": b"longname content"}
    for i in range(70):
        files[f"many/m{i:03d}.py"] = bytes([65 + i % 26]) * (100 + 3 * i)
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    if odd_names:
        with open(os.path.join(bytes(root), b"caf\xe9.txt"), "wb") as fh:
            fh.write(b"latin-1 name\n")
    os.symlink("train.py", root / "link_to_file")
    os.symlink("src", root / "link_to_dir")
    os.symlink("missing-target", root / "dangling")
    os.symlink(str(root / "a"), root / "a" / "b" / "loop")
    for path in sorted(root.rglob("*"), reverse=True):
        if not path.is_symlink():
            os.utime(path, (T0, T0))


def tar_members(raw: bytes) -> dict:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(raw)) as tf:
        for m in tf.getmembers():
            data = tf.extractfile(m).read() if m.isfile() else b""
            out[m.name.rstrip("/")] = (m.isdir(), m.mode, m.uid, m.gid, m.mtime, m.size, data)
    return out


def entries_of(root: Path, exclude=None) -> list:
    """The tree's walk as the snapshot upload sees it, with remote
    metadata on two entries (mode 0 on a dir is a value, not unset)."""
    from devspace_tpu_torch.utils.ignoreutil import IgnoreMatcher

    walked = session.walk_local_tree(str(root), IgnoreMatcher(exclude or []))
    entries = [walked[k] for k in sorted(walked)]
    f = next(i for i, e in enumerate(entries) if not e.is_directory)
    d = next(i for i, e in enumerate(entries) if e.is_directory)
    entries[f] = dataclasses.replace(entries[f], remote_mode=0o600, remote_uid=1234,
                                     remote_gid=99)
    entries[d] = dataclasses.replace(entries[d], remote_mode=0)
    return entries


@pytest.mark.parametrize("follow", [True, False])
@pytest.mark.parametrize("prune", [None, [".git", "node_modules"]])
def test_walk_entries_equal_the_jax_packages(libs, tmp_path, follow, prune):
    build_tree(tmp_path)
    before = native.CALLS["walk"]
    ours = list(native.walk(str(tmp_path), prune=prune, follow_symlinks=follow))
    theirs = list(jnative.walk(str(tmp_path), prune=prune, follow_symlinks=follow))
    assert native.CALLS["walk"] == before + 1
    assert ours == theirs
    rels = {e.rel for e in ours}
    assert "caf\udce9.txt" in rels and "d" * 60 + "/" + "e" * 60 + "/" + "f" * 40 + ".txt" in rels
    assert "a/b/loop" in rels and ("dangling" in rels) == (not follow)
    link = next(e for e in ours if e.rel == "link_to_dir")
    assert link.is_symlink and link.is_dir == follow  # followed for stat, flagged a link
    assert (".git/objects/blob" in rels) == (prune is None)
    assert "top/inner/t.txt" in rels  # only prune names the C++ side skips


def test_pack_tar_bytes_equal_the_jax_packages(libs, tmp_path):
    build_tree(tmp_path)
    entries = [
        native.PackEntry(name=e.rel, is_dir=e.is_dir,
                         mode=[-1, 0o600, 0, 0o755][i % 4] if e.is_dir or i % 2 else -1,
                         uid=[-1, 1234][i % 2], gid=[-1, 99][i % 3 == 0], mtime=e.mtime)
        for i, e in enumerate(native.walk(str(tmp_path), follow_symlinks=True))
    ] + [native.PackEntry("gone.txt", False, -1, -1, -1, T0)]
    before = native.CALLS["pack_tar"]
    ours = native.pack_tar(str(tmp_path), entries)
    assert ours == jnative.pack_tar(str(tmp_path), [jnative.PackEntry(*e) for e in entries])
    assert native.CALLS["pack_tar"] == before + 1
    members = tar_members(ours)
    assert "gone.txt" not in members  # an entry that cannot be opened is skipped
    assert members["d" * 60 + "/" + "e" * 60 + "/" + "f" * 40 + ".txt"][-1] == b"longname content"
    # a name the line protocol cannot carry: both give way to tarfile
    odd = [native.PackEntry("tab\there", False, -1, -1, -1, T0)]
    assert native.pack_tar(str(tmp_path), odd) is None
    assert jnative.pack_tar(str(tmp_path), [jnative.PackEntry(*odd[0])]) is None
    assert native.CALLS["pack_tar"] == before + 1


def test_prune_names_equal_the_jax_packages():
    cases = [[".git/", "node_modules", "*.pyc", "a/b", "/top"], [".git/", "!keep"], None, [],
             ["# comment", "", "  build/  ", "dist", "[ab]x", "x?", "/"], [" !neg", "vendor"]]
    for patterns in cases:
        assert native.prune_names(patterns) == jnative.prune_names(patterns), patterns
    assert native.prune_names(cases[0]) == [".git", "node_modules"]
    assert native.prune_names(cases[1]) == []


@pytest.mark.parametrize("mode", ["native", "python"])
def test_walk_local_tree_equals_the_jax_packages(libs, tmp_path, monkeypatch, mode):
    from devspace_tpu.utils.ignoreutil import IgnoreMatcher as JMatcher
    from devspace_tpu_torch.utils.ignoreutil import IgnoreMatcher

    build_tree(tmp_path)
    if mode == "python":
        monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    for excludes in (EXCLUDES, EXCLUDES + ["!node_modules/pkg"], None):
        before = native.CALLS["walk"]
        ours = session.walk_local_tree(str(tmp_path), excludes and IgnoreMatcher(excludes))
        theirs = jsession.walk_local_tree(str(tmp_path), excludes and JMatcher(excludes))
        assert native.CALLS["walk"] == before + (mode == "native")
        assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.items()}
        assert "a/b/loop" in ours and "caf\udce9.txt" in ours and "dangling" not in ours
        assert ("data.bin" in ours) == (excludes is None)


def test_walk_local_tree_native_equals_python(libs, tmp_path, monkeypatch):
    from devspace_tpu_torch.utils.ignoreutil import IgnoreMatcher

    build_tree(tmp_path)
    for excludes in (EXCLUDES, EXCLUDES + ["!node_modules/pkg"], []):
        nat = session.walk_local_tree(str(tmp_path), IgnoreMatcher(excludes))
        monkeypatch.setenv("DEVSPACE_NATIVE", "0")
        py = session.walk_local_tree(str(tmp_path), IgnoreMatcher(excludes))
        monkeypatch.delenv("DEVSPACE_NATIVE")
        assert nat == py
        assert ("node_modules/pkg/index.js" in nat) == (excludes == [])


@pytest.mark.parametrize("mode", ["native", "python"])
def test_build_tar_equals_the_jax_packages(libs, tmp_path, monkeypatch, mode):
    """The tar inside each package's gzip is byte-identical and the gzip
    streams differ only in the header's timestamp, for a batch above the
    native packer's 64-entry threshold."""
    build_tree(tmp_path, odd_names=False)
    entries = entries_of(tmp_path, EXCLUDES)
    assert len(entries) >= 64
    if mode == "python":
        monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    before = native.CALLS["pack_tar"]
    ours = shell.build_tar(str(tmp_path), entries)
    theirs = jshell.build_tar(str(tmp_path), [JInfo(**dataclasses.asdict(e)) for e in entries])
    assert native.CALLS["pack_tar"] == before + (mode == "native")
    assert ours[:4] + ours[8:] == theirs[:4] + theirs[8:]
    assert gzip.decompress(ours) == gzip.decompress(theirs)


def test_build_tar_native_members_equal_python(libs, tmp_path, monkeypatch):
    """Both of the port's packers give the same members (names, dirs,
    mode, uid, gid, mtime, size, bytes); a file deleted after the walk is
    skipped by both, and a name with a tab goes through tarfile."""
    build_tree(tmp_path, odd_names=False)
    entries = entries_of(tmp_path, EXCLUDES)
    nat = tar_members(gzip.decompress(shell.build_tar(str(tmp_path), entries)))
    monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    py = tar_members(gzip.decompress(shell.build_tar(str(tmp_path), entries)))
    monkeypatch.delenv("DEVSPACE_NATIVE")
    assert nat == py and len(nat) == len(entries)
    (tmp_path / "many" / "m000.py").unlink()
    nat = tar_members(gzip.decompress(shell.build_tar(str(tmp_path), entries)))
    assert "many/m000.py" not in nat and "many/m001.py" in nat
    (tmp_path / "tab\tname.txt").write_bytes(b"tab")
    before = native.CALLS["pack_tar"]
    tabbed = entries + [FileInformation(name="tab\tname.txt", size=3, mtime=T0)]
    got = tar_members(gzip.decompress(shell.build_tar(str(tmp_path), tabbed)))
    assert native.CALLS["pack_tar"] == before
    assert got["tab\tname.txt"][-1] == b"tab"


@pytest.mark.parametrize("mode", ["native", "python"])
def test_directory_hash_equals_the_jax_packages(libs, tmp_path, monkeypatch, mode):
    build_tree(tmp_path, odd_names=False)
    if mode == "python":
        monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    for excludes in (EXCLUDES, [".git/", "!node_modules/pkg"], None):
        before = native.CALLS["walk"]
        ours = hashutil.directory_hash(str(tmp_path), excludes)
        assert ours == jhashutil.directory_hash(str(tmp_path), excludes)
        assert native.CALLS["walk"] == before + (mode == "native")
    assert hashutil.directory_hash(str(tmp_path), content=True) == \
        jhashutil.directory_hash(str(tmp_path), content=True)


def test_directory_hash_native_equals_python(libs, tmp_path, monkeypatch):
    build_tree(tmp_path, odd_names=False)
    nat = hashutil.directory_hash(str(tmp_path), EXCLUDES)
    monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    assert hashutil.directory_hash(str(tmp_path), EXCLUDES) == nat
    monkeypatch.delenv("DEVSPACE_NATIVE")
    os.utime(tmp_path / "train.py", ns=(1, 10**18))
    assert hashutil.directory_hash(str(tmp_path), EXCLUDES) != nat


def test_build_tar_zero_fills_file_truncated_mid_copy(tmp_path, monkeypatch):
    """A file that shrinks between the walk and the copy yields a
    well-formed archive: the shortfall zero-filled, the next member
    intact (the Python packer; the native one does the same in C)."""
    import builtins

    (tmp_path / "a.txt").write_bytes(b"A" * 100)
    (tmp_path / "b.txt").write_bytes(b"B" * 50)
    entries = [FileInformation(name="a.txt", size=100, mtime=T0),
               FileInformation(name="b.txt", size=50, mtime=T0)]
    real_open = builtins.open

    def racing_open(path, *a, **kw):
        fh = real_open(path, *a, **kw)
        if str(path).endswith("a.txt"):
            data = fh.read(30)
            fh.close()
            return io.BytesIO(data)
        return fh

    monkeypatch.setattr(builtins, "open", racing_open)
    gz = shell.build_tar(str(tmp_path), entries)
    monkeypatch.undo()
    members = tar_members(gzip.decompress(gz))
    assert members["a.txt"][-1] == b"A" * 30 + b"\0" * 70
    assert members["b.txt"][-1] == b"B" * 50


def test_calls_count_every_native_call_from_many_threads(libs, tmp_path):
    """``CALLS`` loses no update when more threads than cores walk and
    pack at once."""
    (tmp_path / "f.txt").write_bytes(b"f")
    entry = [native.PackEntry("f.txt", False, -1, -1, -1, T0)]
    threads, per = 4 * (os.cpu_count() or 1), 25
    before = dict(native.CALLS)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                list(native.walk(str(tmp_path)))
                native.pack_tar(str(tmp_path), entry)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert native.CALLS == {k: before[k] + threads * per for k in before}


@pytest.fixture
def fresh_loader(monkeypatch):
    monkeypatch.delenv("DEVSPACE_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)


def test_disable_via_env(libs, monkeypatch, tmp_path):
    monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    before = dict(native.CALLS)
    assert native.load() is None and not native.available()
    assert native.walk(str(tmp_path)) is None
    assert native.pack_tar(str(tmp_path), []) is None
    assert native.CALLS == before


class _OldLib:
    """A library from an older ABI: ``ds_walk`` only."""

    class _Sym:
        restype = None
        argtypes = None

    ds_walk = _Sym()

    def __getattr__(self, name):
        raise AttributeError(name)


class _WrongAbi:
    class _Sym:
        restype = None
        argtypes = None

        def __call__(self):
            return 1

    ds_walk = ds_pack = ds_free = ds_abi_version = _Sym()


@pytest.mark.parametrize("fake", [_OldLib, _WrongAbi])
def test_loader_gives_way_on_a_library_it_cannot_use(fresh_loader, monkeypatch, tmp_path, fake):
    """A library that lacks a symbol or reports another ABI leaves the
    Python path in charge, for good (no rebind per call), and the walk,
    the tar and the hash still give their results."""
    monkeypatch.setattr(ctypes, "CDLL", lambda path: fake())
    assert native.load() is None and native._load_failed
    assert native.walk(str(tmp_path)) is None
    build_tree(tmp_path, odd_names=False)
    monkeypatch.setenv("DEVSPACE_NATIVE", "0")
    want = session.walk_local_tree(str(tmp_path))
    monkeypatch.delenv("DEVSPACE_NATIVE")
    assert session.walk_local_tree(str(tmp_path)) == want


def test_loader_gives_way_when_the_build_fails(fresh_loader, monkeypatch, tmp_path):
    bad = tmp_path / "devsync.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.build() is None and native.load() is None
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix in (".so", ".tmp")]


def test_library_is_the_ports_own(libs):
    """The port loads the library built from its own source into its own
    build dir, named by the source's hash, and nothing from ``native/``."""
    assert native.SOURCE == PACKAGE / "native" / "devsync.cc"
    assert native.BUILD_DIR == PACKAGE / "_build"
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libdevsync-")
    assert path.exists()
    with open("/proc/self/maps") as fh:
        mapped = {line.split()[-1] for line in fh if "libdevsync" in line}
    assert str(path) in mapped
    assert not any(m.startswith(str(REPO / "native") + os.sep) for m in mapped)


BUILD_SCRIPT = r"""
import json, os, sys, time
from pathlib import Path

repo_native = sys.argv[4]
touched = []

def hook(event, args):
    if event in ("open", "ctypes.dlopen", "subprocess.Popen") and args:
        for a in (args[0], *(args[1] if event == "subprocess.Popen" and args[1] else ())):
            if isinstance(a, (str, bytes)) and os.fsdecode(a).startswith(repo_native):
                touched.append([event, os.fsdecode(a)])

sys.addaudithook(hook)
from devspace_tpu_torch.utils import native

native.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[2] + f".{os.getpid()}").touch()
while not os.path.exists(sys.argv[2]):
    time.sleep(0.002)
lib = native.load()
n = len(list(native.walk(sys.argv[3]))) if lib is not None else None
print(json.dumps({"loaded": lib is not None, "n": n, "touched": touched,
                  "lib": str(native.library_path())}))
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    """Two processes that reach the first build together: one compiles,
    the other waits on the lock and loads the same file; one library and
    no temporary file is left, and neither opens the repo-level
    ``native/``."""
    build_dir, go, tree = tmp_path / "_build", tmp_path / "go", tmp_path / "tree"
    build_tree(tree, odd_names=False)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("DEVSPACE_NATIVE", None)
    args = [sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(go), str(tree),
            str(REPO / "native") + os.sep]
    procs = [subprocess.Popen(args, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    deadline = time.monotonic() + 60
    while len(list(tmp_path.glob("go.*"))) < 2:
        assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["loaded"] for o in outs] == [True, True]
    assert outs[0]["n"] == outs[1]["n"] > 70
    assert outs[0]["touched"] == outs[1]["touched"] == []
    built = sorted(p.name for p in build_dir.iterdir())
    assert built == sorted([Path(outs[0]["lib"]).name, "libdevsync.lock"])
    assert outs[0]["lib"] == outs[1]["lib"]
