"""ctypes loader for libdevsync — the native filesystem-scan fast path.

The reference is a compiled Go binary; its local walks (initial-sync
snapshot diff, downstream compare, build-context hashing) are native code.
This module gives the Python framework the same property: the package's
``native/devsync.cc`` is a small C++ library that g++ builds at first use
into the package's git-ignored ``_build/``, and everything here degrades
to pure Python when it is unavailable (``DEVSPACE_NATIVE=0`` forces the
fallback).

The port's copy of ``devspace_tpu/utils/native.py``, with the same API and
contract; the build differs. The library file is named by a hash of the
source and the flags, so an edited source never loads a stale build, and it
is compiled to a temporary name and moved into place under an exclusive
file lock, so processes that reach the first build at once (a test run
spread over workers) leave one whole library. ``CALLS`` counts the calls
of :func:`walk` and :func:`pack_tar` that took the native path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import stat as statmod
import subprocess
import threading
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

_ABI_VERSION = 2

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "devsync.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

# calls of walk() and pack_tar() that went through the library; the sync
# session packs for several workers from several threads at once
CALLS = {"walk": 0, "pack_tar": 0}
_calls_lock = threading.Lock()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class WalkEntry(NamedTuple):
    rel: str  # '/'-separated path relative to the walk root
    size: int  # 0 for directories
    mtime: int  # whole seconds
    mtime_ns: int  # nanoseconds part
    mode: int  # raw st_mode of the stat result (followed when requested)
    uid: int
    gid: int
    is_symlink: bool  # from lstat — a followed link-to-dir is both dir+link

    @property
    def is_dir(self) -> bool:
        return statmod.S_ISDIR(self.mode)


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdevsync-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Build ``native/devsync.cc`` with g++ unless the library for its
    hash is there already; the library's path, or None when the source,
    the compiler or a writable ``_build/`` is missing or g++ fails."""
    try:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "libdevsync.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():  # built by another process while this one waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) libdevsync; None when unavailable."""
    global _lib, _load_failed
    if os.environ.get("DEVSPACE_NATIVE") == "0":
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.ds_walk.restype = ctypes.c_void_p
            lib.ds_walk.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.ds_pack.restype = ctypes.c_void_p
            lib.ds_pack.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.ds_free.argtypes = [ctypes.c_void_p]
            lib.ds_abi_version.restype = ctypes.c_uint64
            if lib.ds_abi_version() != _ABI_VERSION:
                _load_failed = True
                return None
        except (OSError, AttributeError):
            # AttributeError: a library from an older ABI may lack newer
            # symbols (e.g. ds_pack) — ctypes raises at the attribute bind,
            # BEFORE ds_abi_version() gets a chance to reject it. Degrade
            # to the Python path either way.
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def walk(
    root: str,
    prune: Optional[list[str]] = None,
    follow_symlinks: bool = True,
) -> Optional[Iterator[WalkEntry]]:
    """Native recursive stat-walk of ``root``; None when the library is
    unavailable (caller falls back to the Python walk). ``prune`` is a
    list of directory *names* to skip entirely."""
    lib = load()
    if lib is None:
        return None
    with _calls_lock:
        CALLS["walk"] += 1
    csv = ",".join(prune or []).encode()
    ptr = lib.ds_walk(root.encode(), csv, 1 if follow_symlinks else 0)
    if not ptr:
        return iter(())
    try:
        raw = ctypes.string_at(ptr).decode("utf-8", "surrogateescape")
    finally:
        lib.ds_free(ptr)
    return _parse(raw)


def _parse(raw: str) -> Iterator[WalkEntry]:
    for line in raw.splitlines():
        parts = line.split("\t")
        if len(parts) != 8:
            continue
        try:
            yield WalkEntry(
                rel=parts[0],
                size=int(parts[1]),
                mtime=int(parts[2]),
                mtime_ns=int(parts[3]),
                mode=int(parts[4], 8),
                uid=int(parts[5]),
                gid=int(parts[6]),
                is_symlink=parts[7] == "1",
            )
        except ValueError:
            continue


class PackEntry(NamedTuple):
    name: str  # '/'-separated path relative to the pack root
    is_dir: bool
    mode: int  # -1 = derive (files: st_mode & 0o7777; dirs: 0755)
    uid: int  # -1 = 0 (TarInfo default)
    gid: int  # -1 = 0
    mtime: int  # used for dirs; files stamp their stat mtime


def pack_tar(root: str, entries: list[PackEntry]) -> Optional[bytes]:
    """Native UNCOMPRESSED tar of ``entries`` under ``root`` (GNU format,
    @LongLink for >=100-char names); None when the library is
    unavailable or an entry name can't ride the line protocol (caller
    falls back to the Python tarfile path). Entries whose stat/open
    fails are skipped — the raced-delete semantics of the Python
    packer. Compression stays in Python: zlib is already C, and the
    per-member header bookkeeping is what the native path removes."""
    lib = load()
    if lib is None:
        return None
    lines = []
    for e in entries:
        if "\t" in e.name or "\n" in e.name:
            return None  # pathological name: let tarfile handle it
        lines.append(
            f"{e.name}\t{1 if e.is_dir else 0}\t{e.mode}\t{e.uid}\t"
            f"{e.gid}\t{e.mtime}\n"
        )
    n = ctypes.c_uint64()
    # surrogateescape round-trips non-UTF-8 filenames (the walk decodes
    # them the same way); the C side treats names as opaque bytes
    ptr = lib.ds_pack(
        root.encode("utf-8", "surrogateescape"),
        "".join(lines).encode("utf-8", "surrogateescape"),
        ctypes.byref(n),
    )
    if not ptr:
        return None
    with _calls_lock:
        CALLS["pack_tar"] += 1
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.ds_free(ptr)


def prune_names(excludes: Optional[list[str]]) -> list[str]:
    """Extract plain directory names from gitignore-style patterns — the
    subset safe to prune inside the native walk (e.g. ``.git/``,
    ``node_modules``). Anything with wildcards, slashes-in-the-middle or
    negation stays a Python-side filter."""
    # Any negation pattern could re-include a child of a pruned directory,
    # so its presence disables native pruning wholesale.
    if any((p or "").strip().startswith("!") for p in excludes or []):
        return []
    out = []
    for p in excludes or []:
        p = p.strip()
        if not p or p.startswith("#"):
            continue
        # Root-anchored patterns ("/top") only match at the top level;
        # pruning by bare name would also drop deeper dirs the matcher
        # keeps, so they stay Python-side.
        name = p.rstrip("/")
        if not name or "/" in name or any(c in name for c in "*?[]"):
            continue
        out.append(name)
    return out
