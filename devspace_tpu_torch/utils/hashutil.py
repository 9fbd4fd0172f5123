"""Directory/file hashing for the chart deployer's cache key.

The port's copy of ``devspace_tpu/utils/hashutil.py`` (reference:
pkg/util/hash/hash.go, Directory / DirectoryExcludes): path, size and
mtime-ns (or the bytes, ``content=True``) hashed with blake2b, with
gitignore-style excludes. A metadata hash walks through the port's native
scanner (``utils/native.py``) when it is built; its lines are the same as
the Python walk's, so the digest does not depend on which walk ran.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from .ignoreutil import IgnoreMatcher


def file_hash(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def directory_hash(
    path: str, excludes: Optional[list[str]] = None, content: bool = False
) -> str:
    """Stable hash of a directory tree.

    By default hashes metadata (relpath, size, mtime-ns) which is what the
    reference's build cache uses (cheap, catches edits). ``content=True``
    hashes file bytes instead (slower, exact).
    """
    matcher = IgnoreMatcher(excludes or [])
    h = hashlib.blake2b(digest_size=16)
    root = os.path.abspath(path)
    if not os.path.isdir(root):
        if os.path.exists(root):
            st = os.stat(root)
            h.update(f"{os.path.basename(root)}|{st.st_size}|{st.st_mtime_ns}".encode())
        return h.hexdigest()
    if not content:
        native_entries = _native_entries(root, matcher)
        if native_entries is not None:
            for line in sorted(native_entries):
                h.update(line.encode() + b"\n")
            return h.hexdigest()
    stack = [root]
    entries: list[str] = []
    while stack:
        d = stack.pop()
        try:
            with os.scandir(d) as it:
                children = sorted(it, key=lambda e: e.name)
        except OSError:
            continue
        for e in children:
            rel = os.path.relpath(e.path, root)
            if matcher.matches(rel, e.is_dir(follow_symlinks=False)):
                continue
            if e.is_dir(follow_symlinks=False):
                stack.append(e.path)
                entries.append(f"{rel}/|dir")
            else:
                try:
                    st = e.stat(follow_symlinks=False)
                except OSError:
                    continue
                if content and e.is_file(follow_symlinks=False):
                    entries.append(f"{rel}|{file_hash(e.path)}")
                else:
                    entries.append(f"{rel}|{st.st_size}|{st.st_mtime_ns}")
    for line in sorted(entries):
        h.update(line.encode() + b"\n")
    return h.hexdigest()


def _native_entries(root: str, matcher: IgnoreMatcher) -> Optional[list[str]]:
    """Metadata entry lines via the native scanner; None when unavailable.
    Produces byte-identical lines to the Python walk above (the walk is the
    expensive part — hashing the small entry buffer stays in Python)."""
    from . import native

    walk = native.walk(
        root, prune=native.prune_names(matcher.patterns), follow_symlinks=False
    )
    if walk is None:
        return None
    entries: list[str] = []
    excluded_dirs: set[str] = set()
    for e in walk:
        parent = os.path.dirname(e.rel)
        if parent and parent in excluded_dirs:
            if e.is_dir:
                excluded_dirs.add(e.rel)
            continue
        if matcher.matches(e.rel, e.is_dir):
            if e.is_dir:
                excluded_dirs.add(e.rel)
            continue
        if e.is_dir:
            entries.append(f"{e.rel}/|dir")
        else:
            mtime_ns = e.mtime * 1_000_000_000 + e.mtime_ns
            entries.append(f"{e.rel}|{e.size}|{mtime_ns}")
    return entries
