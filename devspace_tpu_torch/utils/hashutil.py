"""Directory/file hashing for the chart deployer's cache key.

The port's copy of ``devspace_tpu/utils/hashutil.py`` (reference:
pkg/util/hash/hash.go, Directory / DirectoryExcludes): path, size and
mtime-ns (or the bytes, ``content=True``) hashed with blake2b, with
gitignore-style excludes. The reference also walks through a native
scanner when it is built; its lines are the same as the Python walk's,
which is the only walk here, so the digests agree.
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
