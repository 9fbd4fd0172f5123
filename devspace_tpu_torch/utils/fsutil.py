"""Filesystem helpers (reference: pkg/util/fsutil).

The port's copy of ``devspace_tpu/utils/fsutil.py``, with the same behaviour.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, Optional

from .ignoreutil import IgnoreMatcher


def write_file(path: str, content: bytes | str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(content, bytes):
        with open(path, "wb") as fh:
            fh.write(content)
    else:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(content)


def read_file(path: str) -> str:
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read()


def copy_tree(src: str, dst: str, overwrite: bool = True) -> None:
    for root, dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        target_root = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(target_root, exist_ok=True)
        for f in files:
            target = os.path.join(target_root, f)
            if overwrite or not os.path.exists(target):
                shutil.copy2(os.path.join(root, f), target)


def walk_files(
    root: str, matcher: Optional[IgnoreMatcher] = None
) -> Iterator[tuple[str, os.stat_result, bool]]:
    """Yield (relpath, stat, is_dir) for every entry under root, honoring an
    optional ignore matcher (ignored dirs are pruned)."""
    root = os.path.abspath(root)
    stack = [root]
    while stack:
        d = stack.pop()
        try:
            with os.scandir(d) as it:
                children = sorted(it, key=lambda e: e.name)
        except OSError:
            continue
        for e in children:
            rel = os.path.relpath(e.path, root).replace(os.sep, "/")
            try:
                is_dir = e.is_dir(follow_symlinks=False)
            except OSError:
                continue
            if matcher is not None and matcher.matches(rel, is_dir):
                continue
            try:
                st = e.stat(follow_symlinks=False)
            except OSError:
                continue
            yield rel, st, is_dir
            if is_dir:
                stack.append(e.path)
