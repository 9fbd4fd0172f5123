"""Gitignore-syntax path matching.

The port's copy of ``IgnoreMatcher`` from ``devspace_tpu/utils/ignoreutil.py``
(reference behaviour: sabhiram/go-gitignore, used for ``.dockerignore``
handling in pkg/util/ignoreutil), which ``utils.hashutil.directory_hash``
applies to its excludes: comments, ``!`` negation (last match wins),
dir-only patterns (trailing ``/``), anchored patterns (leading or
embedded ``/``), ``*``, ``?``, character classes and ``**``.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional


def _translate(pattern: str) -> str:
    """Translate one gitignore glob into a regex over a '/'-joined relpath."""
    out = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "*":
            if pattern[i : i + 3] == "**/":
                out.append("(?:.*/)?")
                i += 3
                continue
            if pattern[i : i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
            i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and pattern[j] in "!^":
                j += 1
            if j < n and pattern[j] == "]":
                j += 1
            while j < n and pattern[j] != "]":
                j += 1
            if j >= n:
                out.append(re.escape(c))
                i += 1
            else:
                cls = pattern[i + 1 : j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append("[" + cls + "]")
                i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


class _Rule:
    __slots__ = ("negate", "dir_only", "regex")

    def __init__(self, pattern: str):
        self.negate = False
        p = pattern
        if p.startswith("!"):
            self.negate = True
            p = p[1:]
        if p.startswith("\\!") or p.startswith("\\#"):
            p = p[1:]
        self.dir_only = p.endswith("/")
        p = p.rstrip("/")
        anchored = p.startswith("/") or "/" in p[:-1].rstrip("/")
        p = p.lstrip("/")
        body = _translate(p)
        if anchored:
            rx = "^" + body
        else:
            rx = "(?:^|.*/)" + body
        # A pattern matches the path itself and everything beneath it.
        self.regex = re.compile(rx + "(?:$|/)")

    def matches(self, relpath: str, is_dir: bool) -> Optional[bool]:
        m = self.regex.match(relpath)
        if not m:
            return None
        if self.dir_only and not is_dir and m.end() >= len(relpath):
            # Dir-only rule matched the leaf itself, but the leaf is a file.
            # (Files *inside* a matched directory match with m.end() < len.)
            return None
        return not self.negate


class IgnoreMatcher:
    """Compiled gitignore rule list; later rules override earlier ones."""

    def __init__(self, patterns: Iterable[str] = ()):
        self.rules: list[_Rule] = []
        self.patterns: list[str] = list(patterns)
        for raw in self.patterns:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            self.rules.append(_Rule(line.strip()))

    def matches(self, relpath: str, is_dir: bool = False) -> bool:
        rel = relpath.replace(os.sep, "/").strip("/")
        if not rel or rel == ".":
            return False
        verdict = False
        for rule in self.rules:
            res = rule.matches(rel, is_dir)
            if res is not None:
                verdict = res
        return verdict
