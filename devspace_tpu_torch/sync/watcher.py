"""Local filesystem watching for the sync upstream.

The reference uses rjeczalik/notify (inotify on Linux) with a 5000-event
buffered channel (pkg/devspace/sync/upstream.go:34). We implement inotify
directly via ctypes (no dependencies) with a polling fallback for other
platforms; both emit (relpath, exists_hint) tuples into a bounded queue —
classification (create vs remove) happens downstream by stat, exactly like
the reference's evaluateChange.

The port's copy of ``devspace_tpu/sync/watcher.py``, with the same
behaviour.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import queue
import select
import struct
import sys
import threading
import time
from typing import Optional

from ..utils.ignoreutil import IgnoreMatcher

EVENT_BUFFER = 5000  # reference: upstream.go:34

# inotify masks
IN_MODIFY = 0x00000002
IN_ATTRIB = 0x00000004
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_DELETE_SELF = 0x00000400
IN_MOVE_SELF = 0x00000800
IN_ISDIR = 0x40000000
IN_Q_OVERFLOW = 0x00004000

_WATCH_MASK = (
    IN_MODIFY
    | IN_ATTRIB
    | IN_CLOSE_WRITE
    | IN_MOVED_FROM
    | IN_MOVED_TO
    | IN_CREATE
    | IN_DELETE
    | IN_DELETE_SELF
)


class Watcher:
    """Interface: emits relative paths (to root) that changed."""

    def __init__(self, root: str, matcher: Optional[IgnoreMatcher] = None):
        self.root = os.path.abspath(root)
        self.matcher = matcher
        self.events: queue.Queue[str] = queue.Queue(maxsize=EVENT_BUFFER)
        self._stopped = threading.Event()
        self.overflowed = threading.Event()

    def start(self) -> None:  # pragma: no cover
        raise NotImplementedError

    def stop(self) -> None:
        self._stopped.set()

    def _emit(self, relpath: str) -> None:
        relpath = relpath.replace(os.sep, "/").strip("/")
        if not relpath:
            return
        try:
            self.events.put_nowait(relpath)
        except queue.Full:
            # Signal overflow — the session falls back to a full re-scan.
            self.overflowed.set()


class InotifyWatcher(Watcher):
    """Recursive inotify watcher (Linux)."""

    def __init__(self, root: str, matcher: Optional[IgnoreMatcher] = None):
        super().__init__(root, matcher)
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self._fd = self._libc.inotify_init1(os.O_NONBLOCK)
        if self._fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._wd_to_path: dict[int, str] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _add_watch(self, path: str) -> None:
        rel = os.path.relpath(path, self.root).replace(os.sep, "/")
        if rel != "." and self.matcher is not None and self.matcher.matches(rel, True):
            return
        wd = self._libc.inotify_add_watch(
            self._fd, path.encode(), ctypes.c_uint32(_WATCH_MASK)
        )
        if wd >= 0:
            with self._lock:
                self._wd_to_path[wd] = path
        elif ctypes.get_errno() not in (errno.ENOENT, errno.EACCES):
            # ENOSPC: watch limit — degrade silently; session still has
            # the downstream poll and initial-sync reconciliation.
            pass

    def _watch_tree(self, top: str) -> None:
        self._add_watch(top)
        try:
            with os.scandir(top) as it:
                for e in it:
                    try:
                        if e.is_dir(follow_symlinks=False):
                            self._watch_tree(e.path)
                    except OSError:
                        continue
        except OSError:
            pass

    def start(self) -> None:
        self._watch_tree(self.root)
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        header = struct.Struct("iIII")
        while not self._stopped.is_set():
            try:
                r, _, _ = select.select([self._fd], [], [], 0.2)
            except OSError:
                break
            if not r:
                continue
            try:
                data = os.read(self._fd, 65536)
            except BlockingIOError:
                continue
            except OSError:
                break
            offset = 0
            while offset + header.size <= len(data):
                wd, mask, cookie, length = header.unpack_from(data, offset)
                name = data[
                    offset + header.size : offset + header.size + length
                ].split(b"\0", 1)[0].decode("utf-8", "replace")
                offset += header.size + length
                if mask & IN_Q_OVERFLOW:
                    self.overflowed.set()
                    continue
                with self._lock:
                    base = self._wd_to_path.get(wd)
                if base is None:
                    continue
                full = os.path.join(base, name) if name else base
                rel = os.path.relpath(full, self.root)
                if rel == ".":
                    continue
                relu = rel.replace(os.sep, "/")
                is_dir_hint = bool(mask & IN_ISDIR)
                if self.matcher is not None and self.matcher.matches(relu, is_dir_hint):
                    continue
                if mask & (IN_CREATE | IN_MOVED_TO) and is_dir_hint:
                    # New directory: watch it and synthesize events for any
                    # contents that raced in before the watch existed.
                    self._watch_tree(full)
                    for dirpath, dirnames, filenames in os.walk(full):
                        for f in filenames + list(dirnames):
                            sub = os.path.relpath(
                                os.path.join(dirpath, f), self.root
                            )
                            self._emit(sub)
                self._emit(relu)
        try:
            os.close(self._fd)
        except OSError:
            pass

    def stop(self) -> None:
        super().stop()


class PollingWatcher(Watcher):
    """Scandir-based polling fallback (also used for symlink targets —
    reference: sync/symlink.go poll-watches link targets at 500ms)."""

    def __init__(
        self,
        root: str,
        matcher: Optional[IgnoreMatcher] = None,
        interval: float = 0.5,
    ):
        super().__init__(root, matcher)
        self.interval = interval
        self._snapshot: dict[str, tuple[int, int, bool]] = {}
        self._thread: Optional[threading.Thread] = None

    def _scan(self) -> dict[str, tuple[int, int, bool]]:
        out: dict[str, tuple[int, int, bool]] = {}
        stack = [self.root]
        while stack:
            d = stack.pop()
            try:
                with os.scandir(d) as it:
                    entries = list(it)
            except OSError:
                continue
            for e in entries:
                rel = os.path.relpath(e.path, self.root).replace(os.sep, "/")
                try:
                    is_dir = e.is_dir()
                except OSError:
                    continue
                if self.matcher is not None and self.matcher.matches(rel, is_dir):
                    continue
                try:
                    st = e.stat()
                except OSError:
                    continue
                out[rel] = (
                    0 if is_dir else st.st_size,
                    int(st.st_mtime),
                    is_dir,
                )
                if is_dir:
                    stack.append(e.path)
        return out

    def start(self) -> None:
        self._snapshot = self._scan()
        self._thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stopped.is_set():
            time.sleep(self.interval)
            current = self._scan()
            for rel, meta in current.items():
                if self._snapshot.get(rel) != meta:
                    self._emit(rel)
            for rel in self._snapshot:
                if rel not in current:
                    self._emit(rel)
            self._snapshot = current


def new_watcher(
    root: str,
    matcher: Optional[IgnoreMatcher] = None,
    poll_interval: float = 0.5,
) -> Watcher:
    if sys.platform.startswith("linux"):
        try:
            return InotifyWatcher(root, matcher)
        except OSError:
            pass
    return PollingWatcher(root, matcher, poll_interval)
