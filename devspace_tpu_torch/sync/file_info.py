"""File metadata + the remote find/stat line protocol.

Reference: pkg/devspace/sync/file_information.go — fileInformation struct
(21-32), remote find command (58: ``find -L DIR -exec stat -c
"%n///%s,%Y,%f,%a,%u,%g" {} +``) and the stat-line parser (62-125). The
format works with both GNU and busybox stat, which is what keeps the
protocol agentless: any container image with sh+find+stat+tar works.

The port's copy of ``devspace_tpu/sync/file_info.py``, with the same
behaviour: ``FileInformation``, the blake2b-128 ``file_digest`` and its
``DigestCache``, and the remote find/stat protocol.
"""

from __future__ import annotations

import hashlib
import os
import shlex
import stat as statmod
import threading
from dataclasses import dataclass
from typing import Optional

SEPARATOR = "///"


@dataclass
class FileInformation:
    name: str  # path relative to the sync root, '/'-separated, no leading /
    size: int = 0
    mtime: int = 0  # whole seconds — the protocol's resolution
    is_directory: bool = False
    is_symlink: bool = False
    remote_mode: Optional[int] = None  # permission bits to preserve on re-upload
    remote_uid: Optional[int] = None
    remote_gid: Optional[int] = None
    # Content digest (blake2b-128 hex) of the file bytes, when known.
    # NOT part of the wire protocol (remote stat can't produce it) and NOT
    # part of same_as: it rides the index so the upstream can tell a
    # touch/checkout that changed only metadata from a real content change
    # and answer with a metadata-only fix instead of a re-upload.
    digest: Optional[str] = None

    def same_as(self, other: "FileInformation") -> bool:
        """Equality for change detection: mtime+size for files, existence
        for directories (reference: evaluater.go predicates)."""
        if self.is_directory or other.is_directory:
            return self.is_directory == other.is_directory
        return self.size == other.size and self.mtime == other.mtime


def file_digest(path: str) -> Optional[str]:
    """blake2b-128 hex of a file's bytes; None when unreadable (raced with
    a delete). 128 bits keeps index entries small while collisions stay
    out of reach for any realistic tree."""
    h = hashlib.blake2b(digest_size=16)
    try:
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
    except OSError:
        return None
    return h.hexdigest()


class DigestCache:
    """Local ``(relpath, size, mtime) -> digest`` memo so the upstream can
    digest-gate without re-hashing unchanged files. The key embeds the
    stat identity, so a real content change (new size/mtime) misses
    naturally; a touch that bumps only the mtime also misses — that single
    re-hash is exactly the gating check. Entries are dropped wholesale
    past ``max_entries`` (the map is a memo, not a correctness surface)."""

    def __init__(self, max_entries: int = 200_000):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._map: dict[tuple[str, int, int], str] = {}

    def digest(self, root: str, info: FileInformation) -> Optional[str]:
        """Digest of the file ``info`` names, re-hashing only on stat
        change. Returns None for directories or unreadable files."""
        if info.is_directory:
            return None
        key = (info.name, info.size, info.mtime)
        with self._lock:
            cached = self._map.get(key)
        if cached is not None:
            return cached
        d = file_digest(os.path.join(root, info.name.replace("/", os.sep)))
        if d is not None:
            with self._lock:
                if len(self._map) >= self.max_entries:
                    self._map.clear()
                self._map[key] = d
        return d


def local_file_information(root: str, relpath: str) -> Optional[FileInformation]:
    """Stat a local file relative to the sync root (follows symlinks,
    matching the remote ``find -L``)."""
    full = os.path.join(root, relpath.replace("/", os.sep))
    try:
        st = os.stat(full)  # follow symlinks
        lst = os.lstat(full)
    except OSError:
        return None
    return FileInformation(
        name=relpath.replace(os.sep, "/"),
        size=0 if statmod.S_ISDIR(st.st_mode) else st.st_size,
        mtime=int(st.st_mtime),
        is_directory=statmod.S_ISDIR(st.st_mode),
        is_symlink=statmod.S_ISLNK(lst.st_mode),
    )


def find_command(remote_dir: str) -> str:
    """The remote snapshot command (reference: file_information.go:58)."""
    q = shlex.quote(remote_dir)
    # `|| true`: find exits nonzero when a file vanishes between listing and
    # stat (a normal race against concurrent uploads/removes); a partial
    # snapshot is fine — the two-stable-polls rule prevents acting on it.
    return (
        f"mkdir -p {q} && {{ find -L {q} -exec stat -c "
        f"'%n{SEPARATOR}%s,%Y,%f,%a,%u,%g' {{}} + 2>/dev/null || true; }}"
    )


def parse_stat_line(line: str, remote_dir: str) -> Optional[FileInformation]:
    """Parse one ``name///size,mtime,rawhex,perm,uid,gid`` line into a
    FileInformation relative to remote_dir; None for unparseable lines or
    the root itself."""
    idx = line.rfind(SEPARATOR)
    if idx < 0:
        return None
    name = line[:idx]
    fields = line[idx + len(SEPARATOR) :].split(",")
    if len(fields) != 5 and len(fields) != 6:
        return None
    try:
        size = int(fields[0])
        mtime = int(fields[1])
        raw_mode = int(fields[2], 16)
        perm = int(fields[3], 8)
        uid = int(fields[4])
        gid = int(fields[5]) if len(fields) == 6 else 0
    except ValueError:
        return None
    if not name.startswith(remote_dir):
        return None
    rel = name[len(remote_dir) :].lstrip("/")
    if not rel:
        return None  # the root dir itself
    is_dir = statmod.S_ISDIR(raw_mode)
    return FileInformation(
        name=rel,
        size=0 if is_dir else size,
        mtime=mtime,
        is_directory=is_dir,
        is_symlink=statmod.S_ISLNK(raw_mode),
        remote_mode=perm,
        remote_uid=uid,
        remote_gid=gid,
    )
