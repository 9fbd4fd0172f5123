"""Content-addressed cache of built tar artifacts.

The fan-out paths that upload the SAME logical batch to several workers —
the initial-sync mirror pass, revive catch-up, the downstream mirror —
would otherwise rebuild (walk + tar + gzip) the identical archive once
per worker. This cache keys each compressed
artifact by a digest of the batch's entry identities, so one build serves
every worker and every retry while the underlying files are unchanged.

Keying: per entry ``(name, size, mtime, mode, uid, gid, dir?, digest?)``.
Size+mtime is the sync protocol's own change identity (file_info.same_as),
so a key collision would require an undetectable change by the protocol's
standards anyway; the content digest is folded in when known, making the
key strictly stronger than what the wire protocol can distinguish.

The port's copy of ``devspace_tpu/sync/artifacts.py``, with the same
behaviour.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

from .file_info import FileInformation
from .shell import build_tar


def batch_key(entries: list[FileInformation]) -> str:
    """Stable digest of a batch's entry identities (order-sensitive — the
    callers batch deterministically, and tar member order matters)."""
    h = hashlib.blake2b(digest_size=16)
    for e in entries:
        h.update(
            (
                f"{e.name}\0{e.size}\0{e.mtime}\0{int(e.is_directory)}\0"
                f"{e.remote_mode}\0{e.remote_uid}\0{e.remote_gid}\0"
                f"{e.digest or ''}\n"
            ).encode()
        )
    return h.hexdigest()


class TarArtifactCache:
    """LRU (by compressed bytes) cache of built tar artifacts.

    ``get_or_build`` is the single entry point: a hit returns the cached
    bytes; a miss builds under a dedicated build lock, so N workers
    mirroring the same batch concurrently produce exactly ONE build (the
    rest wait briefly, then hit). Counters are exposed for stats/tests:
    ``builds`` is the number of actual build_tar invocations, ``hits``
    the number of reuses.
    """

    def __init__(self, max_bytes: int = 128 << 20):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self.builds = 0
        self.hits = 0

    def _get(self, key: str) -> Optional[bytes]:
        with self._lock:
            data = self._cache.get(key)
            if data is not None:
                self._cache.move_to_end(key)
                self.hits += 1
            return data

    def get_or_build(
        self, local_root: str, entries: list[FileInformation]
    ) -> bytes:
        key = batch_key(entries)
        data = self._get(key)
        if data is not None:
            return data
        # One builder at a time: concurrent misses on the SAME key (the
        # mirror fan-out) serialize here and all but the first turn into
        # hits on the re-check; concurrent misses on different keys also
        # serialize, which keeps gzip from thrashing every core.
        with self._build_lock:
            data = self._get(key)
            if data is not None:
                return data
            data = build_tar(local_root, entries)
            with self._lock:
                self.builds += 1
                self._cache[key] = data
                self._bytes += len(data)
                while self._bytes > self.max_bytes and len(self._cache) > 1:
                    _, evicted = self._cache.popitem(last=False)
                    self._bytes -= len(evicted)
        return data

    def stats(self) -> dict:
        with self._lock:
            return {
                "artifact_builds": self.builds,
                "artifact_hits": self.hits,
                "artifact_cached_bytes": self._bytes,
                "artifact_entries": len(self._cache),
            }
