"""Shared sync state: the file index.

Reference: pkg/devspace/sync/file_index.go — mutex-guarded
map[path]fileInformation recording what both sides are believed to hold.
Uploads/downloads update it; the conflict predicates consult it.

The port's copy of ``devspace_tpu/sync/index.py``, with the same behaviour.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .file_info import FileInformation


class FileIndex:
    def __init__(self):
        self._lock = threading.RLock()
        self._map: dict[str, FileInformation] = {}

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._map

    def get(self, name: str) -> Optional[FileInformation]:
        with self._lock:
            return self._map.get(name)

    def set(self, info: FileInformation) -> None:
        with self._lock:
            # Digest preservation: callers that re-index an unchanged file
            # from a digest-less source (a remote snapshot, a stat walk)
            # must not erase a digest the upload path already paid to
            # compute — keep it while the stat identity still matches.
            if info.digest is None and not info.is_directory:
                old = self._map.get(info.name)
                if (
                    old is not None
                    and old.digest is not None
                    and old.size == info.size
                    and old.mtime == info.mtime
                ):
                    info.digest = old.digest
            self._map[info.name] = info
            # Ensure parent dirs exist in the index (reference:
            # CreateDirInFileMap).
            parts = info.name.split("/")
            for i in range(1, len(parts)):
                parent = "/".join(parts[:i])
                if parent and parent not in self._map:
                    self._map[parent] = FileInformation(
                        name=parent, is_directory=True
                    )

    def remove(self, name: str) -> None:
        """Remove an entry and everything beneath it (reference:
        RemoveDirInFileMap)."""
        with self._lock:
            prefix = name + "/"
            for key in [k for k in self._map if k == name or k.startswith(prefix)]:
                del self._map[key]

    def snapshot(self) -> dict[str, FileInformation]:
        with self._lock:
            return dict(self._map)

    def transact(self, fn: Callable[[dict[str, FileInformation]], None]) -> None:
        """Run fn with the raw map under the lock (multi-step decisions that
        must be atomic against concurrent pipes)."""
        with self._lock:
            fn(self._map)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)
