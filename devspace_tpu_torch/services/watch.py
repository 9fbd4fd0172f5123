"""Auto-reload watcher: poll-based glob watching with a callback.

Reference: pkg/devspace/watch/watch.go — 1s-poll doublestar-glob watcher
used by ``dev`` to watch chart paths / Dockerfiles / custom paths and
trigger a full redeploy (cmd/dev.go:283-301, 2s debounce after change).

The port's copy of ``devspace_tpu/services/watch.py``, with the same
behaviour.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Callable, Optional


class GlobWatcher:
    def __init__(
        self,
        patterns: list[str],
        callback: Callable[[list[str]], None],
        base_dir: str = ".",
        interval: float = 1.0,  # reference: watch.go poll interval
        debounce: float = 2.0,  # reference: cmd/dev.go:287-288
    ):
        self.patterns = patterns
        self.callback = callback
        self.base_dir = base_dir
        self.interval = interval
        self.debounce = debounce
        self._snapshot: dict[str, tuple[float, int]] = {}
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _scan(self) -> dict[str, tuple[float, int]]:
        out: dict[str, tuple[float, int]] = {}
        for pattern in self.patterns:
            for path in glob.glob(
                os.path.join(self.base_dir, pattern), recursive=True
            ):
                if os.path.isdir(path):
                    for dirpath, _, files in os.walk(path):
                        for f in files:
                            full = os.path.join(dirpath, f)
                            try:
                                st = os.stat(full)
                                out[full] = (st.st_mtime, st.st_size)
                            except OSError:
                                continue
                else:
                    try:
                        st = os.stat(path)
                        out[path] = (st.st_mtime, st.st_size)
                    except OSError:
                        continue
        return out

    def start(self) -> None:
        self._snapshot = self._scan()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            time.sleep(self.interval)
            current = self._scan()
            changed = [
                p
                for p in set(current) | set(self._snapshot)
                if current.get(p) != self._snapshot.get(p)
            ]
            if changed:
                # Debounce: wait for quiet, re-scan, then fire once.
                time.sleep(self.debounce)
                current = self._scan()
                self._snapshot = current
                if not self._stopped.is_set():
                    self.callback(sorted(changed))
            else:
                self._snapshot = current

    def stop(self) -> None:
        self._stopped.set()
