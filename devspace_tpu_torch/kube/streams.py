"""Remote process streams: the one abstraction the sync engine, terminal and
services talk to.

A :class:`RemoteProcess` is a long-lived command inside a container with
stdin/stdout/stderr byte streams. Two implementations:

- :class:`SubprocessRemoteProcess` — a local ``sh`` standing in for the
  container (the reference's key test trick, SURVEY §4: SyncConfig.testing
  spawns exec.Command("sh") so the whole remote protocol runs against a local
  temp dir).
- :class:`WSRemoteProcess` (exec.py) — the real thing over a Kubernetes
  exec WebSocket with v4.channel.k8s.io channel demuxing.

The port's copy of ``devspace_tpu/kube/streams.py``, with the same behaviour.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Optional


class StreamClosed(Exception):
    pass


class ConnectionTracker:
    """Registry of live remote streams so a session teardown can force-close
    hung connections (reference: kubectl/upgrade_wrapper.go:20-52, used by
    services/terminal.go:113 to kill SPDY connections on exit).

    Processes are held strongly — a handle dropped on an error path must
    still be reachable at teardown (GC would not kill the remote command) —
    and exited ones are pruned on every registration."""

    def __init__(self):
        self._procs: list["RemoteProcess"] = []
        self._lock = threading.Lock()

    def track(self, proc: "RemoteProcess") -> "RemoteProcess":
        with self._lock:
            self._procs = [p for p in self._procs if self._alive(p)]
            self._procs.append(proc)
        return proc

    @staticmethod
    def _alive(p: "RemoteProcess") -> bool:
        try:
            return p.poll() is None
        except Exception:  # noqa: BLE001 — broken stream counts as dead
            return False

    def close_all(self) -> int:
        """Force-close every tracked stream still running; returns the
        number closed."""
        with self._lock:
            procs, self._procs = self._procs, []
        closed = 0
        for p in procs:
            try:
                if p.poll() is None:
                    p.terminate()
                    closed += 1
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        return closed


class StreamBuffer:
    """Thread-safe producer/consumer byte buffer with blocking reads."""

    def __init__(self):
        self._buf = bytearray()
        self._cond = threading.Condition()
        self._eof = False

    # -- producer ---------------------------------------------------------
    def feed(self, data: bytes) -> None:
        with self._cond:
            self._buf.extend(data)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    # -- consumer ---------------------------------------------------------
    def read_exact(self, n: int, timeout: Optional[float] = None) -> bytes:
        """Block until n bytes are available; raises StreamClosed on EOF
        before n bytes, TimeoutError on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._buf) < n:
                if self._eof:
                    raise StreamClosed(
                        f"stream closed with {len(self._buf)}/{n} bytes buffered"
                    )
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"timed out waiting for {n} bytes")
                self._cond.wait(remaining)
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def read_available(self, timeout: Optional[float] = 0.0) -> bytes:
        """Return whatever is buffered (possibly waiting up to timeout for the
        first byte); b"" on timeout, raises StreamClosed at EOF with nothing
        buffered."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._buf:
                if self._eof:
                    raise StreamClosed("stream closed")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return b""
                self._cond.wait(remaining)
            out = bytes(self._buf)
            del self._buf[:]
            return out

    def read_until(
        self, tokens: list[bytes], timeout: Optional[float] = None
    ) -> tuple[bytes, bytes]:
        """Block until any token appears; returns (data_before_token, token)
        and consumes through the token. Raises StreamClosed/TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                best: Optional[tuple[int, bytes]] = None
                for token in tokens:
                    idx = self._buf.find(token)
                    if idx >= 0 and (best is None or idx < best[0]):
                        best = (idx, token)
                if best is not None:
                    idx, token = best
                    before = bytes(self._buf[:idx])
                    del self._buf[: idx + len(token)]
                    return before, token
                if self._eof:
                    raise StreamClosed(
                        f"stream closed before token; buffered: "
                        f"{bytes(self._buf[-256:])!r}"
                    )
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for {tokens}; buffered: "
                        f"{bytes(self._buf[-256:])!r}"
                    )
                self._cond.wait(remaining)

    def drain(self) -> bytes:
        with self._cond:
            out = bytes(self._buf)
            del self._buf[:]
            return out

    @property
    def at_eof(self) -> bool:
        with self._cond:
            return self._eof and not self._buf


class RemoteProcess:
    """Interface: a running remote command with byte streams."""

    stdout: StreamBuffer
    stderr: StreamBuffer

    def write_stdin(self, data: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def close_stdin(self) -> None:  # pragma: no cover
        raise NotImplementedError

    def poll(self) -> Optional[int]:  # pragma: no cover
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def terminate(self) -> None:  # pragma: no cover
        raise NotImplementedError

    def resize(self, cols: int, rows: int) -> None:
        pass


class SubprocessRemoteProcess(RemoteProcess):
    """Local subprocess with pump threads filling the stream buffers."""

    def __init__(
        self,
        command: list[str],
        cwd: Optional[str] = None,
        env: Optional[dict[str, str]] = None,
    ):
        self.proc = subprocess.Popen(
            command,
            cwd=cwd,
            env={**os.environ, **(env or {})},
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            bufsize=0,
        )
        self.stdout = StreamBuffer()
        self.stderr = StreamBuffer()
        self._stdin_lock = threading.Lock()
        for fh, buf in ((self.proc.stdout, self.stdout), (self.proc.stderr, self.stderr)):
            t = threading.Thread(target=self._pump, args=(fh, buf), daemon=True)
            t.start()

    @staticmethod
    def _pump(fh, buf: StreamBuffer) -> None:
        try:
            while True:
                chunk = fh.read1(65536) if hasattr(fh, "read1") else fh.read(65536)
                if not chunk:
                    break
                buf.feed(chunk)
        except (OSError, ValueError):
            pass
        finally:
            buf.close()

    def write_stdin(self, data: bytes) -> None:
        with self._stdin_lock:
            try:
                self.proc.stdin.write(data)
                self.proc.stdin.flush()
            except (BrokenPipeError, ValueError) as e:
                raise StreamClosed(f"stdin closed: {e}") from e

    def close_stdin(self) -> None:
        with self._stdin_lock:
            try:
                self.proc.stdin.close()
            except OSError:
                pass

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self) -> None:
        try:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        except OSError:
            pass
