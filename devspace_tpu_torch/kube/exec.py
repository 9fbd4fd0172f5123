"""Remote command execution over the Kubernetes exec/attach WebSocket.

Reference: pkg/devspace/kubectl/exec.go (ExecStreamWithTransport — POST
pods/.../exec with SPDY upgrade) and attach.go. Our transport is the modern
WebSocket path with the ``v4.channel.k8s.io`` subprotocol: one binary
message per chunk, first byte = channel (0 stdin, 1 stdout, 2 stderr,
3 error-status JSON, 4 resize).

The port's copy of ``devspace_tpu/kube/exec.py``, with the same behaviour.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from .streams import RemoteProcess, StreamBuffer, StreamClosed
from .transport import KubeTransport
from .websocket import OP_CLOSE, WebSocket, WebSocketError

CH_STDIN = 0
CH_STDOUT = 1
CH_STDERR = 2
CH_ERROR = 3
CH_RESIZE = 4


class WSRemoteProcess(RemoteProcess):
    """A command running in a container, demuxed from an exec WebSocket."""

    def __init__(self, sock: WebSocket):
        self.ws = sock
        self.stdout = StreamBuffer()
        self.stderr = StreamBuffer()
        self._status: Optional[int] = None
        self._status_lock = threading.Lock()
        self._error_payload = b""
        self._send_lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        aborted = False
        try:
            while True:
                opcode, payload = self.ws.recv_message()
                if opcode == OP_CLOSE:
                    break
                if not payload:
                    continue
                channel, data = payload[0], payload[1:]
                if channel == CH_STDOUT:
                    self.stdout.feed(data)
                elif channel == CH_STDERR:
                    self.stderr.feed(data)
                elif channel == CH_ERROR:
                    self._error_payload += data
        except WebSocketError:
            aborted = True
        finally:
            with self._status_lock:
                if aborted and not self._error_payload:
                    # Connection dropped before the kubelet sent a status —
                    # this is NOT success; callers must not trust partial
                    # output (e.g. the sync shell protocol).
                    self._status = -1
                else:
                    self._status = self._parse_status()
            self.stdout.close()
            self.stderr.close()

    def _parse_status(self) -> int:
        """The error channel carries a v1.Status JSON; Success => 0,
        NonZeroExitCode is in details.causes."""
        if not self._error_payload:
            return 0
        try:
            status = json.loads(self._error_payload)
        except ValueError:
            return 1
        if status.get("status") == "Success":
            return 0
        for cause in (status.get("details") or {}).get("causes") or []:
            if cause.get("reason") == "ExitCode":
                try:
                    return int(cause.get("message", "1"))
                except ValueError:
                    return 1
        return 1

    @property
    def error_message(self) -> str:
        try:
            status = json.loads(self._error_payload)
            return status.get("message", "")
        except ValueError:
            return self._error_payload.decode("utf-8", "replace")

    # -- RemoteProcess ----------------------------------------------------
    def write_stdin(self, data: bytes) -> None:
        with self._send_lock:
            try:
                # Chunk to keep frames bounded; kubelet reassembles.
                for i in range(0, len(data), 1 << 20):
                    self.ws.send(bytes([CH_STDIN]) + data[i : i + (1 << 20)])
            except WebSocketError as e:
                raise StreamClosed(str(e)) from e

    def close_stdin(self) -> None:
        # v4 protocol has no half-close; sending an empty stdin message is a
        # no-op for most runtimes. Callers that need EOF semantics should end
        # the remote command explicitly (e.g. send "exit\n" to a shell).
        pass

    def poll(self) -> Optional[int]:
        with self._status_lock:
            return self._status

    def terminate(self) -> None:
        self.ws.close()

    def resize(self, cols: int, rows: int) -> None:
        with self._send_lock:
            try:
                self.ws.send(
                    bytes([CH_RESIZE])
                    + json.dumps({"Width": cols, "Height": rows}).encode()
                )
            except WebSocketError:
                pass


def exec_stream(
    transport: KubeTransport,
    pod: str,
    namespace: str,
    command: list[str],
    container: Optional[str] = None,
    tty: bool = False,
    stdin: bool = True,
) -> WSRemoteProcess:
    """Start a command in a container (reference: kubectl.ExecStream)."""
    query: list[tuple[str, str]] = [("command", c) for c in command]
    query += [
        ("stdin", "true" if stdin else "false"),
        ("stdout", "true"),
        ("stderr", "false" if tty else "true"),
        ("tty", "true" if tty else "false"),
    ]
    if container:
        query.append(("container", container))
    sock = transport.connect_websocket(
        f"/api/v1/namespaces/{namespace}/pods/{pod}/exec",
        query=query,
        subprotocols=["v4.channel.k8s.io"],
    )
    return WSRemoteProcess(sock)


def attach_stream(
    transport: KubeTransport,
    pod: str,
    namespace: str,
    container: Optional[str] = None,
    tty: bool = False,
    stdin: bool = False,
) -> WSRemoteProcess:
    """Attach to the running main process (reference: kubectl.AttachStream)."""
    query: list[tuple[str, str]] = [
        ("stdin", "true" if stdin else "false"),
        ("stdout", "true"),
        ("stderr", "false" if tty else "true"),
        ("tty", "true" if tty else "false"),
    ]
    if container:
        query.append(("container", container))
    sock = transport.connect_websocket(
        f"/api/v1/namespaces/{namespace}/pods/{pod}/attach",
        query=query,
        subprotocols=["v4.channel.k8s.io"],
    )
    return WSRemoteProcess(sock)


def exec_buffered(
    transport: KubeTransport,
    pod: str,
    namespace: str,
    command: list[str],
    container: Optional[str] = None,
    timeout: float = 60.0,
) -> tuple[bytes, bytes, int]:
    """Run to completion, returning (stdout, stderr, exit_code)
    (reference: kubectl.ExecBuffered)."""
    proc = exec_stream(
        transport, pod, namespace, command, container=container, stdin=False
    )
    rc = proc.wait(timeout)
    out = proc.stdout.drain()
    err = proc.stderr.drain()
    if rc is None:
        proc.terminate()
        raise TimeoutError(f"exec of {command} timed out after {timeout}s")
    return out, err, rc
