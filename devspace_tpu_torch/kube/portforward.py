"""Port forwarding: local TCP listeners tunneled to container ports.

Reference: pkg/devspace/kubectl/client.go:356-383 (NewPortForwarder — POST
pods/.../portforward with SPDY dialer) driven by
services/port_forwarding.go. Our transport opens one WebSocket per accepted
local connection (the WS portforward protocol is not stream-multiplexed the
way SPDY was): channels alternate data/error per port, each prefixed by a
2-byte little-endian port confirmation frame.

The port's copy of ``devspace_tpu/kube/portforward.py``, with the same behaviour.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional

from ..resilience.policy import RetryPolicy
from .transport import KubeTransport
from .websocket import OP_CLOSE, WebSocketError


class PortForwardError(Exception):
    pass


def _default_dial_policy() -> RetryPolicy:
    """A tunnel dial races pod restarts and transient API-server blips;
    three quick attempts ride out both without the user noticing."""
    return RetryPolicy(
        max_attempts=3,
        base_delay=0.05,
        max_delay=0.5,
        jitter=0.0,
        seed=0,
        retry_on=(OSError, WebSocketError),
    )


class PortForwarder:
    """Forwards localPort -> (pod, remotePort) pairs until stopped."""

    def __init__(
        self,
        dial: Callable[[int], "object"],
        ports: list[tuple[int, int]],
        bind_address: str = "127.0.0.1",
        logger=None,
        dial_policy: Optional[RetryPolicy] = None,
    ):
        """``dial(remote_port)`` returns a connected bidirectional stream
        object with send(bytes)/recv()->bytes/close() — implementation
        detail of the backend (WebSocket tunnel or fake local socket).
        Each accepted local connection dials under ``dial_policy``."""
        self.dial = dial
        self.ports = ports
        self.bind_address = bind_address
        self.log = logger
        self.dial_policy = dial_policy or _default_dial_policy()
        self._listeners: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()
        self._dead = threading.Event()  # a listener died while not stopped
        self.ready = threading.Event()
        self.local_ports: list[int] = []

    def start(self) -> None:
        for local, remote in self.ports:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                lsock.bind((self.bind_address, local))
            except OSError as e:
                self.stop()
                raise PortForwardError(
                    f"cannot bind {self.bind_address}:{local}: {e}"
                ) from e
            lsock.listen(16)
            self._listeners.append(lsock)
            self.local_ports.append(lsock.getsockname()[1])
            t = threading.Thread(
                target=self._accept_loop, args=(lsock, remote), daemon=True
            )
            t.start()
            self._threads.append(t)
        self.ready.set()

    def _accept_loop(self, lsock: socket.socket, remote: int) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                if not self._stopped.is_set():
                    # listener socket died under us — the forwarder is no
                    # longer serving; surface it to liveness probes
                    self._dead.set()
                return
            threading.Thread(
                target=self._handle, args=(conn, remote), daemon=True
            ).start()

    def alive(self) -> bool:
        """Liveness probe for the session supervisor: started, not stopped
        and every listener still accepting."""
        return (
            self.ready.is_set()
            and not self._stopped.is_set()
            and not self._dead.is_set()
        )

    def _handle(self, conn: socket.socket, remote: int) -> None:
        try:
            tunnel = self.dial_policy.execute(
                self.dial,
                remote,
                describe=f"port-forward dial :{remote}",
                reraise=True,
                on_retry=lambda attempt, exc, delay: self.log
                and self.log.warn(
                    "port-forward dial to %d failed (attempt %d), retrying "
                    "in %.2fs: %s", remote, attempt, delay, exc,
                ),
            )
        except Exception as e:  # noqa: BLE001 — surface any dial failure
            if self.log:
                self.log.error("port-forward dial to %d failed: %s", remote, e)
            conn.close()
            return
        done = threading.Event()

        def local_to_remote():
            try:
                while True:
                    data = conn.recv(65536)
                    if not data:
                        break
                    tunnel.send(data)
            except OSError:
                pass
            finally:
                done.set()

        def remote_to_local():
            try:
                while True:
                    data = tunnel.recv()
                    if not data:
                        break
                    conn.sendall(data)
            except (OSError, WebSocketError):
                pass
            finally:
                done.set()

        t1 = threading.Thread(target=local_to_remote, daemon=True)
        t2 = threading.Thread(target=remote_to_local, daemon=True)
        t1.start()
        t2.start()
        done.wait()
        try:
            conn.close()
        finally:
            tunnel.close()

    def stop(self) -> None:
        self._stopped.set()
        for lsock in self._listeners:
            try:
                lsock.close()
            except OSError:
                pass


class WSPortTunnel:
    """One forwarded connection over a pod portforward WebSocket."""

    def __init__(self, transport: KubeTransport, pod: str, namespace: str, port: int):
        self.ws = transport.connect_websocket(
            f"/api/v1/namespaces/{namespace}/pods/{pod}/portforward",
            query=[("ports", str(port))],
            subprotocols=["v4.channel.k8s.io"],
        )
        # The first frame on each channel (data=0, error=1) is a 2-byte
        # little-endian confirmation of the port number.
        self._confirmed: set[int] = set()

    def send(self, data: bytes) -> None:
        self.ws.send(bytes([0]) + data)

    def recv(self) -> bytes:
        while True:
            opcode, payload = self.ws.recv_message()
            if opcode == OP_CLOSE:
                return b""
            if not payload:
                continue
            channel, data = payload[0], payload[1:]
            if channel not in self._confirmed:
                # Port confirmation frame — strictly the first frame per
                # channel, so a real 2-byte payload is never swallowed.
                self._confirmed.add(channel)
                if len(data) == 2:
                    struct.unpack("<H", data)
                    continue
            if channel == 0:
                return data
            if channel == 1 and data:
                raise WebSocketError(
                    f"port-forward error: {data.decode('utf-8', 'replace')}"
                )

    def close(self) -> None:
        self.ws.close()


class LocalPortTunnel:
    """Fake-backend tunnel: plain TCP to a local port (the 'container' is a
    process on this machine — mirrors the reference's local test backend)."""

    def __init__(self, target_host: str, target_port: int):
        self.sock = socket.create_connection((target_host, target_port), timeout=10)

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv(self) -> bytes:
        try:
            return self.sock.recv(65536)
        except OSError:
            return b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
