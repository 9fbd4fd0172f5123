"""Minimal RFC 6455 WebSocket client over a connected socket.

The reference reaches containers through SPDY stream upgrades
(pkg/devspace/kubectl/exec.go:63, client.go:368-376). SPDY is deprecated in
Kubernetes; the modern equivalent — and our transport — is WebSocket with the
``v4.channel.k8s.io`` subprotocol for exec/attach and
``v4.channel.k8s.io``/portforward framing for port-forward. Stdlib-only:
handshake over an existing socket (plain or TLS), masked client frames,
fragmentation, ping/pong, close.

Frame helpers are symmetric so tests can run a loopback server.

The port's copy of ``devspace_tpu/kube/websocket.py``, with the same behaviour.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketError(Exception):
    pass


def accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((client_key + GUID).encode()).digest()
    ).decode()


def client_handshake(
    sock: socket.socket,
    host: str,
    path: str,
    headers: Optional[dict[str, str]] = None,
    subprotocols: Optional[list[str]] = None,
) -> tuple[Optional[str], bytes]:
    """Perform the client upgrade handshake; returns (accepted subprotocol,
    leftover frame bytes that arrived coalesced with the 101 response — pass
    them to WebSocket(prebuffer=...)). Raises WebSocketError on refusal."""
    key = base64.b64encode(os.urandom(16)).decode()
    lines = [
        f"GET {path} HTTP/1.1",
        f"Host: {host}",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Key: {key}",
        "Sec-WebSocket-Version: 13",
    ]
    if subprotocols:
        lines.append("Sec-WebSocket-Protocol: " + ", ".join(subprotocols))
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())

    # Read response head.
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketError("connection closed during handshake")
        head += chunk
        if len(head) > 65536:
            raise WebSocketError("handshake response too large")
    head_text, _, rest = head.partition(b"\r\n\r\n")
    lines_in = head_text.decode("latin-1").split("\r\n")
    status = lines_in[0].split(" ", 2)
    if len(status) < 2 or status[1] != "101":
        raise WebSocketError(f"upgrade refused: {lines_in[0]}\n" + "\n".join(lines_in[1:8]))
    resp_headers = {}
    for ln in lines_in[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            resp_headers[k.strip().lower()] = v.strip()
    if resp_headers.get("sec-websocket-accept") != accept_key(key):
        raise WebSocketError("bad Sec-WebSocket-Accept")
    return resp_headers.get("sec-websocket-protocol"), rest


def encode_frame(opcode: int, payload: bytes, mask: bool = True, fin: bool = True) -> bytes:
    b0 = (0x80 if fin else 0) | opcode
    length = len(payload)
    if length < 126:
        header = struct.pack("!BB", b0, (0x80 if mask else 0) | length)
    elif length < (1 << 16):
        header = struct.pack("!BBH", b0, (0x80 if mask else 0) | 126, length)
    else:
        header = struct.pack("!BBQ", b0, (0x80 if mask else 0) | 127, length)
    if mask:
        key = os.urandom(4)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return header + key + masked
    return header + payload


class WebSocket:
    """Blocking WebSocket endpoint over a connected (TLS) socket."""

    def __init__(
        self, sock: socket.socket, is_client: bool = True, prebuffer: bytes = b""
    ):
        self.sock = sock
        self.is_client = is_client
        self._buffer = prebuffer
        self._closed = False

    # -- raw io -----------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        while len(self._buffer) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError as e:
                raise WebSocketError(f"socket error: {e}") from e
            if not chunk:
                raise WebSocketError("connection closed")
            self._buffer += chunk
        out, self._buffer = self._buffer[:n], self._buffer[n:]
        return out

    # -- frames -----------------------------------------------------------
    def send(self, payload: bytes, opcode: int = OP_BINARY) -> None:
        if self._closed:
            raise WebSocketError("websocket closed")
        frame = encode_frame(opcode, payload, mask=self.is_client)
        try:
            self.sock.sendall(frame)
        except OSError as e:
            raise WebSocketError(f"send failed: {e}") from e

    def recv_frame(self) -> tuple[int, bytes, bool]:
        """Returns (opcode, payload, fin). Control frames are returned as-is;
        use :meth:`recv_message` for transparent handling."""
        b0, b1 = self._recv_exact(2)
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        length = b1 & 0x7F
        if length == 126:
            (length,) = struct.unpack("!H", self._recv_exact(2))
        elif length == 127:
            (length,) = struct.unpack("!Q", self._recv_exact(8))
        key = self._recv_exact(4) if masked else None
        payload = self._recv_exact(length)
        if key:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return opcode, payload, fin

    def recv_message(self) -> tuple[int, bytes]:
        """Blocking read of the next data message, reassembling fragments and
        answering pings. Returns (opcode, payload); opcode OP_CLOSE on close."""
        message = b""
        message_op: Optional[int] = None
        while True:
            opcode, payload, fin = self.recv_frame()
            if opcode == OP_PING:
                self.send(payload, OP_PONG)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._closed = True
                try:
                    self.sock.sendall(encode_frame(OP_CLOSE, payload, mask=self.is_client))
                except OSError:
                    pass
                return OP_CLOSE, payload
            if opcode in (OP_TEXT, OP_BINARY):
                message_op = opcode
                message = payload
            elif opcode == OP_CONT:
                message += payload
            if fin:
                return message_op if message_op is not None else OP_BINARY, message

    def close(self, code: int = 1000) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.sock.sendall(
                    encode_frame(OP_CLOSE, struct.pack("!H", code), mask=self.is_client)
                )
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


# -- server-side helpers (tests' loopback server) --------------------------
def server_handshake(sock: socket.socket) -> tuple[Optional[str], bytes]:
    """Accept a client upgrade on a connected socket; returns (first requested
    subprotocol — echoed back, leftover frame bytes)."""
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketError("closed during handshake")
        head += chunk
    head_text, _, rest = head.partition(b"\r\n\r\n")
    headers = {}
    for ln in head_text.decode("latin-1").split("\r\n")[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key", "")
    proto = (headers.get("sec-websocket-protocol") or "").split(",")[0].strip() or None
    lines = [
        "HTTP/1.1 101 Switching Protocols",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Accept: {accept_key(key)}",
    ]
    if proto:
        lines.append(f"Sec-WebSocket-Protocol: {proto}")
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
    return proto, rest
