"""HTTPS transport to the Kubernetes API server: REST + WebSocket upgrade.

Reference: pkg/devspace/kubectl/client.go builds a clientset from kubeconfig
or from inline cluster config (APIServer/CaCert/Token in the devspace
config); exec/attach/portforward upgrade the connection (exec.go:20,
client.go:368-376). Here both ride one stdlib transport: http.client for
REST, raw socket + ssl + RFC6455 for streams.

The port's copy of ``devspace_tpu/kube/transport.py``, with the same behaviour.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import socket
import ssl
import tempfile
import urllib.parse
from typing import Any, Iterator, Optional

from ..resilience.policy import RetryPolicy
from . import websocket as ws
from .kubeconfig import ClusterInfo, ContextInfo, KubeConfig, UserInfo


class ApiError(Exception):
    def __init__(self, status: int, reason: str, body: Any = None):
        super().__init__(f"API error {status}: {reason}")
        self.status = status
        self.reason = reason
        self.body = body


def _default_connect_policy() -> RetryPolicy:
    """Transport-level transient-failure policy: connection refused/reset
    and malformed responses from an API server mid-restart are retried with
    short exponential backoff; HTTP-level errors (ApiError) are never — the
    server answered, the answer stands."""
    return RetryPolicy(
        max_attempts=3,
        base_delay=0.2,
        max_delay=2.0,
        jitter=0.2,
        seed=0,
        retry_on=(OSError, http.client.HTTPException),
    )


class KubeTransport:
    def __init__(
        self,
        server: str,
        ca_data: Optional[bytes] = None,
        token: Optional[str] = None,
        client_cert_data: Optional[bytes] = None,
        client_key_data: Optional[bytes] = None,
        basic_auth: Optional[tuple[str, str]] = None,
        insecure: bool = False,
        default_namespace: str = "default",
        context_name: Optional[str] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.retry_policy = retry_policy or _default_connect_policy()
        u = urllib.parse.urlparse(server)
        if u.scheme not in ("https", "http"):
            raise ValueError(f"unsupported API server scheme: {server}")
        self.scheme = u.scheme
        self.host = u.hostname or "localhost"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.base_path = u.path.rstrip("/")
        self.token = token
        self.basic_auth = basic_auth
        self.default_namespace = default_namespace
        self.context_name = context_name
        self._cert_files: list[str] = []
        self.ssl_context: Optional[ssl.SSLContext] = None
        if self.scheme == "https":
            ctx = ssl.create_default_context()
            if insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            elif ca_data:
                ctx.load_verify_locations(cadata=ca_data.decode("utf-8", "ignore"))
            if client_cert_data and client_key_data:
                # ssl requires file paths for the client chain.
                cert_path = self._tmpfile(client_cert_data)
                key_path = self._tmpfile(client_key_data)
                ctx.load_cert_chain(cert_path, key_path)
            self.ssl_context = ctx

    def _tmpfile(self, data: bytes) -> str:
        fd, path = tempfile.mkstemp(prefix="devspace-kube-")
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.chmod(path, 0o600)
        self._cert_files.append(path)
        return path

    def __del__(self):  # best-effort cleanup of key material
        for p in getattr(self, "_cert_files", []):
            try:
                os.unlink(p)
            except OSError:
                pass

    # -- construction -----------------------------------------------------
    @classmethod
    def from_kubeconfig(
        cls,
        path: Optional[str] = None,
        context: Optional[str] = None,
        namespace: Optional[str] = None,
    ) -> "KubeTransport":
        kc = KubeConfig.load(path)
        cluster, user, ctx = kc.resolve(context)
        return cls._from_parts(
            cluster, user, ctx, namespace, context or kc.current_context
        )

    @classmethod
    def _from_parts(
        cls,
        cluster: ClusterInfo,
        user: UserInfo,
        ctx: ContextInfo,
        namespace: Optional[str],
        context_name: Optional[str],
    ) -> "KubeTransport":
        return cls(
            server=cluster.server,
            ca_data=cluster.ca_data,
            token=user.token,
            client_cert_data=user.client_cert_data,
            client_key_data=user.client_key_data,
            basic_auth=(user.username, user.password)
            if user.username and user.password
            else None,
            insecure=cluster.insecure,
            default_namespace=namespace or ctx.namespace or "default",
            context_name=context_name,
        )

    @classmethod
    def from_inline(
        cls,
        api_server: str,
        ca_cert_b64: Optional[str] = None,
        token: Optional[str] = None,
        namespace: str = "default",
    ) -> "KubeTransport":
        """Inline cluster config as the reference supports in
        devspace config cluster.{apiServer,caCert,user.token}."""
        ca = base64.b64decode(ca_cert_b64) if ca_cert_b64 else None
        return cls(
            server=api_server,
            ca_data=ca,
            token=token,
            insecure=ca is None,
            default_namespace=namespace,
        )

    # -- auth headers ------------------------------------------------------
    def _auth_headers(self) -> dict[str, str]:
        headers: dict[str, str] = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        elif self.basic_auth:
            raw = f"{self.basic_auth[0]}:{self.basic_auth[1]}".encode()
            headers["Authorization"] = "Basic " + base64.b64encode(raw).decode()
        return headers

    # -- REST --------------------------------------------------------------
    def request(
        self,
        method: str,
        path: str,
        query: Optional[dict[str, str]] = None,
        body: Any = None,
        content_type: str = "application/json",
        timeout: float = 30.0,
    ) -> Any:
        """One API request, retried under ``retry_policy`` when safe:
        idempotent methods (GET/HEAD/DELETE/PUT) retry any transport error;
        non-idempotent ones (POST/PATCH) retry only ConnectionRefusedError —
        with the connection refused, nothing reached the server."""
        if method.upper() in ("GET", "HEAD", "DELETE", "PUT"):
            return self.retry_policy.execute(
                self._request_once,
                method, path, query, body, content_type, timeout,
                describe=f"{method} {path}",
                reraise=True,
            )
        try:
            return self._request_once(method, path, query, body, content_type, timeout)
        except ConnectionRefusedError:
            return self.retry_policy.execute(
                self._request_once,
                method, path, query, body, content_type, timeout,
                describe=f"{method} {path}",
                reraise=True,
            )

    def _request_once(
        self,
        method: str,
        path: str,
        query: Optional[dict[str, str]] = None,
        body: Any = None,
        content_type: str = "application/json",
        timeout: float = 30.0,
    ) -> Any:
        conn_cls = http.client.HTTPSConnection if self.scheme == "https" else http.client.HTTPConnection
        kwargs = {"timeout": timeout}
        if self.scheme == "https":
            kwargs["context"] = self.ssl_context
        conn = conn_cls(self.host, self.port, **kwargs)
        try:
            full = self.base_path + path
            if query:
                full += "?" + urllib.parse.urlencode(query)
            headers = {"Accept": "application/json", **self._auth_headers()}
            payload = None
            if body is not None:
                payload = body if isinstance(body, (bytes, str)) else json.dumps(body)
                headers["Content-Type"] = content_type
            conn.request(method, full, body=payload, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 400:
                try:
                    parsed = json.loads(raw)
                    reason = parsed.get("message", resp.reason)
                except (ValueError, AttributeError):
                    parsed, reason = raw.decode("utf-8", "replace"), resp.reason
                raise ApiError(resp.status, reason, parsed)
            if not raw:
                return None
            try:
                return json.loads(raw)
            except ValueError:
                return raw
        finally:
            conn.close()

    def stream_lines(
        self,
        path: str,
        query: Optional[dict[str, str]] = None,
        timeout: float = 3600.0,
    ) -> Iterator[bytes]:
        """GET a streaming endpoint (pod logs with follow=true) yielding
        raw lines."""
        conn_cls = http.client.HTTPSConnection if self.scheme == "https" else http.client.HTTPConnection
        kwargs = {"timeout": timeout}
        if self.scheme == "https":
            kwargs["context"] = self.ssl_context
        conn = conn_cls(self.host, self.port, **kwargs)
        try:
            full = self.base_path + path
            if query:
                full += "?" + urllib.parse.urlencode(query)
            conn.request("GET", full, headers=self._auth_headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                raise ApiError(resp.status, resp.reason, resp.read().decode("utf-8", "replace"))
            buf = b""
            while True:
                chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
                if not chunk:
                    if buf:
                        yield buf
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    yield line
        finally:
            conn.close()

    # -- WebSocket upgrade -------------------------------------------------
    def connect_websocket(
        self,
        path: str,
        query: Optional[list[tuple[str, str]]] = None,
        subprotocols: Optional[list[str]] = None,
        timeout: float = 30.0,
    ) -> ws.WebSocket:
        """Dial + upgrade, retried under ``retry_policy``: until the
        handshake completes no stream state exists, so a redial is free."""
        return self.retry_policy.execute(
            self._connect_websocket_once,
            path, query, subprotocols, timeout,
            describe=f"websocket {path}",
            reraise=True,
        )

    def _connect_websocket_once(
        self,
        path: str,
        query: Optional[list[tuple[str, str]]] = None,
        subprotocols: Optional[list[str]] = None,
        timeout: float = 30.0,
    ) -> ws.WebSocket:
        raw = socket.create_connection((self.host, self.port), timeout=timeout)
        try:
            if self.scheme == "https":
                raw = self.ssl_context.wrap_socket(raw, server_hostname=self.host)
            full = self.base_path + path
            if query:
                full += "?" + urllib.parse.urlencode(query)
            ws_host = self.host if self.port in (80, 443) else f"{self.host}:{self.port}"
            _, prebuffer = ws.client_handshake(
                raw,
                ws_host,
                full,
                headers=self._auth_headers(),
                subprotocols=subprotocols or ["v4.channel.k8s.io"],
            )
            raw.settimeout(None)
            return ws.WebSocket(raw, is_client=True, prebuffer=prebuffer)
        except BaseException:
            raw.close()
            raise
