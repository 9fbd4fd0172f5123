"""Minimal Docker Engine API client over the unix socket, stdlib-only.

Reference: pkg/devspace/docker/client.go (docker client from env or
minikube's docker-env) + builder/docker/docker.go (build-context tar,
JSON progress stream, push with base64 auth). We speak the Engine REST API
directly: ping, build, tag, push.

The port's copy of ``devspace_tpu/builder/dockerclient.py``, with the same behaviour.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import os
import socket
import subprocess
import tarfile
from typing import Iterator, Optional

from ..utils.ignoreutil import IgnoreMatcher

DEFAULT_SOCKET = "/var/run/docker.sock"


class DockerError(Exception):
    pass


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 600.0):
        super().__init__("localhost", timeout=timeout)
        self.socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.socket_path)
        self.sock = sock


class DockerClient:
    def __init__(self, socket_path: Optional[str] = None, host: Optional[str] = None):
        env_host = host or os.environ.get("DOCKER_HOST", "")
        if env_host.startswith("unix://"):
            socket_path = env_host[len("unix://") :]
        self.socket_path = socket_path or DEFAULT_SOCKET

    def _conn(self, timeout: float = 600.0) -> _UnixHTTPConnection:
        return _UnixHTTPConnection(self.socket_path, timeout)

    def ping(self, timeout: float = 3.0) -> bool:
        try:
            conn = self._conn(timeout)
            conn.request("GET", "/_ping")
            resp = conn.getresponse()
            ok = resp.status == 200
            resp.read()
            conn.close()
            return ok
        except (OSError, http.client.HTTPException):
            return False

    # -- build -------------------------------------------------------------
    @staticmethod
    def make_build_context(
        context_dir: str,
        dockerfile_path: Optional[str] = None,
        dockerfile_override: Optional[bytes] = None,
    ) -> bytes:
        """Tar the build context honoring .dockerignore; a Dockerfile outside
        the context (or an entrypoint-overridden one) is spliced in as
        'Dockerfile' (reference: builder/docker/docker.go:56-120,
        builder/util.go OverwriteDockerfileInBuildContext)."""
        ignore = IgnoreMatcher.from_file(os.path.join(context_dir, ".dockerignore"))
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            for root, dirs, files in os.walk(context_dir):
                for name in files:
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, context_dir).replace(os.sep, "/")
                    if rel != "Dockerfile" and ignore.matches(rel, False):
                        continue
                    if rel == "Dockerfile" and (dockerfile_override or dockerfile_path):
                        continue  # replaced below
                    try:
                        tf.add(full, arcname=rel, recursive=False)
                    except OSError:
                        continue
                dirs[:] = [
                    d
                    for d in dirs
                    if not ignore.matches(
                        os.path.relpath(os.path.join(root, d), context_dir).replace(
                            os.sep, "/"
                        ),
                        True,
                    )
                ]
            content = dockerfile_override
            if content is None and dockerfile_path:
                with open(dockerfile_path, "rb") as fh:
                    content = fh.read()
            if content is not None:
                ti = tarfile.TarInfo("Dockerfile")
                ti.size = len(content)
                tf.addfile(ti, io.BytesIO(content))
        return buf.getvalue()

    def build(
        self,
        context_tar: bytes,
        tag: str,
        build_args: Optional[dict[str, str]] = None,
        target: Optional[str] = None,
        network: Optional[str] = None,
        registry_auth: Optional[dict] = None,
    ) -> Iterator[str]:
        """POST /build; yields progress lines from the JSON stream."""
        import urllib.parse

        query = {"t": tag, "dockerfile": "Dockerfile"}
        if build_args:
            query["buildargs"] = json.dumps(build_args)
        if target:
            query["target"] = target
        if network:
            query["networkmode"] = network
        headers = {"Content-Type": "application/x-tar"}
        if registry_auth:
            headers["X-Registry-Config"] = base64.b64encode(
                json.dumps(registry_auth).encode()
            ).decode()
        conn = self._conn()
        conn.request(
            "POST",
            "/build?" + urllib.parse.urlencode(query),
            body=context_tar,
            headers=headers,
        )
        resp = conn.getresponse()
        try:
            yield from self._progress(resp, "build")
        finally:
            conn.close()

    def push(self, image: str, tag: str, auth: Optional[dict] = None) -> Iterator[str]:
        import urllib.parse

        headers = {
            "X-Registry-Auth": base64.b64encode(
                json.dumps(auth or {}).encode()
            ).decode()
        }
        conn = self._conn()
        conn.request(
            "POST",
            f"/images/{urllib.parse.quote(image, safe='')}/push?"
            + urllib.parse.urlencode({"tag": tag}),
            headers=headers,
        )
        resp = conn.getresponse()
        try:
            yield from self._progress(resp, "push")
        finally:
            conn.close()

    @staticmethod
    def _progress(resp, phase: str) -> Iterator[str]:
        if resp.status >= 400:
            raise DockerError(f"{phase} failed: {resp.status} {resp.read().decode('utf-8', 'replace')}")
        buf = b""
        while True:
            chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if "errorDetail" in msg or "error" in msg:
                    detail = msg.get("errorDetail", {}).get("message") or msg.get("error")
                    raise DockerError(f"{phase} failed: {detail}")
                text = msg.get("stream") or msg.get("status") or ""
                if text.strip():
                    yield text.rstrip("\n")


# -- docker auth (reference: pkg/devspace/docker/{auth,config}.go) ----------
def load_docker_auths(config_path: Optional[str] = None) -> dict[str, dict]:
    """Parse ~/.docker/config.json auths into {registry: authconfig}."""
    path = config_path or os.path.join(
        os.environ.get("DOCKER_CONFIG", os.path.expanduser("~/.docker")),
        "config.json",
    )
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    out: dict[str, dict] = {}
    for registry, entry in (data.get("auths") or {}).items():
        auth = dict(entry)
        if auth.get("auth"):
            try:
                user, _, pw = base64.b64decode(auth["auth"]).decode().partition(":")
                auth["username"], auth["password"] = user, pw
            except Exception:  # noqa: BLE001 — malformed entry
                pass
        out[registry] = auth
    cred_store = data.get("credsStore")
    if cred_store and not out:
        out.update(_auths_from_credstore(cred_store))
    return out


def save_docker_auth(
    registry: str,
    username: str,
    password: str,
    config_path: Optional[str] = None,
) -> str:
    """Persist a registry login into ~/.docker/config.json auths
    (reference: pkg/devspace/docker/auth.go:34 Login with
    ConfigFile.Save). Returns the path written."""
    path = config_path or os.path.join(
        os.environ.get("DOCKER_CONFIG", os.path.expanduser("~/.docker")),
        "config.json",
    )
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        data = {}
    auths = data.setdefault("auths", {})
    auths[registry] = {
        "auth": base64.b64encode(f"{username}:{password}".encode()).decode()
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # credentials file: owner-only, like the docker CLI writes it
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2)
    os.chmod(path, 0o600)
    return path


def _auths_from_credstore(store: str) -> dict[str, dict]:
    """Query a docker credential helper (best effort)."""
    helper = f"docker-credential-{store}"
    try:
        listing = subprocess.run(
            [helper, "list"], capture_output=True, timeout=10, check=True
        )
        servers = json.loads(listing.stdout or b"{}")
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}
    out: dict[str, dict] = {}
    for server in servers:
        try:
            got = subprocess.run(
                [helper, "get"],
                input=server.encode(),
                capture_output=True,
                timeout=10,
                check=True,
            )
            cred = json.loads(got.stdout)
            out[server] = {
                "username": cred.get("Username", ""),
                "password": cred.get("Secret", ""),
                "serveraddress": server,
            }
        except (OSError, subprocess.SubprocessError, ValueError):
            continue
    return out


def registry_from_image(image: str) -> str:
    """Registry host from an image name (reference: registry/util.go:9)."""
    first = image.split("/")[0]
    if "." in first or ":" in first or first == "localhost":
        return first
    return "docker.io"
