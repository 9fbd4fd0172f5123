"""Kubeconfig load/save/context handling.

Reference: pkg/util/kubeconfig/kubeconfig.go (Read/WriteKubeConfig) and the
client construction in pkg/devspace/kubectl/client.go:63-142 (kubeconfig or
inline cluster config, optional context switch). Pure stdlib + yaml.

The port's copy of ``devspace_tpu/kube/kubeconfig.py``, with the same behaviour.
"""

from __future__ import annotations

import base64
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import yaml


def default_path() -> str:
    env = os.environ.get("KUBECONFIG")
    if env:
        return env.split(os.pathsep)[0]
    return os.path.join(os.path.expanduser("~"), ".kube", "config")


@dataclass
class ClusterInfo:
    server: str = ""
    ca_data: Optional[bytes] = None  # PEM bytes
    insecure: bool = False


@dataclass
class UserInfo:
    token: Optional[str] = None
    client_cert_data: Optional[bytes] = None
    client_key_data: Optional[bytes] = None
    username: Optional[str] = None
    password: Optional[str] = None


@dataclass
class ContextInfo:
    cluster: str = ""
    user: str = ""
    namespace: Optional[str] = None


@dataclass
class KubeConfig:
    clusters: dict[str, ClusterInfo] = field(default_factory=dict)
    users: dict[str, UserInfo] = field(default_factory=dict)
    contexts: dict[str, ContextInfo] = field(default_factory=dict)
    current_context: str = ""
    path: Optional[str] = None

    @classmethod
    def load(cls, path: Optional[str] = None) -> "KubeConfig":
        path = path or default_path()
        kc = cls(path=path)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = yaml.safe_load(fh) or {}
        except OSError:
            return kc
        for c in data.get("clusters") or []:
            info = c.get("cluster") or {}
            ca = None
            if info.get("certificate-authority-data"):
                ca = base64.b64decode(info["certificate-authority-data"])
            elif info.get("certificate-authority"):
                try:
                    with open(info["certificate-authority"], "rb") as fh:
                        ca = fh.read()
                except OSError:
                    ca = None
            kc.clusters[c.get("name", "")] = ClusterInfo(
                server=info.get("server", ""),
                ca_data=ca,
                insecure=bool(info.get("insecure-skip-tls-verify")),
            )
        for u in data.get("users") or []:
            info = u.get("user") or {}

            def _read(data_key: str, file_key: str) -> Optional[bytes]:
                if info.get(data_key):
                    return base64.b64decode(info[data_key])
                if info.get(file_key):
                    try:
                        with open(info[file_key], "rb") as fh:
                            return fh.read()
                    except OSError:
                        return None
                return None

            kc.users[u.get("name", "")] = UserInfo(
                token=info.get("token"),
                client_cert_data=_read("client-certificate-data", "client-certificate"),
                client_key_data=_read("client-key-data", "client-key"),
                username=info.get("username"),
                password=info.get("password"),
            )
        for ctx in data.get("contexts") or []:
            info = ctx.get("context") or {}
            kc.contexts[ctx.get("name", "")] = ContextInfo(
                cluster=info.get("cluster", ""),
                user=info.get("user", ""),
                namespace=info.get("namespace"),
            )
        kc.current_context = data.get("current-context", "")
        return kc

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path or default_path()
        data = {
            "apiVersion": "v1",
            "kind": "Config",
            "current-context": self.current_context,
            "clusters": [
                {
                    "name": name,
                    "cluster": {
                        "server": c.server,
                        **(
                            {
                                "certificate-authority-data": base64.b64encode(
                                    c.ca_data
                                ).decode()
                            }
                            if c.ca_data
                            else {}
                        ),
                        **({"insecure-skip-tls-verify": True} if c.insecure else {}),
                    },
                }
                for name, c in self.clusters.items()
            ],
            "users": [
                {
                    "name": name,
                    "user": {
                        **({"token": u.token} if u.token else {}),
                        **({"username": u.username} if u.username else {}),
                        **({"password": u.password} if u.password else {}),
                        **(
                            {
                                "client-certificate-data": base64.b64encode(
                                    u.client_cert_data
                                ).decode()
                            }
                            if u.client_cert_data
                            else {}
                        ),
                        **(
                            {
                                "client-key-data": base64.b64encode(
                                    u.client_key_data
                                ).decode()
                            }
                            if u.client_key_data
                            else {}
                        ),
                    },
                }
                for name, u in self.users.items()
            ],
            "contexts": [
                {
                    "name": name,
                    "context": {
                        "cluster": c.cluster,
                        "user": c.user,
                        **({"namespace": c.namespace} if c.namespace else {}),
                    },
                }
                for name, c in self.contexts.items()
            ],
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Atomic write — kubeconfig corruption locks the user out of the
        # cluster, so never leave a half-written file.
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                yaml.safe_dump(data, fh, sort_keys=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def resolve(
        self, context: Optional[str] = None
    ) -> tuple[ClusterInfo, UserInfo, ContextInfo]:
        name = context or self.current_context
        if name not in self.contexts:
            raise KeyError(
                f"kube context '{name}' not found (available: {', '.join(self.contexts) or 'none'})"
            )
        ctx = self.contexts[name]
        cluster = self.clusters.get(ctx.cluster)
        user = self.users.get(ctx.user)
        if cluster is None:
            raise KeyError(f"cluster '{ctx.cluster}' referenced by context '{name}' not found")
        return cluster, user or UserInfo(), ctx
