"""Cloud provider registry — ``~/.devspace/clouds.yaml``.

Reference: pkg/devspace/cloud/config.go:13-38 — a YAML map of named
providers, each with a host and (after login) a token, plus the implicit
default provider entry. ``DEVSPACE_CLOUD_CONFIG`` overrides the path so
tests and CI never touch the real home directory.

The port's copy of ``devspace_tpu/cloud/config.py``: the same file, the
same default provider, so either package reads the other's registry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import yaml

DEFAULT_PROVIDER_NAME = "tpu-cloud"
DEFAULT_PROVIDER_HOST = "https://cloud.devspace-tpu.dev"
CONFIG_ENV = "DEVSPACE_CLOUD_CONFIG"


def config_path() -> str:
    env = os.environ.get(CONFIG_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".devspace", "clouds.yaml")


@dataclass
class CloudProvider:
    name: str
    host: str
    key: Optional[str] = None  # long-lived access key (from login)
    token: Optional[str] = None  # short-lived JWT minted from the key


@dataclass
class ProviderRegistry:
    providers: Dict[str, CloudProvider] = field(default_factory=dict)
    default: str = DEFAULT_PROVIDER_NAME
    path: Optional[str] = None

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ProviderRegistry":
        path = path or config_path()
        reg = cls(path=path)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = yaml.safe_load(fh) or {}
        except OSError:
            data = {}
        for name, raw in (data.get("providers") or {}).items():
            raw = raw or {}
            reg.providers[name] = CloudProvider(
                name=name,
                host=raw.get("host", ""),
                key=raw.get("key"),
                token=raw.get("token"),
            )
        reg.default = data.get("default") or DEFAULT_PROVIDER_NAME
        # The default cloud is always present even on a fresh machine, like
        # the reference's implicit DevSpaceCloudProviderConfig entry.
        if DEFAULT_PROVIDER_NAME not in reg.providers:
            reg.providers[DEFAULT_PROVIDER_NAME] = CloudProvider(
                name=DEFAULT_PROVIDER_NAME, host=DEFAULT_PROVIDER_HOST
            )
        return reg

    def save(self) -> None:
        path = self.path or config_path()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        data = {
            "default": self.default,
            "providers": {
                p.name: {
                    "host": p.host,
                    **({"key": p.key} if p.key else {}),
                    **({"token": p.token} if p.token else {}),
                }
                for p in self.providers.values()
            },
        }
        with open(path, "w", encoding="utf-8") as fh:
            yaml.safe_dump(data, fh, sort_keys=False)

    def get(self, name: Optional[str] = None) -> CloudProvider:
        name = name or self.default
        if name not in self.providers:
            raise KeyError(
                f"cloud provider '{name}' not found "
                f"(available: {', '.join(sorted(self.providers)) or 'none'})"
            )
        return self.providers[name]
