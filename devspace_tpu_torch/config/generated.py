"""Runtime state cache — ``.devspace/generated.yaml``.

The port's copy of ``devspace_tpu/config/generated.py`` (reference:
pkg/devspace/config/generated/config.go:16-55): per-named-config x
{dev,deploy} caches of image tags, Dockerfile timestamps, context hashes,
chart hashes and deploy timestamps, answered vars, and the bound cloud
Space. The file is the reference's, so either package reads the other's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import yaml

DEVSPACE_DIR = ".devspace"
GENERATED_FILE = "generated.yaml"


@dataclass
class CacheConfig:
    image_tags: Dict[str, str] = field(default_factory=dict)
    dockerfile_timestamps: Dict[str, float] = field(default_factory=dict)
    dockerfile_context_hashes: Dict[str, str] = field(default_factory=dict)
    chart_hashes: Dict[str, str] = field(default_factory=dict)
    deployment_timestamps: Dict[str, float] = field(default_factory=dict)


@dataclass
class SpaceConfig:
    space_id: Optional[int] = None
    name: Optional[str] = None
    provider_name: Optional[str] = None
    namespace: Optional[str] = None
    server: Optional[str] = None
    ca_cert: Optional[str] = None
    token: Optional[str] = None
    domain: Optional[str] = None
    created: Optional[str] = None


@dataclass
class ConfigCache:
    dev: CacheConfig = field(default_factory=CacheConfig)
    deploy: CacheConfig = field(default_factory=CacheConfig)
    vars: Dict[str, str] = field(default_factory=dict)


class GeneratedConfig:
    def __init__(self, root: str = "."):
        self.root = root
        self.active_config: str = "default"
        self.configs: Dict[str, ConfigCache] = {}
        self.space: Optional[SpaceConfig] = None

    # -- accessors --------------------------------------------------------
    def get_active(self) -> ConfigCache:
        if self.active_config not in self.configs:
            self.configs[self.active_config] = ConfigCache()
        return self.configs[self.active_config]

    def get_cache(self, dev_mode: bool) -> CacheConfig:
        active = self.get_active()
        return active.dev if dev_mode else active.deploy

    # -- persistence ------------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.root, DEVSPACE_DIR, GENERATED_FILE)

    @classmethod
    def load(cls, root: str = ".") -> "GeneratedConfig":
        gc = cls(root)
        try:
            with open(gc.path, "r", encoding="utf-8") as fh:
                data = yaml.safe_load(fh) or {}
            return cls._parse(gc, data)
        except OSError:
            return gc
        except Exception:
            # State cache is advisory — a truncated/corrupt file must never
            # brick every command; degrade to a fresh cache.
            return cls(root)

    @classmethod
    def _parse(cls, gc: "GeneratedConfig", data: dict) -> "GeneratedConfig":
        gc.active_config = data.get("activeConfig", "default")
        for name, raw in (data.get("configs") or {}).items():
            cc = ConfigCache()
            for mode in ("dev", "deploy"):
                m = raw.get(mode) or {}
                cache = getattr(cc, mode)
                cache.image_tags = dict(m.get("imageTags") or {})
                cache.dockerfile_timestamps = dict(m.get("dockerfileTimestamps") or {})
                cache.dockerfile_context_hashes = dict(
                    m.get("dockerfileContextHashes") or {}
                )
                cache.chart_hashes = dict(m.get("chartHashes") or {})
                cache.deployment_timestamps = dict(m.get("deploymentTimestamps") or {})
            cc.vars = dict(raw.get("vars") or {})
            gc.configs[name] = cc
        if data.get("space"):
            s = data["space"]
            gc.space = SpaceConfig(
                space_id=s.get("spaceId"),
                name=s.get("name"),
                provider_name=s.get("providerName"),
                namespace=s.get("namespace"),
                server=s.get("server"),
                ca_cert=s.get("caCert"),
                token=s.get("token"),
                domain=s.get("domain"),
                created=s.get("created"),
            )
        return gc

    def save(self) -> None:
        data: dict = {"activeConfig": self.active_config, "configs": {}}
        for name, cc in self.configs.items():
            entry: dict = {"vars": cc.vars}
            for mode in ("dev", "deploy"):
                cache = getattr(cc, mode)
                entry[mode] = {
                    "imageTags": cache.image_tags,
                    "dockerfileTimestamps": cache.dockerfile_timestamps,
                    "dockerfileContextHashes": cache.dockerfile_context_hashes,
                    "chartHashes": cache.chart_hashes,
                    "deploymentTimestamps": cache.deployment_timestamps,
                }
            data["configs"][name] = entry
        if self.space:
            data["space"] = {
                "spaceId": self.space.space_id,
                "name": self.space.name,
                "providerName": self.space.provider_name,
                "namespace": self.space.namespace,
                "server": self.space.server,
                "caCert": self.space.ca_cert,
                "token": self.space.token,
                "domain": self.space.domain,
                "created": self.space.created,
            }
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w", encoding="utf-8") as fh:
            yaml.safe_dump(data, fh, sort_keys=False)
