"""Legacy config schema ``tpu/v1alpha1`` and its upgrade to ``tpu/v1``.

The port's copy of ``devspace_tpu/config/v1alpha1.py`` (reference:
pkg/devspace/config/versions/v1alpha1/{schema,upgrade}.go): the old draft
kept ``sync``/``ports``/``terminal`` at the top level and a
per-deployment ``autoReload`` flag; the upgrade relocates them under
``dev.*``. Its ``gpu`` block carries over as it is (the reference's
``tpu`` block).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from . import latest
from .structs import from_dict, to_dict

VERSION = "tpu/v1alpha1"


@dataclass
class SyncConfigV1A1:
    selector: Optional[str] = None
    local_sub_path: Optional[str] = None
    container_path: Optional[str] = None
    exclude_paths: Optional[List[str]] = None


@dataclass
class PortConfigV1A1:
    selector: Optional[str] = None
    local_port: Optional[int] = None
    remote_port: Optional[int] = None


@dataclass
class TerminalConfigV1A1:
    selector: Optional[str] = None
    command: Optional[List[str]] = None
    disabled: Optional[bool] = None


@dataclass
class DeploymentConfigV1A1:
    name: Optional[str] = None
    namespace: Optional[str] = None
    auto_reload: Optional[bool] = None
    chart: Optional[latest.ChartConfig] = None
    manifests: Optional[latest.ManifestsConfig] = None


@dataclass
class ConfigV1A1:
    version: Optional[str] = None
    cluster: Optional[latest.Cluster] = None
    gpu: Optional[latest.GPUConfig] = None
    images: Optional[Dict[str, latest.ImageConfig]] = None
    deployments: Optional[List[DeploymentConfigV1A1]] = None
    sync: Optional[List[SyncConfigV1A1]] = None
    ports: Optional[List[PortConfigV1A1]] = None
    terminal: Optional[TerminalConfigV1A1] = None

    def upgrade(self) -> latest.Config:
        cfg = latest.Config(
            version=latest.VERSION,
            cluster=self.cluster,
            gpu=self.gpu,
            images=self.images,
        )
        dev = latest.DevConfig()
        # The old schema referenced selectors by bare name with no selector
        # definitions list; materialize empty definitions so upgraded configs
        # stay valid (resolution falls back to release=<deployment> labels).
        referenced = []
        for item in (self.sync or []) + (self.ports or []) + (
            [self.terminal] if self.terminal else []
        ):
            if item.selector and item.selector not in referenced:
                referenced.append(item.selector)
        if referenced:
            dev.selectors = [latest.SelectorConfig(name=n) for n in referenced]
        if self.sync:
            dev.sync = [
                latest.SyncConfig(
                    selector=s.selector,
                    local_sub_path=s.local_sub_path,
                    container_path=s.container_path,
                    exclude_paths=s.exclude_paths,
                )
                for s in self.sync
            ]
        if self.ports:
            dev.ports = [
                latest.PortForwardingConfig(
                    selector=p.selector,
                    port_mappings=[
                        latest.PortMapping(
                            local_port=p.local_port, remote_port=p.remote_port
                        )
                    ],
                )
                for p in self.ports
            ]
        if self.terminal:
            dev.terminal = latest.TerminalConfig(
                selector=self.terminal.selector,
                command=self.terminal.command,
                disabled=self.terminal.disabled,
            )
        if self.deployments:
            reload_deployments = [
                d.name for d in self.deployments if d.auto_reload and d.name
            ]
            if reload_deployments:
                dev.auto_reload = latest.AutoReloadConfig(
                    deployments=reload_deployments
                )
            cfg.deployments = [
                latest.DeploymentConfig(
                    name=d.name,
                    namespace=d.namespace,
                    chart=d.chart,
                    manifests=d.manifests,
                )
                for d in self.deployments
            ]
        if any(
            getattr(dev, f) is not None
            for f in ("sync", "ports", "terminal", "auto_reload")
        ):
            cfg.dev = dev
        return cfg


def parse(data: dict) -> ConfigV1A1:
    return from_dict(ConfigV1A1, data)
