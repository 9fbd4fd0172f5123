"""Canonical config schema, version ``tpu/v1``.

The port's copy of ``devspace_tpu/config/latest.py`` (reference:
pkg/devspace/config/versions/latest/schema.go: Config{Version, Cluster,
Dev, Deployments, Images}; DevConfig{Terminal, AutoReload,
OverrideImages, Selectors, Ports, Sync}), with one difference: where the
reference describes a TPU slice in a ``tpu`` block, the port describes
its GPU job in a ``gpu`` block (``GPUConfig``: ``workers``,
``perWorker``, ``product``). The version string stays ``tpu/v1``, so the
reference's configs load unchanged; one with a ``tpu`` block is refused
(``versions.parse``), since the port ships no TPU chart.

Every field is Optional — "unset" is distinguishable from zero, mirroring
the reference's pointer-field tri-state design.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

VERSION = "tpu/v1"


# -- cluster ---------------------------------------------------------------
@dataclass
class ClusterUser:
    client_cert: Optional[str] = None
    client_key: Optional[str] = None
    token: Optional[str] = None


@dataclass
class Cluster:
    kube_context: Optional[str] = None
    namespace: Optional[str] = None
    api_server: Optional[str] = None
    ca_cert: Optional[str] = None
    user: Optional[ClusterUser] = None


# -- gpu job ---------------------------------------------------------------
# The defaults of chart-gpu (devspace_tpu_torch/generator/templates).
DEFAULT_GPU_WORKERS = 1
DEFAULT_GPU_PER_WORKER = 1
DEFAULT_GPU_PRODUCT = "NVIDIA-H100-80GB-HBM3"


@dataclass
class GPUConfig:
    """Describes the GPU job, in chart-gpu's own names. It is the render
    context's ``gpu.*`` (``deploy.chart.gpu_context``), which sizes the
    chart's StatefulSet, and what the project lint holds the rendered
    objects to (TPU201-205)."""

    workers: Optional[int] = None  # hosts (pods): torchrun's --nnodes
    per_worker: Optional[int] = None  # cards a host: torchrun's --nproc-per-node
    product: Optional[str] = None  # GPU feature discovery's product label


# -- images ----------------------------------------------------------------
@dataclass
class BuildOptions:
    build_args: Optional[Dict[str, str]] = None
    target: Optional[str] = None
    network: Optional[str] = None


@dataclass
class KanikoConfig:
    cache: Optional[bool] = None
    namespace: Optional[str] = None
    pull_secret: Optional[str] = None
    image: Optional[str] = None


@dataclass
class DockerConfig:
    prefer_minikube: Optional[bool] = None
    disable_fallback: Optional[bool] = None


@dataclass
class BuildConfig:
    disabled: Optional[bool] = None
    kaniko: Optional[KanikoConfig] = None
    docker: Optional[DockerConfig] = None
    options: Optional[BuildOptions] = None


@dataclass
class ImageConfig:
    image: Optional[str] = None
    tag: Optional[str] = None
    dockerfile: Optional[str] = None
    context: Optional[str] = None
    create_pull_secret: Optional[bool] = None
    insecure: Optional[bool] = None
    skip_push: Optional[bool] = None
    build: Optional[BuildConfig] = None


# -- deployments -----------------------------------------------------------
@dataclass
class ChartConfig:
    path: Optional[str] = None
    name: Optional[str] = None
    values: Optional[Dict[str, object]] = None
    value_files: Optional[List[str]] = None
    wait: Optional[bool] = None
    timeout: Optional[int] = None


@dataclass
class ManifestsConfig:
    paths: Optional[List[str]] = None


@dataclass
class DeploymentConfig:
    name: Optional[str] = None
    namespace: Optional[str] = None
    chart: Optional[ChartConfig] = None
    manifests: Optional[ManifestsConfig] = None


# -- dev -------------------------------------------------------------------
@dataclass
class SelectorConfig:
    name: Optional[str] = None
    namespace: Optional[str] = None
    label_selector: Optional[Dict[str, str]] = None
    container_name: Optional[str] = None


@dataclass
class PortMapping:
    local_port: Optional[int] = None
    remote_port: Optional[int] = None
    bind_address: Optional[str] = None


@dataclass
class PortForwardingConfig:
    selector: Optional[str] = None
    namespace: Optional[str] = None
    label_selector: Optional[Dict[str, str]] = None
    port_mappings: Optional[List[PortMapping]] = None
    # TPU addition: forward from which worker (default 0); "all" offsets
    # local ports by worker id so every host is reachable at once.
    workers: Optional[str] = None


@dataclass
class BandwidthLimits:
    download: Optional[int] = None  # KB/s
    upload: Optional[int] = None


@dataclass
class SyncConfig:
    selector: Optional[str] = None
    namespace: Optional[str] = None
    label_selector: Optional[Dict[str, str]] = None
    container_name: Optional[str] = None
    local_sub_path: Optional[str] = None
    container_path: Optional[str] = None
    exclude_paths: Optional[List[str]] = None
    download_exclude_paths: Optional[List[str]] = None
    upload_exclude_paths: Optional[List[str]] = None
    bandwidth_limits: Optional[BandwidthLimits] = None
    # TPU addition: "all" broadcasts uploads to every worker and treats
    # worker 0 as authoritative for downloads; "worker0" syncs one host.
    fan_out: Optional[str] = None
    # Seconds between drift-verification passes over mirror workers
    # (0 disables; default 30).
    verify_interval: Optional[float] = None
    # Content-digest gating: metadata-only changes (touch/checkout with
    # unchanged bytes) become remote mtime fixes instead of re-uploads.
    # Default on; set false for trees where hashing costs more than the
    # transfers it avoids.
    digest: Optional[bool] = None


@dataclass
class TerminalConfig:
    selector: Optional[str] = None
    namespace: Optional[str] = None
    label_selector: Optional[Dict[str, str]] = None
    container_name: Optional[str] = None
    command: Optional[List[str]] = None
    disabled: Optional[bool] = None
    # TPU addition: which worker to open the shell on (default 0).
    worker: Optional[int] = None


@dataclass
class AutoReloadConfig:
    paths: Optional[List[str]] = None
    deployments: Optional[List[str]] = None
    images: Optional[List[str]] = None
    disabled: Optional[bool] = None


@dataclass
class ImageOverrideConfig:
    name: Optional[str] = None
    entrypoint: Optional[List[str]] = None


@dataclass
class DevConfig:
    terminal: Optional[TerminalConfig] = None
    auto_reload: Optional[AutoReloadConfig] = None
    override_images: Optional[List[ImageOverrideConfig]] = None
    selectors: Optional[List[SelectorConfig]] = None
    ports: Optional[List[PortForwardingConfig]] = None
    sync: Optional[List[SyncConfig]] = None


# -- root ------------------------------------------------------------------
@dataclass
class Config:
    version: Optional[str] = None
    cluster: Optional[Cluster] = None
    gpu: Optional[GPUConfig] = None
    dev: Optional[DevConfig] = None
    deployments: Optional[List[DeploymentConfig]] = None
    images: Optional[Dict[str, ImageConfig]] = None


def new() -> Config:
    return Config(version=VERSION)
