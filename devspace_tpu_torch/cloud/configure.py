"""Space binding: generated-cache state + kubeconfig materialization.

Reference: pkg/devspace/cloud/configure.go — ``Configure`` (79-118) runs at
the top of every cluster-touching command and re-binds the session to the
active Space; ``UpdateKubeConfig`` (186-219) writes the space's service
account as kube context ``devspace-<space>``.

The port's copy of ``devspace_tpu/cloud/configure.py``, through the port's
own ``kube/kubeconfig.py`` and ``config/generated.py``: the same context
names and the same generated cache, so either package uses the other's
binding.
"""

from __future__ import annotations

import base64
from typing import Optional

from ..config.generated import GeneratedConfig, SpaceConfig
from ..kube.kubeconfig import ClusterInfo, ContextInfo, KubeConfig, UserInfo
from ..utils import log as logutil
from .config import ProviderRegistry
from .provider import CloudError, Provider, ServiceAccount, Space, token_valid

CONTEXT_PREFIX = "devspace-"


def kube_context_name(space_name: str) -> str:
    return CONTEXT_PREFIX + space_name


def update_kube_config(
    space_name: str,
    sa: ServiceAccount,
    set_current: bool = True,
    kubeconfig_path: Optional[str] = None,
) -> str:
    """Write the space's service account into the kubeconfig as context
    ``devspace-<space>`` and return the context name."""
    kc = KubeConfig.load(kubeconfig_path)
    name = kube_context_name(space_name)
    ca = base64.b64decode(sa.ca_cert) if sa.ca_cert else None
    kc.clusters[name] = ClusterInfo(server=sa.server, ca_data=ca)
    kc.users[name] = UserInfo(token=sa.token)
    kc.contexts[name] = ContextInfo(cluster=name, user=name, namespace=sa.namespace)
    if set_current:
        kc.current_context = name
    kc.save()
    return name


def remove_kube_context(space_name: str, kubeconfig_path: Optional[str] = None) -> None:
    kc = KubeConfig.load(kubeconfig_path)
    name = kube_context_name(space_name)
    kc.clusters.pop(name, None)
    kc.users.pop(name, None)
    kc.contexts.pop(name, None)
    if kc.current_context == name:
        kc.current_context = next(iter(kc.contexts), "")
    kc.save()


def bind_space(
    provider: Provider,
    space: Space,
    generated: GeneratedConfig,
    kubeconfig_path: Optional[str] = None,
) -> str:
    """``use space``: fetch credentials, materialize the kube context and
    record the binding in the generated cache (configure.go:144-219)."""
    sa = provider.get_service_account(space.space_id)
    context = update_kube_config(space.name, sa, kubeconfig_path=kubeconfig_path)
    generated.space = SpaceConfig(
        space_id=space.space_id,
        name=space.name,
        provider_name=provider.entry.name,
        namespace=sa.namespace,
        server=sa.server,
        ca_cert=sa.ca_cert,
        token=sa.token,
        domain=space.domain,
        created=space.created,
    )
    generated.save()
    return context


def configure(
    generated: GeneratedConfig,
    logger: Optional[logutil.Logger] = None,
    registry: Optional[ProviderRegistry] = None,
    kubeconfig_path: Optional[str] = None,
) -> Optional[str]:
    """Per-command preamble (configure.go:79-118): when a Space is bound,
    refresh its credentials if stale and return the kube context to use.
    Returns None when no space is bound (plain kubeconfig flow)."""
    log = logger or logutil.get_logger()
    space = generated.space
    if space is None or not space.name:
        return None
    if token_valid(space.token):
        return kube_context_name(space.name)
    registry = registry or ProviderRegistry.load()
    try:
        provider = Provider(registry.get(space.provider_name), registry, log)
        sa = provider.get_service_account(space.space_id)
    except (KeyError, CloudError) as e:
        log.warn(
            "[cloud] could not refresh credentials for space '%s': %s — "
            "using cached credentials",
            space.name,
            e,
        )
        return kube_context_name(space.name)
    space.token = sa.token
    space.server = sa.server
    space.ca_cert = sa.ca_cert
    space.namespace = sa.namespace
    generated.save()
    context = update_kube_config(space.name, sa, kubeconfig_path=kubeconfig_path)
    log.debug("[cloud] refreshed credentials for space '%s'", space.name)
    return context
