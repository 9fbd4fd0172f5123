"""Registry pull secrets.

Reference: pkg/devspace/registry/{registry,init}.go — for each image with
createPullSecret, resolve the registry from the image name, pull local
docker creds, and create a kubernetes.io/dockerconfigjson secret named
``devspace-auth-<registry>`` in every deployment namespace; the secret names
are later injected into charts (GetPullSecretNames).

The port's copy of ``devspace_tpu/builder/registry.py``, with the same behaviour.
"""

from __future__ import annotations

import base64
import json
import re
from typing import Optional

from ..config import latest
from ..utils import log as logutil
from .dockerclient import load_docker_auths, registry_from_image

SECRET_PREFIX = "devspace-auth-"


def secret_name(registry: str) -> str:
    """Reference: registry/registry.go:80 GetRegistryAuthSecretName."""
    slug = re.sub(r"[^a-z0-9-]", "-", registry.lower()).strip("-") or "registry"
    return SECRET_PREFIX + slug


def create_pull_secret(
    backend,
    namespace: str,
    registry: str,
    username: str,
    password: str,
    email: str = "noreply@devspace.tpu",
) -> str:
    auth = base64.b64encode(f"{username}:{password}".encode()).decode()
    docker_config = {
        "auths": {
            registry: {"username": username, "password": password, "email": email, "auth": auth}
        }
    }
    name = secret_name(registry)
    backend.apply(
        {
            "apiVersion": "v1",
            "kind": "Secret",
            "type": "kubernetes.io/dockerconfigjson",
            "metadata": {"name": name, "namespace": namespace},
            "data": {
                ".dockerconfigjson": base64.b64encode(
                    json.dumps(docker_config).encode()
                ).decode()
            },
        },
        namespace=namespace,
    )
    return name


def init_registries(
    backend,
    config: latest.Config,
    namespace: str,
    logger: Optional[logutil.Logger] = None,
) -> list[str]:
    """Create pull secrets for every image with createPullSecret in every
    deployment namespace (reference: registry/init.go InitRegistries).
    Returns the created secret names for chart injection."""
    log = logger or logutil.get_logger()
    auths = load_docker_auths()
    namespaces = {namespace}
    for d in config.deployments or []:
        if d.namespace:
            namespaces.add(d.namespace)
    created: list[str] = []
    for name, image_conf in (config.images or {}).items():
        if not image_conf.create_pull_secret or not image_conf.image:
            continue
        registry = registry_from_image(image_conf.image)
        cred = None
        for key, value in auths.items():
            if registry in key:
                cred = value
                break
        if cred is None or not cred.get("username"):
            log.warn(
                "[registry] no local docker credentials for %s — skipping pull secret",
                registry,
            )
            continue
        for ns in namespaces:
            backend.ensure_namespace(ns)
            sname = create_pull_secret(
                backend, ns, registry, cred["username"], cred.get("password", "")
            )
            if sname not in created:
                created.append(sname)
        log.done("[registry] pull secret ready for %s", registry)
    return created
