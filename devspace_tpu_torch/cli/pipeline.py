"""The shared build -> deploy pipeline.

The port's copy of ``inject_default_image`` and ``build_and_deploy`` from
``devspace_tpu/cli/pipeline.py`` (reference: cmd/deploy.go, CI-style, no
dev overrides; cmd/dev.go buildAndDeploy 185). The reference's live dev
loop (``DevLoop``: sync, port forwarding, terminal, auto-reload) waits for
the port's ``sync/`` and ``services/`` (ROADMAP A21).
"""

from __future__ import annotations

from typing import Optional

from ..builder.images import build_all
from ..builder.registry import init_registries
from ..config import latest
from ..deploy.manifests import deploy_all
from ..utils import log as logutil
from ..utils.trace import span
from .context import Context


def inject_default_image(config: latest.Config, image_tags: dict[str, str]) -> None:
    """Charts default to ``values.image``; point it at the freshly built
    image when the user didn't set one explicitly (the reference injects
    a .Values.images map the same way, deploy/helm/deploy.go:154-161)."""
    if not image_tags:
        return
    default_ref = image_tags.get("default") or next(iter(image_tags.values()))
    for d in config.deployments or []:
        if d.chart is not None:
            values = dict(d.chart.values or {})
            values.setdefault("image", default_ref)
            d.chart.values = values


def build_and_deploy(
    ctx: Context,
    dev_mode: bool,
    force_build: bool = False,
    force_deploy: bool = False,
    logger: Optional[logutil.Logger] = None,
) -> dict[str, str]:
    """Reference: cmd/dev.go buildAndDeploy / cmd/deploy.go Run."""
    log = logger or ctx.log
    config = ctx.config
    backend = ctx.backend
    with span("pipeline", dev_mode=dev_mode):
        backend.ensure_namespace(ctx.namespace)
        if getattr(backend, "ensure_cluster_admin_binding", None) and ctx.is_gke:
            backend.ensure_cluster_admin_binding()
        with span("registries"):
            pull_secrets = init_registries(backend, config, ctx.namespace, log)
        cache = ctx.loader.generated.get_cache(dev_mode)
        with span("build", images=len(config.images or {})) as s:
            image_tags = build_all(
                config,
                cache,
                backend=backend,
                dev_mode=dev_mode,
                force=force_build,
                base_dir=ctx.root,
                logger=log,
            )
            s["built"] = len(image_tags)
        ctx.save_generated()
        inject_default_image(config, image_tags)
        with span("deploy", deployments=len(config.deployments or [])):
            deploy_all(
                backend,
                config,
                ctx.namespace,
                image_tags=image_tags,
                pull_secrets=pull_secrets,
                force=force_deploy,
                cache=cache,
                base_dir=ctx.root,
                logger=log,
            )
        ctx.save_generated()
    return image_tags
