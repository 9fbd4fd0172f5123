"""Raw manifest engine: the port's copy of ``devspace_tpu/deploy/manifests.py``.

Reference: pkg/devspace/deploy/kubectl (``kubectl apply`` of the
deployment's files, with image-tag rewriting via a YAML tree walk,
kubectl.go:105-178 + walk/), and the deploy pipeline's ``deploy_all`` /
``purge_all`` over every configured deployment. ``deploy_all`` hands the
chart engine the config's ``gpu`` block where the reference hands it
``tpu``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import yaml

from ..config import latest
from ..utils import log as logutil


def walk_replace(tree, match, replace):
    """Generic YAML tree walk (reference: deploy/kubectl/walk/walk.go —
    shared with config var substitution)."""
    if isinstance(tree, dict):
        for k, v in list(tree.items()):
            if isinstance(v, (dict, list)):
                walk_replace(v, match, replace)
            elif match(k, v):
                tree[k] = replace(v)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            if isinstance(v, (dict, list)):
                walk_replace(v, match, replace)
            elif match(None, v):
                tree[i] = replace(v)


def rewrite_image_tags(manifest: dict, image_tags: dict[str, str]) -> None:
    """Replace ``image:`` refs whose repo matches a built image with the
    freshly built ``repo:tag`` (reference: kubectl.go replaceManifest:160)."""

    def match(key, value):
        if key != "image" or not isinstance(value, str):
            return False
        repo = value.split(":")[0]
        return repo in image_tags or value in image_tags

    def replace(value):
        repo = value.split(":")[0]
        return image_tags.get(value) or image_tags[repo]

    walk_replace(manifest, match, replace)


class ManifestDeployer:
    """The raw-manifest engine for one deployment: its manifests loaded,
    image-rewritten and applied through a ``kube/`` backend (None where
    only :meth:`render_manifests` is called)."""

    def __init__(
        self,
        backend,
        deployment: latest.DeploymentConfig,
        namespace: str,
        base_dir: str = ".",
        logger: Optional[logutil.Logger] = None,
    ):
        if deployment.manifests is None or not deployment.name:
            raise ValueError("manifest deployment needs a name and manifests config")
        self.backend = backend
        self.deployment = deployment
        self.namespace = deployment.namespace or namespace
        self.base_dir = base_dir
        self.log = logger or logutil.get_logger()

    def _load(self) -> list[dict]:
        docs: list[dict] = []
        for pattern in self.deployment.manifests.paths or []:
            paths = sorted(glob.glob(os.path.join(self.base_dir, pattern)))
            if not paths:
                self.log.warn("[deploy] no manifests match %s", pattern)
            for path in paths:
                with open(path, "r", encoding="utf-8") as fh:
                    for doc in yaml.safe_load_all(fh):
                        if doc:
                            docs.append(doc)
        return docs

    def render_manifests(
        self, image_tags: Optional[dict[str, str]] = None, **_: object
    ) -> list[dict]:
        """Load + image-rewrite without applying. ``image_tags`` is what a
        build returns, {config_name: "repo:tag"}; manifests reference
        images by repo, so the rewrite map is keyed by repo too."""
        docs = self._load()
        repo_map: dict[str, str] = {}
        for key, ref in (image_tags or {}).items():
            repo_map[ref.rsplit(":", 1)[0]] = ref
            if "/" in key:
                repo_map[key] = ref
        for doc in docs:
            if repo_map:
                rewrite_image_tags(doc, repo_map)
            doc.setdefault("metadata", {}).setdefault("namespace", self.namespace)
        return docs

    def deploy(
        self,
        image_tags: Optional[dict[str, str]] = None,
        force: bool = False,
        cache=None,
        **_: object,
    ) -> bool:
        docs = self.render_manifests(image_tags=image_tags)
        self.backend.ensure_namespace(self.namespace)
        for doc in docs:
            self.backend.apply(doc, namespace=self.namespace)
        self.log.done(
            "[deploy] %s: applied %d manifest(s)", self.deployment.name, len(docs)
        )
        return True

    def delete(self) -> None:
        for doc in reversed(self._load()):
            self.backend.delete_object(doc, namespace=self.namespace)
        self.log.done("[deploy] deleted manifests of %s", self.deployment.name)

    def status(self) -> list[dict]:
        out = []
        for doc in self._load():
            meta = doc.get("metadata", {})
            obj = self.backend.get_object(
                doc.get("apiVersion", "v1"),
                doc.get("kind"),
                meta.get("name"),
                meta.get("namespace") or self.namespace,
            )
            out.append(
                {
                    "kind": doc.get("kind"),
                    "name": meta.get("name"),
                    "namespace": meta.get("namespace") or self.namespace,
                    "found": obj is not None,
                }
            )
        return out


def create_deployer(backend, deployment: latest.DeploymentConfig, namespace: str, base_dir: str = ".", logger=None):
    """Engine dispatch (reference: deploy/util.go All)."""
    from .chart import ChartDeployer

    if deployment.chart is not None:
        return ChartDeployer(backend, deployment, namespace, logger, base_dir=base_dir)
    if deployment.manifests is not None:
        return ManifestDeployer(backend, deployment, namespace, base_dir, logger)
    raise ValueError(f"deployment {deployment.name} has neither chart nor manifests")


def deploy_all(
    backend,
    config: latest.Config,
    namespace: str,
    image_tags: Optional[dict[str, str]] = None,
    pull_secrets: Optional[list[str]] = None,
    force: bool = False,
    cache=None,
    base_dir: str = ".",
    logger=None,
) -> int:
    """Deploy every configured deployment in order (reference:
    deploy.All, pkg/devspace/deploy/util.go:15)."""
    count = 0
    for d in config.deployments or []:
        deployer = create_deployer(backend, d, namespace, base_dir, logger)
        kwargs = dict(image_tags=image_tags, force=force, cache=cache)
        from .chart import ChartDeployer

        if isinstance(deployer, ChartDeployer):
            # Honor the config's rollout-wait knobs (reference honors
            # Helm.Wait/Helm.Timeout, deploy/helm/deploy.go:163-168);
            # defaults match helm's wait=true / 40s (helm/install.go:28).
            chart_cfg = d.chart
            kwargs.update(
                gpu=config.gpu,
                pull_secrets=pull_secrets,
                wait=True if chart_cfg.wait is None else bool(chart_cfg.wait),
                wait_timeout=float(
                    40 if chart_cfg.timeout is None else chart_cfg.timeout
                ),
            )
        if deployer.deploy(**kwargs):
            count += 1
    return count


def purge_all(backend, config: latest.Config, namespace: str, base_dir: str = ".", logger=None) -> None:
    """Delete deployments in reverse order (reference: cmd/purge.go:104)."""
    for d in reversed(config.deployments or []):
        try:
            create_deployer(backend, d, namespace, base_dir, logger).delete()
        except Exception as e:  # noqa: BLE001 — best-effort teardown
            (logger or logutil.get_logger()).warn(
                "[purge] failed to delete %s: %s", d.name, e
            )
