"""Raw manifest engine, render half: the port's copy of
``devspace_tpu/deploy/manifests.py``.

Reference: pkg/devspace/deploy/kubectl (``kubectl apply`` of the
deployment's files, with image-tag rewriting via a YAML tree walk,
kubectl.go:105-178 + walk/): ``walk_replace``, ``rewrite_image_tags``,
``ManifestDeployer.render_manifests`` and ``create_deployer``. Applying
them, and ``deploy_all``/``purge_all``, need ``kube/``, which the port
does not have yet.
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
    """The raw-manifest engine for one deployment, render half: its
    manifests loaded and image-rewritten. The reference's
    ``deploy``/``delete``/``status`` apply through ``kube/``, which the
    port does not have yet; ``backend`` is kept in the signature for them
    and may be None."""

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


def create_deployer(backend, deployment: latest.DeploymentConfig, namespace: str, base_dir: str = ".", logger=None):
    """Engine dispatch (reference: deploy/util.go All)."""
    from .chart import ChartDeployer

    if deployment.chart is not None:
        return ChartDeployer(backend, deployment, namespace, logger, base_dir=base_dir)
    if deployment.manifests is not None:
        return ManifestDeployer(backend, deployment, namespace, base_dir, logger)
    raise ValueError(f"deployment {deployment.name} has neither chart nor manifests")
