"""Per-image build orchestration with incremental skip cache.

Reference: pkg/devspace/image/build.go — BuildAll (24): for each configured
image, skip when dockerfile mtime + context hash match the generated cache
(shouldRebuild 189-238), otherwise random 7-char tag (86), authenticate ->
build -> push, dev-mode entrypoint override injection (146-158), record tag
in the cache (179-183); create_builder.go picks docker vs kaniko.

The port's copy of ``devspace_tpu/builder/images.py``. Its
``create_builder`` raises ``BuildError`` where the reference would pick
the in-cluster Kaniko builder, which waits for the port's sync engine
(ROADMAP A21); it never picks another builder in its place.
"""

from __future__ import annotations

import os
from typing import Optional

from ..config import latest
from ..config.generated import CacheConfig
from ..utils import log as logutil
from ..utils.hashutil import directory_hash
from ..utils.ignoreutil import get_ignore_rules
from ..utils.randutil import random_string
from .builders import BuildError, DockerBuilder, FakeBuilder

KANIKO_PENDING = (
    "the in-cluster Kaniko builder is not ported yet: it uploads its build "
    "context through the sync engine (ROADMAP A21)"
)


def create_builder(
    image_conf: latest.ImageConfig,
    backend=None,
    namespace: str = "default",
    pull_secret: Optional[str] = None,
    logger=None,
    prefer_fake: bool = False,
):
    """Pick the build engine (reference: image/create_builder.go): the
    fake recorder on a fake backend, else local docker. Where the
    reference picks kaniko (configured, or the fallback when docker is
    unreachable and a backend exists) this raises ``BuildError``: the
    Kaniko builder waits for the sync engine (ROADMAP A21)."""
    build = image_conf.build
    if prefer_fake or getattr(backend, "is_fake", False):
        return FakeBuilder()
    if build and build.kaniko is not None and backend is not None:
        raise BuildError(
            f"image {image_conf.image}: build.kaniko is set, but {KANIKO_PENDING}"
        )
    docker = DockerBuilder(logger=logger)
    if docker.available():
        return docker
    if backend is not None and not (
        build and build.docker and build.docker.disable_fallback
    ):
        raise BuildError(
            f"image {image_conf.image}: the docker daemon is unreachable and the "
            f"fallback would build in the cluster, but {KANIKO_PENDING}"
        )
    raise RuntimeError(
        "no build engine available: docker daemon unreachable and no cluster "
        "backend for kaniko"
    )


def should_rebuild(
    name: str,
    image_conf: latest.ImageConfig,
    cache: CacheConfig,
    base_dir: str = ".",
) -> bool:
    """Dockerfile mtime + context hash vs cache
    (reference: image/build.go:189-238)."""
    dockerfile = os.path.join(base_dir, image_conf.dockerfile or "Dockerfile")
    context = os.path.join(base_dir, image_conf.context or ".")
    try:
        mtime = os.path.getmtime(dockerfile)
    except OSError:
        return True
    excludes = get_ignore_rules(os.path.join(context, ".dockerignore"))
    ctx_hash = directory_hash(context, excludes=excludes)
    unchanged = (
        cache.dockerfile_timestamps.get(name) == mtime
        and cache.dockerfile_context_hashes.get(name) == ctx_hash
        and name in cache.image_tags
    )
    if unchanged:
        return False
    cache.dockerfile_timestamps[name] = mtime
    cache.dockerfile_context_hashes[name] = ctx_hash
    return True


def build_all(
    config: latest.Config,
    cache: CacheConfig,
    backend=None,
    dev_mode: bool = False,
    force: bool = False,
    base_dir: str = ".",
    logger: Optional[logutil.Logger] = None,
    builder_factory=None,
) -> dict[str, str]:
    """Build every configured image; returns {name: full_ref_with_tag}
    for deploy-time injection (reference: image.BuildAll)."""
    log = logger or logutil.get_logger()
    image_tags: dict[str, str] = {}
    for name, image_conf in (config.images or {}).items():
        if image_conf.build and image_conf.build.disabled:
            continue
        if not force and not should_rebuild(name, image_conf, cache, base_dir):
            tag = cache.image_tags[name]
            image_tags[name] = f"{image_conf.image}:{tag}"
            log.info("[build] %s unchanged, keeping tag %s", name, tag)
            continue
        tag = image_conf.tag or random_string(7)
        entrypoint_override = None
        if dev_mode and config.dev and config.dev.override_images:
            for ov in config.dev.override_images:
                if ov.name == name and ov.entrypoint:
                    entrypoint_override = ov.entrypoint
        builder = (
            builder_factory(image_conf)
            if builder_factory
            else create_builder(image_conf, backend, logger=log)
        )
        opts = image_conf.build.options if image_conf.build else None
        log.info("[build] building %s:%s", image_conf.image, tag)
        builder.authenticate(image_conf.image)
        builder.build(
            image_conf.image,
            tag,
            context_dir=os.path.join(base_dir, image_conf.context or "."),
            dockerfile_path=os.path.join(
                base_dir, image_conf.dockerfile or "Dockerfile"
            ),
            entrypoint_override=entrypoint_override,
            build_args=(opts.build_args if opts else None),
            target=(opts.target if opts else None),
            network=(opts.network if opts else None),
        )
        if not image_conf.skip_push:
            builder.push(image_conf.image, tag)
        cache.image_tags[name] = tag
        image_tags[name] = f"{image_conf.image}:{tag}"
        log.done("[build] %s -> %s:%s", name, image_conf.image, tag)
    return image_tags
