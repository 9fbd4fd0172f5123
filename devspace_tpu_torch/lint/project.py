"""Project-wide finding collection — the preflight of a torch project.

The port's copy of ``devspace_tpu/lint/project.py``: renders every
configured deployment through the deploy render path (the same image-tag
fallbacks, the same ``gpu`` context), runs the manifest and hygiene packs
over each deployment's objects and the GPU job rules (TPU201-205) once
over all of them, the image pack over every configured Dockerfile, and
the hot-path and concurrency packs over the project's own Python.

The reference takes the CLI's loaded project context; the port has no
CLI, so :func:`load_project` builds the context it needs from a project
root through the port's own config loader.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..config import latest
from ..config.loader import ConfigLoader, get_default_namespace
from ..utils import log as logutil
from .engine import (
    CHART_CATEGORIES,
    ERROR,
    Finding,
    LintContext,
    lint_docs,
    render_failure,
    run_rules,
)


@dataclass
class ProjectContext:
    """What the preflight reads of a loaded project (the CLI context's
    fields in the reference): its root, loader, config and namespace.
    ``backend`` is the cluster backend the deployers would apply through
    (None: render only)."""

    root: str
    loader: ConfigLoader
    config: latest.Config
    namespace: str
    log: logutil.Logger
    backend: object = None


def load_project(
    root: str,
    config_name: Optional[str] = None,
    interactive: Optional[bool] = False,
    logger: Optional[logutil.Logger] = None,
) -> ProjectContext:
    """Load ``root``'s ``.devspace`` config through the port's loader
    (variables from the environment and the generated cache; never asks
    unless ``interactive``)."""
    loader = ConfigLoader(root, logger)
    config = loader.load(config_name, interactive=interactive)
    return ProjectContext(root=loader.root, loader=loader, config=config,
                          namespace=get_default_namespace(config), log=loader.log)


def collect_project_findings(ctx) -> tuple[list[Finding], int]:
    """All findings for a loaded project context (:class:`ProjectContext`).

    Returns ``(findings, n_objects)`` — the rendered-object count feeds
    a summary line. Render failures become DS100 findings rather than
    exceptions so one broken deployment doesn't hide the others."""
    from ..deploy.chart import ChartDeployer, ChartError
    from ..deploy.gotemplate import TemplateError
    from ..deploy.manifests import create_deployer

    findings: list[Finding] = []
    image_tags = dict(
        (ctx.loader.generated.get_active().deploy.image_tags or {})
    )
    for k, v in (ctx.config.images or {}).items():
        if v.image:
            image_tags.setdefault(k, f"{v.image}:dev")

    all_docs: list[dict] = []
    for d in ctx.config.deployments or []:
        deployer = create_deployer(ctx.backend, d, ctx.namespace, ctx.root, ctx.log)
        try:
            if isinstance(deployer, ChartDeployer):
                docs = deployer.render_manifests(
                    image_tags=image_tags, gpu=ctx.config.gpu
                )
            else:
                docs = deployer.render_manifests(image_tags=image_tags)
        except (ChartError, TemplateError, OSError) as e:
            f = render_failure(d.name, e)
            f.artifact = d.name
            findings.append(f)
            continue
        # structural + hygiene per deployment (findings carry the
        # deployment name); job invariants run once across ALL
        # deployments below — the gpu block is config-global
        findings.extend(
            lint_docs(
                docs,
                artifact=d.name,
                categories=CHART_CATEGORIES - {"gpu"},
            )
        )
        all_docs.extend(docs)
    findings.extend(
        run_rules(
            LintContext(docs=all_docs, gpu=ctx.config.gpu),
            categories={"gpu"},
        )
    )

    dockerfiles = []
    flavor = ctx.config.gpu is not None
    for _, img in sorted((ctx.config.images or {}).items()):
        rel = img.dockerfile or "Dockerfile"
        path = os.path.join(ctx.root, rel)
        if not os.path.isfile(path):
            continue  # the build pipeline owns missing-file errors
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                dockerfiles.append((rel, fh.read(), flavor))
        except OSError:
            continue
    if dockerfiles:
        findings.extend(
            run_rules(
                LintContext(dockerfiles=dockerfiles), categories={"image"}
            )
        )

    # hot-path + concurrency analysis over the project's own Python: the
    # torch code this project deploys is where a graph rebuilt in a loop
    # or a lock-order hazard costs card time. Warnings don't gate a
    # deploy (only PY500 syntax errors and the error rules do).
    from .pysource import collect_python_sources

    py_sources = collect_python_sources(ctx.root, subdirs=("",))
    if py_sources:
        findings.extend(
            run_rules(
                LintContext(python_sources=py_sources),
                categories={"hotpath", "concurrency"},
            )
        )
    return findings, len(all_docs)


def has_errors(findings) -> bool:
    return any(f.severity == ERROR for f in findings)
