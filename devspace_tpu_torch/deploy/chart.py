"""Chart engine, render half: the port's copy of ``devspace_tpu/deploy/chart.py``.

Charts are rendered client-side (reference: pkg/devspace/deploy/helm +
pkg/devspace/helm: InstallChartByPath, values merge, image-tag injection)
into manifest dicts. The chart format is the reference's: a directory with

    chart.yaml       name/version/description
    values.yaml      defaults (deep-merged with config + runtime values)
    templates/*.yaml YAML manifests with ${{ expr }} substitutions

or an upstream-style Helm chart (``Chart.yaml``, Go templates through
``deploy.gotemplate``). Expressions resolve dotted paths against the
render context (``values.*``, ``release.name``, ``release.namespace``,
``gpu.*``, ``images.*``, ``pullSecrets``). A scalar whose whole value is
one expression keeps its native type (ints stay ints).

Where the reference's deployer injects a ``tpu.*`` context built from
the config's ``tpu`` block, the port's injects ``gpu.*`` from its ``gpu``
block (:func:`gpu_context`); chart-gpu sizes its StatefulSet from it.
Applying, deleting and the release status need ``kube/``, which the port
does not have yet: ``ChartDeployer`` here renders.
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
from typing import Any, Optional

import yaml

from ..config import latest
from ..config.merge import merge
from ..utils import log as logutil
from ..utils.hashutil import directory_hash
from ..utils.torchrun import max_nodes, torchrun_flags

_EXPR = re.compile(r"\$\{\{\s*([A-Za-z0-9_.\-\[\]]+)\s*\}\}")

GPU_RESOURCE = "nvidia.com/gpu"


class ChartError(Exception):
    pass


def _lookup(context: dict, path: str) -> Any:
    cur: Any = context
    for part in path.split("."):
        while "[" in part:
            base, _, rest = part.partition("[")
            idx, _, part2 = rest.partition("]")
            if base:
                if not isinstance(cur, dict) or base not in cur:
                    raise ChartError(f"unknown template path: {path}")
                cur = cur[base]
            try:
                cur = cur[int(idx)]
            except (IndexError, ValueError, TypeError) as e:
                raise ChartError(f"bad index in template path: {path}") from e
            part = part2.lstrip(".")
            if not part:
                break
        if not part:
            continue
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise ChartError(f"unknown template path: {path}")
    return cur


def render_value(value: Any, context: dict) -> Any:
    if isinstance(value, str):
        full = _EXPR.fullmatch(value.strip())
        if full:
            return _lookup(context, full.group(1))
        return _EXPR.sub(lambda m: str(_lookup(context, m.group(1))), value)
    if isinstance(value, dict):
        return {render_value(k, context): render_value(v, context) for k, v in value.items()}
    if isinstance(value, list):
        return [render_value(v, context) for v in value]
    return value


def chart_meta_path(chart_path: str) -> Optional[str]:
    """Path of the chart's metadata file: ``chart.yaml`` (our dialect) or
    ``Chart.yaml`` (upstream Helm naming — reference loads real Helm
    charts, pkg/devspace/helm/install.go:54)."""
    for name in ("chart.yaml", "Chart.yaml"):
        p = os.path.join(chart_path, name)
        if os.path.isfile(p):
            return p
    return None


def is_helm_chart(chart_path: str) -> bool:
    """Helm-style charts use capital-C ``Chart.yaml`` and Go templates."""
    return os.path.isfile(os.path.join(chart_path, "Chart.yaml")) and not os.path.isfile(
        os.path.join(chart_path, "chart.yaml")
    )


def load_chart(chart_path: str) -> dict:
    meta_path = chart_meta_path(chart_path)
    if meta_path is None:
        raise ChartError(f"not a chart: {chart_path} (no chart.yaml/Chart.yaml)")
    with open(meta_path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh) or {}


def render_chart(
    chart_path: str,
    release_name: str,
    namespace: str,
    values: Optional[dict] = None,
    value_files: Optional[list[str]] = None,
    extra_context: Optional[dict] = None,
) -> list[dict]:
    """Render all templates to manifest dicts. Value precedence mirrors the
    reference (deploy/helm/deploy.go:108-161): chart values.yaml < value
    files < inline values."""
    meta = load_chart(chart_path)
    merged_values: dict = {}
    defaults_path = os.path.join(chart_path, "values.yaml")
    if os.path.isfile(defaults_path):
        with open(defaults_path, "r", encoding="utf-8") as fh:
            merged_values = yaml.safe_load(fh) or {}
    for vf in value_files or []:
        with open(vf, "r", encoding="utf-8") as fh:
            merged_values = merge(merged_values, yaml.safe_load(fh) or {})
    if values:
        merged_values = merge(merged_values, values)
    _derive_persistence(merged_values)
    _derive_autoscaling(merged_values)
    context = {
        "values": merged_values,
        "release": {"name": release_name, "namespace": namespace},
        "chart": meta,
        **(extra_context or {}),
    }
    manifests = _render_templates(chart_path, context, release_name, namespace)

    # Vendored packages (deploy/packages.py add_package): each renders with
    # its own defaults overridden by the parent's values.packages.<name>,
    # sharing the release/extra context so its pods join the same release.
    # Helm-style vendored dependencies live in charts/ with values scoped
    # under values.<name> (helm subchart semantics); ours in packages/
    # scoped under values.packages.<name>. A helm-style parent handles its
    # own charts/ inside _render_helm_templates (shared define namespace,
    # dependency condition gating), so skip that subdir here.
    subdirs = (
        (("packages", "packages"),)
        if is_helm_chart(chart_path)
        else (("packages", "packages"), ("charts", None))
    )
    for subdir, scope in subdirs:
        base = os.path.join(chart_path, subdir)
        if not os.path.isdir(base):
            continue
        for pkg_name in sorted(os.listdir(base)):
            pkg_dir = os.path.join(base, pkg_name)
            if chart_meta_path(pkg_dir) is None:
                continue
            pkg_values: dict = {}
            pkg_defaults = os.path.join(pkg_dir, "values.yaml")
            if os.path.isfile(pkg_defaults):
                with open(pkg_defaults, "r", encoding="utf-8") as fh:
                    pkg_values = yaml.safe_load(fh) or {}
            if scope:
                overrides = (merged_values.get(scope) or {}).get(pkg_name) or {}
            else:
                overrides = merged_values.get(pkg_name) or {}
            sub_values = merge(pkg_values, overrides)
            if scope is None and "global" in merged_values:
                sub_values = merge(sub_values, {"global": merged_values["global"]})
            # dialect packages follow the same persistence convention as
            # the parent; helm packages template their own PVCs with
            # their own values schemas — deriving (and validating) there
            # would break vendored upstream charts whose persistence:
            # shape differs
            if not is_helm_chart(pkg_dir):
                _derive_persistence(sub_values)
                _derive_autoscaling(sub_values)
            pkg_context = {
                **context,
                "values": sub_values,
                "chart": load_chart(pkg_dir),
            }
            manifests.extend(
                _render_templates(pkg_dir, pkg_context, release_name, namespace)
            )

    if not manifests:
        raise ChartError(f"chart {chart_path} rendered no manifests")
    _check_hpa_slice_conflict(manifests)
    return manifests


def requests_gpu(container: dict) -> bool:
    """The container asks for ``nvidia.com/gpu`` (requests or limits)."""
    res = container.get("resources") or {}
    return any(GPU_RESOURCE in (res.get(k) or {}) for k in ("requests", "limits"))


def _check_hpa_slice_conflict(manifests: list[dict]) -> None:
    """Render-time hard error (every render path goes through here): an
    HPA must never target a MULTI-worker GPU job, whose worker count is
    its torchrun world (``--nnodes``), not load; the reference's rule
    for a multi-host TPU slice (its ``TPU_WORKER_HOSTNAMES`` roster).
    Detected from the manifests alone, so it holds even when no ``gpu``
    config is in scope: a workload with a container that requests
    ``nvidia.com/gpu`` and starts torchrun over more than one node.
    One-worker workloads may scale (each replica an independent
    server)."""
    worlds: dict[tuple[str, str], int] = {}
    for doc in manifests:
        if not isinstance(doc, dict):
            continue
        key = (
            str(doc.get("kind")),
            str((doc.get("metadata") or {}).get("name")),
        )
        spec = doc.get("spec") or {}
        tmpl = ((spec.get("template") or {}).get("spec")) or {}
        containers = list(tmpl.get("containers") or []) + list(
            tmpl.get("initContainers") or []
        )
        for c in containers:
            flags = torchrun_flags(c) if isinstance(c, dict) else None
            if flags is None or not requests_gpu(c):
                continue
            hosts = max_nodes(flags.get("nnodes", "1")) or 0
            worlds[key] = max(hosts, worlds.get(key, 0))
    for doc in manifests:
        if (
            not isinstance(doc, dict)
            or doc.get("kind") != "HorizontalPodAutoscaler"
        ):
            continue
        ref = ((doc.get("spec") or {}).get("scaleTargetRef")) or {}
        hosts = worlds.get((str(ref.get("kind")), str(ref.get("name"))), 0)
        if hosts > 1:
            raise ChartError(
                f"autoscaling: HPA targets {ref.get('kind')}/"
                f"{ref.get('name')}, a {hosts}-worker GPU job — its worker "
                f"count is its torchrun world (--nnodes), not load; "
                f"horizontal scaling fits one-worker serving replicas only"
            )


def _derive_persistence(values: dict) -> None:
    """Engine convention for stateful workloads: a single
    ``persistence.volumes`` list — ``[{name, size, storageClass?,
    accessModes?}]``, the reference's ``volumes:`` values shape
    (the reference's examples/php-mysql-example/chart/values.yaml) — is
    expanded IN PLACE into the three k8s-native derived lists templates
    consume, so chart authors declare a volume once:

    - ``persistence.claims``      [{name, spec}]         standalone PVCs
      (Deployment + shared claim, via x-devspace-for-each)
    - ``persistence.attach``      pod-spec ``volumes:`` claim references
    - ``persistence.claimTemplates``  StatefulSet ``volumeClaimTemplates``
      (per-replica claims — each GPU job worker gets its own, the
      durable-checkpoint-dir story)

    ``persistence.mounts`` (k8s-native volumeMounts) stays user-written —
    only the author knows the paths. Explicitly-set derived keys win
    (they are only filled when absent)."""
    pers = values.get("persistence")
    if not isinstance(pers, dict):
        return
    vols = pers.get("volumes") or []
    if not isinstance(vols, list):
        raise ChartError("persistence.volumes must be a list")

    def claim_spec(v: dict) -> dict:
        if not isinstance(v, dict) or not v.get("name") or not v.get("size"):
            raise ChartError(
                f"persistence.volumes entries need name+size, got {v!r}"
            )
        spec = {
            "accessModes": v.get("accessModes") or ["ReadWriteOnce"],
            "resources": {"requests": {"storage": str(v["size"])}},
        }
        if v.get("storageClass"):
            spec["storageClassName"] = v["storageClass"]
        return spec

    pers.setdefault(
        "claims", [{"name": v["name"], "spec": claim_spec(v)} for v in vols]
    )
    pers.setdefault(
        "attach",
        [
            {
                "name": v["name"],
                "persistentVolumeClaim": {"claimName": v["name"]},
            }
            for v in vols
        ],
    )
    pers.setdefault(
        "claimTemplates",
        [
            {"metadata": {"name": v["name"]}, "spec": claim_spec(v)}
            for v in vols
        ],
    )
    pers.setdefault("mounts", [])


def _derive_autoscaling(values: dict) -> None:
    """Engine convention for horizontal pod autoscaling — the reference's
    ``autoScaling.horizontal`` values gate
    (the reference's examples/php-mysql-example/chart/templates/
    pod-autoscaling.yaml: rendered only when ``maxReplicas`` exceeds the
    component's ``replicas``), expressed as a derived list the charts'
    hpa.yaml consumes via x-devspace-for-each (empty -> no HPA rendered):

    .. code-block:: yaml

        autoscaling:
          horizontal:
            maxReplicas: 5      # must exceed replicas to render
            averageCPU: 80      # % target utilization
            averageMemory: 512Mi  # absolute target (optional)

    Emits autoscaling/v2 ``metrics`` entries (the reference's v2beta1
    fields upgraded to the ``target:`` schema current clusters accept).
    An explicitly-set ``autoscaling.objects`` wins (only filled when
    absent), like the persistence derivations above."""
    auto = values.get("autoscaling")
    if not isinstance(auto, dict):
        # `autoscaling: null` is the standard disable-override idiom —
        # normalize so the hpa.yaml for-each lookup still resolves
        values["autoscaling"] = {"objects": []}
        return
    hor = auto.get("horizontal")
    if not isinstance(hor, dict) or not hor:
        auto.setdefault("objects", [])
        return
    try:
        replicas = int(values.get("replicas") or 1)
    except (TypeError, ValueError):
        replicas = 1
    if hor.get("maxReplicas") is None:
        raise ChartError(
            "autoscaling.horizontal needs maxReplicas (metrics alone "
            "render nothing; the gate would silently drop the HPA)"
        )
    try:
        max_replicas = int(hor["maxReplicas"])
    except (TypeError, ValueError) as e:
        raise ChartError(
            f"autoscaling.horizontal.maxReplicas must be an integer: {e}"
        ) from e
    # metrics validate BEFORE the render gate: a bad averageCPU must fail
    # at authoring time, not months later when someone lowers replicas
    # and the gate flips on
    metrics = []
    if hor.get("averageCPU") is not None:
        try:
            cpu = int(hor["averageCPU"])
        except (TypeError, ValueError) as e:
            raise ChartError(
                f"autoscaling.horizontal.averageCPU must be an integer "
                f"percentage: {e}"
            ) from e
        metrics.append(
            {
                "type": "Resource",
                "resource": {
                    "name": "cpu",
                    "target": {
                        "type": "Utilization",
                        "averageUtilization": cpu,
                    },
                },
            }
        )
    if hor.get("averageMemory"):
        metrics.append(
            {
                "type": "Resource",
                "resource": {
                    "name": "memory",
                    "target": {
                        "type": "AverageValue",
                        "averageValue": str(hor["averageMemory"]),
                    },
                },
            }
        )
    if max_replicas <= replicas:
        # the reference's gt-gate: an HPA capped at or below the static
        # replica count could only fight the Deployment. Gated-off
        # configs may omit metrics entirely (lowering maxReplicas is a
        # legitimate disable idiom) — only VALUE malformation above
        # fails at authoring time.
        auto.setdefault("objects", [])
        return
    if not metrics:
        raise ChartError(
            "autoscaling.horizontal needs averageCPU and/or averageMemory "
            "(an HPA without metrics cannot scale)"
        )
    auto.setdefault(
        "objects",
        [
            {
                "minReplicas": replicas,
                "maxReplicas": max_replicas,
                "metrics": metrics,
            }
        ],
    )


# Doc-level expansion directive: a template document carrying this key is
# rendered once per element of the referenced list (dotted context path),
# with ``item`` / ``itemIndex`` added to the context — and dropped
# entirely when the list is empty. The chart language stays pure
# substitution otherwise; this is its one iteration construct (used by
# the generator charts' volumes.yaml to emit one PVC per declared volume,
# the reference's range loop at
# examples/php-mysql-example/chart/templates/volumes.yaml).
FOR_EACH_KEY = "x-devspace-for-each"


def _render_templates(
    chart_path: str, context: dict, release_name: str, namespace: str
) -> list[dict]:
    if is_helm_chart(chart_path):
        return _render_helm_templates(chart_path, context, release_name, namespace)
    manifests: list[dict] = []
    template_dir = os.path.join(chart_path, "templates")
    for path in sorted(glob.glob(os.path.join(template_dir, "*.yaml"))) + sorted(
        glob.glob(os.path.join(template_dir, "*.yml"))
    ):
        with open(path, "r", encoding="utf-8") as fh:
            raw = fh.read()
        try:
            docs = list(yaml.safe_load_all(raw))
        except yaml.YAMLError as e:
            raise ChartError(f"{path}: invalid YAML: {e}") from e
        for doc in docs:
            if not doc:
                continue
            contexts = [context]
            if isinstance(doc, dict) and FOR_EACH_KEY in doc:
                list_path = str(doc[FOR_EACH_KEY])
                doc = {k: v for k, v in doc.items() if k != FOR_EACH_KEY}
                items = _lookup(context, list_path)
                if not isinstance(items, list):
                    raise ChartError(
                        f"{path}: {FOR_EACH_KEY} target {list_path!r} is "
                        f"not a list"
                    )
                contexts = [
                    {**context, "item": it, "itemIndex": i}
                    for i, it in enumerate(items)
                ]
            for ctx in contexts:
                rendered = render_value(doc, ctx)
                if not isinstance(rendered, dict) or "kind" not in rendered:
                    raise ChartError(f"{path}: rendered doc has no kind")
                rendered.setdefault("metadata", {}).setdefault(
                    "namespace", namespace
                )
                labels = rendered["metadata"].setdefault("labels", {})
                labels.setdefault("devspace.tpu/release", release_name)
                manifests.append(rendered)
    return manifests


def _dependency_enabled(dep: dict, parent_values: dict) -> bool:
    """Helm dependency gating: ``enabled:`` and ``condition:`` (a comma list
    of value paths; the first that exists wins, default true)."""
    if dep.get("enabled") is False:
        return False
    cond = dep.get("condition")
    if not cond:
        return True
    for path in str(cond).split(","):
        cur: Any = parent_values
        for part in path.strip().split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                cur = None
                break
        if cur is not None:
            return bool(cur)
    return True


def _helm_chart_tree(
    chart_path: str, values: dict, meta: dict
) -> list[tuple[str, dict, dict]]:
    """(dir, scoped_values, meta) for a helm chart and its *enabled*
    ``charts/`` dependencies, recursively. Subchart values follow helm
    semantics: subchart defaults < parent's ``values.<name>``, with the
    parent's ``global`` passed through; ``dependencies:`` in Chart.yaml
    (or requirements.yaml) gate via condition/enabled."""
    out = [(chart_path, values, meta)]
    charts_dir = os.path.join(chart_path, "charts")
    if not os.path.isdir(charts_dir):
        return out
    deps_meta: dict[str, dict] = {}
    for dep in meta.get("dependencies") or []:
        if dep.get("name"):
            deps_meta[dep["name"]] = dep
    req_path = os.path.join(chart_path, "requirements.yaml")
    if os.path.isfile(req_path):
        with open(req_path, "r", encoding="utf-8") as fh:
            for dep in (yaml.safe_load(fh) or {}).get("dependencies") or []:
                if dep.get("name"):
                    deps_meta.setdefault(dep["name"], dep)
    for sub_name in sorted(os.listdir(charts_dir)):
        sub_dir = os.path.join(charts_dir, sub_name)
        if chart_meta_path(sub_dir) is None:
            continue
        sub_meta = load_chart(sub_dir)
        dep_name = sub_meta.get("name", sub_name)
        if not _dependency_enabled(deps_meta.get(dep_name, {}), values):
            continue
        sub_values: dict = {}
        sub_defaults = os.path.join(sub_dir, "values.yaml")
        if os.path.isfile(sub_defaults):
            with open(sub_defaults, "r", encoding="utf-8") as fh:
                sub_values = yaml.safe_load(fh) or {}
        sub_values = merge(sub_values, values.get(dep_name) or {})
        if "global" in values:
            sub_values = merge(sub_values, {"global": values["global"]})
        out.extend(_helm_chart_tree(sub_dir, sub_values, sub_meta))
    return out


def _is_hook_manifest(doc: dict) -> bool:
    annotations = (doc.get("metadata") or {}).get("annotations") or {}
    return any(str(k).startswith("helm.sh/hook") for k in annotations)


def _render_helm_templates(
    chart_path: str, context: dict, release_name: str, namespace: str
) -> list[dict]:
    """Render an upstream-style Helm chart: Go templates under
    ``templates/`` (incl. ``_helpers.tpl`` defines), the standard
    ``.Values/.Release/.Chart/.Capabilities`` context. The runtime trio
    the deployer injects (images / gpu / pullSecrets) is exposed as Helm
    *values*, exactly where the reference injects the same trio
    (deploy/helm/deploy.go:154-161).

    All charts in the tree (parent + enabled charts/ dependencies) share
    ONE define namespace, like helm's single template engine — library
    charts whose only content is _helpers defines work. ``templates/
    tests/`` and ``helm.sh/hook``-annotated manifests are skipped (helm
    runs those only under `helm test` / at hook points, not on install)."""
    from .gotemplate import Renderer, TemplateError

    meta = context.get("chart") or {}
    values = dict(context.get("values") or {})
    for key in ("images", "gpu", "pullSecrets"):
        if key in context and key not in values:
            values[key] = context[key]

    tree = _helm_chart_tree(chart_path, values, meta)
    renderer = Renderer(seed=f"{release_name}/{namespace}")
    # (template-key, helm_ctx, display_path) for non-helper templates
    sources: list[tuple[str, dict, str]] = []
    release_ctx = {
        "Name": release_name,
        "Namespace": namespace,
        "Service": "devspace-tpu",
        "IsInstall": True,
        "IsUpgrade": False,
        "Revision": 1,
    }
    capabilities = {
        "KubeVersion": {"Version": "v1.27.0", "Major": "1", "Minor": "27"},
        "APIVersions": _APIVersions(),
    }
    for sub_dir, sub_values, sub_meta in tree:
        helm_ctx = {
            "Values": sub_values,
            "Release": release_ctx,
            # Helm exposes metadata with capitalized field names
            "Chart": {str(k)[:1].upper() + str(k)[1:]: v for k, v in sub_meta.items()},
            "Capabilities": capabilities,
        }
        template_dir = os.path.join(sub_dir, "templates")
        for path in sorted(
            glob.glob(os.path.join(template_dir, "**", "*"), recursive=True)
        ):
            base = os.path.basename(path)
            if not os.path.isfile(path) or base == "NOTES.txt":
                continue
            if not base.endswith((".yaml", ".yml", ".tpl")):
                continue
            rel = os.path.relpath(path, template_dir)
            key = os.path.relpath(path, chart_path)
            with open(path, "r", encoding="utf-8") as fh:
                try:
                    renderer.load(key, fh.read())
                except TemplateError as e:
                    raise ChartError(f"{path}: {e}") from e
            if base.startswith("_"):  # _helpers.tpl etc: defines only
                continue
            if rel.split(os.sep)[0] == "tests":  # helm test templates
                continue
            sources.append((key, helm_ctx, path))
    manifests: list[dict] = []
    for key, helm_ctx, path in sources:
        try:
            out = renderer.execute(key, helm_ctx)
        except TemplateError as e:
            raise ChartError(f"{path}: {e}") from e
        try:
            docs = list(yaml.safe_load_all(out))
        except yaml.YAMLError as e:
            raise ChartError(
                f"{path}: rendered to invalid YAML: {e}\n--- rendered ---\n{out}"
            ) from e
        for doc in docs:
            if not doc:
                continue
            if not isinstance(doc, dict) or "kind" not in doc:
                raise ChartError(f"{path}: rendered doc has no kind")
            if _is_hook_manifest(doc):
                continue
            doc.setdefault("metadata", {}).setdefault("namespace", namespace)
            labels = doc["metadata"].setdefault("labels", {})
            labels.setdefault("devspace.tpu/release", release_name)
            manifests.append(doc)
    return manifests


class _APIVersions:
    """``.Capabilities.APIVersions``: iterable of versions with a ``Has``
    method callable from templates."""

    _versions = ("v1", "apps/v1", "batch/v1", "networking.k8s.io/v1")

    def __iter__(self):
        return iter(self._versions)

    def Has(self, version: str) -> bool:  # noqa: N802 — helm casing
        return version in self._versions


def gpu_context(gpu: Optional[latest.GPUConfig]) -> dict:
    """The render context's ``gpu.*`` from the config's ``gpu`` block,
    chart-gpu's defaults where it is unset: ``workers`` (hosts, the
    StatefulSet's replicas and torchrun's ``--nnodes``), ``perWorker``
    (cards a host: ``nvidia.com/gpu`` and ``--nproc-per-node``) and
    ``product`` (the node selector's GPU product)."""
    return {
        "workers": (gpu.workers if gpu else None) or latest.DEFAULT_GPU_WORKERS,
        "perWorker": (gpu.per_worker if gpu else None) or latest.DEFAULT_GPU_PER_WORKER,
        "product": (gpu.product if gpu else None) or latest.DEFAULT_GPU_PRODUCT,
    }


class ChartDeployer:
    """The chart engine for one chart deployment (reference interface:
    pkg/devspace/deploy/interface.go), render half: the chart and value
    files it resolves, its cache key, and its manifests. The reference's
    ``deploy``/``delete``/``status`` (and its rollout wait and release
    record) apply through ``kube/``, which the port does not have yet;
    ``backend`` is kept in the signature for them and may be None."""

    def __init__(
        self,
        backend,
        deployment: latest.DeploymentConfig,
        namespace: str,
        logger: Optional[logutil.Logger] = None,
        base_dir: str = ".",
    ):
        if deployment.chart is None or not deployment.name:
            raise ChartError("chart deployment needs a name and chart config")
        self.backend = backend
        self.deployment = deployment
        self.namespace = deployment.namespace or namespace
        self.log = logger or logutil.get_logger()
        # chart paths resolve against the PROJECT root, not the cwd —
        # commands run from a subdirectory must see the same chart
        self.base_dir = base_dir

    def _resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.base_dir, path)

    @property
    def chart_path(self) -> str:
        return self._resolve(self.deployment.chart.path or "")

    @property
    def value_files(self) -> list[str]:
        return [self._resolve(vf) for vf in self.deployment.chart.value_files or []]

    # -- cache key (reference: deploy/helm/deploy.go:29-80 skip-if-unchanged)
    def chart_hash(self) -> str:
        path = self.chart_path
        parts = [directory_hash(path)] if path and os.path.isdir(path) else []
        for vf in self.value_files:
            try:
                parts.append(str(os.path.getmtime(vf)))
            except OSError:
                parts.append("missing")
        parts.append(str(self.deployment.chart.values or {}))
        return hashlib.blake2b("|".join(parts).encode(), digest_size=12).hexdigest()

    def render_manifests(
        self,
        image_tags: Optional[dict[str, str]] = None,
        gpu: Optional[latest.GPUConfig] = None,
        pull_secrets: Optional[list[str]] = None,
    ) -> list[dict]:
        """Render this deployment's manifests without applying anything:
        the single source of the render context. Injects ``images`` (name
        -> full ref with built tag), ``gpu.*`` (:func:`gpu_context`) and
        ``pullSecrets``, the trio the reference injects as helm values
        (deploy/helm/deploy.go:154-161), with ``gpu`` in place of its
        ``tpu``."""
        return render_chart(
            self.chart_path,
            release_name=self.deployment.name,
            namespace=self.namespace,
            values=self.deployment.chart.values,
            value_files=self.value_files,
            extra_context={
                "images": image_tags or {},
                "gpu": gpu_context(gpu),
                "pullSecrets": pull_secrets or [],
            },
        )
