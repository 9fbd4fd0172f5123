"""Structural rules every rendered Kubernetes object must pass.

The port's copy of ``devspace_tpu/lint/rules_manifest.py`` (DS101-106,
DS150), messages byte-identical, so a chart rendered for the card lints
the same under either package. Reference parity: helm lint renders with
default values and schema-checks the objects.
"""

from __future__ import annotations

import re

from .engine import ERROR, WARNING, LintContext, rule

# DNS-1123 SUBDOMAIN (dots allowed): most resource names accept it, and
# CRDs ('certificates.cert-manager.io') require it — a label-only regex
# would false-positive on valid charts
_DNS1123 = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)
WORKLOAD_KINDS = {
    "Deployment",
    "StatefulSet",
    "DaemonSet",
    "Job",
    "ReplicaSet",
}
# k8s resource.Quantity for storage requests (decimal/binary SI suffixes)
_QUANTITY = re.compile(r"^[0-9]+(\.[0-9]+)?(m|k|Ki|M|Mi|G|Gi|T|Ti|P|Pi|E|Ei)?$")
_ACCESS_MODES = {
    "ReadWriteOnce",
    "ReadOnlyMany",
    "ReadWriteMany",
    "ReadWriteOncePod",
}


def containers_of(doc: dict) -> list[dict]:
    spec = doc.get("spec") or {}
    if doc.get("kind") == "Pod":
        return (spec.get("containers") or []) + (spec.get("initContainers") or [])
    tmpl = (spec.get("template") or {}).get("spec") or {}
    return (tmpl.get("containers") or []) + (tmpl.get("initContainers") or [])


def pod_spec_of(doc: dict) -> dict:
    spec = doc.get("spec") or {}
    if doc.get("kind") == "Pod":
        return spec
    return (spec.get("template") or {}).get("spec") or {}


def _label(doc: dict, i: int) -> str:
    kind = doc.get("kind")
    name = (doc.get("metadata") or {}).get("name")
    return f"{kind or '?'}/{name or f'#{i}'}"


def _mappings(ctx: LintContext):
    """(index, doc, label) for every well-typed document."""
    for i, doc in enumerate(ctx.docs):
        if isinstance(doc, dict) and doc:
            yield i, doc, _label(doc, i)


@rule(
    "DS101",
    severity=ERROR,
    category="manifest",
    description="Objects need apiVersion/kind, a DNS-1123 metadata.name, "
    "and a unique kind+name+namespace",
)
def check_object_structure(ctx: LintContext):
    seen: set[tuple[str, str, str]] = set()
    for i, doc in enumerate(ctx.docs):
        if not isinstance(doc, dict) or not doc:
            yield f"document #{i}: not a mapping ({type(doc).__name__})"
            continue
        kind = doc.get("kind")
        meta = doc.get("metadata") or {}
        name = meta.get("name")
        label = _label(doc, i)
        if not doc.get("apiVersion"):
            yield (label, "missing apiVersion")
        if not kind:
            yield (label, "missing kind")
        if not name:
            yield (label, "missing metadata.name")
        elif not _DNS1123.match(str(name)) or len(str(name)) > 253:
            yield (label, f"metadata.name not DNS-1123 ({name!r})")
        if kind and name:
            key = (str(kind), str(name), str(meta.get("namespace") or ""))
            if key in seen:
                yield (label, "duplicate object (kind+name+namespace)")
            seen.add(key)


@rule(
    "DS102",
    severity=ERROR,
    category="manifest",
    description="Every container needs a name and an image",
)
def check_containers(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        for c in containers_of(doc):
            cname = c.get("name") or "?"
            if not c.get("name"):
                yield (label, "container without a name")
            if not c.get("image"):
                yield (label, f"container {cname} has no image")


@rule(
    "DS103",
    severity=ERROR,
    category="manifest",
    description="Workload selector.matchLabels must be matched by the pod "
    "template labels",
)
def check_selector_wiring(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        kind = doc.get("kind")
        if kind not in WORKLOAD_KINDS or kind == "DaemonSet":
            continue
        sel = ((doc.get("spec") or {}).get("selector") or {}).get(
            "matchLabels"
        ) or {}
        tmpl_labels = (
            ((doc.get("spec") or {}).get("template") or {}).get("metadata")
            or {}
        ).get("labels") or {}
        if sel and any(tmpl_labels.get(k) != v for k, v in sel.items()):
            yield (
                label,
                f"selector.matchLabels not matched by template labels "
                f"({sel} vs {tmpl_labels})",
            )


def _lint_claim_spec(label: str, spec: dict):
    """Shared PVC-spec checks for standalone claims and StatefulSet
    volumeClaimTemplates."""
    storage = (
        ((spec.get("resources") or {}).get("requests") or {}).get("storage")
    )
    if not storage:
        yield (label, "no resources.requests.storage")
    elif not _QUANTITY.match(str(storage)):
        yield (
            label,
            f"storage {storage!r} is not a k8s quantity (e.g. 5Gi, 500Mi)",
        )
    for mode in spec.get("accessModes") or []:
        if mode not in _ACCESS_MODES:
            yield (label, f"unknown accessMode {mode!r}")
    sc = spec.get("storageClassName")
    if sc is not None and (not isinstance(sc, str) or not sc):
        yield (label, "storageClassName must be a non-empty string")


@rule(
    "DS104",
    severity=ERROR,
    category="manifest",
    description="PVC specs and volumeClaimTemplates must be well-formed; "
    "volumeMounts must reference declared volumes",
)
def check_persistence(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        kind = doc.get("kind")
        if kind == "PersistentVolumeClaim":
            yield from _lint_claim_spec(label, doc.get("spec") or {})
        if kind not in WORKLOAD_KINDS and kind != "Pod":
            continue
        pod = pod_spec_of(doc)
        declared = {
            v.get("name")
            for v in pod.get("volumes") or []
            if isinstance(v, dict)
        }
        for tmpl in (doc.get("spec") or {}).get("volumeClaimTemplates") or []:
            tname = (tmpl.get("metadata") or {}).get("name")
            tlabel = f"{label}: volumeClaimTemplates[{tname or '?'}]"
            if not tname:
                yield (tlabel, "missing metadata.name")
            elif not _DNS1123.match(str(tname)):
                yield (tlabel, "name not DNS-1123")
            else:
                declared.add(tname)
            yield from _lint_claim_spec(tlabel, tmpl.get("spec") or {})
        for c in containers_of(doc):
            for m in c.get("volumeMounts") or []:
                mname = m.get("name") if isinstance(m, dict) else None
                if not mname or not m.get("mountPath"):
                    yield (
                        label,
                        f"container {c.get('name', '?')} has a volumeMount "
                        f"without name+mountPath ({m!r})",
                    )
                elif mname not in declared:
                    yield (
                        label,
                        f"container {c.get('name', '?')} mounts undeclared "
                        f"volume {mname!r} (pod volumes/claimTemplates: "
                        f"{sorted(declared) or 'none'})",
                    )


@rule(
    "DS105",
    severity=ERROR,
    category="manifest",
    description="HPAs need a resolvable scaleTargetRef, sane min/max "
    "replicas, and (autoscaling/v2) a metrics list",
)
def check_hpa_structure(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        if doc.get("kind") != "HorizontalPodAutoscaler":
            continue
        spec = doc.get("spec") or {}
        ref = spec.get("scaleTargetRef") or {}
        if not ref.get("kind") or not ref.get("name"):
            yield (label, f"scaleTargetRef needs kind+name ({ref!r})")
        else:
            resolved = any(
                isinstance(d, dict)
                and d.get("kind") == ref["kind"]
                and (d.get("metadata") or {}).get("name") == ref["name"]
                for d in ctx.docs
            )
            if not resolved:
                yield (
                    label,
                    f"scaleTargetRef {ref['kind']}/{ref['name']} is not "
                    f"among the rendered objects",
                )
        max_r = spec.get("maxReplicas")
        min_r = spec.get("minReplicas", 1)
        if not isinstance(max_r, int) or max_r < 1:
            yield (label, f"maxReplicas must be a positive integer ({max_r!r})")
        elif isinstance(min_r, int) and min_r > max_r:
            yield (label, f"minReplicas {min_r} > maxReplicas {max_r}")
        if not isinstance(min_r, int):
            yield (label, f"minReplicas must be an integer ({min_r!r})")
        elif min_r < 1:
            yield (label, f"minReplicas must be >= 1 ({min_r})")
        # v2-only: autoscaling/v1 scales via
        # spec.targetCPUUtilizationPercentage and has no metrics list
        # (vendored upstream charts legitimately render v1 objects)
        if str(doc.get("apiVersion")).startswith("autoscaling/v2") and not spec.get(
            "metrics"
        ):
            yield (label, "no metrics — the HPA could never scale")


@rule(
    "DS106",
    severity=ERROR,
    category="manifest",
    description="StatefulSets need a serviceName backed by a headless "
    "Service among the rendered objects",
)
def check_statefulset_service(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        if doc.get("kind") != "StatefulSet":
            continue
        svc = (doc.get("spec") or {}).get("serviceName")
        if not svc:
            yield (label, "StatefulSet without serviceName")
            continue
        has_headless = any(
            isinstance(d, dict)
            and d.get("kind") == "Service"
            and (d.get("metadata") or {}).get("name") == svc
            and (d.get("spec") or {}).get("clusterIP") in (None, "None")
            for d in ctx.docs
        )
        if not has_headless:
            yield (
                label,
                f"serviceName '{svc}' has no (headless) Service in the "
                f"rendered objects",
            )


@rule(
    "DS150",
    severity=WARNING,
    category="hygiene",
    description="Container images should be pinned to a tag or digest "
    "(floating :latest redeploys are not reproducible)",
)
def check_image_pinned(ctx: LintContext):
    for _, doc, label in _mappings(ctx):
        for c in containers_of(doc):
            image = c.get("image")
            if not isinstance(image, str) or not image:
                continue  # DS102's problem
            if "@" in image:
                continue  # digest-pinned
            # tag = text after the last ':' that is not part of a
            # registry:port prefix (a '/' after it means it's a port)
            tag = ""
            if ":" in image.rsplit("/", 1)[-1]:
                tag = image.rsplit(":", 1)[1]
            if not tag or tag == "latest":
                yield (
                    label,
                    f"container {c.get('name', '?')} image {image!r} is "
                    f"not pinned to a tag (floating tags make rollbacks "
                    f"and slice restarts non-reproducible)",
                )
