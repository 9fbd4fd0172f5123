"""Render-time GPU job invariants as registered rules: the port's
counterpart of ``devspace_tpu/lint/rules_tpu.py``, over ``chart-gpu``.

The reference checks a TPU slice against the config's ``tpu`` block
(``google.com/tpu``, ``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES``, the JAX
coordinator). The port checks a torchrun job against its ``gpu`` block:
one pod per host, ``nvidia.com/gpu`` at ``perWorker`` a pod, ``NODE_RANK``
from the pod index, pod 0 the rendezvous master through the headless
service. The ids stay TPU201-TPU205, rule for rule, in the ``gpu``
category.
"""

from __future__ import annotations

from ..deploy.chart import GPU_RESOURCE, requests_gpu
from ..utils.torchrun import max_nodes, torchrun_flags
from .engine import ERROR, LintContext, rule
from .rules_manifest import WORKLOAD_KINDS, containers_of

POD_INDEX_FIELD = "metadata.labels['apps.kubernetes.io/pod-index']"


def _sizes(gpu) -> tuple[int, int]:
    """``(workers, perWorker)`` of the block, 1 where unset."""
    return (1 if gpu.workers is None else gpu.workers,
            1 if gpu.per_worker is None else gpu.per_worker)


def job_workloads(docs: list) -> list[dict]:
    """Workload docs that ARE the job (``nvidia.com/gpu`` requested or
    ``NODE_RANK`` wired), with the derived facts every GPU rule needs."""
    out = []
    for doc in docs:
        if not isinstance(doc, dict) or doc.get("kind") not in WORKLOAD_KINDS:
            continue
        containers = [c for c in containers_of(doc) if isinstance(c, dict)]
        env = {
            e.get("name"): e
            for c in containers
            for e in c.get("env") or []
            if isinstance(e, dict)
        }
        gpu_containers = [c for c in containers if requests_gpu(c)]
        if not (gpu_containers or "NODE_RANK" in env):
            continue
        # [(container, flags)] of the containers that start torchrun
        torchrun = []
        for c in containers:
            flags = torchrun_flags(c)
            if flags is not None:
                torchrun.append((c, flags))
        name = (doc.get("metadata") or {}).get("name")
        out.append(
            {
                "doc": doc,
                "name": name,
                "label": f"{doc.get('kind')}/{name}",
                "id": (str(doc.get("kind")), str(name)),
                "containers": containers,
                "gpu_containers": gpu_containers,
                "env": env,
                "torchrun": torchrun,
            }
        )
    return out


@rule(
    "TPU201",
    severity=ERROR,
    category="gpu",
    description="workers x perWorker is the job's world size: both must be "
    "positive, and torchrun's --nnodes / --nproc-per-node must match them",
)
def check_world_size(ctx: LintContext):
    gpu = ctx.gpu
    if gpu is None:
        return
    workers, per_worker = _sizes(gpu)
    if workers < 1 or per_worker < 1:
        yield (
            "gpu",
            f"workers {workers} x perWorker {per_worker} is no world: both "
            f"must be positive integers",
        )
        return
    world = workers * per_worker
    for w in job_workloads(ctx.docs):
        label = w["label"]
        for _, flags in w["torchrun"]:
            nnodes = flags.get("nnodes")
            if nnodes is None:
                yield (label, f"torchrun without --nnodes (gpu.workers = {workers})")
            elif max_nodes(nnodes) != workers:
                yield (
                    label,
                    f"torchrun --nnodes={nnodes} but gpu.workers = {workers}",
                )
            nproc = flags.get("nproc-per-node")
            if nproc is None:
                yield (
                    label,
                    f"torchrun without --nproc-per-node (gpu.perWorker = "
                    f"{per_worker})",
                )
            elif nproc != str(per_worker):
                yield (
                    label,
                    f"torchrun --nproc-per-node={nproc} but gpu.perWorker = "
                    f"{per_worker}",
                )
        # a static world size must be the product as well
        size = w["env"].get("WORLD_SIZE", {}).get("value")
        if size is not None and str(size) != str(world):
            yield (
                label,
                f"WORLD_SIZE {size} != workers x perWorker = {world}",
            )


@rule(
    "TPU202",
    severity=ERROR,
    category="gpu",
    description="A config with a gpu block must render at least one job "
    "workload (nvidia.com/gpu resources or NODE_RANK wired)",
)
def check_job_present(ctx: LintContext):
    if ctx.gpu is None:
        return
    if not job_workloads(ctx.docs):
        yield (
            "gpu",
            f"config has a gpu block but no rendered workload requests "
            f"{GPU_RESOURCE} or wires NODE_RANK",
        )


@rule(
    "TPU203",
    severity=ERROR,
    category="gpu",
    description="Job workload replicas must equal gpu.workers, and "
    "multi-worker jobs need StatefulSet identities",
)
def check_job_shape(ctx: LintContext):
    gpu = ctx.gpu
    if gpu is None:
        return
    workers, _ = _sizes(gpu)
    for w in job_workloads(ctx.docs):
        label = w["label"]
        replicas = (w["doc"].get("spec") or {}).get("replicas")
        if replicas is not None:
            try:
                replicas_n = int(replicas)
            except (TypeError, ValueError):
                yield (label, f"replicas is not an integer ({replicas!r})")
                replicas_n = None
            if replicas_n is not None and replicas_n != workers:
                yield (
                    label,
                    f"replicas {replicas} != gpu.workers {workers} "
                    f"(job atomicity: every worker pod must exist)",
                )
        if w["doc"].get("kind") != "StatefulSet" and workers > 1:
            yield (
                label,
                f"multi-worker jobs need stable identities — use a "
                f"StatefulSet (got {w['doc'].get('kind')})",
            )


def _int_or_none(value):
    try:
        return int(str(value))
    except ValueError:
        return None


@rule(
    "TPU204",
    severity=ERROR,
    category="gpu",
    description="Job workloads need nvidia.com/gpu requests and limits of "
    "gpu.perWorker, NODE_RANK from the pod index, and pod 0 as torchrun's "
    "master through the headless service",
)
def check_job_wiring(ctx: LintContext):
    gpu = ctx.gpu
    if gpu is None:
        return
    workers, per_worker = _sizes(gpu)
    for w in job_workloads(ctx.docs):
        label = w["label"]
        if not w["gpu_containers"]:
            yield (
                label,
                f"NODE_RANK wired but no container requests {GPU_RESOURCE} "
                f"resources",
            )
        for c in w["gpu_containers"]:
            res = c.get("resources") or {}
            for kind in ("requests", "limits"):
                got = (res.get(kind) or {}).get(GPU_RESOURCE)
                if _int_or_none(got) != per_worker:
                    yield (
                        label,
                        f"container {c.get('name')}: {GPU_RESOURCE} {kind} "
                        f"{got} != gpu.perWorker {per_worker}",
                    )
        rank = w["env"].get("NODE_RANK")
        if rank is None:
            yield (label, "missing NODE_RANK env")
        elif (
            ((rank.get("valueFrom") or {}).get("fieldRef") or {}).get("fieldPath")
            != POD_INDEX_FIELD
        ):
            yield (
                label,
                f"NODE_RANK must come from the pod index (fieldRef "
                f"{POD_INDEX_FIELD})",
            )
        if workers > 1 and not w["torchrun"]:
            yield (label, "multi-worker job without torchrun to wire its ranks")
        service = (w["doc"].get("spec") or {}).get("serviceName")
        master = f"{w['name']}-0.{service}"
        for _, flags in w["torchrun"]:
            addr = flags.get("master-addr")
            if addr is None:
                if workers > 1:
                    yield (label, "multi-worker job without torchrun --master-addr")
            elif not service or not (addr == master or addr.startswith(master + ".")):
                yield (
                    label,
                    f"torchrun --master-addr={addr} must name pod 0 through "
                    f"the headless service ({master})",
                )
            if workers > 1 and flags.get("node-rank") != "$(NODE_RANK)":
                yield (
                    label,
                    f"torchrun --node-rank={flags.get('node-rank')} must be "
                    f"$(NODE_RANK) (every worker its pod index)",
                )


@rule(
    "TPU205",
    severity=ERROR,
    category="gpu",
    description="HPAs must never target a multi-worker GPU job (worker "
    "count is its torchrun world, not load)",
)
def check_hpa_job_conflict(ctx: LintContext):
    # Job atomicity vs autoscaling: a MULTI-worker job's worker count is
    # its torchrun world (--nnodes: every rank must exist), so an HPA must
    # never resize it. One-worker workloads may scale: each replica is an
    # independent server on its own host (the serving story).
    gpu = ctx.gpu
    if gpu is None:
        return
    workers, _ = _sizes(gpu)
    if workers <= 1:
        return
    job_ids = {w["id"] for w in job_workloads(ctx.docs)}
    for doc in ctx.docs:
        if (
            not isinstance(doc, dict)
            or doc.get("kind") != "HorizontalPodAutoscaler"
        ):
            continue
        ref = ((doc.get("spec") or {}).get("scaleTargetRef")) or {}
        if (str(ref.get("kind")), str(ref.get("name"))) in job_ids:
            yield (
                f"HorizontalPodAutoscaler/"
                f"{(doc.get('metadata') or {}).get('name')}",
                f"targets multi-worker GPU job {ref.get('kind')}/"
                f"{ref.get('name')} ({workers} workers) — its worker count "
                f"is its torchrun world, not load; HPAs fit one-worker "
                f"serving replicas only",
            )
