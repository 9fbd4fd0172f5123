"""Selector resolution: which pods does a dev-session service target?

Reference: pkg/devspace/services/{pod_selector.go, attach.go:76
getSelectorNamespaceLabelSelector} — precedence: explicit selector config >
inline labelSelector > fallback ``app=<first deployment>`` (the reference
falls back to ``release=<first helm deployment>``; our charts stamp
``app: <release>``). The multi-host twist (SURVEY §7/L2): a selector
resolves to the *ordered* worker list of the job, not one pod.

The port's copy of ``devspace_tpu/services/selectors.py``, with one
difference: the number of workers to wait for is the ``gpu`` block's
``workers`` (``config.gpu``), where the reference reads its ``tpu``
block. The backend orders them by :attr:`kube.client.Pod.worker_id`.
"""

from __future__ import annotations

from typing import Optional

from ..config import latest
from ..config.loader import get_default_namespace, get_selector
from ..resilience.policy import RetryPolicy


class SelectorError(Exception):
    pass


def _default_resolve_policy() -> RetryPolicy:
    """Pod resolution races pod churn (a slice restarting mid-resolve shows
    up as a transient connection error); retry those, never config errors."""
    return RetryPolicy(
        max_attempts=3,
        base_delay=0.2,
        max_delay=2.0,
        jitter=0.2,
        seed=0,
        retry_on=(ConnectionError, TimeoutError),
    )


def resolve_selector(
    config: latest.Config,
    selector_name: Optional[str] = None,
    label_selector: Optional[dict[str, str]] = None,
    namespace: Optional[str] = None,
    container: Optional[str] = None,
) -> tuple[str, dict[str, str], Optional[str]]:
    """Returns (namespace, label_selector, container_name)."""
    if selector_name:
        sel = get_selector(config, selector_name)
        if sel is None:
            raise SelectorError(f"unknown selector '{selector_name}'")
        return (
            namespace or sel.namespace or get_default_namespace(config),
            sel.label_selector or {},
            container or sel.container_name,
        )
    if label_selector:
        return (namespace or get_default_namespace(config), label_selector, container)
    # Fallback: first deployment's app label (reference: attach.go:120-124).
    if config.deployments:
        first = config.deployments[0].name
        if first:
            return (
                namespace
                or config.deployments[0].namespace
                or get_default_namespace(config),
                {"app": first},
                container,
            )
    raise SelectorError(
        "cannot resolve target pods: no selector, no labelSelector and no "
        "deployments configured"
    )


def resolve_workers(
    backend,
    config: latest.Config,
    selector_name: Optional[str] = None,
    label_selector: Optional[dict[str, str]] = None,
    namespace: Optional[str] = None,
    container: Optional[str] = None,
    timeout: float = 120.0,
    retry_policy: Optional[RetryPolicy] = None,
) -> tuple[list, str, Optional[str]]:
    """Resolve the ordered worker pods of the job for a service.
    Returns (workers, namespace, container_name). Transient backend errors
    (connection drops, timeouts) are retried under ``retry_policy``;
    configuration errors (:class:`SelectorError`) are not."""
    ns, labels, cont = resolve_selector(
        config, selector_name, label_selector, namespace, container
    )
    expected = config.gpu.workers if config.gpu and config.gpu.workers else None
    policy = retry_policy or _default_resolve_policy()
    workers = policy.execute(
        backend.slice_workers,
        labels,
        namespace=ns,
        expected=expected,
        timeout=timeout,
        describe=f"resolve workers for {labels!r}",
        reraise=True,
    )
    return workers, ns, cont
