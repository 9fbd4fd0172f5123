"""Resilience primitives: retry with backoff, circuit breaking, idle
backoff, the service supervisor and deterministic fault injection.

The port's copy of ``devspace_tpu/resilience/``: ``policy``,
``supervisor`` and ``chaos`` (``ChaosConfig``, the failure dial that the
fake cluster, ``kube/fake.py``, consults before each operation).
"""

from .chaos import ChaosConfig, ChaosError
from .policy import (
    CircuitBreaker,
    CircuitOpenError,
    IdleBackoff,
    RetryExhausted,
    RetryPolicy,
)
from .supervisor import (
    RESTART_ALWAYS,
    RESTART_NEVER,
    RESTART_ON_FAILURE,
    ServiceState,
    SessionSupervisor,
    SupervisorEvent,
    format_ready_timeout,
)

__all__ = [
    "ChaosConfig",
    "ChaosError",
    "CircuitBreaker",
    "CircuitOpenError",
    "IdleBackoff",
    "RetryExhausted",
    "RetryPolicy",
    "RESTART_ALWAYS",
    "RESTART_NEVER",
    "RESTART_ON_FAILURE",
    "ServiceState",
    "SessionSupervisor",
    "SupervisorEvent",
    "format_ready_timeout",
]
