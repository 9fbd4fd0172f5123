"""Resilience primitives: retry with backoff, circuit breaking, idle
backoff and the service supervisor.

The port's copy of ``devspace_tpu/resilience/``'s policy and supervisor
modules; the reference's chaos hooks into its dev-loop streams are not
ported (the port has none of those streams).
"""

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
