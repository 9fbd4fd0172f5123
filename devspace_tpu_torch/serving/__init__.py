"""Serving tier: replica fleet, autoscaler, loadgen, prefix-aware routing.

The port's server (``devspace_tpu_torch/serve.py``) proves the engine;
this package runs several of them: a replica fleet manager restarting
and draining server processes under the supervisor (:mod:`.fleet`), a
closed-loop autoscaler driving replica count from collector HPA signals
(:mod:`.autoscale`), an open-loop traffic generator with per-request
outcome accounting (:mod:`.loadgen`), a deterministic stub replica that
makes all of it testable in milliseconds (:mod:`.stub`), and a
prefix-cache-aware routing gateway fronting the fleet (:mod:`.router` +
:mod:`.gateway`).

The port's copy of ``devspace_tpu/serving/__init__.py``; it imports
nothing of the JAX package.
"""

from .autoscale import (  # noqa: F401
    AutoscaleDecision,
    Autoscaler,
    AutoscalerConfig,
)
from .fleet import (  # noqa: F401
    FLEET_METRIC_FAMILIES,
    PROBE_ALIVE,
    PROBE_DEAD,
    PROBE_READY,
    Replica,
    ReplicaFleet,
    ReplicaSpec,
    free_port,
    spawn_replica,
)
from .gateway import RoutingGateway  # noqa: F401
from .loadgen import (  # noqa: F401
    LoadGenerator,
    LoadReport,
    RequestOutcome,
    TraceSpec,
    generate_trace,
)
from .router import (  # noqa: F401
    ROUTE_POLICIES,
    SERVING_ROUTER_METRIC_FAMILIES,
    PrefixRouter,
    ReplicaLoad,
    RouterConfig,
    RoutingDecision,
    ShadowRadixIndex,
    loads_from_collector,
)
