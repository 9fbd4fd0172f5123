"""Prefix-aware routing core: cache-locality scheduling for the fleet.

The fleet keeps N replicas alive; traffic still reaches them
by naive assignment, so a chat session's growing shared prefix
recomputes prefill on whichever replica each turn lands on instead of
hitting the radix cache that already holds the chain. This
module is the decision core that fixes that — pure logic, injected
clock and load signals, golden-testable sample by sample. The HTTP
frontend that wires it to live sockets is :mod:`.gateway`.

Three cooperating mechanisms:

**Shadow radix index** (:class:`ShadowRadixIndex`). The router cannot
see replica radix trees, so it keeps a shadow: every routed request's
token prefix is fingerprinted into a blake2b block-digest chain
(:func:`devspace_tpu_torch.inference.prefix_cache.fingerprint_chain` — the
same hashing the real cache uses) and recorded against the chosen
replica. A later request's expected cached-token overlap on a replica
is ``block_size`` times the longest *leading* run of its chain already
recorded there (a chain is only matchable through its full ancestor
line, exactly the radix tree's rule). The index is an LRU over digests,
bounded by ``max_shadow_blocks`` per replica — stale entries age out
the same way the real cache evicts.

**Blended scoring with spillover.** For policy ``prefix``::

    score(r) = w_prefix * overlap_tokens(r) / prompt_tokens
             - w_load   * load(r)
             - w_fair   * fairness_penalty(tenant, r)

    load(r)  = occupancy(r) + queued(r) / max_slots(r) + w_slo * slo_pressure(r)

Occupancy/queue come from the fleet collector's per-replica snapshots
(:func:`loads_from_collector`), blended with the router's own in-flight
counts (scrapes are stale between rounds; the router's view is live).
``slo_pressure`` maps a replica's own TTFT-burn SLO status (ok/warn/
breach) to 0/1/2. The blend is what produces spillover: a saturated
replica's load term outweighs its prefix term, so the request lands on
the next-best prefix holder instead of deepening the hot queue — when
that happens the decision is flagged ``spilled`` and counted.

**Fairness counters.** Per replica, a sliding window of the last
``fairness_window`` routed tenants. A tenant already holding more than
its fair share (``1 / distinct active tenants``) of a replica's recent
assignments pays ``share - fair_share`` as a penalty there, steering it
toward replicas it is not already dominating. Untagged traffic (one
anonymous tenant) pays zero by construction.

**SLO-aware admission.** Instead of FIFO-until-timeout, the router
projects TTFT on the chosen replica::

    projected_ttft(r) = (queued(r) + active(r)) / max_slots(r) * service_s(r)

with ``service_s`` an EWMA of observed request service times (seeded by
``default_service_s``). The projection is compared to the TTFT
objective through the SLO burn-rate bands: ``projected / target_ttft``
below ``warn_burn`` admits, between ``warn_burn`` and ``breach_burn``
queues (the gateway re-polls until capacity or ``queue_timeout_s``),
at/above ``breach_burn`` rejects immediately — shedding the load an
FIFO queue would silently convert into timeout pain.

**Two-phase placement** (disaggregated prefill/decode). With
``disagg_threshold_tokens > 0``, a request whose uncached prompt span
reaches the threshold — or whose decode target sits at/above
``disagg_occupancy_band`` occupancy — gets a second verdict field:
``prefill_replica``, the least-prefill-loaded candidate (preferring the
dedicated ``prefill_pool``, whose members never take decode streams
while anything else is routable). The gateway prefills there first,
then sends the decode request with ``kv_source`` so the decode replica
pulls the KV chain (:mod:`devspace_tpu_torch.inference.kv_tier` wire format)
instead of recomputing a long prefill in its decode batch. Phase-1
failures degrade to unified placement — the decode replica simply
prefills locally.

Policies: ``prefix`` (the full blend), ``least_loaded`` (load term
only), ``round_robin`` (cycle — the A/B baseline). All three share
admission and bookkeeping, so the bench compares routing policy alone.

The port's copy of ``devspace_tpu/serving/router.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..inference.prefix_cache import fingerprint_chain
from ..obs import events as obs_events
from ..obs.metrics import Registry

ROUTE_POLICIES = ("prefix", "round_robin", "least_loaded")

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"

# Lint catalog (OBS7xx): every family the routing gateway exposes.
# Counters/histograms merge by sum across gateways; the point-in-time
# gauges also sum (each gateway owns disjoint in-flight/shadow state).
SERVING_ROUTER_METRIC_FAMILIES = (
    ("serving_router_requests_total", "counter",
     "Requests routed to a replica (admitted, by any policy)", "sum"),
    ("serving_router_rejected_total", "counter",
     "Requests shed by SLO-aware admission (projected TTFT past the "
     "breach band)", "sum"),
    ("serving_router_queued_total", "counter",
     "Requests held in the admission queue before routing", "sum"),
    ("serving_router_spillovers_total", "counter",
     "Requests steered off their best prefix holder because it was hot",
     "sum"),
    ("serving_router_retries_total", "counter",
     "Requests rerouted after their replica failed before first byte",
     "sum"),
    ("serving_router_upstream_failures_total", "counter",
     "Streams aborted after bytes were already forwarded (client must "
     "retry)", "sum"),
    ("serving_router_expected_hit_tokens_total", "counter",
     "Prompt tokens the shadow index predicted cached on the chosen "
     "replica", "sum"),
    ("serving_router_prompt_tokens_total", "counter",
     "Prompt tokens across all routed requests", "sum"),
    ("serving_router_decision_seconds", "histogram",
     "Time to score replicas and pick a route", "sum"),
    ("serving_router_queue_wait_seconds", "histogram",
     "Admission-queue wait before a queued request was routed", "sum"),
    ("serving_router_inflight_requests", "gauge",
     "Requests currently proxied through this gateway", "sum"),
    ("serving_router_shadow_blocks", "gauge",
     "Block digests tracked across all replica shadow indexes", "sum"),
    ("serving_router_prefill_dispatches_total", "counter",
     "Requests placed two-phase: prefill on one replica, decode on "
     "another", "sum"),
    ("serving_router_prefill_tokens_total", "counter",
     "Uncached prompt tokens sent to a separate prefill replica", "sum"),
    ("serving_router_prefill_failures_total", "counter",
     "Phase-1 prefill calls that failed (request degraded to unified "
     "placement)", "sum"),
    ("serving_router_prefill_inflight_tokens", "gauge",
     "Prompt tokens currently prefilling on behalf of other replicas",
     "sum"),
)


@dataclass
class ReplicaLoad:
    """One replica's live pressure signals, as the router consumes them.
    ``loads_from_collector`` builds these from scraped snapshots; golden
    tests inject them directly."""

    occupancy: float = 0.0     # active slots / max slots (0..1+)
    queued: float = 0.0        # requests waiting for a slot
    max_slots: float = 1.0     # admission concurrency
    active: float = 0.0        # in-flight requests on the replica
    slo_pressure: float = 0.0  # 0 ok / 1 warn / 2 breach (TTFT burn)


def loads_from_collector(collector) -> dict:
    """{replica name: ReplicaLoad} from the fleet collector's per-target
    snapshots. A target that is down, quarantined, or not yet scraped
    contributes nothing — the router treats missing loads as idle and
    its own in-flight counts keep the view honest between scrapes."""
    out = {}
    for t in collector.targets:
        snap = t.snapshot
        if snap is None or t.quarantined or not t.up:
            continue

        def tval(name, default=0.0):
            fam = snap.get(name)
            if not fam or not fam["samples"]:
                return default
            v = fam["samples"][0][1]
            return float(v) if not isinstance(v, dict) else default

        pressure = 0.0
        if t.health and isinstance(t.health.get("slo"), dict):
            status = t.health["slo"].get("status")
            pressure = {"warn": 1.0, "breach": 2.0}.get(status, 0.0)
        out[t.name] = ReplicaLoad(
            occupancy=tval("engine_dispatch_depth_occupancy"),
            queued=tval("engine_queued_requests"),
            max_slots=max(1.0, tval("engine_max_slots", 1.0)),
            active=tval("engine_active_slots"),
            slo_pressure=pressure,
        )
    return out


class ShadowRadixIndex:
    """Per-replica shadow of recently-routed digest chains.

    ``observe(replica, chain)`` records (LRU-touches) every digest of a
    routed chain; ``overlap(replica, chain)`` returns how many LEADING
    digests are present — the radix rule: block K is only a cache hit if
    blocks 0..K-1 are too. Bounded to ``max_blocks`` digests per replica
    with least-recently-touched eviction. Not thread-safe on its own;
    the router serializes access under its lock."""

    def __init__(self, max_blocks: int = 4096):
        if max_blocks < 1:
            raise ValueError("max_blocks must be >= 1")
        self.max_blocks = max_blocks
        self._by_replica: dict = {}  # name -> OrderedDict[digest, None]

    def observe(self, replica: str, chain: list) -> None:
        index = self._by_replica.setdefault(replica, OrderedDict())
        for digest in chain:
            if digest in index:
                index.move_to_end(digest)
            else:
                index[digest] = None
        while len(index) > self.max_blocks:
            index.popitem(last=False)

    def overlap(self, replica: str, chain: list) -> int:
        """Leading digests of ``chain`` present for ``replica``.
        Touches the matched run (a routed hit keeps the chain warm)."""
        index = self._by_replica.get(replica)
        if not index:
            return 0
        n = 0
        for digest in chain:
            if digest not in index:
                break
            index.move_to_end(digest)
            n += 1
        return n

    def drop_replica(self, replica: str) -> None:
        self._by_replica.pop(replica, None)

    def replicas(self) -> list:
        return sorted(self._by_replica)

    def total_blocks(self) -> int:
        return sum(len(ix) for ix in self._by_replica.values())

    def blocks(self, replica: str) -> int:
        return len(self._by_replica.get(replica) or ())


@dataclass
class RouterConfig:
    """Scoring and admission knobs. Defaults are hand-computable and
    pinned by the golden decision tables in tests/test_serving_router.py."""

    policy: str = "prefix"
    block_size: int = 8            # fingerprint granularity (tokens)
    max_shadow_blocks: int = 4096  # digest LRU bound per replica
    w_prefix: float = 1.0
    w_load: float = 0.6
    w_fair: float = 0.4
    w_slo: float = 0.5             # slo_pressure weight inside load()
    fairness_window: int = 64      # recent assignments kept per replica
    # SLO-aware admission: projected-TTFT burn vs the SLO bands
    # (SLOSpec defaults: warn_burn=1.0, breach_burn=6.0).
    admission: bool = True
    target_ttft_s: float = 1.0
    warn_burn: float = 1.0
    breach_burn: float = 6.0
    queue_timeout_s: float = 5.0
    default_service_s: float = 0.2
    service_ewma: float = 0.2      # weight of the newest observation
    # Disaggregated prefill/decode (two-phase placement). 0 disables.
    # A request whose UNCACHED prompt span reaches the threshold — or
    # whose decode target's occupancy is at/above the band — prefills on
    # the least-prefill-loaded replica first; the decode target then
    # pulls the KV chain (engine ``kv_source``). ``prefill_pool`` names
    # replicas reserved for prefill: they are excluded from decode
    # candidacy while any other replica is routable.
    disagg_threshold_tokens: int = 0
    disagg_occupancy_band: float = 0.85
    prefill_pool: tuple = ()

    def validate(self) -> None:
        if self.policy not in ROUTE_POLICIES:
            raise ValueError(
                f"policy must be one of {ROUTE_POLICIES}, not "
                f"{self.policy!r}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.breach_burn < self.warn_burn:
            raise ValueError("breach_burn must be >= warn_burn")
        if self.target_ttft_s <= 0:
            raise ValueError("target_ttft_s must be > 0")
        if self.disagg_threshold_tokens < 0:
            raise ValueError("disagg_threshold_tokens must be >= 0")
        if not 0.0 < self.disagg_occupancy_band:
            raise ValueError("disagg_occupancy_band must be > 0")


@dataclass
class RoutingDecision:
    """One routing verdict. ``admission`` is ADMIT/QUEUE/REJECT; the
    replica is only set when admitted (QUEUE resolves to a later ADMIT
    or REJECT through the gateway's re-poll loop)."""

    admission: str
    replica: Optional[str] = None
    overlap_tokens: int = 0
    prompt_tokens: int = 0
    spilled: bool = False
    projected_ttft_s: float = 0.0
    scores: dict = field(default_factory=dict)  # name -> blended score
    reason: str = ""
    # Two-phase placement: when set, the gateway prefills there first
    # and the decode replica pulls the KV chain (``kv_source``).
    prefill_replica: Optional[str] = None


class PrefixRouter:
    """The routing decision core. Thread-safe; the gateway calls
    :meth:`route` per request and :meth:`complete` per terminal outcome.

    ``replicas_fn`` returns the current routable {name: base_url} view
    (``fleet.targets`` or a static dict); ``loads_fn`` the latest
    {name: ReplicaLoad} (``lambda: loads_from_collector(c)``). Both are
    re-read per decision, so scale events and scrape rounds take effect
    immediately."""

    def __init__(
        self,
        replicas_fn: Callable[[], dict],
        loads_fn: Optional[Callable[[], dict]] = None,
        config: Optional[RouterConfig] = None,
        registry: Optional[Registry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or RouterConfig()
        self.config.validate()
        self.replicas_fn = replicas_fn
        self.loads_fn = loads_fn or (lambda: {})
        self._clock = clock
        self._lock = threading.Lock()
        self.shadow = ShadowRadixIndex(self.config.max_shadow_blocks)
        self._rr_next = 0
        self._inflight: dict = {}       # name -> int
        self._service_s: dict = {}      # name -> EWMA seconds
        self._fair: dict = {}           # name -> deque[tenant]
        self._prefill_tokens: dict = {}  # name -> in-flight prefill toks
        self._decisions = deque(maxlen=128)  # recent dicts for /debug

        self.registry = registry or Registry()
        reg = self.registry
        fams = {f[0]: f for f in SERVING_ROUTER_METRIC_FAMILIES}

        def counter(name):
            return reg.counter(name, fams[name][2])

        self.m_requests = counter("serving_router_requests_total")
        self.m_rejected = counter("serving_router_rejected_total")
        self.m_queued = counter("serving_router_queued_total")
        self.m_spillovers = counter("serving_router_spillovers_total")
        self.m_retries = counter("serving_router_retries_total")
        self.m_upstream_failures = counter(
            "serving_router_upstream_failures_total")
        self.m_hit_tokens = counter(
            "serving_router_expected_hit_tokens_total")
        self.m_prompt_tokens = counter("serving_router_prompt_tokens_total")
        self.m_prefill_dispatches = counter(
            "serving_router_prefill_dispatches_total")
        self.m_prefill_tokens = counter(
            "serving_router_prefill_tokens_total")
        self.m_prefill_failures = counter(
            "serving_router_prefill_failures_total")
        self.h_decision = reg.histogram(
            "serving_router_decision_seconds",
            fams["serving_router_decision_seconds"][2])
        self.h_queue_wait = reg.histogram(
            "serving_router_queue_wait_seconds",
            fams["serving_router_queue_wait_seconds"][2])
        reg.register_callback(
            "serving_router_inflight_requests", "gauge",
            fams["serving_router_inflight_requests"][2],
            lambda: sum(self._inflight.values()))
        reg.register_callback(
            "serving_router_shadow_blocks", "gauge",
            fams["serving_router_shadow_blocks"][2],
            self.shadow.total_blocks)
        reg.register_callback(
            "serving_router_prefill_inflight_tokens", "gauge",
            fams["serving_router_prefill_inflight_tokens"][2],
            lambda: sum(self._prefill_tokens.values()))

    # -- load view -----------------------------------------------------------
    def _effective_load(self, name: str, loads: dict) -> tuple:
        """(load score, queued, active, max_slots) blending the scraped
        signals with the router's own live in-flight count — whichever
        view sees more pressure wins (scrapes lag; the router's count
        misses other traffic sources)."""
        cfg = self.config
        sig = loads.get(name) or ReplicaLoad()
        mine = float(self._inflight.get(name, 0))
        slots = max(1.0, sig.max_slots)
        active = max(sig.active, min(mine, slots))
        queued = max(sig.queued, mine - slots if mine > slots else 0.0)
        occupancy = max(sig.occupancy, active / slots)
        load = occupancy + queued / slots + cfg.w_slo * sig.slo_pressure
        return load, queued, active, slots

    def _projected_ttft(self, name: str, loads: dict) -> float:
        _load, queued, active, slots = self._effective_load(name, loads)
        service = self._service_s.get(name, self.config.default_service_s)
        return (queued + active) / slots * service

    def _fairness_penalty(self, tenant: str, name: str) -> float:
        window = self._fair.get(name)
        if not window:
            return 0.0
        tenants = {tenant}
        for w in self._fair.values():
            tenants.update(w)
        fair_share = 1.0 / max(1, len(tenants))
        share = sum(1 for t in window if t == tenant) / len(window)
        return max(0.0, share - fair_share)

    # -- decision ------------------------------------------------------------
    def route(self, prompt_ids, tenant: str = "", stamp: bool = True,
              requeue: bool = False,
              exclude: frozenset = frozenset()) -> RoutingDecision:
        """Score the routable replicas and pick one (or queue/reject).
        ``stamp=False`` evaluates without mutating any state.
        ``requeue=True`` marks an admission re-poll of an
        already-counted queued request, so the queue counter and event
        fire exactly once per request. ``exclude`` removes replicas from
        candidacy (the gateway's reroute path excludes every replica the
        request already failed on)."""
        t0 = self._clock()
        cfg = self.config
        routable = sorted(
            n for n in self.replicas_fn() if n not in exclude)
        if not routable:
            return RoutingDecision(
                admission=REJECT, reason="no routable replicas")
        # Dedicated prefill-pool replicas never take decode streams while
        # any other replica is routable (they would pin long prefills
        # behind decodes); the pool degrades to full candidacy when it is
        # all that's left.
        replicas = [n for n in routable if n not in cfg.prefill_pool] \
            or routable
        chain = fingerprint_chain(prompt_ids, cfg.block_size) \
            if cfg.policy == "prefix" else []
        loads = self.loads_fn() or {}
        with self._lock:
            decision = self._route_locked(
                replicas, routable, chain, len(prompt_ids), tenant,
                loads, stamp)
        if stamp:
            self.h_decision.observe(max(0.0, self._clock() - t0))
            if decision.admission == ADMIT:
                self.m_requests.inc()
                self.m_prompt_tokens.inc(decision.prompt_tokens)
                self.m_hit_tokens.inc(decision.overlap_tokens)
                if decision.spilled:
                    self.m_spillovers.inc()
                    obs_events.emit(
                        "router", "spillover", level="info",
                        replica=decision.replica,
                        overlap_tokens=decision.overlap_tokens,
                        reason=decision.reason,
                    )
                if decision.prefill_replica:
                    self.m_prefill_dispatches.inc()
                    self.m_prefill_tokens.inc(max(
                        0, decision.prompt_tokens
                        - decision.overlap_tokens))
                    obs_events.emit(
                        "router", "prefill_dispatched", level="info",
                        replica=decision.replica,
                        prefill_replica=decision.prefill_replica,
                        prompt_tokens=decision.prompt_tokens,
                        overlap_tokens=decision.overlap_tokens,
                    )
                obs_events.emit(
                    "router", "request_routed", level="debug",
                    replica=decision.replica, policy=cfg.policy,
                    tenant=tenant,
                    overlap_tokens=decision.overlap_tokens,
                    prompt_tokens=decision.prompt_tokens,
                    projected_ttft_s=round(decision.projected_ttft_s, 4),
                )
            elif decision.admission == REJECT:
                self.m_rejected.inc()
                obs_events.emit(
                    "router", "request_rejected", level="warn",
                    tenant=tenant, reason=decision.reason,
                    projected_ttft_s=round(decision.projected_ttft_s, 4),
                )
            elif decision.admission == QUEUE and not requeue:
                self.m_queued.inc()
        return decision

    def _route_locked(self, replicas, routable, chain, prompt_tokens,
                      tenant, loads, stamp) -> RoutingDecision:
        cfg = self.config
        overlaps = {}
        scores = {}
        for name in replicas:
            load, _q, _a, _s = self._effective_load(name, loads)
            if cfg.policy == "prefix":
                overlap = self.shadow.overlap(name, chain) * cfg.block_size
                overlap = min(overlap, prompt_tokens)
                overlaps[name] = overlap
                score = (cfg.w_prefix * overlap / max(1, prompt_tokens)
                         - cfg.w_load * load
                         - cfg.w_fair * self._fairness_penalty(tenant, name))
            elif cfg.policy == "least_loaded":
                overlaps[name] = 0
                score = -load
            else:  # round_robin scores are positional, not load-derived
                overlaps[name] = 0
                score = 0.0
            scores[name] = round(score, 9)

        if cfg.policy == "round_robin":
            chosen = replicas[self._rr_next % len(replicas)]
            if stamp:
                self._rr_next += 1
        else:
            # deterministic tie-break: best score, then name order
            chosen = min(scores, key=lambda n: (-scores[n], n))

        projected = self._projected_ttft(chosen, loads)
        if cfg.admission:
            burn = projected / cfg.target_ttft_s
            if burn >= cfg.breach_burn:
                return RoutingDecision(
                    admission=REJECT, projected_ttft_s=projected,
                    scores=scores, prompt_tokens=prompt_tokens,
                    reason=f"projected TTFT {projected:.2f}s is "
                           f"{burn:.1f}x the {cfg.target_ttft_s:g}s "
                           f"objective (breach band)")
            if burn >= cfg.warn_burn:
                return RoutingDecision(
                    admission=QUEUE, projected_ttft_s=projected,
                    scores=scores, prompt_tokens=prompt_tokens,
                    reason=f"projected TTFT {projected:.2f}s in the "
                           f"warn band")

        best_overlap = max(overlaps.values()) if overlaps else 0
        spilled = (cfg.policy == "prefix" and best_overlap > 0
                   and overlaps[chosen] < best_overlap)
        decision = RoutingDecision(
            admission=ADMIT, replica=chosen,
            overlap_tokens=overlaps.get(chosen, 0),
            prompt_tokens=prompt_tokens, spilled=spilled,
            projected_ttft_s=projected, scores=scores,
            reason=f"policy={cfg.policy}",
        )
        decision.prefill_replica = self._pick_prefill_locked(
            decision, chosen, routable, loads)
        if stamp:
            self._stamp_locked(decision, chain, tenant)
        return decision

    def _pick_prefill_locked(self, decision, chosen, routable,
                             loads) -> Optional[str]:
        """Two-phase placement trigger + target. Fires when the uncached
        prompt span reaches ``disagg_threshold_tokens`` (or the decode
        target's occupancy is at/above ``disagg_occupancy_band``) and at
        least one full block would migrate; the prefill target is the
        least-prefill-loaded candidate, preferring the dedicated pool."""
        cfg = self.config
        if cfg.disagg_threshold_tokens <= 0:
            return None
        uncached = decision.prompt_tokens - decision.overlap_tokens
        if uncached < cfg.block_size:
            return None  # nothing worth migrating
        sig = loads.get(chosen) or ReplicaLoad()
        if (uncached < cfg.disagg_threshold_tokens
                and sig.occupancy < cfg.disagg_occupancy_band):
            return None
        pool = [n for n in routable
                if n in cfg.prefill_pool and n != chosen]
        candidates = pool or [n for n in routable if n != chosen]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda n: (
                self._prefill_tokens.get(n, 0),
                self._effective_load(n, loads)[0],
                n,
            ))

    def _stamp_locked(self, decision, chain, tenant) -> None:
        cfg = self.config
        name = decision.replica
        self._inflight[name] = self._inflight.get(name, 0) + 1
        if cfg.policy == "prefix":
            self.shadow.observe(name, chain)
        window = self._fair.setdefault(
            name, deque(maxlen=cfg.fairness_window))
        window.append(tenant)
        if decision.prefill_replica:
            pre = decision.prefill_replica
            uncached = max(0, decision.prompt_tokens
                           - decision.overlap_tokens)
            self._prefill_tokens[pre] = (
                self._prefill_tokens.get(pre, 0) + uncached)
            if cfg.policy == "prefix":
                # the prefill replica's radix cache holds the prompt
                # chain after phase 1 — teach the shadow index so a
                # repeat prompt can decode there directly
                self.shadow.observe(pre, chain)
        self._decisions.append({
            "replica": name,
            "tenant": tenant,
            "overlap_tokens": decision.overlap_tokens,
            "prompt_tokens": decision.prompt_tokens,
            "spilled": decision.spilled,
            "prefill_replica": decision.prefill_replica,
            "projected_ttft_s": round(decision.projected_ttft_s, 4),
        })

    # -- bookkeeping ---------------------------------------------------------
    def observe_chain(self, replica: str, token_ids) -> None:
        """Record emitted tokens as cached on their replica: the next
        chat turn's prompt embeds this reply, and the real radix cache
        holds the full prompt+reply chain after decode."""
        if self.config.policy != "prefix":
            return
        chain = fingerprint_chain(token_ids, self.config.block_size)
        with self._lock:
            self.shadow.observe(replica, chain)

    def complete(self, replica: str, service_s: Optional[float] = None,
                 ok: bool = True) -> None:
        """One proxied request reached a terminal outcome on
        ``replica``. Updates in-flight and (on success) the service-time
        EWMA the admission projection uses."""
        cfg = self.config
        with self._lock:
            n = self._inflight.get(replica, 0)
            if n > 1:
                self._inflight[replica] = n - 1
            else:
                self._inflight.pop(replica, None)
            if ok and service_s is not None and service_s >= 0:
                prev = self._service_s.get(replica, cfg.default_service_s)
                self._service_s[replica] = (
                    (1 - cfg.service_ewma) * prev
                    + cfg.service_ewma * service_s)

    def prefill_complete(self, replica: str, tokens: int,
                         ok: bool = True) -> None:
        """Phase 1 of a two-phase placement reached a terminal outcome:
        release the replica's in-flight prefill tokens; a failure also
        counts (the gateway degraded the request to unified placement)."""
        with self._lock:
            n = self._prefill_tokens.get(replica, 0) - max(0, tokens)
            if n > 0:
                self._prefill_tokens[replica] = n
            else:
                self._prefill_tokens.pop(replica, None)
        if not ok:
            self.m_prefill_failures.inc()

    def forget_replica(self, name: str) -> None:
        """Drop a replica's shadow/fairness state (it died or scaled
        away — its radix cache died with it)."""
        with self._lock:
            self.shadow.drop_replica(name)
            self._fair.pop(name, None)
            self._inflight.pop(name, None)
            self._service_s.pop(name, None)
            self._prefill_tokens.pop(name, None)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self.config.policy,
                "inflight": dict(self._inflight),
                "prefill_tokens": dict(self._prefill_tokens),
                "service_s": {
                    k: round(v, 4) for k, v in self._service_s.items()},
                "shadow_blocks": {
                    name: self.shadow.blocks(name)
                    for name in self.shadow.replicas()},
                "recent_decisions": list(self._decisions),
            }
