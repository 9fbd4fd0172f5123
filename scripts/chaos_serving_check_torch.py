"""Serving chaos gate for the port: composed failure weather over a live replica fleet.

The port's copy of ``scripts/chaos_serving_check.py``, over
``devspace_tpu_torch.serving``; it imports nothing of the JAX package.
Six scenarios, each against a real (stub-replica) fleet with real
subprocesses, sockets and streams — run ``--repeats`` times (default 3)
so a flaky pass can't sneak through:

1. **kill-mid-stream** — SIGKILL a replica while open-loop traffic
   streams through the fleet. Invariants: every accepted request
   reaches a terminal outcome, ZERO corrupted streams, ZERO hung
   requests, the fleet returns to all-healthy.
2. **hang-replica** — wedge a replica (its /readyz and /healthz block)
   without killing the process. The supervisor's probe must classify it
   dead and restart it; the fleet returns to all-healthy.
3. **metrics-garbage** — one replica's /metrics turns to garbage. The
   collector must quarantine exactly that target (survivors keep
   merging, HPA signals keep flowing) and readmit it on the first clean
   parse.
4. **burst-then-idle** — 4x burst load through the closed autoscale
   loop must scale the fleet up; the following idle must drain it back
   to min after the stabilization window. The emitted fleet.scale_up /
   fleet.scale_down events must match that trajectory, and the burst's
   traffic must still resolve with zero corrupted streams.
5. **router-kill-prefix-hot** — chat traffic flows through the
   prefix-aware routing gateway, concentrating shared-prefix sessions
   on one replica; SIGKILL that prefix-hot replica mid-wave. The
   gateway must reroute with zero corrupted and zero hung streams, the
   fleet must return to all-healthy, and a post-recovery wave's p99
   TTFT must re-converge to the healthy baseline.
6. **disagg-kill-prefill** — mixed short-chat + long-RAG traffic flows
   through a gateway running two-phase placement with a dedicated
   prefill-pool replica; SIGKILL that replica mid-migration. Every
   orphaned migration must degrade — unified placement or
   recompute-prefill — with zero corrupted and zero hung streams, the
   decode replicas' ``engine_kv_restore_fallbacks_total`` must exactly
   match their migration failures (no silent partial scatters), the
   router's in-flight prefill accounting must drain, and the fleet
   returns to all-healthy.

Usage:
    python scripts/chaos_serving_check_torch.py [--repeats N] [--scenario NAME]

Exit codes: 0 all scenarios pass on every repeat, 1 any invariant
violated, 2 harness error.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from devspace_tpu_torch.obs import events as obs_events  # noqa: E402
from devspace_tpu_torch.obs.collector import TelemetryCollector  # noqa: E402
from devspace_tpu_torch.serving import (  # noqa: E402
    AutoscalerConfig,
    LoadGenerator,
    ReplicaFleet,
    ReplicaSpec,
    TraceSpec,
    generate_trace,
)
from devspace_tpu_torch.serving.autoscale import AutoscaleLoop  # noqa: E402


class CheckFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise CheckFailure(f"timed out after {timeout_s:.0f}s waiting for {what}")


def fast_spec(**env):
    base = {"STUB_TOKEN_DELAY_S": "0.002"}
    base.update({k: str(v) for k, v in env.items()})
    return ReplicaSpec(env=base, probe_timeout_s=0.5, ready_timeout_s=20.0)


def chaos_post(fleet, name, body):
    replica = fleet.replica(name)
    import urllib.request

    req = urllib.request.Request(
        replica.base_url + "/chaos", data=json.dumps(body).encode())
    urllib.request.urlopen(req, timeout=2.0).read()


# -- scenarios ---------------------------------------------------------------

def scenario_kill_mid_stream() -> dict:
    fleet = ReplicaFleet(
        spec=fast_spec(STUB_TOKEN_DELAY_S="0.01"), replicas=3,
        poll_interval=0.1)
    fleet.start()
    try:
        trace = generate_trace(TraceSpec(
            seed=11, kind="poisson", duration_s=3.0, rate_rps=15,
            max_new_tokens=(24, 48)))
        gen = LoadGenerator(
            fleet.targets, request_timeout_s=10, hang_timeout_s=25)
        import threading

        box = {}
        th = threading.Thread(
            target=lambda: box.__setitem__("report", gen.run(trace)),
            daemon=True)
        th.start()
        time.sleep(0.8)  # streams in flight
        victim = fleet.names()[0]
        fleet.kill(victim)  # SIGKILL by PID
        th.join(timeout=60)
        check(not th.is_alive(), "loadgen did not finish")
        report = box["report"]
        counts = report.counts()
        check(len(report.outcomes) == len(trace),
              f"unresolved requests: {len(report.outcomes)}/{len(trace)}")
        check(counts["corrupted"] == 0, f"corrupted streams: {counts}")
        check(counts["hung"] == 0, f"hung requests: {counts}")
        wait_for(fleet.all_healthy, 20, "fleet recovery after SIGKILL")
        return {"counts": counts, "victim": victim}
    finally:
        fleet.stop()


def scenario_hang_replica() -> dict:
    fleet = ReplicaFleet(spec=fast_spec(), replicas=3, poll_interval=0.1)
    flight = obs_events.add_sink(obs_events.FlightRecorder())
    fleet.start()
    try:
        victim = fleet.names()[1]
        old_pid = fleet.replica(victim).pid
        chaos_post(fleet, victim, {"hang": True})
        wait_for(
            lambda: fleet.replica(victim).pid != old_pid,
            30, "wedged replica restart")
        wait_for(fleet.all_healthy, 20, "fleet recovery after hang")
        names = [(e.subsystem, e.name) for e in flight.dump()]
        check(("fleet", "replica_restarted") in names,
              f"no replica_restarted event: {names}")
        return {"victim": victim, "old_pid": old_pid,
                "new_pid": fleet.replica(victim).pid}
    finally:
        obs_events.remove_sink(flight)
        fleet.stop()


def scenario_metrics_garbage() -> dict:
    fleet = ReplicaFleet(spec=fast_spec(), replicas=3, poll_interval=0.1)
    fleet.start()
    try:
        coll = TelemetryCollector.from_replicas([], interval_s=60)
        coll.refresh(sorted(fleet.targets().items()))
        for _ in range(2):
            coll.scrape_once()
        check(all(not t.quarantined for t in coll.targets),
              "clean fleet should have no quarantine")
        victim = fleet.names()[2]
        chaos_post(fleet, victim, {"metrics_garbage": True})
        for _ in range(4):  # quarantine_after=3 consecutive parse errors
            coll.scrape_once()
        quarantined = [t.name for t in coll.targets if t.quarantined]
        check(quarantined == [victim],
              f"expected only {victim} quarantined, got {quarantined}")
        signals = coll.hpa_signals()
        check(signals, "survivors must keep producing HPA signals")
        chaos_post(fleet, victim, {"metrics_garbage": False})
        coll.scrape_once()
        check(not any(t.quarantined for t in coll.targets),
              "clean parse must readmit the quarantined target")
        return {"victim": victim, "signals": len(signals)}
    finally:
        fleet.stop()


def scenario_burst_then_idle() -> dict:
    fleet = ReplicaFleet(
        spec=fast_spec(STUB_MAX_SLOTS=2, STUB_TOKEN_DELAY_S="0.005"),
        replicas=1, poll_interval=0.1)
    flight = obs_events.add_sink(obs_events.FlightRecorder())
    fleet.start()
    try:
        coll = TelemetryCollector.from_replicas([], interval_s=60)
        loop = AutoscaleLoop(fleet, coll, AutoscalerConfig(
            min_replicas=1, max_replicas=3,
            targets={"engine_queued_requests": 1.0},
            scale_down_stabilization_s=1.5))
        gen = LoadGenerator(
            fleet.targets, request_timeout_s=15, hang_timeout_s=30)
        trace = generate_trace(TraceSpec(
            seed=5, kind="bursty", duration_s=3.0, rate_rps=8,
            burst_multiplier=4.0, max_new_tokens=(16, 32)))
        import threading

        box = {}
        th = threading.Thread(
            target=lambda: box.__setitem__("report", gen.run(trace)),
            daemon=True)
        th.start()
        peak = 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            coll.scrape_once()
            loop.tick()
            peak = max(peak, fleet.desired)
            if not th.is_alive() and fleet.desired == 1 and peak > 1:
                break
            time.sleep(0.1)
        th.join(timeout=60)
        check(not th.is_alive(), "burst loadgen did not finish")
        report = box["report"]
        counts = report.counts()
        check(len(report.outcomes) == len(trace),
              f"unresolved requests: {len(report.outcomes)}/{len(trace)}")
        check(counts["corrupted"] == 0, f"corrupted streams: {counts}")
        check(peak > 1, "burst load never forced a scale-up")
        check(fleet.desired == 1,
              f"idle never drained back to min (desired={fleet.desired})")
        wait_for(fleet.all_healthy, 20, "fleet healthy after drain-down")
        # the event trail must match the trajectory: at least one
        # scale_up, then at least one scale_down, in that order
        trail = [e.name for e in flight.dump("fleet")]
        check("scale_up" in trail, f"no scale_up event: {trail}")
        check("scale_down" in trail, f"no scale_down event: {trail}")
        check(trail.index("scale_up") < trail.index("scale_down"),
              f"scale events out of order: {trail}")
        return {"counts": counts, "peak_replicas": peak,
                "decisions": len(loop.decisions)}
    finally:
        obs_events.remove_sink(flight)
        fleet.stop()


def scenario_router_kill_prefix_hot() -> dict:
    from devspace_tpu_torch.serving.gateway import RoutingGateway
    from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig

    fleet = ReplicaFleet(
        spec=fast_spec(STUB_TOKEN_DELAY_S="0.01"), replicas=3,
        poll_interval=0.1)
    fleet.start()
    gw = None
    try:
        router = PrefixRouter(
            replicas_fn=fleet.targets,
            # admission off: the gate's invariants are reroute + TTFT
            # re-convergence, and outcomes must repeat exactly
            config=RouterConfig(admission=False))
        gw = RoutingGateway(router, port=0)
        gw.start()

        def run_wave(seed):
            trace = generate_trace(TraceSpec(
                seed=seed, kind="chat", duration_s=2.0, rate_rps=10,
                turns=(2, 3), max_new_tokens=(16, 24)))
            gen = LoadGenerator(
                lambda: {"gw": gw.base_url}, request_timeout_s=10,
                hang_timeout_s=25, max_attempts=4)
            return trace, gen

        # wave 1: healthy baseline through the gateway
        trace, gen = run_wave(21)
        healthy = gen.run(trace)
        counts = healthy.counts()
        check(counts["corrupted"] == 0, f"baseline corrupted: {counts}")
        check(counts["hung"] == 0, f"baseline hung: {counts}")
        p99_healthy = healthy.ttft_quantile(0.99)

        # wave 2: SIGKILL the replica holding the most shadow chains
        trace, gen = run_wave(22)
        import threading

        box = {}
        th = threading.Thread(
            target=lambda: box.__setitem__("report", gen.run(trace)),
            daemon=True)
        th.start()
        time.sleep(0.5)  # routed streams in flight
        blocks = router.stats()["shadow_blocks"]
        hot = max(sorted(blocks), key=lambda n: blocks[n])
        fleet.kill(hot)
        th.join(timeout=60)
        check(not th.is_alive(), "router-wave loadgen did not finish")
        counts = box["report"].counts()
        check(len(box["report"].outcomes) == len(trace),
              f"unresolved: {len(box['report'].outcomes)}/{len(trace)}")
        check(counts["corrupted"] == 0, f"corrupted streams: {counts}")
        check(counts["hung"] == 0, f"hung requests: {counts}")
        wait_for(fleet.all_healthy, 20, "fleet recovery after router kill")

        # wave 3: p99 TTFT must re-converge to the healthy baseline
        trace, gen = run_wave(23)
        recovered = gen.run(trace)
        counts3 = recovered.counts()
        check(counts3["corrupted"] == 0, f"post-recovery: {counts3}")
        p99_after = recovered.ttft_quantile(0.99)
        bound = max(2.5 * p99_healthy, p99_healthy + 0.25)
        check(p99_after <= bound,
              f"p99 TTFT did not re-converge: {p99_after:.3f}s vs "
              f"healthy {p99_healthy:.3f}s (bound {bound:.3f}s)")
        retries = int(router.registry.snapshot()
                      ["serving_router_retries_total"]["samples"][0][1])
        return {"victim": hot, "kill_wave_counts": counts,
                "p99_ttft_healthy_s": round(p99_healthy, 4),
                "p99_ttft_recovered_s": round(p99_after, 4),
                "retries_total": retries}
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


def scrape_metric(base_url: str, name: str) -> float:
    import urllib.request

    with urllib.request.urlopen(base_url + "/metrics", timeout=5) as resp:
        text = resp.read().decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def scenario_disagg_kill_prefill() -> dict:
    from devspace_tpu_torch.serving.gateway import RoutingGateway
    from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig

    fleet = ReplicaFleet(
        spec=fast_spec(STUB_TOKEN_DELAY_S="0.01",
                       STUB_PREFILL_DELAY_PER_TOKEN_S="0.002"),
        replicas=3, poll_interval=0.1)
    fleet.start()
    gw = None
    try:
        pool = "replica-2"
        router = PrefixRouter(
            replicas_fn=fleet.targets,
            # admission off: the gate's invariants are degrade-on-death,
            # and outcomes must repeat exactly across --repeats
            config=RouterConfig(admission=False, prefill_pool=(pool,),
                                disagg_threshold_tokens=32))
        gw = RoutingGateway(router, port=0)
        gw.start()

        # mixed weather: short chat turns interleaved with long RAG
        # prompts whose fresh contexts each take the two-phase path
        trace = generate_trace(TraceSpec(
            seed=31, kind="rag", duration_s=2.5, rate_rps=10,
            rag_contexts=4, rag_context_len=(96, 128),
            rag_long_fraction=0.5, max_new_tokens=(12, 24)))
        gen = LoadGenerator(
            lambda: {"gw": gw.base_url}, request_timeout_s=15,
            hang_timeout_s=30, max_attempts=4)
        import threading

        box = {}
        th = threading.Thread(
            target=lambda: box.__setitem__("report", gen.run(trace)),
            daemon=True)
        th.start()
        # SIGKILL the pool replica the moment migrations are in flight
        wait_for(
            lambda: any(d.get("prefill_replica")
                        for d in router.stats()["recent_decisions"]),
            20, "first two-phase placement")
        fleet.kill(pool)
        th.join(timeout=90)
        check(not th.is_alive(), "disagg loadgen did not finish")
        report = box["report"]
        counts = report.counts()
        check(len(report.outcomes) == len(trace),
              f"unresolved requests: {len(report.outcomes)}/{len(trace)}")
        check(counts["corrupted"] == 0, f"corrupted streams: {counts}")
        check(counts["hung"] == 0, f"hung requests: {counts}")
        check(counts["failed"] == 0, f"failed requests: {counts}")
        snap = router.registry.snapshot()
        dispatches = int(
            snap["serving_router_prefill_dispatches_total"]["samples"][0][1])
        check(dispatches >= 1, "no two-phase placement ever fired")
        wait_for(lambda: router.stats()["prefill_tokens"] == {}, 20,
                 "in-flight prefill accounting to drain")
        wait_for(fleet.all_healthy, 20, "fleet recovery after pool kill")
        # degrade accounting: every failed migration on a decode replica
        # counted exactly one recompute fallback — nothing scattered
        # partially, nothing silently retried into corruption. (The
        # restarted pool replica reports fresh zeros; summing it is a
        # no-op.)
        failures = fallbacks = 0
        for name, url in sorted(fleet.targets().items()):
            failures += scrape_metric(url, "engine_kv_migrate_failures_total")
            fallbacks += scrape_metric(url, "engine_kv_restore_fallbacks_total")
        check(failures == fallbacks,
              f"migration failures ({failures}) != recompute fallbacks "
              f"({fallbacks}): a failed migration was not degraded cleanly")
        prefill_failures = int(
            snap["serving_router_prefill_failures_total"]["samples"][0][1])
        return {"counts": counts, "prefill_dispatches": dispatches,
                "phase1_failures": prefill_failures,
                "migrate_failures": int(failures),
                "recompute_fallbacks": int(fallbacks)}
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


SCENARIOS = {
    "kill-mid-stream": scenario_kill_mid_stream,
    "hang-replica": scenario_hang_replica,
    "metrics-garbage": scenario_metrics_garbage,
    "burst-then-idle": scenario_burst_then_idle,
    "router-kill-prefix-hot": scenario_router_kill_prefix_hot,
    "disagg-kill-prefill": scenario_disagg_kill_prefill,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    help="run one scenario instead of all")
    args = ap.parse_args()

    names = [args.scenario] if args.scenario else list(SCENARIOS)
    failures = []
    for rep in range(1, args.repeats + 1):
        for name in names:
            t0 = time.monotonic()
            try:
                detail = SCENARIOS[name]()
            except CheckFailure as e:
                failures.append((rep, name, str(e)))
                print(f"[serving-chaos] repeat {rep} {name}: FAIL {e}",
                      file=sys.stderr, flush=True)
                continue
            except Exception as e:  # noqa: BLE001 — harness error
                print(f"[serving-chaos] repeat {rep} {name}: "
                      f"harness error {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                return 2
            print(f"[serving-chaos] repeat {rep} {name}: "
                  f"ok in {time.monotonic() - t0:.1f}s {json.dumps(detail)}",
                  flush=True)

    summary = {
        "repeats": args.repeats,
        "scenarios": names,
        "failures": [f"{r}/{n}: {m}" for r, n, m in failures],
    }
    print(json.dumps(summary))
    if failures:
        print(f"[serving-chaos] FAIL: {len(failures)} scenario run(s)",
              file=sys.stderr)
        return 1
    print(f"[serving-chaos] OK: {len(names)} scenarios x "
          f"{args.repeats} repeats, all invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
