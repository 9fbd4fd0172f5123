"""The port's serving tier under SIGKILL, over its stub replicas.

The live tests of tests/test_serving_router.py and
tests/test_serving_disagg.py that drive the loadgen, run on the port's
loadgen, fleet, router and gateway: the routed replica killed mid-stream
reroutes with zero corrupted outcomes (chaos), the RAG trace shape, the
gateway forwarding each token as it arrives, a streamed request
rerouted from a replica that accepts and never answers (a killed one
still tearing down) and a two-phase placement degraded from such a
prefill pool, the gateway's and the server's accept queues
holding a burst, a live two-phase placement that migrates the chain and keeps the stream
exact, and the prefill-pool replica killed mid-migration degrading every
orphaned migration cleanly (chaos). The chaos-marked tests are run three
times by scripts/chaos_check_torch.py.
"""

import json
import threading
import time
import urllib.request

import pytest

from devspace_tpu_torch.serving import ReplicaFleet, ReplicaSpec
from devspace_tpu_torch.serving.gateway import RoutingGateway
from devspace_tpu_torch.serving.loadgen import LoadGenerator, TraceSpec, generate_trace
from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig
from devspace_tpu_torch.serving.stub import token_at

SHORT = list(range(16))


def wait_for(cond, timeout=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def fast_fleet(replicas=2, **env):
    env.setdefault("STUB_TOKEN_DELAY_S", "0.002")
    return ReplicaFleet(spec=ReplicaSpec(env=env), replicas=replicas,
                        poll_interval=0.1)


def make_gateway(fleet, **cfg_kw):
    cfg_kw.setdefault("policy", "prefix")
    router = PrefixRouter(replicas_fn=fleet.targets,
                          config=RouterConfig(**cfg_kw))
    gw = RoutingGateway(router, port=0)
    gw.start()
    return gw


def gw_stream(gw, prompt, n):
    body = json.dumps({"prompt_ids": prompt, "max_new_tokens": n,
                       "stream": True}).encode()
    req = urllib.request.Request(gw.base_url + "/generate", data=body)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return [json.loads(line) for line in resp]


def replica_metric(url: str, name: str) -> float:
    with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


# -- router (tests/test_serving_router.py) -----------------------------------
@pytest.mark.chaos
def test_routed_replica_killed_mid_stream_reroutes_clean():
    """SIGKILL the replica currently holding the routed streams. Every
    client stream must end completed or retried — zero corrupted, zero
    hung: the gateway aborts half-written streams instead of replaying,
    and the loadgen's retry rides a fresh routing decision."""
    fleet = fast_fleet(replicas=2, STUB_TOKEN_DELAY_S="0.01")
    fleet.start()
    gw = None
    try:
        # admission off: this test is about reroute-on-death, and the
        # outcome must be deterministic across the chaos gate's repeats
        gw = make_gateway(fleet, admission=False)
        gen = LoadGenerator(targets_fn=lambda: {"gw": gw.base_url},
                            hang_timeout_s=60.0, max_attempts=4)
        # one shared prefix -> all streams route to one replica, so the
        # kill provably lands on routed traffic
        base = list(range(24))
        trace = [{"id": i, "at": 0.0, "prompt_ids": base,
                  "max_new_tokens": 40, "sampled": False, "session": 0}
                 for i in range(6)]

        killed = {}

        def kill_routed():
            wait_for(
                lambda: gw.router.stats()["recent_decisions"],
                msg="first routed decision")
            time.sleep(0.15)  # let streams get bytes in flight
            name = gw.router.stats()["recent_decisions"][-1]["replica"]
            killed["name"] = name
            fleet.kill(name)

        killer = threading.Thread(target=kill_routed, daemon=True)
        killer.start()
        report = gen.run(trace)
        killer.join(timeout=30)
        counts = report.counts()
        assert counts["corrupted"] == 0, report.to_dict()
        assert counts["hung"] == 0, report.to_dict()
        assert counts["failed"] == 0, report.to_dict()
        assert counts["completed"] + counts["retried"] == len(trace)
        assert killed, "kill thread never fired"
        # the supervisor restarts the killed replica behind the gateway
        wait_for(fleet.all_healthy, msg="fleet recovered after kill")
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


def test_rag_trace_is_byte_stable_and_shares_contexts():
    from devspace_tpu_torch.serving.loadgen import trace_json

    spec = TraceSpec(kind="rag", seed=11, duration_s=4.0, rate_rps=10,
                     rag_contexts=2, rag_context_len=(64, 96),
                     rag_long_fraction=0.4)
    assert trace_json(spec) == trace_json(spec)
    trace = generate_trace(spec)
    assert trace, "empty rag trace"
    long = [e for e in trace if e["session"] >= 0]
    short = [e for e in trace if e["session"] == -1]
    assert long and short, "rag must interleave long and short prompts"
    # every long query embeds its context verbatim as the prompt prefix
    by_ctx = {}
    for e in long:
        by_ctx.setdefault(e["session"], []).append(e["prompt_ids"])
    for prompts in by_ctx.values():
        ctx_len = min(len(p) for p in prompts) - 1
        head = prompts[0][:64]  # at least the min context length
        assert all(p[:64] == head for p in prompts)
        assert ctx_len >= 64
    assert max(len(e["prompt_ids"]) for e in long) > max(
        len(e["prompt_ids"]) for e in short)


def test_gateway_forwards_each_token_as_it_arrives():
    """The gateway forwards what the replica has streamed so far, not 8
    KiB at a time: through it the first token of a 1.5 s stream arrives
    as soon as the replica sends it. A gateway that waits for a full
    buffer holds a short stream back until it ends, so its TTFT is the
    stream's whole latency and a long stream outlasts the client's read
    timeout."""
    fleet = fast_fleet(replicas=1, STUB_TOKEN_DELAY_S="0.05")
    fleet.start()
    gw = None
    try:
        gw = make_gateway(fleet)
        body = json.dumps({"prompt_ids": SHORT, "max_new_tokens": 30,
                           "stream": True}).encode()
        req = urllib.request.Request(gw.base_url + "/generate", data=body)
        t0 = time.monotonic()
        arrivals, lines = [], []
        with urllib.request.urlopen(req, timeout=30) as resp:
            for line in resp:
                arrivals.append(time.monotonic() - t0)
                lines.append(json.loads(line))
        assert [m["token"] for m in lines[:-1]] == [
            token_at(SHORT, i) for i in range(30)]
        assert lines[-1] == {"done": True}
        assert arrivals[-1] >= 1.4 and arrivals[0] < arrivals[-1] / 3, arrivals
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


@pytest.mark.parametrize("streamed", [True, False])
def test_gateway_reroutes_a_replica_that_accepts_and_never_answers(streamed):
    """A replica killed while its process still tears down keeps its
    listening socket: the kernel completes the gateway's connect into
    the backlog, and nothing answers until the teardown ends (a socket
    that listens and never accepts is that state). With ``header_timeout_s`` a streamed
    request gives up on it after that timeout and reroutes to the live
    replica, long before a client's 10 s read timeout; a request that
    does not stream keeps the request's timeout (a replica answers it
    only when it is done), so it still waits."""
    import socket

    from devspace_tpu_torch.serving.gateway import RoutingGateway

    fleet = fast_fleet(replicas=1)
    fleet.start()
    gw = None
    with socket.socket() as hole:
        hole.bind(("127.0.0.1", 0))
        hole.listen(8)
        dead = f"http://127.0.0.1:{hole.getsockname()[1]}"
        try:
            wait_for(lambda: len(fleet.targets()) == 1, msg="the live replica")
            # least_loaded breaks the tie by name: the dead one is picked first
            router = PrefixRouter(replicas_fn=lambda: {"a-dead": dead, **fleet.targets()},
                                  config=RouterConfig(policy="least_loaded"))
            gw = RoutingGateway(router, port=0, request_timeout_s=4.0, header_timeout_s=0.5)
            gw.start()
            body = {"prompt_ids": SHORT, "max_new_tokens": 8, "stream": streamed}
            req = urllib.request.Request(gw.base_url + "/generate",
                                         data=json.dumps(body).encode())
            t0 = time.monotonic()
            with urllib.request.urlopen(req, timeout=30) as resp:
                raw = resp.read()
            elapsed = time.monotonic() - t0
            want = [token_at(SHORT, i) for i in range(8)]
            if streamed:
                lines = [json.loads(line) for line in raw.splitlines()]
                assert [m["token"] for m in lines[:-1]] == want and lines[-1] == {"done": True}
                assert elapsed < 3.0, elapsed
            else:
                assert json.loads(raw)["tokens"] == want
                assert elapsed >= 4.0, elapsed
            assert router.m_retries.value == 1
        finally:
            if gw is not None:
                gw.stop()
            fleet.stop()


def test_gateway_degrades_a_prefill_pool_that_accepts_and_never_answers():
    """Phase 1 of a two-phase placement whose pool accepts the connect
    and never answers (a socket that listens and never accepts) gives up
    after ``prefill_timeout_s``: the request degrades to unified
    placement on the live replica, its stream exact, long before a
    client's 10 s read timeout, and the router counts one phase-1
    failure and releases the pool's prefill tokens."""
    import socket

    from devspace_tpu_torch.serving.gateway import RoutingGateway

    fleet = fast_fleet(replicas=1)
    fleet.start()
    gw = None
    with socket.socket() as hole:
        hole.bind(("127.0.0.1", 0))
        hole.listen(8)
        dead = f"http://127.0.0.1:{hole.getsockname()[1]}"
        try:
            wait_for(lambda: len(fleet.targets()) == 1, msg="the live replica")
            router = PrefixRouter(
                replicas_fn=lambda: {"pool": dead, **fleet.targets()},
                config=RouterConfig(prefill_pool=("pool",), disagg_threshold_tokens=32))
            gw = RoutingGateway(router, port=0, request_timeout_s=30.0,
                                header_timeout_s=0.5, prefill_timeout_s=0.5)
            gw.start()
            prompt = list(range(96))
            t0 = time.monotonic()
            lines = gw_stream(gw, prompt, 5)
            elapsed = time.monotonic() - t0
            assert [m["token"] for m in lines[:-1]] == [token_at(prompt, i) for i in range(5)]
            assert lines[-1] == {"done": True}
            assert elapsed < 3.0, elapsed
            d = router.stats()["recent_decisions"][-1]
            assert d["prefill_replica"] == "pool" and d["replica"] != "pool", d
            assert router.m_prefill_failures.value == 1
            wait_for(lambda: router.stats()["prefill_tokens"] == {},
                     msg="prefill tokens drained")
        finally:
            if gw is not None:
                gw.stop()
            fleet.stop()


def connected_before_accept(port: int, n: int = 64) -> int:
    """How many of ``n`` simultaneous connections complete their handshake
    while the server accepts none: what its accept queue holds."""
    import socket

    held = []

    def connect():
        sock = socket.socket()
        sock.settimeout(0.5)
        try:
            sock.connect(("127.0.0.1", port))
            held.append(sock)
        except OSError:
            sock.close()

    threads = [threading.Thread(target=connect) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for sock in held:
        sock.close()
    return len(held)


@pytest.mark.parametrize("frontend", ["gateway", "server"])
def test_accept_queue_holds_a_burst(frontend):
    """A burst of 64 connections to the gateway, and to a replica's
    server, all complete their handshake before the server accepts any.
    socketserver's queue of 5 drops the rest, whose SYN retransmits then
    wait 1, 3, 7 s: under a wave of requests, or the retries after a
    replica dies, a request can stay silent for its client's whole read
    timeout."""
    if frontend == "gateway":
        router = PrefixRouter(replicas_fn=dict, config=RouterConfig())
        httpd = RoutingGateway(router, port=0)._httpd
    else:
        from devspace_tpu_torch import serve

        httpd = serve.make_http_server(None, "127.0.0.1", 0)
    try:
        assert connected_before_accept(httpd.server_address[1]) == 64
    finally:
        httpd.server_close()


# -- disaggregated prefill (tests/test_serving_disagg.py) --------------------
def test_live_disagg_migrates_chain_and_keeps_stream_exact():
    fleet = fast_fleet(replicas=3)
    fleet.start()
    gw = None
    try:
        gw = make_gateway(fleet, prefill_pool=("replica-2",),
                          disagg_threshold_tokens=32)
        prompt = list(range(96))
        lines = gw_stream(gw, prompt, 5)
        assert [m["token"] for m in lines[:-1]] == [
            token_at(prompt, i) for i in range(5)]
        assert lines[-1] == {"done": True}
        decisions = gw.router.stats()["recent_decisions"]
        d = decisions[-1]
        assert d["prefill_replica"] == "replica-2"
        assert d["replica"] in ("replica-0", "replica-1")
        targets = fleet.targets()
        # prefill side exported the chain; decode side pulled it whole
        assert replica_metric(
            targets["replica-2"], "engine_kv_export_chains_total") >= 1
        decode_url = targets[d["replica"]]
        assert replica_metric(
            decode_url, "engine_kv_migrate_chains_total") >= 1
        assert replica_metric(
            decode_url, "engine_kv_migrate_bytes_total") > 0
        assert replica_metric(
            decode_url, "engine_kv_migrate_failures_total") == 0
        # a short prompt stays unified and off the pool
        short_lines = gw_stream(gw, SHORT, 3)
        assert [m["token"] for m in short_lines[:-1]] == [
            token_at(SHORT, i) for i in range(3)]
        d2 = gw.router.stats()["recent_decisions"][-1]
        assert d2["prefill_replica"] is None
        assert d2["replica"] != "replica-2"
        # phase-1 accounting drains once the streams complete
        wait_for(lambda: gw.router.stats()["prefill_tokens"] == {},
                 msg="prefill tokens drained")
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


@pytest.mark.chaos
def test_prefill_pool_replica_killed_mid_migration_degrades_clean():
    """SIGKILL the dedicated prefill replica while mixed short+long load
    is in flight. Long requests whose phase-1 or chain pull lands on the
    corpse must degrade — unified placement or recompute-prefill — with
    ZERO corrupted and ZERO hung client streams; decode replicas never
    scatter a partial migration into their pools."""
    fleet = fast_fleet(replicas=3, STUB_TOKEN_DELAY_S="0.01",
                       STUB_PREFILL_DELAY_PER_TOKEN_S="0.002")
    fleet.start()
    gw = None
    try:
        # admission off: the outcome must be deterministic across the
        # chaos gate's repeats, not dependent on queue timing
        gw = make_gateway(fleet, admission=False,
                          prefill_pool=("replica-2",),
                          disagg_threshold_tokens=32)
        gen = LoadGenerator(targets_fn=lambda: {"gw": gw.base_url},
                            hang_timeout_s=60.0, max_attempts=4)
        long_base = list(range(96))
        trace = []
        for i in range(10):
            # alternate short chat turns with long RAG-style prompts that
            # all share one context -> every long request wants the pool
            if i % 2 == 0:
                # a distinct leading token per request -> distinct chains,
                # so EVERY long request takes the two-phase path
                ids = [7000 + i] + long_base
                trace.append({"id": i, "at": 0.05 * i, "prompt_ids": ids,
                              "max_new_tokens": 12, "sampled": False,
                              "session": 0})
            else:
                trace.append({"id": i, "at": 0.05 * i,
                              "prompt_ids": [500 + i] * 12,
                              "max_new_tokens": 8, "sampled": False,
                              "session": -1})

        killed = {}

        def kill_prefill_pool():
            wait_for(
                lambda: any(d.get("prefill_replica")
                            for d in gw.router.stats()["recent_decisions"]),
                msg="first two-phase placement")
            killed["name"] = "replica-2"
            fleet.kill("replica-2")

        killer = threading.Thread(target=kill_prefill_pool, daemon=True)
        killer.start()
        report = gen.run(trace)
        killer.join(timeout=30)
        counts = report.counts()
        assert counts["corrupted"] == 0, report.to_dict()
        assert counts["hung"] == 0, report.to_dict()
        assert counts["failed"] == 0, report.to_dict()
        assert counts["completed"] + counts["retried"] == len(trace)
        assert all(o.received == [] for o in report.outcomes)
        assert killed, "kill thread never fired"
        # phase-1 token accounting drains even for orphaned migrations
        wait_for(lambda: gw.router.stats()["prefill_tokens"] == {},
                 msg="prefill tokens drained after kill")
        # the supervisor restarts the pool replica behind the gateway
        wait_for(fleet.all_healthy, msg="fleet recovered after kill")
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()


# -- the harness scripts ---------------------------------------------------------
def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serving_chaos_script_has_the_reference_scenarios():
    port, ref = _script("chaos_serving_check_torch"), _script("chaos_serving_check")
    assert list(port.SCENARIOS) == list(ref.SCENARIOS) == [
        "kill-mid-stream", "hang-replica", "metrics-garbage", "burst-then-idle",
        "router-kill-prefix-hot", "disagg-kill-prefill"]
    for fn in port.SCENARIOS.values():
        assert fn.__module__ == port.__name__


def test_every_required_chaos_module_carries_a_chaos_test():
    import ast
    import os

    gate = _script("chaos_check_torch")
    assert "test_torch_serving_chaos" in gate.REQUIRED_CHAOS_MODULES
    files = {os.path.splitext(os.path.basename(f))[0]: f for f in gate.chaos_test_files()}
    for mod in gate.REQUIRED_CHAOS_MODULES:
        src = open(os.path.join(gate.REPO, files[mod])).read()
        marked = [n.name for n in ast.walk(ast.parse(src))
                  if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
                  and any("chaos" in ast.unparse(d) for d in n.decorator_list)]
        assert marked, f"{mod} carries no chaos-marked test"
