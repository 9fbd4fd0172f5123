"""The port's loadgen (``devspace_tpu_torch/serving/loadgen.py``) on the CPU.

- The reference's loadgen tests (tests/test_serving_loadgen.py), run on
  the port's loadgen and its stub replicas: trace determinism, the
  workload shapes, outcome accounting, live replay, corruption and
  truncation, recorded traces.
- Held to the JAX package's loadgen: ``trace_json`` byte-equal for every
  kind over several seeds (a recorded ``file:`` trace too),
  ``LoadReport.to_dict()`` equal on the same outcomes, the default
  expected stream equal to the reference's, and the ``received`` seam set
  only on a corrupted outcome.
"""

import http.server
import json
import threading

import pytest

from devspace_tpu.serving import loadgen as ref_loadgen
from devspace_tpu_torch.serving import (
    LoadGenerator,
    ReplicaFleet,
    ReplicaSpec,
    TraceSpec,
    generate_trace,
)
from devspace_tpu_torch.serving import loadgen
from devspace_tpu_torch.serving.loadgen import OUTCOMES, LoadReport, RequestOutcome, trace_json
from devspace_tpu_torch.serving.stub import token_at


# -- determinism -------------------------------------------------------------
@pytest.mark.parametrize("kind", ["poisson", "chat", "bursty"])
def test_trace_byte_stable_per_seed(kind):
    spec = TraceSpec(kind=kind, seed=42, duration_s=2.0, rate_rps=10)
    again = TraceSpec(kind=kind, seed=42, duration_s=2.0, rate_rps=10)
    assert trace_json(spec) == trace_json(again)
    # a different seed must actually change the trace
    assert trace_json(spec) != trace_json(
        TraceSpec(kind=kind, seed=43, duration_s=2.0, rate_rps=10)
    )


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown trace kind"):
        generate_trace(TraceSpec(kind="sawtooth"))


# -- workload shapes ---------------------------------------------------------
def test_poisson_trace_sorted_and_bounded():
    spec = TraceSpec(kind="poisson", seed=1, duration_s=3.0, rate_rps=20)
    trace = generate_trace(spec)
    assert trace, "a 3s/20rps trace must produce events"
    ats = [e["at"] for e in trace]
    assert ats == sorted(ats)
    assert all(0 <= t < spec.duration_s for t in ats)
    lo, hi = spec.prompt_len
    assert all(lo <= len(e["prompt_ids"]) <= hi for e in trace)
    assert {e["sampled"] for e in trace} == {True, False}


def test_chat_sessions_share_growing_prefix():
    trace = generate_trace(
        TraceSpec(kind="chat", seed=3, duration_s=2.0, rate_rps=5,
                  turns=(3, 3))
    )
    sessions = {}
    for e in trace:
        sessions.setdefault(e["session"], []).append(e)
    multi = [v for v in sessions.values() if len(v) > 1]
    assert multi, "chat trace must contain multi-turn sessions"
    for turns in multi:
        turns.sort(key=lambda e: e["at"])
        for prev, nxt in zip(turns, turns[1:]):
            prev_prompt = prev["prompt_ids"]
            # next turn = previous prompt + previous turn's full reply
            reply = [token_at(prev_prompt, i)
                     for i in range(prev["max_new_tokens"])]
            assert nxt["prompt_ids"] == prev_prompt + reply


def test_bursty_trace_denser_in_bursts():
    spec = TraceSpec(kind="bursty", seed=9, duration_s=8.0, rate_rps=10,
                     burst_on_s=1.0, burst_off_s=1.0, burst_multiplier=4.0)
    trace = generate_trace(spec)
    period = spec.burst_on_s + spec.burst_off_s
    on = sum(1 for e in trace if (e["at"] % period) < spec.burst_on_s)
    off = len(trace) - on
    assert on > 2 * off, f"burst phase must dominate: on={on} off={off}"


# -- report accounting -------------------------------------------------------
def test_report_counts_and_quantiles():
    rep = LoadReport(outcomes=[
        RequestOutcome(id=0, outcome="completed", latency_s=0.1),
        RequestOutcome(id=1, outcome="completed", latency_s=0.3),
        RequestOutcome(id=2, outcome="retried", latency_s=0.5, attempts=2),
        RequestOutcome(id=3, outcome="failed", latency_s=9.0),
    ], wall_s=1.0)
    counts = rep.counts()
    assert set(counts) == set(OUTCOMES)
    assert counts["completed"] == 2 and counts["retried"] == 1
    assert sum(counts.values()) == 4
    # failed latencies are excluded from the served-latency quantiles
    assert rep.latency_quantile(1.0) == 0.5
    d = rep.to_dict()
    assert d["requests"] == 4 and d["counts"]["failed"] == 1


def test_no_targets_resolves_as_failed():
    gen = LoadGenerator(lambda: {}, max_attempts=2, hang_timeout_s=2)
    trace = generate_trace(
        TraceSpec(seed=0, duration_s=0.2, rate_rps=20))
    report = gen.run(trace, speed=10.0)
    assert len(report.outcomes) == len(trace)
    assert report.counts()["failed"] == len(trace)


# -- live replay against a stub replica -------------------------------------
def test_replay_verifies_streams_live():
    fleet = ReplicaFleet(
        spec=ReplicaSpec(env={"STUB_TOKEN_DELAY_S": "0.001"}),
        replicas=1, poll_interval=0.1)
    fleet.start()
    try:
        trace = generate_trace(
            TraceSpec(seed=7, duration_s=0.6, rate_rps=25))
        gen = LoadGenerator(fleet.targets, request_timeout_s=5,
                            hang_timeout_s=10)
        report = gen.run(trace, speed=2.0)
        counts = report.counts()
        assert len(report.outcomes) == len(trace)
        assert counts["completed"] == len(trace), counts
        assert counts["corrupted"] == 0 and counts["hung"] == 0
        assert all(o.tokens == trace[i]["max_new_tokens"]
                   for i, o in enumerate(report.outcomes))
        assert all(o.received == [] for o in report.outcomes)
    finally:
        fleet.stop()


class _Target:
    """A one-handler HTTP target on a free port, shut down on exit."""

    def __init__(self, handler):
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


class LyingHandler(http.server.BaseHTTPRequestHandler):
    """Streams 1, 2, 3 and done, whatever the prompt."""

    def log_message(self, *a):  # noqa: N802
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(200)
        self.end_headers()
        for tok in (1, 2, 3):
            self.wfile.write(json.dumps({"token": tok}).encode() + b"\n")
        self.wfile.write(json.dumps({"done": True}).encode() + b"\n")


def test_corruption_is_detected_not_papered_over():
    # a target that streams WRONG tokens must yield outcome=corrupted:
    # the verifier compares against token_at, so a lying replica can't
    # hide behind a well-formed stream
    with _Target(LyingHandler) as target:
        gen = LoadGenerator(lambda: {"liar": target.url}, hang_timeout_s=5)
        trace = generate_trace(TraceSpec(seed=2, duration_s=0.2, rate_rps=10))
        report = gen.run(trace, speed=10.0)
        assert report.counts()["corrupted"] == len(trace)
        # the seam: what the corrupted stream delivered
        assert all(o.received == [1, 2, 3] for o in report.outcomes)


def test_truncated_stream_is_death_not_corruption():
    # a replica killed mid-stream surfaces as EOF (close-delimited body)
    # or a half-written line, never as a socket error — the verifier must
    # classify a correct-prefix truncation as a death (retryable), and
    # reserve `corrupted` for wrong content. With every target
    # truncating, requests end `failed`; corrupted stays zero.
    class TruncatingHandler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: N802
            pass

        def do_POST(self):  # noqa: N802
            body = json.loads(
                self.rfile.read(int(self.headers.get("Content-Length", 0))))
            self.send_response(200)
            self.end_headers()
            # two CORRECT tokens, then a half-written third line and a
            # dropped connection — no done marker ever arrives
            for i in range(2):
                self.wfile.write(json.dumps(
                    {"token": token_at(body["prompt_ids"], i)}
                ).encode() + b"\n")
            self.wfile.write(b'{"tok')
            self.wfile.flush()
            self.connection.close()

    with _Target(TruncatingHandler) as target:
        gen = LoadGenerator(lambda: {"trunc": target.url}, hang_timeout_s=5)
        trace = generate_trace(TraceSpec(
            seed=3, duration_s=0.2, rate_rps=10,
            max_new_tokens=(4, 8)))
        report = gen.run(trace, speed=10.0)
        counts = report.counts()
        assert counts["corrupted"] == 0, counts
        assert counts["hung"] == 0, counts
        assert counts["failed"] == len(trace), counts
        assert all(o.received == [] for o in report.outcomes)


# -- recorded-trace replay ---------------------------------------------------
RECORDED = (
    '{"timestamp": 1000.5, "prompt": [1, 2, 3], "tenant": "acme"}\n'
    "\n"  # blank lines are skipped
    '{"timestamp": 1000.0, "prompt_ids": [4, 5], "max_new_tokens": 3,'
    ' "sampled": true, "session": 7}\n'
    '{"at": 1001.2, "prompt": [6]}\n'
)


def test_recorded_trace_file_replays_byte_stable(tmp_path):
    """``kind="file:<path>.jsonl"`` replays recorded traffic: arrivals
    re-based so the earliest is 0, prompt/tenant carried through, and
    trace_json byte-stable (same file in, same trace out)."""
    path = tmp_path / "prod.jsonl"
    path.write_text(RECORDED)
    spec = TraceSpec(kind=f"file:{path}")
    trace = generate_trace(spec)
    assert [e["at"] for e in trace] == [0.0, 0.5, 1.2]
    assert trace[0] == {"id": 1, "at": 0.0, "prompt_ids": [4, 5],
                        "max_new_tokens": 3, "sampled": True,
                        "session": 7, "tenant": ""}
    assert trace[1]["prompt_ids"] == [1, 2, 3]
    assert trace[1]["tenant"] == "acme"
    assert trace[1]["max_new_tokens"] == 16  # default when unrecorded
    assert trace_json(spec) == trace_json(TraceSpec(kind=f"file:{path}"))


def test_recorded_trace_rejects_bad_records(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"timestamp": 0.0}\n')  # no prompt at all
    with pytest.raises(ValueError, match="bad.jsonl:1: bad trace record"):
        generate_trace(TraceSpec(kind=f"file:{bad}"))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n\n")
    with pytest.raises(ValueError, match="empty trace file"):
        generate_trace(TraceSpec(kind=f"file:{empty}"))


# -- held to the JAX package's loadgen ---------------------------------------
SPEC_FIELDS = {
    "poisson": {"duration_s": 3.0, "rate_rps": 15, "max_new_tokens": (24, 48)},
    "chat": {"duration_s": 2.0, "rate_rps": 10, "turns": (2, 3), "prompt_len": (64, 192)},
    "bursty": {"duration_s": 3.0, "rate_rps": 8, "burst_multiplier": 4.0},
    "rag": {"duration_s": 2.5, "rate_rps": 10, "rag_contexts": 4,
            "rag_context_len": (512, 1024), "rag_long_fraction": 0.5},
}


@pytest.mark.parametrize("kind", sorted(SPEC_FIELDS))
@pytest.mark.parametrize("seed", [0, 5, 11, 21, 31])
def test_trace_json_is_byte_equal_to_the_reference(kind, seed):
    fields = {"kind": kind, "seed": seed, **SPEC_FIELDS[kind]}
    got = trace_json(TraceSpec(**fields))
    assert got == ref_loadgen.trace_json(ref_loadgen.TraceSpec(**fields))
    assert json.loads(got)


def test_recorded_trace_json_is_byte_equal_to_the_reference(tmp_path):
    path = tmp_path / "prod.jsonl"
    path.write_text(RECORDED)
    kind = f"file:{path}"
    assert trace_json(TraceSpec(kind=kind)) == ref_loadgen.trace_json(
        ref_loadgen.TraceSpec(kind=kind))


def test_report_dict_equals_the_reference():
    rows = [("completed", 0.1, 1, 24, 0.02), ("completed", 0.31, 1, 30, 0.05),
            ("retried", 0.52, 2, 40, 0.3), ("failed", 9.0, 2, 0, 0.0),
            ("corrupted", 0.2, 1, 0, 0.0), ("hung", 25.0, 1, 0, 0.0),
            ("completed", 0.12345678, 1, 7, 0.0)]
    port = LoadReport(wall_s=3.14159, outcomes=[
        RequestOutcome(id=i, outcome=o, latency_s=lat, attempts=a, tokens=t, ttft_s=tt,
                       received=[1, 2] if o == "corrupted" else [])
        for i, (o, lat, a, t, tt) in enumerate(rows)])
    ref = ref_loadgen.LoadReport(wall_s=3.14159, outcomes=[
        ref_loadgen.RequestOutcome(id=i, outcome=o, latency_s=lat, attempts=a, tokens=t,
                                   ttft_s=tt)
        for i, (o, lat, a, t, tt) in enumerate(rows)])
    assert port.to_dict() == ref.to_dict()
    assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(ref.to_dict(),
                                                                    sort_keys=True)
    for q in (0.5, 0.95, 0.99, 1.0):
        assert port.latency_quantile(q) == ref.latency_quantile(q)
        assert port.ttft_quantile(q) == ref.ttft_quantile(q)
    assert LoadReport().to_dict() == ref_loadgen.LoadReport().to_dict()


def test_default_expected_stream_equals_the_reference():
    from devspace_tpu.serving.stub import token_at as ref_token_at

    trace = generate_trace(TraceSpec(kind="chat", seed=4, duration_s=1.0, rate_rps=8))
    gen = LoadGenerator(lambda: {})
    assert gen.expected_fn is loadgen.stub_stream
    for event in trace:
        want = [ref_token_at(event["prompt_ids"], i) for i in range(event["max_new_tokens"])]
        assert gen.expected_fn(event) == want


def test_expected_fn_and_received_seams():
    """``expected_fn`` replaces the stub's stream: a target streaming 1, 2,
    3 completes when that is what is expected, and is corrupted, carrying
    what it delivered, when it parts from it."""
    trace = generate_trace(TraceSpec(seed=2, duration_s=0.2, rate_rps=10,
                                     max_new_tokens=(3, 3)))
    with _Target(LyingHandler) as target:
        good = LoadGenerator(lambda: {"t": target.url}, hang_timeout_s=5,
                             expected_fn=lambda e: [1, 2, 3]).run(trace, speed=10.0)
        assert good.counts()["completed"] == len(trace)
        assert all(o.received == [] and o.tokens == 3 for o in good.outcomes)
        bad = LoadGenerator(lambda: {"t": target.url}, hang_timeout_s=5,
                            expected_fn=lambda e: [1, 5, 3]).run(trace, speed=10.0)
        assert bad.counts()["corrupted"] == len(trace)
        assert all(o.received == [1, 2, 3] for o in bad.outcomes)
    # received stays out of the report, which matches the reference's keys
    assert set(bad.to_dict()) == set(ref_loadgen.LoadReport().to_dict())
