"""Three host functions of the port held against the JAX package's:
``ServingTelemetry.export_chrome`` writes the same Chrome-trace events on
the same fake-clock traffic, ``resilience.policy.retry`` retries as the
reference's decorator does, and ``inference.prefix_cache.microbench``
returns the reference's keys at a small size."""

import json
import time
from types import SimpleNamespace

import pytest

from devspace_tpu.inference import prefix_cache as jpc
from devspace_tpu.obs.request_trace import ServingTelemetry as JTelemetry
from devspace_tpu.resilience import policy as jpolicy
from devspace_tpu_torch.inference import prefix_cache as pc
from devspace_tpu_torch.obs.request_trace import ServingTelemetry
from devspace_tpu_torch.resilience import policy


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def chrome_events(cls, dest, monkeypatch) -> tuple:
    """Three completed requests and one failed one through ``cls``, at a
    fixed wall clock and with a traceparent each, exported."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    clock = FakeClock()
    tel = cls(clock=clock)
    for i in range(4):
        r = SimpleNamespace(prompt_ids=list(range(4 + i)), max_new_tokens=8,
                            traceparent=f"00-{i + 1:032x}-{i + 7:016x}-01")
        tel.on_submit(r)
        clock.t += 1.0
        tel.on_admit(r)
        clock.t += 0.5
        tel.on_prefill_done(r)
        for _ in range(i + 1):
            clock.t += 0.25
            tel.on_emit(r)
        tel.on_finish(r, "failed" if i == 3 else "completed")
    n = tel.export_chrome(str(dest))
    with open(dest) as fh:
        return n, json.load(fh)


def test_export_chrome_equals_the_jax_packages(tmp_path, monkeypatch):
    ours = chrome_events(ServingTelemetry, tmp_path / "ours.json", monkeypatch)
    theirs = chrome_events(JTelemetry, tmp_path / "theirs.json", monkeypatch)
    assert ours == theirs
    n, trace = ours
    events = trace["traceEvents"]
    assert len(events) == n == 16  # queue_wait, prefill, decode and the request, each
    assert {e["name"] for e in events} >= {"queue_wait", "prefill", "decode", "request-1"}
    assert all(e["ph"] == "X" for e in events)
    assert [e["args"]["ok"] for e in events if e["name"] == "request-4"] == [False]


def test_export_chrome_of_an_empty_ring(tmp_path):
    dest = tmp_path / "empty.json"
    assert ServingTelemetry(clock=FakeClock()).export_chrome(str(dest)) == 0
    assert json.loads(dest.read_text()) == {"traceEvents": []}


def run_decorated(mod, fails: int, max_attempts: int):
    calls = []
    pol = mod.RetryPolicy(max_attempts=max_attempts, base_delay=0.001)

    @mod.retry(pol)
    def flaky(x, scale=1):
        """Fails ``fails`` times, then answers."""
        calls.append(x)
        if len(calls) <= fails:
            raise OSError(f"attempt {len(calls)}")
        return x * scale

    try:
        out = ("ok", flaky(3, scale=2))
    except mod.RetryExhausted as exc:
        out = ("exhausted", str(exc), exc.attempts, type(exc.last).__name__)
    return out, calls, flaky.__name__, flaky.__doc__


@pytest.mark.parametrize("fails", [0, 1, 2, 5])
def test_retry_decorator_equals_the_jax_packages(fails):
    ours = run_decorated(policy, fails, 3)
    assert ours == run_decorated(jpolicy, fails, 3)
    (status, *rest), calls, name, doc = ours
    assert name == "flaky" and doc.startswith("Fails")
    if fails < 3:
        assert (status, rest) == ("ok", [6]) and calls == [3] * (fails + 1)
    else:
        assert status == "exhausted" and "flaky failed after 3 attempt(s)" in rest[0]


def test_retry_decorator_as_the_reference_tests_it():
    calls = {"n": 0}

    @policy.retry(policy.RetryPolicy(max_attempts=3, base_delay=0.0))
    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise OSError("once")
        return 7

    assert flaky() == 7
    assert calls["n"] == 2


def test_retry_decorator_describe_names_the_operation():
    @policy.retry(policy.RetryPolicy(max_attempts=2, base_delay=0.0), describe="push image")
    def push():
        raise OSError("down")

    with pytest.raises(policy.RetryExhausted, match="push image failed after 2"):
        push()


def test_microbench_returns_the_jax_packages_keys():
    kw = dict(n_entries=256, prompt_tokens=512, block_size=64, n_match=4, n_evict=4,
              include_flat=True)
    ours, theirs = pc.microbench(**kw), jpc.microbench(**kw)
    assert set(ours) == set(theirs) == {"radix", "flat"}
    for name in ours:
        assert set(ours[name]) == set(theirs[name]) == {"entries", "match_us", "evict_us"}
        assert ours[name]["entries"] == theirs[name]["entries"] == 256
        assert ours[name]["match_us"] > 0 and ours[name]["evict_us"] > 0
    assert set(pc.microbench(n_entries=64, prompt_tokens=256, n_match=2, n_evict=2)) == {"radix"}
