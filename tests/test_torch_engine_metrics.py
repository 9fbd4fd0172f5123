"""The port's engine telemetry against the JAX engine's, on the CPU:
float32 TINY, the same converted weights, the same greedy requests (a
pair that contends for a 4-block pool so one is preempted, queued before
the scheduler starts; then two requests sharing a 16-token prefix, one
after the other), at dispatch depth 1, so both engines schedule them
alike whatever the host's load.

- the registries hold the same families: names, kinds, help text and
  label names, the ``engine_*`` ones and the request-latency ones;
- the deterministic counters are equal: completed, failed, preempted,
  tokens, prefix hit tokens and blocks, KV blocks and ``max_slots``;
  and so are the streams;
- the latency histograms have the same bucket edges;
- ``metrics=False`` renders an empty exposition and leaves ``stats()``
  as it is with metrics on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JEngine
from devspace_tpu.inference import engine as jengine_mod
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference import engine as tengine_mod
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
from devspace_tpu_torch.obs.fleet import parse_exposition

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
# depth 1: each chunk is read back before the next, so no readiness race
# on the host's clock decides when a slot finishes (and so where the
# preemption falls and what the prefix cache holds then)
ENGINE = dict(max_slots=2, max_len=32, block_size=8, n_blocks=5, prefill_chunk=8,
              dispatch_depth=1)
PREFIX = list(range(3, 19))
PHASES = [
    # 3 and 4 blocks, 4 allocatable: the younger is preempted. The first
    # stops at 17 tokens, short of a near tie that the JAX engine on the
    # CPU breaks either way from run to run (its 19th token)
    [([2, 3, 4, 5], 17), ([9, 8, 7], 28)],
    [(PREFIX + [40, 41, 42], 6)],
    [(PREFIX + [50, 51], 6)],
]
DETERMINISTIC = ("requests_completed", "requests_failed", "requests_preempted",
                 "tokens_generated", "prefix_hit_tokens", "prefix_hit_blocks", "total_blocks",
                 "max_slots")


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


def drive(engine):
    # the first phase is queued whole before the scheduler runs, so its
    # requests are admitted together; the later ones go one at a time
    pending = [engine.submit(p, n) for p, n in PHASES[0]]
    engine.start()
    try:
        streams = [[int(t) for t in h.result(timeout=300)] for h in pending]
        for phase in PHASES[1:]:
            handles = [engine.submit(p, n) for p, n in phase]
            streams += [[int(t) for t in h.result(timeout=300)] for h in handles]
        return streams, engine.stats()
    finally:
        engine.stop()


def families(registry):
    """{name: (kind, help, label names)} of a registry's exposition."""
    out = {}
    for name, fam in parse_exposition(registry.render()).items():
        labels = sorted({k for lb, _ in fam["samples"] for k in lb if k != "le"})
        out[name] = (fam["kind"], fam["help"], tuple(labels))
    return out


@pytest.fixture(scope="module")
def runs(jparams):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JEngine(jparams, JCFG, metrics=True, **ENGINE)
    teng = InferenceEngine(params, CFG, device="cpu", metrics=True, **ENGINE)
    toff = InferenceEngine(params, CFG, device="cpu", metrics=False, **ENGINE)
    out = {"jax": drive(jeng), "torch": drive(teng), "off": drive(toff)}
    out["engines"] = {"jax": jeng, "torch": teng, "off": toff}
    return out


def test_family_sets_are_equal(runs):
    jreg = runs["engines"]["jax"].metrics_registry
    treg = runs["engines"]["torch"].metrics_registry
    jf, tf = families(jreg), families(treg)
    assert tf == jf
    engine_families = {n for n in tf if n.startswith("engine_")}
    assert engine_families == {f[0] for f in tengine_mod.ENGINE_METRIC_FAMILIES}
    assert tengine_mod.ENGINE_METRIC_FAMILIES == jengine_mod.ENGINE_METRIC_FAMILIES
    assert {"ttft_seconds", "tpot_seconds", "queue_wait_seconds", "prefill_seconds",
            "request_e2e_seconds", "requests_finished_total"} <= set(tf)
    # the port's own counters stay in stats() alone
    for port_only in ("graph_captures", "paged_decode_launches", "spec_launch_s"):
        assert port_only in runs["torch"][1]
        assert not any(port_only in n for n in tf)


def test_deterministic_counters_and_streams_are_equal(runs):
    (jstreams, jst), (tstreams, tst) = runs["jax"], runs["torch"]
    assert tstreams == jstreams
    assert {k: tst[k] for k in DETERMINISTIC} == {k: jst[k] for k in DETERMINISTIC}
    assert tst["requests_preempted"] >= 1 and tst["prefix_hit_blocks"] >= 2
    assert tst["requests_completed"] == 4 and tst["requests_failed"] == 0
    # and the exposition carries the stats() values
    snap = runs["engines"]["torch"].metrics_registry.snapshot()
    for name, key in (("engine_tokens_generated_total", "tokens_generated"),
                      ("engine_prefix_hit_tokens_total", "prefix_hit_tokens"),
                      ("engine_requests_preempted_total", "requests_preempted"),
                      ("engine_kv_blocks", "total_blocks")):
        assert snap[name]["samples"][0][1] == tst[key], name
    finished = dict((lb["outcome"], v) for lb, v in snap["requests_finished_total"]["samples"])
    assert finished == {"completed": 4.0}


def test_histogram_bucket_edges_are_identical(runs):
    jsnap = runs["engines"]["jax"].metrics_registry.snapshot()
    tsnap = runs["engines"]["torch"].metrics_registry.snapshot()
    for name in ("ttft_seconds", "tpot_seconds", "queue_wait_seconds", "prefill_seconds",
                 "request_e2e_seconds", "engine_kv_restore_seconds",
                 "engine_kv_migrate_seconds"):
        (_, jv), = jsnap[name]["samples"]
        (_, tv), = tsnap[name]["samples"]
        assert [le for le, _ in tv["buckets"]] == [le for le, _ in jv["buckets"]], name
    (_, ttft), = tsnap["ttft_seconds"]["samples"]
    assert ttft["count"] == 4


def test_metrics_off_renders_nothing_and_keeps_stats(runs):
    off = runs["engines"]["off"]
    assert off.telemetry is None and off.metrics_registry is None
    assert off.metrics_text() == ""
    (ostreams, ost), (tstreams, tst) = runs["off"], runs["torch"]
    assert ostreams == tstreams
    assert set(ost) == set(tst)
    assert {k: ost[k] for k in DETERMINISTIC} == {k: tst[k] for k in DETERMINISTIC}


def test_request_traces_follow_the_lifecycle(runs):
    tel = runs["engines"]["torch"].telemetry
    rows = tel.recent(16)
    assert len(rows) == 4 and all(r["outcome"] == "completed" for r in rows)
    assert sum(r["preemptions"] for r in rows) == runs["torch"][1]["requests_preempted"]
    names = [e[0] for e in rows[0]["events"]]
    assert names[0] == "enqueue" and "admit" in names and "prefill_done" in names
    assert "first_token" in names and names[-1] == "completed"
