"""The port's overlapped serving loop (devspace_tpu_torch/inference/
dispatch.py) on the CPU, float32 TINY with JAX weights converted through
numpy, mirroring tests/test_engine_dispatch.py: the dispatch-ahead window
must be invisible in outputs — byte-identical streams at depth 1 and
depth 2 (and 4) over greedy, sampled and EOS traces, under pool-pressure
preemption and with a draft — zombie slots release their blocks once the
window drains, the env knob selects the serial loop, a mid-window
failure fails every in-flight request and the pool serves again, and the
port's greedy streams equal the JAX engine's at its defaults (depth 2,
prefix cache on).

On the CPU an in-flight entry never reports itself ready, so the window
fills and the blocking drain runs, as on the card when the host is
ahead. Greedy runs stay under ~30 new tokens, before the exact float32
logit tie this TINY/seed-0 trajectory reaches near 38 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JaxEngine
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.dispatch import resolve_dispatch_depth
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
TIMEOUT = 300


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def reference(jparams):
    cache = {}

    def generate(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = jtfm.generate(jparams, jnp.asarray([prompt], jnp.int32), JCFG, max_new_tokens=n)
            cache[key] = [int(t) for t in out[0]]
        return cache[key]

    return generate


def run_trace(params, depth, reqs, **engine_kwargs):
    """Serve ``reqs`` (submitted up-front, in order) at the given window
    depth -> (results, errors, stats)."""
    engine = InferenceEngine(params, CFG, device="cpu", dispatch_depth=depth,
                             **engine_kwargs).start()
    outs, errs = [], []
    try:
        handles = [engine.submit(**r) for r in reqs]
        for h in handles:
            try:
                outs.append(h.result(timeout=TIMEOUT))
                errs.append(None)
            except RuntimeError as e:
                outs.append(None)
                errs.append(str(e))
        st = engine.stats()
    finally:
        engine.stop()
    return outs, errs, st


# -- equivalence: overlapped vs serial ------------------------------------
def test_overlap_matches_serial_mixed_trace(params, reference):
    """A greedy/sampled/EOS mix streams byte-identically at depth 2 and in
    the serial loop, and the overlap stats surface with sane values."""
    prompt = [5, 1, 4, 9]
    eos_ref = reference(prompt, 8)
    reqs = [
        dict(prompt_ids=[2, 3, 4], max_new_tokens=8),
        dict(prompt_ids=[9, 8], max_new_tokens=7, temperature=0.8, seed=3, top_k=8),
        dict(prompt_ids=prompt, max_new_tokens=8, eos_id=int(eos_ref[2])),
    ]
    kw = dict(max_slots=3, max_len=32, chunk_max=4)
    serial = run_trace(params, 1, reqs, **kw)
    overlap = run_trace(params, 2, reqs, **kw)
    assert all(e is None for e in serial[1] + overlap[1])
    assert overlap[0] == serial[0], "window depth changed a token stream"
    assert serial[0][0] == reference([2, 3, 4], 8)
    assert serial[0][2] == eos_ref[:3]
    st = overlap[2]
    assert st["dispatch_depth"] == 2 and serial[2]["dispatch_depth"] == 1
    assert st["decode_dispatches"] >= 1
    assert st["carry_updates"] >= 1
    assert 1.0 < st["dispatch_depth_occupancy"] <= 2.0  # the window did fill
    assert serial[2]["dispatch_depth_occupancy"] == 1.0
    assert st["readback_wait_s"] >= 0.0
    assert st["host_sched_s"] >= 0.0


@pytest.mark.slow
def test_overlap_matches_serial_randomized_traces(params, reference):
    """Randomized admit/EOS/sampling mix (greedy, temperature, top-k,
    mid-stream EOS learned from the greedy reference, min_new_tokens):
    depth-2 and depth-4 streams equal depth-1 streams token for token,
    and the plain greedy requests equal JAX's generate."""
    rng = np.random.default_rng(7)
    reqs = []
    for t in range(10):
        plen = int(rng.integers(1, 24))
        n = int(rng.integers(2, 14))
        prompt = [int(x) for x in rng.integers(1, CFG.vocab_size, size=plen)]
        r = dict(prompt_ids=prompt, max_new_tokens=n)
        mode = t % 3
        if mode == 1:
            r.update(temperature=0.8, seed=t, top_k=int(rng.integers(0, 8)))
        elif mode == 2:
            ref = reference(prompt, n)
            r.update(eos_id=int(ref[min(2, len(ref) - 1)]))
        if t % 4 == 3:
            r.update(min_new_tokens=2)
        reqs.append(r)
    serial = run_trace(params, 1, reqs, max_slots=3, max_len=64)
    overlap = run_trace(params, 2, reqs, max_slots=3, max_len=64)
    deep = run_trace(params, 4, reqs, max_slots=3, max_len=64)
    assert all(e is None for e in serial[1] + overlap[1] + deep[1])
    assert overlap[0] == serial[0], "window depth changed a token stream"
    assert deep[0] == serial[0], "deeper window changed a token stream"
    for r, got in zip(reqs, serial[0]):
        if not r.get("temperature") and "eos_id" not in r and "min_new_tokens" not in r:
            assert got == reference(r["prompt_ids"], r["max_new_tokens"])
    assert deep[2]["dispatch_depth"] == 4
    assert 0.0 < overlap[2]["dispatch_depth_occupancy"] <= 2.0


@pytest.mark.slow
def test_overlap_matches_serial_under_preemption(params, reference):
    """Oversubscribed pool (6 usable 8-token blocks, 4-5 needed per
    sequence): the preemption
    ladder fires in both loops, and the greedy streams equal the serial
    run's and JAX's generate — the overlapped ladder settles the window
    before evicting anything."""
    p1, p2 = [2, 3, 4, 5], [9, 8, 7]
    reqs = [dict(prompt_ids=p, max_new_tokens=30) for p in (p1, p2, p1, p2)]
    kw = dict(max_slots=2, max_len=48, block_size=8, n_blocks=7, prefill_chunk=8)
    serial = run_trace(params, 1, reqs, **kw)
    overlap = run_trace(params, 2, reqs, **kw)
    assert all(e is None for e in serial[1] + overlap[1])
    assert overlap[0] == serial[0]
    assert overlap[2]["requests_preempted"] >= 1, "trace did not exercise pool pressure"
    for r, got in zip(reqs, serial[0]):
        assert got == reference(r["prompt_ids"], r["max_new_tokens"])


@pytest.mark.slow
def test_sampled_overlap_matches_serial_under_preemption(params):
    """Sampled streams survive preemption whatever its schedule: the draw
    for committed token k is keyed by (seed, position) alone, so the
    depth-2 streams under pool pressure equal the serial loop's."""
    p1, p2 = [2, 3, 4, 5], [9, 8, 7]
    reqs = [
        dict(prompt_ids=p, max_new_tokens=40, temperature=0.8, seed=11 + n, top_k=8)
        for n, p in enumerate((p1, p2, p1, p2))
    ]
    kw = dict(max_slots=2, max_len=64, block_size=8, n_blocks=10, prefill_chunk=8)
    serial = run_trace(params, 1, reqs, **kw)
    overlap = run_trace(params, 2, reqs, **kw)
    assert all(e is None for e in serial[1] + overlap[1])
    assert overlap[0] == serial[0], "sampled stream moved with the preemption schedule"
    assert overlap[2]["requests_preempted"] >= 1, "trace did not exercise pool pressure"


@pytest.mark.slow
def test_overlap_with_speculative_engine(params, reference):
    """Spec rounds interleave with the window (drain before a spec
    round): greedy speculative decoding stays lossless at depth 2."""
    reqs = [dict(prompt_ids=[5, 1, 4], max_new_tokens=10),
            dict(prompt_ids=[2, 2, 2, 2], max_new_tokens=8),
            dict(prompt_ids=[7, 3], max_new_tokens=9, logit_bias={17: 1.5})]  # plain path
    kw = dict(max_slots=2, max_len=64, draft_params=params, draft_cfg=CFG, spec_k=3)
    serial = run_trace(params, 1, reqs, **kw)
    overlap = run_trace(params, 2, reqs, **kw)
    assert overlap[0] == serial[0]
    for r, got in zip(reqs[:2], serial[0]):
        assert got == reference(r["prompt_ids"], r["max_new_tokens"])
    assert overlap[2]["spec_rounds"] > 0 and overlap[2]["decode_dispatches"] > 0


def test_zombie_slot_blocks_freed_after_window_drain(params, reference):
    """A slot that finishes (EOS) while later chunks are in flight is a
    zombie: its blocks are released once the window drains, and the slot
    is re-admitted — no leaks, and the next request exact."""
    prompt = [5, 9, 2]
    ref = reference(prompt, 24)
    eos = ref[2]  # fires mid-chunk with dispatch-ahead chunks in flight
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=64,
                             dispatch_depth=2)
    h1 = engine.submit(prompt, 24, eos_id=eos)
    h2 = engine.submit([3, 3], 4)
    engine.start()
    try:
        assert h1.result(timeout=TIMEOUT) == ref[: ref.index(eos) + 1]
        assert h2.result(timeout=TIMEOUT) == reference([3, 3], 4)
        st = engine.stats()
    finally:
        engine.stop()
    assert st["free_blocks"] == st["total_blocks"], "zombie leaked blocks"
    assert engine._dispatcher.in_flight == 0
    assert not engine._dispatcher.pending_free


def test_prefill_round_robin_rotation(params, monkeypatch):
    """The prefill pick rotates over prefilling slots instead of always
    taking the lowest index."""
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=3, max_len=64, prefill_chunk=4)
    order = []
    orig = engine._prefill_one_chunk

    def spy(i):
        order.append(i)
        return orig(i)

    monkeypatch.setattr(engine, "_prefill_one_chunk", spy)
    prompts = [np.random.default_rng(i).integers(1, CFG.vocab_size, size=16).tolist()
               for i in range(3)]
    handles = [engine.submit(p, 2) for p in prompts]
    engine.start()
    try:
        for h in handles:
            h.result(timeout=TIMEOUT)
    finally:
        engine.stop()
    assert order[:12] == [0, 1, 2] * 4, f"prefill starved: {order[:12]}"


def test_stream_through_engine_delivers_all_tokens(params):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=64,
                             dispatch_depth=2).start()
    try:
        h = engine.submit([5, 1, 4], 9)
        streamed = list(h.stream(timeout=120))
        assert streamed == h.result(timeout=1)
    finally:
        engine.stop()


def test_overlap_env_escape_hatch(params, monkeypatch):
    monkeypatch.setenv("DEVSPACE_ENGINE_OVERLAP", "off")
    assert resolve_dispatch_depth(None) == 1
    assert InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32).dispatch_depth == 1
    monkeypatch.delenv("DEVSPACE_ENGINE_OVERLAP")
    assert resolve_dispatch_depth(None) == 2
    assert InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32).dispatch_depth == 2
    monkeypatch.setenv("DEVSPACE_ENGINE_OVERLAP", "3")
    assert resolve_dispatch_depth(None) == 3
    assert resolve_dispatch_depth(4) == 4  # an explicit argument wins
    with pytest.raises(ValueError):
        InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32, dispatch_depth=0)


@pytest.mark.chaos
def test_chaos_mid_window_decode_failure_fails_all_in_flight(params, reference):
    """A fault on the SECOND decode dispatch, while the first is still in
    flight: the whole window is abandoned (both resident requests fail),
    the pool is zeroed in place, and fresh traffic is served exactly
    through the same programs."""
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=64,
                             dispatch_depth=2)
    calls = {"n": 0}
    real = engine._programs.run

    def flaky(key):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode fault")
        return real(key)

    engine._programs.run = flaky
    h1 = engine.submit([5, 1, 4], 24)
    h2 = engine.submit([2, 9], 24)
    engine.start()
    try:
        with pytest.raises(RuntimeError, match="decode failed"):
            h1.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="decode failed"):
            h2.result(timeout=TIMEOUT)
        got = engine.submit([7, 7, 7], 6).result(timeout=TIMEOUT)
        st = engine.stats()
    finally:
        engine.stop()
    assert got == reference([7, 7, 7], 6)
    assert st["requests_failed"] == 2 and st["requests_completed"] == 1
    assert st["free_blocks"] == st["total_blocks"]
    assert engine._dispatcher.in_flight == 0 and not engine._dispatcher.pending_free


def test_greedy_streams_equal_jax_engine_defaults(params, jparams, reference):
    """The port and the JAX engine, both at their defaults (depth-2
    window, prefix cache on), on one greedy trace with more requests than
    slots, a shared 2-block prefix and an EOS: the same streams."""
    rng = np.random.default_rng(21)
    shared = rng.integers(1, CFG.vocab_size, size=20).tolist()
    eos = reference([5, 1, 4], 14)[5]
    reqs = [
        (shared + [7, 8], 10, {}),
        (rng.integers(1, CFG.vocab_size, size=5).tolist(), 12, {}),
        (shared + [9], 8, {}),
        ([5, 1, 4], 14, {"eos_id": eos}),
        (shared + [1, 2, 3], 6, {}),
    ]

    def serve(engine):
        # the first request alone, so the others find its prefix cached
        engine.start()
        try:
            outs = [engine.submit(reqs[0][0], reqs[0][1]).result(timeout=TIMEOUT)]
            handles = [engine.submit(p, n, **kw) for p, n, kw in reqs[1:]]
            outs += [h.result(timeout=TIMEOUT) for h in handles]
            return outs, engine.stats()
        finally:
            engine.stop()

    kw = dict(max_slots=2, max_len=64, block_size=8)
    jax_out, jst = serve(JaxEngine(jparams, JCFG, **kw))
    torch_out, st = serve(InferenceEngine(params, CFG, device="cpu", **kw))
    assert torch_out == jax_out
    assert torch_out[3][-1] == eos and len(torch_out[3]) <= 6
    assert st["dispatch_depth"] == jst["dispatch_depth"] == 2
    assert st["prefix_hit_blocks"] > 0 and jst["prefix_hit_blocks"] > 0
