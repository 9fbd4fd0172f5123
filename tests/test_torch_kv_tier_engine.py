"""The port's engine with its host KV tier on the CPU: the tier must be
invisible in outputs. TINY with the JAX package's weights (bf16, seed 0)
through the converter, the traces of tests/test_kv_tier.py.

- int8 pool: the resident representation is the spill format, so
  restores are exact and streams with the tier on (RAM or disk) equal the
  streams with it off, through spill/restore cycles and under randomized
  admission traces; the counters follow the hand-computed goldens.
- float (bf16) pool: restores dequantize int8 payloads, so equality holds
  on the tie-free trace the reference pins.
- An unpressured pool never touches the tier; no free block carries a
  table reference after spill/restore churn (the ``_pop_block`` check).
- Chaos: a host tier whose reads fail, and payloads corrupted in RAM,
  both fall back to recompute-prefill with the same streams, and a
  corrupt block is never scattered.
- On a float32 TINY copy, the tier's counters over the restore trace are
  the JAX engine's.

Preemption resume and the speculative interleave are ``slow``, as in the
reference.
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
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

CFG = ttfm.TINY
TIMEOUT = 300


@pytest.fixture(scope="module")
def params():
    jparams = jtfm.init_params(jtfm.TINY, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _run(params, reqs, kv_tier="off", waves=None, cfg=CFG, **kw):
    """Serve requests (in sequential waves, to force eviction between
    them, when ``waves`` is given) -> (streams, stats)."""
    defaults = dict(max_slots=2, max_len=64, block_size=8, n_blocks=10,
                    prefill_chunk=8, chunk_max=4)
    defaults.update(kw)
    engine = InferenceEngine(params, cfg, device="cpu", kv_tier=kv_tier, **defaults).start()
    outs = []
    try:
        for lo, hi in waves or [(0, len(reqs))]:
            handles = [engine.submit(**r) for r in reqs[lo:hi]]
            outs.extend(h.result(timeout=TIMEOUT) for h in handles)
        st = engine.stats()
    finally:
        engine.stop()
    return outs, st


def _spill_restore_trace(seed=1, tail=(7, 9)):
    """Seed a prefix, flood it out of the pool, then hit it again: the
    waves force the eviction (spill) and the re-hit (restore)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(2, 200, size=24)]
    reqs = [dict(prompt_ids=shared, max_new_tokens=8)]
    for _ in range(4):
        reqs.append(dict(prompt_ids=[int(t) for t in rng.integers(2, 200, size=24)],
                         max_new_tokens=8))
    reqs.append(dict(prompt_ids=shared + list(tail), max_new_tokens=8))
    return reqs, [(i, i + 1) for i in range(len(reqs))]


_OFF_BASELINES: dict = {}


def _off_baseline(key, params, reqs, waves, **kw):
    if key not in _OFF_BASELINES:
        _OFF_BASELINES[key] = _run(params, reqs, "off", waves, **kw)
    return _OFF_BASELINES[key]


def test_restore_streams_identical_and_saves_recompute(params):
    reqs, waves = _spill_restore_trace()
    kw = dict(max_slots=1, n_blocks=9, kv_dtype="int8")
    off, st_off = _off_baseline("seed1-int8", params, reqs, waves, **kw)
    host, st_host = _run(params, reqs, "host", waves, **kw)
    assert off == host
    assert st_off["kv_tier"] == "off" and st_host["kv_tier"] == "host"
    assert st_host["kv_spill_blocks"] > 0
    assert st_host["kv_restore_hits"] >= 3  # the 24-token shared prefix
    assert st_host["kv_restore_fallbacks"] == 0
    assert st_host["kv_restore_hit_rate"] == 1.0
    assert st_host["recompute_tokens_saved"] == st_host["kv_restore_hits"] * 8
    assert st_host["kv_restores"] == st_host["kv_restore_hits"]
    assert st_off["kv_spill_blocks"] == 0 and st_off["kv_tier_entries"] == 0


def test_float_pool_restore_identical_on_tie_free_trace(params):
    reqs, waves = _spill_restore_trace(tail=(7, 7))
    kw = dict(max_slots=1, n_blocks=9)
    off, _ = _run(params, reqs, "off", waves, **kw)
    host, st = _run(params, reqs, "host", waves, **kw)
    assert off == host
    assert st["kv_restore_hits"] == 3


def test_disk_tier_streams_identical(params, tmp_path):
    reqs, waves = _spill_restore_trace()
    kw = dict(max_slots=1, n_blocks=9, kv_dtype="int8")
    off, _ = _off_baseline("seed1-int8", params, reqs, waves, **kw)
    disk, st = _run(params, reqs, "host+disk", waves, kv_tier_bytes=4096,
                    kv_tier_dir=str(tmp_path), **kw)
    assert off == disk
    assert st["kv_restore_hits"] >= 1
    # the tiny RAM budget forced traffic through the disk level
    assert st["kv_spill_bytes"] > 4096
    assert st["kv_tier"] == "host+disk"


@pytest.mark.parametrize(
    "trial", [0, pytest.param(1, marks=pytest.mark.slow), pytest.param(2, marks=pytest.mark.slow)])
def test_randomized_traces_tier_invariant(params, trial):
    """Randomized admissions, lengths and sampling under pool pressure
    (preemption included), int8 pool at dispatch depth 2: the same
    streams with the tier off and on."""
    rng = np.random.default_rng(7 + trial)
    reqs = []
    for i in range(5):
        n = int(rng.integers(6, 24))
        r = dict(prompt_ids=[int(t) for t in rng.integers(2, 200, size=n)],
                 max_new_tokens=int(rng.integers(4, 20)))
        if i % 2:
            r.update(temperature=0.8, seed=trial * 10 + i, top_k=8)
        reqs.append(r)
    kw = dict(kv_dtype="int8", dispatch_depth=2)
    off, _ = _run(params, reqs, "off", **kw)
    host, _ = _run(params, reqs, "host", **kw)
    assert off == host, f"trial {trial} diverged"


@pytest.mark.slow
def test_preemption_resume_restores_spilled_chain(params):
    """A tight pool and long decodes force preemption; the preempted
    chain is published and spills, and the resumed streams equal the
    tier-off streams (greedy, int8 pool)."""
    rng = np.random.default_rng(2)
    reqs = [dict(prompt_ids=[int(t) for t in rng.integers(2, 200, size=16)],
                 max_new_tokens=24) for _ in range(5)]
    kw = dict(dispatch_depth=2, kv_dtype="int8")
    off, st_off = _run(params, reqs, "off", **kw)
    host, st_host = _run(params, reqs, "host", **kw)
    assert off == host
    assert st_off["requests_preempted"] > 0
    assert st_host["kv_spill_blocks"] > 0


@pytest.mark.slow
def test_speculative_interleave_tier_invariant(params):
    rng = np.random.default_rng(5)
    reqs = [dict(prompt_ids=[int(t) for t in rng.integers(2, 200, size=12)],
                 max_new_tokens=16) for _ in range(4)]
    kw = dict(draft_params=params, draft_cfg=CFG, spec_k=3, dispatch_depth=2)
    off, _ = _run(params, reqs, "off", **kw)
    host, st = _run(params, reqs, "host", **kw)
    assert off == host
    assert st["spec_rounds"] > 0


def test_unpressured_pool_never_touches_tier(params):
    reqs = [dict(prompt_ids=[5, 1, 4, 9], max_new_tokens=8),
            dict(prompt_ids=[2, 3], max_new_tokens=8)]
    off, _ = _run(params, reqs, "off", n_blocks=32)
    host, st = _run(params, reqs, "host", n_blocks=32)
    assert off == host
    assert st["kv_spill_blocks"] == 0 and st["kv_restore_hits"] == 0
    assert st["kv_tier_resident_bytes"] == 0


def test_tier_needs_the_prefix_cache(params, monkeypatch):
    monkeypatch.setenv("DEVSPACE_KV_TIER", "host")
    on = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32)
    off = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32,
                          prefix_cache=False)
    assert on.kv_tier_mode == "host" and on.stats()["kv_tier"] == "host"
    assert off.kv_tier_mode == "off" and off._kv_tier is None
    assert off.export_kv_chain("00" * 16) is None


# -- stats goldens -----------------------------------------------------------
def test_prefix_hit_token_goldens(params):
    """Two identical 16-token prompts, block size 8: the second matches
    one full block (one prompt token is left to prefill)."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
    reqs = [dict(prompt_ids=prompt, max_new_tokens=4), dict(prompt_ids=prompt, max_new_tokens=4)]
    _, st = _run(params, reqs, "host", [(0, 1), (1, 2)], n_blocks=32)
    assert st["prefix_hit_blocks"] == 1
    assert st["prefix_hit_tokens"] == 8
    assert st["recompute_tokens_saved"] == 0
    assert st["kv_restore_hit_rate"] == 0.0


def test_restore_golden_saved_tokens(params):
    """The 24-token shared prefix spills as 3 full blocks; the re-hit
    restores all 3: 24 tokens saved."""
    reqs, waves = _spill_restore_trace()
    _, st = _run(params, reqs, "host", waves, max_slots=1, n_blocks=9)
    assert st["kv_restore_hits"] == 3
    assert st["recompute_tokens_saved"] == 24
    assert st["prefix_hit_tokens"] >= 24


def test_pop_block_zeroes_block_refs_bookkeeping(params):
    reqs, waves = _spill_restore_trace(seed=3)
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=64, block_size=8,
                             n_blocks=9, prefill_chunk=8, chunk_max=4, kv_tier="host").start()
    try:
        for lo, hi in waves:
            for h in [engine.submit(**r) for r in reqs[lo:hi]]:
                h.result(timeout=TIMEOUT)
        assert engine.stats()["kv_spill_blocks"] > 0
        for b in engine._free_blocks:
            assert engine._block_refs.get(b, 0) == 0, f"stale refs for free block {b}"
        for b, refs in engine._block_refs.items():
            assert refs >= 0
    finally:
        engine.stop()


# -- chaos: the degradation ladder -------------------------------------------
def _tiered_engine(params):
    return InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=64, block_size=8,
                           n_blocks=9, prefill_chunk=8, chunk_max=4, kv_tier="host").start()


@pytest.mark.chaos
def test_chaos_restore_failure_degrades_to_recompute(params):
    reqs, waves = _spill_restore_trace()
    off, _ = _off_baseline("seed1-float", params, reqs, waves, max_slots=1, n_blocks=9)
    engine = _tiered_engine(params)
    outs = []
    try:
        def flaky_get(digest):
            raise OSError("injected host-tier failure")

        for i, (lo, hi) in enumerate(waves):
            if i == len(waves) - 1:  # the restore wave
                engine._kv_tier.get = flaky_get
            outs.extend(h.result(timeout=TIMEOUT) for h in [engine.submit(**r) for r in reqs[lo:hi]])
        st = engine.stats()
    finally:
        engine.stop()
    assert outs == off
    assert st["kv_restore_fallbacks"] >= 1
    assert st["kv_restore_hits"] == 0
    assert st["kv_restore_hit_rate"] == 0.0
    assert st["kv_tier_spilled_nodes"] == engine._prefix_cache.spilled_count()


@pytest.mark.chaos
def test_chaos_corrupt_spilled_block_never_scattered(params, monkeypatch):
    """Bits flipped in every spilled payload: the checksum drops them all,
    the restore falls back to recompute with the same stream, and no
    scatter ever runs."""
    reqs, waves = _spill_restore_trace()
    off, _ = _off_baseline("seed1-float", params, reqs, waves, max_slots=1, n_blocks=9)
    engine = _tiered_engine(params)
    scattered = []
    real = engine._restore_chain
    monkeypatch.setattr(engine, "_restore_chain",
                        lambda *a: scattered.append(a[0]) or real(*a))
    outs = []
    try:
        for i, (lo, hi) in enumerate(waves):
            if i == len(waves) - 1:
                tier = engine._kv_tier
                assert len(tier._ram) > 0
                for d, (payload, checksum) in list(tier._ram.items()):
                    bad = bytearray(payload)
                    bad[len(bad) // 2] ^= 0xFF
                    tier._ram[d] = (bytes(bad), checksum)
            outs.extend(h.result(timeout=TIMEOUT) for h in [engine.submit(**r) for r in reqs[lo:hi]])
        st = engine.stats()
        tier_stats = engine._kv_tier.stats()
    finally:
        engine.stop()
    assert outs == off
    assert st["kv_restore_hits"] == 0
    assert st["kv_restore_fallbacks"] >= 1
    assert tier_stats["corrupt_dropped"] >= 1
    assert scattered == []


# -- against the JAX engine --------------------------------------------------
def test_tier_counters_equal_the_jax_engines():
    """float32 TINY, the restore trace, int8 pool: the port's spill,
    restore and hit counters equal the JAX engine's, and so do the
    streams."""
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
    cfg = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    reqs, waves = _spill_restore_trace()
    kw = dict(max_slots=1, max_len=64, block_size=8, n_blocks=9, prefill_chunk=8, chunk_max=4,
              kv_dtype="int8")
    ours, st = _run(tparams, reqs, "host", waves, cfg=cfg, **kw)
    engine = JaxEngine(jparams, jcfg, kv_tier="host", **kw).start()
    try:
        theirs = []
        for lo, hi in waves:
            theirs.extend(h.result(timeout=TIMEOUT) for h in [engine.submit(**r) for r in reqs[lo:hi]])
        jst = engine.stats()
    finally:
        engine.stop()
    keys = ("kv_spill_blocks", "kv_spill_bytes", "kv_restore_hits", "kv_restore_fallbacks",
            "recompute_tokens_saved", "prefix_hit_tokens", "kv_tier_entries",
            "kv_tier_spilled_nodes")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert ours == theirs
