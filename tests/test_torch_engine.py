"""The port's continuous-batching engine on the CPU (float32 TINY, JAX
weights converted through numpy) against the JAX package's greedy
``generate`` — the oracle the JAX engine itself is held to
(tests/test_inference.py). Greedy streams must be equal token for token;
every run stays under ~30 new tokens, before the exact float32 logit
tie this TINY/seed-0 trajectory reaches near 38 tokens.

Sampled streams cannot match JAX's threefry bits; they are held to the
port's own invariants (chunk size, preemption) and to the filter
semantics of ``speculative.filter_scaled_logits``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference.speculative import filter_scaled_logits as jax_filter
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.sampling import filter_scaled_logits, gumbel_noise
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
TIMEOUT = 120


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


def run(params, requests, **engine_kwargs):
    """Submit (prompt, n, kwargs) requests concurrently; results + stats."""
    engine = InferenceEngine(params, CFG, device="cpu", **engine_kwargs).start()
    try:
        handles = [engine.submit(p, n, **kw) for p, n, kw in requests]
        results = [h.result(timeout=TIMEOUT) for h in handles]
        return results, engine.stats()
    finally:
        engine.stop()


def test_engine_matches_jax_generate(params, reference):
    """Different prompt and generation lengths, more requests than slots
    (queuing + slot reuse): every stream equals JAX's greedy generate."""
    rng = np.random.default_rng(0)
    requests = [
        (rng.integers(1, CFG.vocab_size, size=plen).tolist(), n, {})
        for plen, n in [(3, 8), (7, 5), (1, 10), (12, 4), (5, 6)]
    ]
    results, st = run(params, requests, max_slots=2, max_len=64)
    for (prompt, n, _), got in zip(requests, results):
        assert got == reference(prompt, n), f"prompt len {len(prompt)} diverged"
    assert st["requests_completed"] == 5 and st["tokens_generated"] == 33
    assert st["free_blocks"] == st["total_blocks"], "leaked blocks"


def test_engine_eos_early_stop_and_slot_reuse(params, reference):
    prompt = [5, 9, 2]
    eos = reference(prompt, 6)[0]
    results, _ = run(params, [(prompt, 6, {"eos_id": eos}), ([3, 3], 2, {})],
                     max_slots=1, max_len=64)
    assert results == [[eos], reference([3, 3], 2)]


def test_engine_rejects_oversized_and_empty(params):
    engine = InferenceEngine(params, CFG, max_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        engine.submit(list(range(1, 15)), 10)
    with pytest.raises(ValueError):
        engine.submit([], 4)
    with pytest.raises(ValueError):
        engine.submit([CFG.vocab_size], 1)


@pytest.mark.parametrize("stop_kind", ["single", "multi", "two-lists"])
def test_stop_sequences_end_generation_and_are_stripped(params, reference, stop_kind):
    prompt = [5, 1, 4]
    full = reference(prompt, 10)
    stop = {"single": [[full[3]]], "multi": [full[2:4]], "two-lists": [[999], full[2:4]]}[stop_kind]
    (got,), _ = run(params, [(prompt, 10, {"stop": stop})], max_slots=2, max_len=32)
    assert got == full[: 4 - len(stop[-1])]


def test_min_new_tokens_suppresses_eos(params, reference):
    prompt = [5, 1, 4]
    first = reference(prompt, 1)[0]
    (bare, held), _ = run(
        params,
        [(prompt, 8, {"eos_id": first}), (prompt, 8, {"eos_id": first, "min_new_tokens": 5})],
        max_slots=2, max_len=32,
    )
    assert bare == [first]
    assert len(held) >= 5 and first not in held[:5]


def test_stop_match_never_strips_below_min_new_tokens(params):
    A = 7
    (out,), _ = run(params, [([1, 2], 10, {"stop": [[A, A]], "min_new_tokens": 3,
                                           "logit_bias": {A: 100.0}})], max_slots=1, max_len=64)
    assert out == [A, A, A]


def test_logit_bias_forces_and_forbids(params, reference):
    prompt = [5, 1, 4]
    free = reference(prompt, 6)
    (forced, forbidden), _ = run(
        params,
        [(prompt, 6, {"logit_bias": {17: 1e9}}),
         (prompt, 6, {"logit_bias": {free[0]: float("-inf")}})],
        max_slots=2, max_len=32,
    )
    assert forced == [17] * 6
    assert free[0] not in forbidden


def test_multi_chunk_prefill_matches_jax(params, reference):
    prompt = np.random.default_rng(3).integers(1, CFG.vocab_size, size=20).tolist()
    (got,), _ = run(params, [(prompt, 6, {})], max_slots=1, max_len=64, prefill_chunk=8)
    assert got == reference(prompt, 6)


def test_preemption_keeps_greedy_streams_exact(params, reference):
    """6 usable 8-token blocks, 5 needed per sequence: the co-resident
    sequences contend, the youngest is preempted and resumed by
    re-prefilling its prompt plus what it had generated."""
    p1, p2 = [2, 3, 4, 5], [9, 8, 7]
    results, st = run(params, [(p1, 30, {}), (p2, 30, {})], max_slots=2, max_len=48,
                      block_size=8, n_blocks=7, prefill_chunk=8)
    assert results == [reference(p1, 30), reference(p2, 30)]
    assert st["requests_preempted"] >= 1
    assert st["free_blocks"] == st["total_blocks"], "leaked blocks"


def test_sampled_streams_invariant_to_chunking_and_preemption(params):
    reqs = [
        ([2, 3, 4, 5], 24, {"temperature": 0.9, "seed": 11}),
        ([9, 8, 7], 24, {"temperature": 0.8, "top_p": 0.9, "seed": 12}),
        ([6, 1], 20, {"temperature": 1.2, "top_k": 20, "seed": 13}),
    ]
    base, _ = run(params, reqs, max_slots=3, max_len=48, block_size=8)
    chunk1, _ = run(params, reqs, max_slots=3, max_len=48, block_size=8, chunk_max=1)
    preempted, st = run(params, reqs, max_slots=3, max_len=48, block_size=8, n_blocks=8,
                        prefill_chunk=8)
    assert st["requests_preempted"] >= 1
    assert base == chunk1 == preempted
    for (_, n, _), toks in zip(reqs, base):
        assert len(toks) == n and all(0 <= t < CFG.vocab_size for t in toks)
    # a different seed draws a different stream
    other, _ = run(params, [(reqs[0][0], 24, {"temperature": 0.9, "seed": 99})],
                   max_slots=1, max_len=48)
    assert other[0] != base[0]


def test_filter_semantics_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 256)).astype(np.float32) * 3
    temps = np.array([0.7, 1.0, 1.3, 0.5, 1.0, 2.0], np.float32)
    top_k = np.array([0, 5, 0, 40, 1, 10], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.95, 1.0, 0.3], np.float32)
    got = filter_scaled_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                               torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    for i in range(len(logits)):
        ref = np.asarray(jax_filter(jnp.asarray(logits[i]), temps[i], top_k[i], top_p[i]))
        np.testing.assert_array_equal(np.isfinite(got[i]), np.isfinite(ref))
        keep = np.isfinite(ref)
        np.testing.assert_allclose(got[i][keep], ref[keep], rtol=1e-6)


def test_gumbel_noise_is_positional_and_well_formed():
    seeds = torch.tensor([1, 1, 2])
    pos = torch.tensor([5, 6, 5])
    g = gumbel_noise(seeds, pos, 4096)
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g[:1], gumbel_noise(seeds[:1], pos[:1], 4096))
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    # standard Gumbel: mean is the Euler-Mascheroni constant, var pi^2/6
    assert abs(g.mean().item() - 0.5772) < 0.05
    assert abs(g.var().item() - 1.6449) < 0.15
