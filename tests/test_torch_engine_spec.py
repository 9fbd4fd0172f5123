"""The port's engine with a draft model on the CPU (float32 TINY, JAX
weights converted through numpy), mirroring the speculative engine tests
of tests/test_inference.py: greedy streams equal the JAX package's
``generate`` (and so the port's engine without a draft) token for token
through queuing, slot reuse, preemption and the max_len boundary;
acceptance with draft == target; sampled neighbours; validation; the
counters in ``stats()``.

Every run stays under ~30 new tokens, before the exact float32 logit tie
this TINY/seed-0 trajectory reaches near 38 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
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
def other():
    jother = jtfm.init_params(JCFG, jax.random.PRNGKey(123))
    return params_from_numpy(jax.tree.map(np.asarray, jother), "cpu")


@pytest.fixture(scope="module")
def reference(jparams):
    def generate(prompt, n):
        out = jtfm.generate(jparams, jnp.asarray([prompt], jnp.int32), JCFG, max_new_tokens=n)
        return [int(t) for t in out[0]]

    return generate


def run(params, requests, **engine_kwargs):
    engine = InferenceEngine(params, CFG, device="cpu", **engine_kwargs).start()
    try:
        handles = [engine.submit(p, n, **kw) for p, n, kw in requests]
        return [h.result(timeout=TIMEOUT) for h in handles], engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_speculative_matches_generate(params, other, reference, depth):
    """An UNRELATED draft, whose proposals are mostly rejected: still
    greedy-lossless through queuing, slot reuse and mixed lengths."""
    rng = np.random.default_rng(3)
    requests = [(rng.integers(1, CFG.vocab_size, size=plen).tolist(), n, {})
                for plen, n in [(3, 8), (7, 5), (1, 10), (12, 4), (5, 6)]]
    results, st = run(params, requests, max_slots=2, max_len=64,
                      draft_params=other, draft_cfg=CFG, spec_k=4, spec_depth=depth)
    for (prompt, n, _), got in zip(requests, results):
        assert got == reference(prompt, n), f"prompt len {len(prompt)} diverged with spec on"
    assert st["spec_rounds"] > 0 and st["spec_committed"] > 0
    assert st["draft_prefills"] == 5 and st["spec_dispatches"] > 0
    assert st["free_blocks"] == st["total_blocks"], "leaked blocks"


def test_engine_with_draft_equals_engine_without(params, other):
    requests = [([5, 1, 4], 20, {}), ([2, 9, 9], 16, {}), (list(range(1, 30)), 12, {})]
    plain, st0 = run(params, requests, max_slots=3, max_len=64)
    spec, st1 = run(params, requests, max_slots=3, max_len=64,
                    draft_params=other, draft_cfg=CFG, spec_k=3)
    assert spec == plain
    assert st0["spec_rounds"] == 0 and st0["draft_prefills"] == 0 and st0["spec_acceptance"] == 0.0
    assert st1["spec_rounds"] > 0 and st1["decode_steps"] == 0  # every slot rode spec
    # the host clock over a dispatch's parts runs only in spec rounds
    assert st0["spec_draft_s"] == st0["spec_verify_s"] == st0["spec_readback_s"] == 0.0
    assert st1["spec_draft_s"] > 0 and st1["spec_verify_s"] > 0
    assert 0 <= st1["spec_readback_s"] <= st1["readback_wait_s"]


def test_engine_speculative_acceptance_with_matching_draft(params, reference):
    """Draft == target: proposals are accepted almost always even with
    several slots speccing at once — the guard for the parked-slot
    draft-cache corruption (a spec round in the iteration of a peer's
    draft prefill overwriting its freshly seeded row)."""
    reqs = [([5, 1, 4], 12, {}), ([2, 9, 9], 12, {}), ([7, 3], 10, {})]
    results, st = run(params, reqs, max_slots=2, max_len=64,
                      draft_params=params, draft_cfg=CFG, spec_k=3)
    for (p, n, _), got in zip(reqs, results):
        assert got == reference(p, n)
    assert st["spec_acceptance"] > 0.8, st
    assert st["spec_committed"] > 2 * st["spec_rounds"]


def test_engine_speculative_with_preemption(params, reference):
    """An oversubscribed pool (6 usable 8-token blocks, 5 needed per
    sequence) preempts and resumes mid-generation; the resumed slot
    prefills BOTH models again and every result stays exact."""
    p1, p2 = [2, 3, 4, 5], [9, 8, 7]
    results, st = run(params, [(p1, 30, {}), (p2, 30, {})], max_slots=2, max_len=48,
                      block_size=8, n_blocks=7, prefill_chunk=8,
                      draft_params=params, draft_cfg=CFG, spec_k=3)
    assert results == [reference(p1, 30), reference(p2, 30)]
    assert st["requests_preempted"] >= 1 and st["draft_prefills"] >= 3
    assert st["free_blocks"] == st["total_blocks"], "leaked blocks"


def test_engine_speculative_mixed_sampling_and_boundary(params, reference):
    """A greedy request whose generation crosses the eligibility boundary
    (length + k > max_len) finishes on the plain path, still exact, beside
    a greedy and a sampled neighbour."""
    prompt = np.random.default_rng(5).integers(1, 200, size=20).tolist()
    results, st = run(params, [(prompt, 12, {}),  # 20 + 12 = max_len
                               ([5, 1, 4], 10, {}),
                               ([4, 8], 10, {"temperature": 0.8, "seed": 7})],
                      max_slots=3, max_len=32, draft_params=params, draft_cfg=CFG, spec_k=4)
    assert results[0] == reference(prompt, 12)
    assert results[1] == reference([5, 1, 4], 10)
    assert len(results[2]) == 10 and all(0 <= t < CFG.vocab_size for t in results[2])
    assert st["requests_completed"] == 3 and st["requests_failed"] == 0
    assert st["spec_rounds"] > 0 and st["decode_steps"] > 0  # both paths ran


def test_extras_keep_a_slot_on_the_plain_path(params, reference):
    """logit_bias slots never ride spec (no draft prefill either);
    min_new_tokens slots join once past their minimum."""
    prompt = [5, 1, 4]
    first = reference(prompt, 1)[0]
    results, st = run(params, [(prompt, 6, {"logit_bias": {17: 1e9}})], max_slots=1, max_len=32,
                      draft_params=params, draft_cfg=CFG, spec_k=3)
    assert results == [[17] * 6] and st["spec_rounds"] == 0 and st["draft_prefills"] == 0
    (held,), st = run(params, [(prompt, 12, {"eos_id": first, "min_new_tokens": 5})],
                      max_slots=1, max_len=32, draft_params=params, draft_cfg=CFG, spec_k=3)
    assert len(held) >= 5 and first not in held[:5]
    assert st["draft_prefills"] == 1 and st["decode_steps"] >= 4


def test_draft_prefill_pads_to_a_power_of_two_bucket(params, monkeypatch):
    """Prompts of 5 and 20 tokens prefill the draft at 8 and 32 (the
    bucket clamps at max_len), padded with token 0."""
    seen = []
    real = ttfm.forward

    def spy(p, tokens, cfg, **kw):
        if kw.get("return_kv"):
            seen.append(tokens[0].tolist())
        return real(p, tokens, cfg, **kw)

    monkeypatch.setattr(ttfm, "forward", spy)
    long = list(range(1, 21))
    run(params, [([9, 8, 7, 6, 5], 3, {}), (long, 3, {})], max_slots=1, max_len=24,
        draft_params=params, draft_cfg=CFG, spec_k=2)
    assert seen == [[9, 8, 7, 6, 5, 0, 0, 0], long + [0] * 4]


def test_engine_speculative_validation(params):
    with pytest.raises(ValueError, match="draft_cfg"):
        InferenceEngine(params, CFG, device="cpu", draft_params=params)
    for bad in (dict(spec_k=0), dict(spec_k=17), dict(spec_depth=0), dict(spec_depth=17)):
        with pytest.raises(ValueError, match="spec_k|spec_depth"):
            InferenceEngine(params, CFG, device="cpu", draft_params=params, draft_cfg=CFG, **bad)


def test_draft_cache_has_a_scratch_tail(params):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=3, max_len=40,
                             draft_params=params, draft_cfg=CFG, spec_k=4)
    assert engine._draft_cache["k"].shape[1:3] == (3, 40 + 4 + 1)
    assert InferenceEngine(params, CFG, device="cpu")._draft_cache is None
    engine.slots[0].draft_ready = True
    engine._reset_draft_cache()
    assert not engine.slots[0].draft_ready and engine._draft_cache["k"].abs().sum() == 0


def test_engine_rounds_equal_the_standalone_paths(params):
    """One request at a time, a draft that agrees with the target only
    part of the time (the target with a perturbed output head): the
    engine's accepted and proposed counts are those of
    ``generate_speculative`` on the same prompt, and so is the stream —
    the engine's bucketed draft prefill, parked rows and paged verify
    change nothing a round decides."""
    from devspace_tpu_torch.inference.speculative import generate_speculative

    noise = torch.randn(params["lm_head"].shape, generator=torch.Generator().manual_seed(1))
    draft = {**params, "lm_head": params["lm_head"] + 0.004 * noise}
    seen = set()
    for prompt in ([5, 1, 4], list(range(3, 40)), [9] * 11):
        want, stats = generate_speculative(params, draft, torch.tensor([prompt]), CFG, CFG, 20, k=4)
        (got,), st = run(params, [(prompt, 20, {})], max_slots=3, max_len=64,
                         draft_params=draft, draft_cfg=CFG, spec_k=4)
        assert got == want[0].tolist()
        assert (st["spec_accepted"], st["spec_proposed"]) == (stats.accepted, stats.proposed)
        seen.add(round(stats.acceptance_rate, 2))
    assert any(0.05 < a < 0.95 for a in seen), seen  # the draft really is in between
