"""The port's copy of the radix prefix cache
(devspace_tpu_torch/inference/prefix_cache.py) and the engine's side of
it, on the CPU.

The cache: the parametrised cases of tests/test_prefix_cache.py on the
port's classes — the radix tree behaves exactly like the flat map
(hits, eviction victims, descendant invalidation) — and the same
randomized traces give the same log on the port's radix tree as on the
JAX package's, with the same chain fingerprints.

The engine (float32 TINY, JAX weights through numpy): a request sharing
whole blocks of prefix with an earlier one skips their prefill
(``prefix_hit_tokens``, the prefill offsets), and its stream equals the
stream with ``prefix_cache=False`` and the JAX engine's; the cache
evicts under pool pressure and a preempted request re-matches its own
blocks, lossless. Greedy runs stay under ~30 new tokens, before the
exact float32 logit tie this TINY/seed-0 trajectory reaches near 38.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JaxEngine
from devspace_tpu.inference import prefix_cache as jpc
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.prefix_cache import (
    FlatPrefixCache,
    RadixPrefixCache,
    fingerprint_chain,
)
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

BS = 4  # tokens per block in the cache tests
JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
TIMEOUT = 300


def blocks(tokens):
    return [tuple(tokens[i * BS: (i + 1) * BS]) for i in range(len(tokens) // BS)]


def publish_chain(cache, tokens, first_blk, refs=0):
    cur = cache.cursor()
    return [cur.publish(edge, first_blk + i, refs) for i, edge in enumerate(blocks(tokens))]


def match(cache, tokens):
    """Engine-shaped match: up to (len-1)//BS blocks, stop at first miss."""
    cur = cache.cursor()
    out = []
    for i in range((len(tokens) - 1) // BS):
        blk = cur.step(tuple(tokens[i * BS: (i + 1) * BS]))
        if blk is None:
            break
        out.append(blk)
    return out


# -- deterministic semantics ----------------------------------------------
@pytest.mark.parametrize("cls", [RadixPrefixCache, FlatPrefixCache])
def test_publish_match_first_writer_wins(cls):
    cache = cls()
    tokens = list(range(12))  # 3 blocks
    assert publish_chain(cache, tokens, 10) == [10, 11, 12]
    assert len(cache) == 3
    assert publish_chain(cache, tokens, 20) == [10, 11, 12]
    assert len(cache) == 3 and not cache.is_published(20)
    other = tokens[:8] + [99, 98, 97, 96]
    assert publish_chain(cache, other, 30) == [10, 11, 32]
    assert match(cache, tokens + [0]) == [10, 11, 12]
    assert match(cache, other + [0]) == [10, 11, 32]
    assert match(cache, tokens[:4] + [7, 7, 7, 7, 0]) == [10]


@pytest.mark.parametrize("cls", [RadixPrefixCache, FlatPrefixCache])
def test_mid_chain_eviction_invalidates_descendants(cls):
    cache = cls()
    edges = blocks(list(range(16)))
    cur = cache.cursor()
    cur.publish(edges[0], 10, 0)
    cur.publish(edges[1], 11, 0)
    cur.publish(edges[2], 12, 1)  # referenced by a live slot
    cur.publish(edges[3], 13, 1)
    assert len(cache) == 4 and cache.evictable() == 2
    victim, freed = cache.pop_victim()
    assert victim == 10 and freed == [11]
    assert len(cache) == 0 and cache.evictable() == 0
    for b in (10, 11, 12, 13):
        assert not cache.is_published(b)
    assert match(cache, list(range(16)) + [0]) == []


@pytest.mark.parametrize("cls", [RadixPrefixCache, FlatPrefixCache])
def test_match_touch_protects_from_eviction(cls):
    cache = cls()
    a, b = [1, 2, 3, 4], [5, 6, 7, 8]
    publish_chain(cache, a, 10)
    publish_chain(cache, b, 11)
    assert match(cache, a + [0]) == [10]  # touch a -> b becomes LRU-oldest
    victim, freed = cache.pop_victim()
    assert victim == 11 and freed == []
    assert cache.is_published(10)


@pytest.mark.parametrize("cls", [RadixPrefixCache, FlatPrefixCache])
def test_ref_release_gates_eviction(cls):
    cache = cls()
    publish_chain(cache, [1, 2, 3, 4], 10)
    publish_chain(cache, [5, 6, 7, 8], 11)
    cache.ref(10)
    assert cache.evictable() == 1
    assert cache.evictable_excluding([11]) == 0
    victim, _ = cache.pop_victim()
    assert victim == 11
    with pytest.raises(RuntimeError, match="no block available"):
        cache.pop_victim()
    cache.release(10)
    assert cache.evictable() == 1
    victim, _ = cache.pop_victim()
    assert victim == 10


@pytest.mark.parametrize("cls", [RadixPrefixCache, FlatPrefixCache])
def test_reset_clears_everything(cls):
    cache = cls()
    publish_chain(cache, list(range(12)), 10)
    cache.ref(10)
    cache.reset()
    assert len(cache) == 0 and cache.evictable() == 0
    assert match(cache, list(range(12)) + [0]) == []
    with pytest.raises(RuntimeError):
        cache.pop_victim()
    assert publish_chain(cache, [9, 9, 9, 9], 50) == [50]
    assert match(cache, [9, 9, 9, 9, 0]) == [50]


# -- randomized trace equivalence -----------------------------------------
def run_trace(cache_cls, seed, n_ops=400):
    """An engine-shaped random trace (admit = match + ref + alloc +
    publish, slot release, allocator eviction, bare match) logging every
    observable; block ids come free-list first, evicting when dry, so a
    divergence cascades into the log."""
    rng = random.Random(seed)
    cache = cache_cls()
    log = []
    refs: dict[int, int] = {}
    free: list[int] = list(range(1000, 1064))
    slots: list[list[int]] = []
    prompts: list[list[int]] = []

    def gen_prompt():
        p = []
        if prompts and rng.random() < 0.65:
            p = list(rng.choice(prompts))
            p = p[: rng.randrange(0, len(p) // BS + 1) * BS]
        p += [rng.randrange(40) for _ in range(BS * rng.randrange(1, 5))]
        prompts.append(p)
        return p

    def alloc():
        if free:
            return free.pop()
        victim, freed = cache.pop_victim()
        free.extend(sorted(freed))
        log.append(("evict-for-alloc", victim, tuple(sorted(freed))))
        return victim

    for _ in range(n_ops):
        op = rng.random()
        if op < 0.40:  # admit
            p = gen_prompt()
            matched = match(cache, p)
            need = len(p) // BS - len(matched)
            avail = len(free) + cache.evictable_excluding(matched)
            log.append(("match", tuple(matched), avail))
            if need > avail:
                log.append(("admit-full",))
                continue
            for b in matched:
                refs[b] = refs.get(b, 0) + 1
                cache.ref(b)
            table = list(matched)
            for _i in range(need):
                b = alloc()
                refs[b] = 1
                table.append(b)
            cur = cache.cursor()
            residents = [cur.publish(edge, table[i], refs.get(table[i], 0))
                         for i, edge in enumerate(blocks(p))]
            slots.append(table)
            log.append(("publish", tuple(residents)))
        elif op < 0.65 and slots:  # release a slot
            table = slots.pop(rng.randrange(len(slots)))
            for b in table:
                refs[b] = refs.get(b, 1) - 1
                if cache.is_published(b):
                    cache.release(b)
                elif refs[b] <= 0:
                    free.append(b)
            log.append(("release", tuple(table)))
        elif op < 0.80:  # allocator pressure: evict one victim
            if cache.evictable() > 0:
                victim, freed = cache.pop_victim()
                free.append(victim)
                free.extend(sorted(freed))
                refs[victim] = 0
                log.append(("evict", victim, tuple(sorted(freed))))
        else:  # bare match (touches LRU, no refs)
            log.append(("bare-match", tuple(match(cache, gen_prompt()))))
        log.append(("state", len(cache), cache.evictable(), len(free)))
    seen = sorted({b for t in slots for b in t} | set(refs) | set(range(1000, 1064)))
    log.append(("published", tuple(b for b in seen if cache.is_published(b))))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_radix_equals_flat_on_random_traces(seed):
    flat = run_trace(FlatPrefixCache, seed)
    radix = run_trace(RadixPrefixCache, seed)
    assert len(flat) == len(radix)
    for i, (f, r) in enumerate(zip(flat, radix)):
        assert f == r, f"trace diverged at event {i}: flat={f} radix={r}"


@pytest.mark.parametrize("seed", range(4))
def test_port_cache_equals_jax_package_cache(seed):
    """The port's copy and the JAX package's cache: one log per trace,
    and the same chain fingerprints."""
    assert run_trace(RadixPrefixCache, seed) == run_trace(jpc.RadixPrefixCache, seed)
    tokens = random.Random(seed).choices(range(32000), k=300)
    for bs in (1, 16, 64):
        assert fingerprint_chain(tokens, bs) == jpc.fingerprint_chain(tokens, bs)


# -- the engine's side -----------------------------------------------------
@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def reference(jparams):
    def generate(prompt, n):
        out = jtfm.generate(jparams, jnp.asarray([prompt], jnp.int32), JCFG, max_new_tokens=n)
        return [int(t) for t in out[0]]

    return generate


def serve_one_at_a_time(engine, reqs):
    engine.start()
    try:
        return [engine.submit(p, n).result(timeout=TIMEOUT) for p, n in reqs], engine.stats()
    finally:
        engine.stop()


def test_shared_prefix_skips_its_prefill(params, jparams, monkeypatch):
    """Requests sharing a 20-token prefix (two whole 8-token blocks) one
    after another: the later ones reference the first's blocks and
    prefill from position 16; their streams equal those with the cache
    off and the JAX engine's at its defaults."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, CFG.vocab_size, size=20).tolist()
    reqs = [(shared + [7, 8], 12), (shared + [9], 10), (shared + [1, 2, 3], 8)]
    kw = dict(max_slots=1, max_len=48, block_size=8, prefill_chunk=8)
    offsets = []
    real = ttfm.prefill_chunk_paged

    def spy(p, pool, table, tokens, offset, cfg):
        offsets.append(offset)
        return real(p, pool, table, tokens, offset, cfg)

    monkeypatch.setattr(ttfm, "prefill_chunk_paged", spy)
    cached, st = serve_one_at_a_time(InferenceEngine(params, CFG, device="cpu", **kw), reqs)
    assert offsets == [0, 8, 16, 16, 16]  # 22 tokens in 3 chunks, then hits at 16
    assert st["prefix_hit_blocks"] == 4 and st["prefix_hit_tokens"] == 32
    assert st["prefix_cached_blocks"] == 2
    assert st["free_blocks"] + st["prefix_cached_blocks"] == st["total_blocks"]
    offsets.clear()
    uncached, st_off = serve_one_at_a_time(
        InferenceEngine(params, CFG, device="cpu", prefix_cache=False, **kw), reqs)
    assert offsets == [0, 8, 16, 0, 8, 16, 0, 8, 16]
    assert st_off["prefix_hit_tokens"] == 0 and st_off["prefix_cached_blocks"] == 0
    jax_out, jst = serve_one_at_a_time(JaxEngine(jparams, JCFG, **kw), reqs)
    assert cached == uncached == jax_out
    assert jst["prefix_hit_tokens"] == st["prefix_hit_tokens"]


def test_prefix_cache_eviction_under_pool_pressure(params, reference):
    """A pool too small to cache every distinct prompt evicts LRU
    unreferenced blocks instead of failing admission; outputs stay
    exact, also for a prompt whose blocks were evicted."""
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(1, CFG.vocab_size, size=16).tolist(), 4) for _ in range(6)]
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32, block_size=8,
                             n_blocks=10)
    results, st = serve_one_at_a_time(engine, reqs + reqs[:1])
    for (prompt, n), got in zip(reqs + reqs[:1], results):
        assert got == reference(prompt, n)
    assert 0 < st["prefix_cached_blocks"] <= 9


def test_prefix_cache_preemption_resume_rematches(params, reference):
    """A preempted request's published blocks survive the slot free; on
    re-admission the resume prompt matches them and prefill restarts past
    the cached region, still exact."""
    rng = np.random.default_rng(14)
    reqs = [(rng.integers(1, CFG.vocab_size, size=16).tolist(), 24) for _ in range(3)]
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=3, max_len=48, block_size=8,
                             n_blocks=10).start()
    try:
        handles = [engine.submit(p, n) for p, n in reqs]
        results = [h.result(timeout=TIMEOUT) for h in handles]
        st = engine.stats()
    finally:
        engine.stop()
    for (prompt, n), got in zip(reqs, results):
        assert got == reference(prompt, n)
    assert st["requests_preempted"] > 0 and st["prefix_hit_blocks"] > 0
