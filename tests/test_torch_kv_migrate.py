"""KV chain migration in the port (devspace_tpu_torch/inference/kv_tier.py
and the engine's export / ``kv_source`` side), on the CPU.

- The KVM1 envelope and the pull client, as tests/test_kv_migrate.py
  holds the reference's: a bit-exact round trip between two tiers, every
  tamper (truncation, a flipped byte, version skew, trailing bytes) a
  clean ``WireFormatError``, a 404 failing fast, transient errors retried.
- Engine to engine (TINY, the JAX package's bf16 weights through the
  converter, int8 pool): the decode engine's stream with ``kv_source``
  equals a cold local prefill, with the migrate counters showing the
  pull; a chain already local is never fetched; a dead source and a
  corrupted envelope fall back to recompute with the same stream.
- Across packages, with the same float32 TINY weights on both sides: a
  chain exported by the JAX engine imports into the port's engine, whose
  pool blocks then equal the payload byte for byte and whose stream
  equals the port's cold stream; the reverse; and on float pools both
  packages' exports of one prompt agree within one int8 step, with scales
  within a relative 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JaxEngine
from devspace_tpu.inference import kv_tier as jkv
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.kv_tier import (
    _WIRE_VERSION,
    HostKVTier,
    KVMigrateError,
    KVMigrationClient,
    WireFormatError,
    _checksum,
    export_chain,
    import_chain,
    kv_payload_bytes,
    pack_chain_envelope,
    pack_kv_payload,
    unpack_chain_envelope,
    unpack_kv_payload,
)
from devspace_tpu_torch.inference.prefix_cache import fingerprint_chain
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
from devspace_tpu_torch.resilience.policy import RetryExhausted, RetryPolicy

CFG = ttfm.TINY
F32 = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
JF32 = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
TIMEOUT = 300


def _payload(seed=0, shape=(2, 2, 4, 8)):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, size=shape).astype(np.int8)
    vq = rng.integers(-127, 128, size=shape).astype(np.int8)
    ks = rng.random(shape[:3], dtype=np.float32)
    vs = rng.random(shape[:3], dtype=np.float32)
    return pack_kv_payload(kq, ks, vq, vs)


def _chain(n=3):
    return [(f"digest-{i:02d}" + "ab" * 8, _payload(seed=i)) for i in range(n)]


# -- wire format -------------------------------------------------------------
def test_envelope_roundtrip_is_bit_exact():
    blocks = _chain(4)
    out = unpack_chain_envelope(pack_chain_envelope(blocks))
    assert [d for d, _ in out] == [d for d, _ in blocks]
    for (_, a), (_, b) in zip(blocks, out):
        assert a == b


def test_cross_process_round_trip_bit_exact_pools():
    src, dst = HostKVTier(max_bytes=1 << 20), HostKVTier(max_bytes=1 << 20)
    blocks = _chain(3)
    for digest, payload in blocks:
        src.put(digest, payload)
    envelope = export_chain(src, [d for d, _ in blocks])
    assert envelope is not None
    assert import_chain(dst, envelope) == [d for d, _ in blocks]
    for digest, payload in blocks:
        got = dst.get(digest)
        assert got == payload
        for a, b in zip(unpack_kv_payload(got), unpack_kv_payload(payload)):
            np.testing.assert_array_equal(a, b)


def test_export_chain_refuses_partial():
    tier = HostKVTier(max_bytes=1 << 20)
    blocks = _chain(3)
    for digest, payload in blocks[:-1]:  # leaf missing
        tier.put(digest, payload)
    assert export_chain(tier, [d for d, _ in blocks]) is None
    assert export_chain(tier, []) is None


def test_truncated_envelope_rejected():
    envelope = pack_chain_envelope(_chain(2))
    for cut in (1, 8, len(envelope) // 2, len(envelope) - 1):
        with pytest.raises(WireFormatError):
            unpack_chain_envelope(envelope[:cut])


def test_bit_flip_rejected_everywhere():
    envelope = pack_chain_envelope(_chain(2))
    step = max(1, len(envelope) // 37)
    for pos in range(0, len(envelope), step):
        bad = envelope[:pos] + bytes([envelope[pos] ^ 0x40]) + envelope[pos + 1:]
        with pytest.raises(WireFormatError):
            unpack_chain_envelope(bad)


def test_version_skew_rejected_cleanly():
    """A future-version envelope with a VALID trailer is rejected by the
    version check itself."""
    envelope = pack_chain_envelope(_chain(1))
    body = bytearray(envelope[:-len(_checksum(b""))])
    assert body[4] == _WIRE_VERSION
    body[4] = _WIRE_VERSION + 8
    skewed = bytes(body) + _checksum(bytes(body))
    with pytest.raises(WireFormatError, match="version"):
        unpack_chain_envelope(skewed)


def test_envelope_trailing_bytes_rejected():
    envelope = pack_chain_envelope(_chain(1))
    with pytest.raises(WireFormatError):
        unpack_chain_envelope(envelope + b"xx")


# -- fetch client ------------------------------------------------------------
def test_client_404_fails_fast_no_retry():
    calls = []

    def fetch(source, digest):
        calls.append(digest)
        raise KVMigrateError("gone at source")

    client = KVMigrationClient(fetch_fn=fetch)
    with pytest.raises(KVMigrateError):
        client.fetch("http://peer", "deadbeef")
    assert len(calls) == 1  # non-retryable: exactly one attempt


def test_client_retries_transient_then_succeeds():
    calls = []

    def fetch(source, digest):
        calls.append(source)
        if len(calls) < 3:
            raise OSError("connection reset")
        return b"the-envelope"

    client = KVMigrationClient(
        retry=RetryPolicy(max_attempts=3, base_delay=0.001, retry_on=(OSError,), seed=0),
        fetch_fn=fetch)
    assert client.fetch("http://peer", "d0") == b"the-envelope"
    assert len(calls) == 3


def test_retry_policy_matches_the_reference():
    """The port's RetryPolicy: the reference's delay schedule for a seed,
    RetryExhausted after the last attempt, and the deadline."""
    from devspace_tpu.resilience.policy import RetryPolicy as JaxPolicy

    kw = dict(max_attempts=6, base_delay=0.05, max_delay=0.5, jitter=0.5, seed=3)
    assert list(RetryPolicy(**kw).delays()) == list(JaxPolicy(**kw).delays())
    waits = []

    def boom():
        raise OSError("down")

    policy = RetryPolicy(max_attempts=3, base_delay=0.01, retry_on=(OSError,))
    with pytest.raises(RetryExhausted) as info:
        policy.execute(boom, sleep=waits.append)
    assert info.value.attempts == 3 and isinstance(info.value.last, OSError)
    assert waits == [0.01, 0.02]
    with pytest.raises(OSError):
        policy.execute(boom, sleep=waits.append, reraise=True)
    clock = iter([0.0, 10.0])
    with pytest.raises(RetryExhausted, match="deadline"):
        RetryPolicy(max_attempts=5, base_delay=1.0, deadline=2.0, retry_on=(OSError,)).execute(
            boom, sleep=waits.append, clock=lambda: next(clock))


# -- engine to engine --------------------------------------------------------
PROMPT = [(7 * i) % 49 + 1 for i in range(40)]  # 4 full blocks at bs=8
N_NEW = 8


@pytest.fixture(scope="module")
def params():
    jparams = jtfm.init_params(jtfm.TINY, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _mk_engine(params, cfg=CFG, **kw):
    defaults = dict(max_slots=2, max_len=64, block_size=8, n_blocks=10, prefill_chunk=8,
                    chunk_max=4, kv_dtype="int8")
    defaults.update(kw)
    return InferenceEngine(params, cfg, device="cpu", kv_tier="host", **defaults)


@pytest.fixture(scope="module")
def baseline(params):
    """Cold local prefill+decode: the equivalence reference."""
    engine = _mk_engine(params).start()
    try:
        return engine.submit(PROMPT, N_NEW).result(timeout=TIMEOUT)
    finally:
        engine.stop()


def _exporting_fetch(source_engine):
    def fetch(source, digest):
        envelope = source_engine.export_kv_chain(digest)
        if envelope is None:
            raise KVMigrateError(f"no chain {digest[:16]} at source")
        return envelope
    return fetch


def _chain_blocks(engine, prompt, bs=8):
    """The pool blocks the engine's radix tree holds for prompt's full
    blocks (resident nodes only)."""
    cur = engine._prefix_cache.cursor()
    out = []
    for i in range(len(prompt) // bs):
        blk = cur.step(tuple(prompt[i * bs: (i + 1) * bs]))
        if blk is None:
            break
        out.append(blk)
    return out


def test_engine_migration_is_byte_identical(params, baseline):
    a = _mk_engine(params).start()
    b = _mk_engine(params).start()
    try:
        assert a.submit(PROMPT, N_NEW).result(timeout=TIMEOUT) == baseline
        b._kv_client = KVMigrationClient(fetch_fn=_exporting_fetch(a))
        tokens = b.submit(PROMPT, N_NEW, kv_source="engine-a").result(timeout=TIMEOUT)
        st = b.stats()
    finally:
        a.stop()
        b.stop()
    assert tokens == baseline
    assert st["kv_migrate_chains"] == 1
    assert st["kv_migrate_blocks"] == 4
    assert st["kv_migrate_bytes"] > 0
    assert st["kv_migrate_failures"] == 0
    assert st["kv_restore_hits"] == 4 and st["recompute_tokens_saved"] == 32
    assert st["kv_tier_remote_nodes"] == 0  # all promoted and restored
    assert a.stats()["kv_export_chains"] == 1
    # the migrated blocks are A's, byte for byte
    for ba, bb in zip(_chain_blocks(a, PROMPT), _chain_blocks(b, PROMPT), strict=True):
        for key in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(a.pool[key][:, ba], b.pool[key][:, bb])


def test_export_through_the_running_scheduler(params):
    """With the scheduler running, an export from another thread goes
    through the mailbox; an unknown digest is None."""
    a = _mk_engine(params).start()
    try:
        a.submit(PROMPT, N_NEW).result(timeout=TIMEOUT)
        digests = fingerprint_chain(PROMPT, 8)
        envelope = a.export_kv_chain(digests[-1])
        assert a.export_kv_chain("ff" * 16) is None
    finally:
        a.stop()
    # the prompt's 5 full blocks were all prefilled, so all 5 are published
    assert [d for d, _ in unpack_chain_envelope(envelope)] == digests and len(digests) == 5


def test_kv_source_ignored_when_chain_already_local(params, baseline):
    calls = []

    def fetch(source, digest):
        calls.append(digest)
        raise AssertionError("must not fetch")

    engine = _mk_engine(params).start()
    try:
        engine._kv_client = KVMigrationClient(fetch_fn=fetch)
        assert engine.submit(PROMPT, N_NEW).result(timeout=TIMEOUT) == baseline
        again = engine.submit(PROMPT, N_NEW, kv_source="http://peer").result(timeout=TIMEOUT)
    finally:
        engine.stop()
    assert again == baseline
    assert calls == []


@pytest.mark.chaos
def test_dead_source_degrades_to_recompute(params, baseline):
    calls = []

    def fetch(source, digest):
        calls.append(digest)
        raise OSError("connection refused")

    b = _mk_engine(params).start()
    try:
        b._kv_client = KVMigrationClient(
            retry=RetryPolicy(max_attempts=2, base_delay=0.001, retry_on=(OSError,), seed=0),
            fetch_fn=fetch)
        tokens = b.submit(PROMPT, N_NEW, kv_source="http://dead").result(timeout=TIMEOUT)
        st = b.stats()
    finally:
        b.stop()
    assert tokens == baseline
    assert len(calls) == 2  # retried once, then gave up
    assert st["kv_migrate_chains"] == 0
    assert st["kv_migrate_failures"] == 1
    assert st["kv_restore_fallbacks"] >= 1
    assert st["kv_tier_remote_nodes"] == 0  # pruned, not leaked


@pytest.mark.chaos
def test_corrupted_envelope_degrades_to_recompute(params, baseline):
    a = _mk_engine(params).start()
    b = _mk_engine(params).start()
    try:
        assert a.submit(PROMPT, N_NEW).result(timeout=TIMEOUT) == baseline
        real = _exporting_fetch(a)

        def corrupting(source, digest):
            envelope = real(source, digest)
            mid = len(envelope) // 2
            return envelope[:mid] + bytes([envelope[mid] ^ 0xFF]) + envelope[mid + 1:]

        b._kv_client = KVMigrationClient(fetch_fn=corrupting)
        tokens = b.submit(PROMPT, N_NEW, kv_source="engine-a").result(timeout=TIMEOUT)
        st = b.stats()
    finally:
        a.stop()
        b.stop()
    assert tokens == baseline
    assert st["kv_migrate_chains"] == 0
    assert st["kv_migrate_failures"] == 1
    assert st["kv_restore_fallbacks"] >= 1
    assert st["kv_tier_remote_nodes"] == 0


def test_envelope_larger_than_the_tier_degrades_to_recompute(params, baseline):
    """A tier smaller than the chain: importing the 4-block envelope root
    first evicts its own root, whose eviction prunes the remote subtree,
    so nothing is promoted or restored and the prompt is recomputed (the
    server sizes its tier to the pool, ``serve.kv_tier_budget``)."""
    payload = kv_payload_bytes(CFG.n_layers, CFG.n_kv_heads, 8, CFG.head_dim)
    a = _mk_engine(params).start()
    b = _mk_engine(params, kv_tier_bytes=2 * payload).start()
    try:
        assert a.submit(PROMPT, N_NEW).result(timeout=TIMEOUT) == baseline
        b._kv_client = KVMigrationClient(fetch_fn=_exporting_fetch(a))
        tokens = b.submit(PROMPT, N_NEW, kv_source="engine-a").result(timeout=TIMEOUT)
        st = b.stats()
    finally:
        a.stop()
        b.stop()
    assert tokens == baseline
    assert a.stats()["kv_export_chains"] == 1
    assert st["kv_migrate_chains"] == 1 and st["kv_migrate_failures"] == 0
    assert st["kv_migrate_blocks"] == 0  # the root was gone before promotion
    assert st["kv_restore_hits"] == 0 and st["recompute_tokens_saved"] == 0
    assert st["kv_restore_fallbacks"] >= 1
    assert st["kv_tier_remote_nodes"] == 0 and st["kv_tier_spilled_nodes"] == 0


# -- across packages -----------------------------------------------------------
ENGINE_KW = dict(max_slots=2, max_len=64, block_size=8, n_blocks=10, prefill_chunk=8,
                 chunk_max=4)


@pytest.fixture(scope="module")
def f32_params():
    jparams = jtfm.init_params(JF32, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _jax_engine(jparams, kv_dtype):
    return JaxEngine(jparams, JF32, kv_tier="host", kv_dtype=kv_dtype, **ENGINE_KW)


def _serve(engine, prompt, n, **kw):
    engine.start()
    try:
        return engine.submit(prompt, n, **kw).result(timeout=TIMEOUT)
    finally:
        engine.stop()  # exports after this are served inline


def _jax_chain_blocks(engine, prompt, bs=8):
    cur = engine._prefix_cache.cursor()
    out = []
    for i in range(len(prompt) // bs):
        blk = cur.step(tuple(prompt[i * bs: (i + 1) * bs]))
        if blk is None:
            break
        out.append(blk)
    return out


def _assert_pool_holds(pool_arrays, blks, envelope):
    """Each migrated block of the pool equals its KVT1 payload, bytes (the
    decode engine prefilled the prompt's fifth block itself)."""
    blocks = unpack_chain_envelope(envelope)
    assert len(blocks) == len(blks) == 4
    for blk, (_, payload) in zip(blks, blocks):
        for arr, want in zip(pool_arrays, unpack_kv_payload(payload)):
            got = np.asarray(arr[:, blk])
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_jax_chain_imports_into_the_port(f32_params):
    jparams, tparams = f32_params
    a = _jax_engine(jparams, "int8")
    _serve(a, PROMPT, N_NEW)
    envelope = a.export_kv_chain(fingerprint_chain(PROMPT, 8)[3])
    cold = _serve(_mk_engine(tparams, F32), PROMPT, N_NEW)
    b = _mk_engine(tparams, F32)
    b._kv_client = KVMigrationClient(fetch_fn=lambda s, d: a.export_kv_chain(d))
    tokens = _serve(b, PROMPT, N_NEW, kv_source="jax-replica")
    st = b.stats()
    assert st["kv_migrate_chains"] == 1 and st["kv_migrate_blocks"] == 4
    assert st["kv_migrate_failures"] == 0 and st["kv_restore_hits"] == 4
    pool = [b.pool[k].numpy() for k in ("k", "k_scale", "v", "v_scale")]
    _assert_pool_holds(pool, _chain_blocks(b, PROMPT)[:4], envelope)
    assert tokens == cold


def test_port_chain_imports_into_jax(f32_params):
    jparams, tparams = f32_params
    a = _mk_engine(tparams, F32)
    _serve(a, PROMPT, N_NEW)
    envelope = a.export_kv_chain(fingerprint_chain(PROMPT, 8)[3])
    cold = _serve(_jax_engine(jparams, "int8"), PROMPT, N_NEW)
    b = _jax_engine(jparams, "int8")
    b._kv_client = jkv.KVMigrationClient(fetch_fn=lambda s, d: a.export_kv_chain(d))
    tokens = _serve(b, PROMPT, N_NEW, kv_source="torch-replica")
    st = b.stats()
    assert st["kv_migrate_chains"] == 1 and st["kv_migrate_blocks"] == 4
    assert st["kv_migrate_failures"] == 0 and st["kv_restore_hits"] == 4
    pool = [np.asarray(b.pool[k]) for k in ("k", "k_scale", "v", "v_scale")]
    _assert_pool_holds(pool, _jax_chain_blocks(b, PROMPT)[:4], envelope)
    assert tokens == cold


def test_float_pool_exports_agree_across_packages(f32_params):
    """float32 pools quantize on each package's device path: the int8
    values agree within one step and the scales within a relative 1e-5."""
    jparams, tparams = f32_params
    leaf = fingerprint_chain(PROMPT, 8)[3]
    j = _jax_engine(jparams, None)
    _serve(j, PROMPT, N_NEW)
    t = _mk_engine(tparams, F32, kv_dtype=None)
    _serve(t, PROMPT, N_NEW)
    ours = unpack_chain_envelope(t.export_kv_chain(leaf))
    theirs = jkv.unpack_chain_envelope(j.export_kv_chain(leaf))
    assert [d for d, _ in ours] == [d for d, _ in theirs] and len(ours) == 4
    for (_, p), (_, q) in zip(ours, theirs):
        for a, b in zip(unpack_kv_payload(p), jkv.unpack_kv_payload(q)):
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
