"""The port's host KV tier (devspace_tpu_torch/inference/kv_tier.py), its
KV-block quantization (inference/quantization.py) and the radix tree's
spilled node state, on the CPU.

The host-level cases of tests/test_kv_tier.py run on the port's classes:
the KVT1 payload round trip and its rejections, LRU by bytes, re-put,
disk overflow and promotion, the disk budget, corrupt RAM and disk
payloads dropped as misses, silent discard, ``resolve_kv_tier`` and the
spill / match-through / revive / prune states of the radix tree. Then the
wire across packages: for the same numpy inputs from a seed, the port's
``pack_kv_payload``, ``pack_chain_envelope`` and ``quantize_kv_block``
give the JAX package's bytes, and each package's ``unpack_*`` reads the
other's; the engine's on-device quantization (``quantize_kv``, the float
pool's spill) gives ``quantize_kv_block``'s bytes.
"""

import os

import numpy as np
import pytest
import torch

from devspace_tpu.inference import kv_tier as jkv
from devspace_tpu.inference import quantization as jq
from devspace_tpu_torch.inference.kv_tier import (
    HostKVTier,
    pack_chain_envelope,
    pack_kv_payload,
    resolve_kv_tier,
    unpack_chain_envelope,
    unpack_kv_payload,
)
from devspace_tpu_torch.inference.prefix_cache import RadixPrefixCache
from devspace_tpu_torch.inference.quantization import (
    KV_SCALE_EPS,
    dequantize_kv_block,
    quantize_kv_block,
)
from devspace_tpu_torch.ops.paged_attention import quantize_kv


def _arrays(seed=0, shape=(2, 2, 4, 8)):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, size=shape).astype(np.int8)
    vq = rng.integers(-127, 128, size=shape).astype(np.int8)
    ks = rng.random(shape[:3], dtype=np.float32)
    vs = rng.random(shape[:3], dtype=np.float32)
    return kq, ks, vq, vs


def _payload(seed=0, shape=(2, 2, 4, 8)):
    arrays = _arrays(seed, shape)
    return pack_kv_payload(*arrays), arrays


# -- payload format --------------------------------------------------------
def test_pack_unpack_roundtrip():
    buf, arrays = _payload()
    for a, b in zip(arrays, unpack_kv_payload(buf)):
        np.testing.assert_array_equal(a, b)


def test_unpack_rejects_bad_magic_and_truncation():
    buf, _ = _payload()
    with pytest.raises(ValueError, match="magic"):
        unpack_kv_payload(b"XXXX" + buf[4:])
    with pytest.raises(ValueError, match="length"):
        unpack_kv_payload(buf[:-1])
    with pytest.raises(ValueError):
        pack_kv_payload(
            np.zeros((1, 1, 2, 4), np.float32),  # not int8
            np.ones((1, 1, 2), np.float32),
            np.zeros((1, 1, 2, 4), np.int8),
            np.ones((1, 1, 2), np.float32),
        )


def test_quantize_kv_block_roundtrip_accuracy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    q, scale = quantize_kv_block(x)
    assert q.dtype == np.int8 and scale.shape == (2, 2, 8)
    deq = dequantize_kv_block(q, scale)
    rel = np.abs(deq - x).max() / np.abs(x).max()
    assert rel < 0.01  # the ~0.5% int8 noise profile, with headroom
    # all-zero rows quantize cleanly (scale floor, no NaN)
    q0, s0 = quantize_kv_block(np.zeros((1, 1, 2, 4), np.float32))
    assert not np.isnan(s0).any() and (q0 == 0).all()
    np.testing.assert_array_equal(dequantize_kv_block(q0, s0), 0)
    assert KV_SCALE_EPS == jq.KV_SCALE_EPS


# -- HostKVTier ------------------------------------------------------------
def test_tier_lru_by_bytes_eviction_order():
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf) * 2)
    gone = []
    tier.on_evict = gone.append
    tier.put("a", buf)
    tier.put("b", buf)
    tier.get("a")  # refresh: b is now oldest
    tier.put("c", buf)
    assert gone == ["b"]
    assert tier.get("b") is None and tier.get("a") is not None
    assert tier.resident_bytes == len(buf) * 2
    assert tier.stats()["evictions"] == 1


def test_tier_reput_refreshes_lru_without_duplicating_bytes():
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf) * 2)
    tier.put("a", buf)
    tier.put("b", buf)
    tier.put("a", buf)  # refresh, not duplicate
    assert tier.resident_bytes == len(buf) * 2
    tier.put("c", buf)  # now b (oldest) ages out, a survives
    assert tier.get("a") is not None and tier.get("b") is None


def test_tier_disk_overflow_and_promotion(tmp_path):
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf), disk_dir=str(tmp_path))
    gone = []
    tier.on_evict = gone.append
    tier.put("a", buf)
    tier.put("b", buf)  # a overflows to disk, not dropped
    assert gone == []
    st = tier.stats()
    assert st["ram_entries"] == 1 and st["disk_entries"] == 1
    assert os.path.exists(tmp_path / "a.kv")
    # read promotes a back to RAM (and b overflows down)
    assert tier.get("a") == buf
    st = tier.stats()
    assert st["ram_entries"] == 1 and st["disk_entries"] == 1
    assert not os.path.exists(tmp_path / "a.kv")
    assert len(tier) == 2


def test_tier_disk_budget_ages_off_end_of_tier(tmp_path):
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf), disk_dir=str(tmp_path),
                      disk_max_bytes=(len(buf) + 16) * 2)
    gone = []
    tier.on_evict = gone.append
    for d in "abcd":
        tier.put(d, buf)
    # a, b, c overflowed to disk in order; disk holds 2 -> a aged off
    assert gone == ["a"]
    assert tier.get("a") is None
    assert tier.get("b") == buf  # promoted back from disk


def test_tier_corrupt_ram_payload_dropped_as_miss():
    buf, _ = _payload()
    tier = HostKVTier()
    tier.put("a", buf)
    payload, checksum = tier._ram["a"]
    bad = bytearray(payload)
    bad[30] ^= 0xFF
    tier._ram["a"] = (bytes(bad), checksum)
    assert tier.get("a") is None
    assert tier.stats()["corrupt_dropped"] == 1
    assert "a" not in tier._ram and tier.resident_bytes == 0


def test_tier_corrupt_disk_file_dropped_as_miss(tmp_path):
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf), disk_dir=str(tmp_path))
    tier.put("a", buf)
    tier.put("b", buf)  # a -> disk
    path = tmp_path / "a.kv"
    raw = bytearray(path.read_bytes())
    raw[40] ^= 0xFF
    path.write_bytes(bytes(raw))
    assert tier.get("a") is None
    assert tier.stats()["corrupt_dropped"] == 1
    assert not path.exists()


def test_tier_discard_is_silent(tmp_path):
    buf, _ = _payload()
    tier = HostKVTier(max_bytes=len(buf), disk_dir=str(tmp_path))
    gone = []
    tier.on_evict = gone.append
    tier.put("a", buf)
    tier.put("b", buf)  # a on disk, b in RAM
    tier.discard("a")
    tier.discard("b")
    tier.discard("nope")
    assert gone == [] and len(tier) == 0 and tier.resident_bytes == 0
    assert not os.path.exists(tmp_path / "a.kv")


def test_resolve_kv_tier_modes(monkeypatch):
    monkeypatch.delenv("DEVSPACE_KV_TIER", raising=False)
    assert resolve_kv_tier(None) == "off"
    assert resolve_kv_tier("host") == "host"
    assert resolve_kv_tier("HOST+DISK") == "host+disk"
    monkeypatch.setenv("DEVSPACE_KV_TIER", "host")
    assert resolve_kv_tier(None) == "host"
    assert resolve_kv_tier("off") == "off"  # explicit arg wins
    with pytest.raises(ValueError):
        resolve_kv_tier("sideways")


# -- radix tree: the spilled node state ------------------------------------
def _publish_chain(cache, blocks, start_blk=1):
    cur = cache.cursor()
    for i, edge in enumerate(blocks):
        cur.publish(tuple(edge), start_blk + i, 0)
    return cur


def test_spill_keeps_chain_matchable_and_revivable():
    cache = RadixPrefixCache(track_digests=True)
    edges = [(1, 2), (3, 4), (5, 6)]
    _publish_chain(cache, edges)
    spill, dropped = [], []
    # evict the whole chain root-first -> all three spill
    blk, freed = cache.pop_victim(collect_spill=spill, dropped=dropped)
    assert blk == 1 and sorted(freed) == [2, 3]
    assert len(spill) == 3 and dropped == []
    assert cache.spilled_count() == 3 and cache.evictable() == 0
    # plain step refuses spilled nodes; step_tiered walks through them
    cur = cache.cursor()
    assert cur.step((1, 2)) is None
    cur = cache.cursor()
    kinds = [cur.step_tiered(e) for e in edges]
    assert [k[0] for k in kinds] == ["spill"] * 3
    assert kinds[0][1] == spill[0][0]  # digest order matches spill order
    # revive mid-chain: publish makes the node resident again
    cur = cache.cursor()
    cur.publish(edges[0], 7, 1)
    assert cache.spilled_count() == 2
    cur2 = cache.cursor()
    assert cur2.step(edges[0]) == 7
    assert cur2.step_tiered(edges[1])[0] == "spill"


def test_drop_spilled_prunes_subtree_and_reports_digests():
    cache = RadixPrefixCache(track_digests=True)
    edges = [(1, 2), (3, 4), (5, 6)]
    _publish_chain(cache, edges)
    spill, dropped = [], []
    cache.pop_victim(collect_spill=spill, dropped=dropped)
    top_digest = spill[0][0]
    gone_digests, freed = cache.drop_spilled(top_digest)
    assert sorted(gone_digests) == sorted(d for d, _ in spill[1:])
    assert freed == [] and cache.spilled_count() == 0
    cur = cache.cursor()
    assert cur.step_tiered(edges[0]) is None
    # unknown digest is a no-op
    assert cache.drop_spilled("beef") == ([], [])


def test_broken_ancestor_chain_drops_orphaned_spilled_nodes():
    cache = RadixPrefixCache(track_digests=True)
    _publish_chain(cache, [(1, 2), (3, 4)])
    cache.cursor().step((1, 2))  # refresh parent: child is now LRU
    spill = []
    # evict the child first: only (3, 4) spills, its parent stays resident
    cache.pop_victim(collect_spill=spill, dropped=[])
    assert len(spill) == 1 and cache.spilled_count() == 1
    # parent evicted WITHOUT spilling: the orphaned spilled child must be
    # pruned and its digest reported
    dropped = []
    cache.pop_victim(dropped=dropped)
    assert dropped == [spill[0][0]]
    assert cache.spilled_count() == 0
    cur = cache.cursor()
    assert cur.step_tiered((1, 2)) is None


def test_tier_off_default_has_no_digest_overhead():
    cache = RadixPrefixCache()  # track_digests=False
    _publish_chain(cache, [(1, 2), (3, 4)])
    spill = []
    blk, freed = cache.pop_victim(collect_spill=spill)
    # without digests nothing can spill
    assert spill == [] and blk == 1 and freed == [2]
    assert cache.spilled_count() == 0


# -- the wire across packages ----------------------------------------------
SHAPES = [(2, 2, 4, 8), (32, 32, 4, 128), (1, 8, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_pack_bytes_equal_the_jax_package(shape, seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    v[0, 0, 0] = 0.0  # an all-zero vector takes the scale floor
    kq, ks = quantize_kv_block(k)
    vq, vs = quantize_kv_block(v)
    jkq, jks = jq.quantize_kv_block(k)
    jvq, jvs = jq.quantize_kv_block(v)
    for a, b in ((kq, jkq), (ks, jks), (vq, jvq), (vs, jvs)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    payload = pack_kv_payload(kq, ks, vq, vs)
    assert payload == jkv.pack_kv_payload(jkq, jks, jvq, jvs)
    np.testing.assert_array_equal(dequantize_kv_block(kq, ks), jq.dequantize_kv_block(kq, ks))


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_envelope_bytes_equal_the_jax_package(n_blocks):
    blocks = [(f"digest-{i:02d}" + "cd" * 8, pack_kv_payload(*_arrays(seed=10 + i)))
              for i in range(n_blocks)]
    assert pack_chain_envelope(blocks) == jkv.pack_chain_envelope(blocks)


def test_each_package_reads_the_others_bytes():
    arrays = _arrays(seed=5, shape=(3, 2, 8, 16))
    ours, theirs = pack_kv_payload(*arrays), jkv.pack_kv_payload(*arrays)
    for got in (unpack_kv_payload(theirs), jkv.unpack_kv_payload(ours)):
        for a, b in zip(arrays, got):
            np.testing.assert_array_equal(a, b)
    blocks = [("aa" * 16, ours), ("bb" * 16, pack_kv_payload(*_arrays(seed=6)))]
    assert unpack_chain_envelope(jkv.pack_chain_envelope(blocks)) == blocks
    assert jkv.unpack_chain_envelope(pack_chain_envelope(blocks)) == blocks
    # the port's rejections are the reference's (a truncated envelope)
    env = pack_chain_envelope(blocks)
    with pytest.raises(jkv.WireFormatError):
        jkv.unpack_chain_envelope(env[:-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_quantization_is_the_host_blocks(dtype):
    """The float pool's spill quantizes on the device with ``quantize_kv``;
    its bytes are ``quantize_kv_block``'s on the same (rounded) values."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 2, 16, 32), generator=g) * 2).to(dtype)
    x[1, 1, 3] = 0
    q, s = quantize_kv(x)
    hq, hs = quantize_kv_block(x.float().numpy())
    assert q.numpy().tobytes() == hq.tobytes() and s.numpy().tobytes() == hs.tobytes()
