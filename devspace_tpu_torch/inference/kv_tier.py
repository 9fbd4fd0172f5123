"""Host-RAM (optionally disk-backed) tier for evicted KV blocks, and the
KVM1 wire envelope that migrates a KV chain between replicas.

The port's own copy of ``devspace_tpu/inference/kv_tier.py``, byte for
byte on the wire: a KVT1 payload or a KVM1 envelope packed here unpacks
in the reference package and the reverse, so a JAX replica and a torch
replica that load the same weights can swap KV chains.

Under KV oversubscription the engine's prefix cache recycles an evicted
chain's pool blocks. With a tier, the engine first copies those blocks
device->host, int8-quantized per block (the same convention as
``inference.quantization.quantize_kv_block``), and parks the payloads
here. A radix match that lands on a spilled chain then restores it
host->device instead of recomputing its prefill.

- **Content-addressed**: keys are blake2b digests of the chain's token
  blocks (computed incrementally by the radix tree,
  ``prefix_cache.RadixPrefixCache(track_digests=True)``). A block's K/V
  is a pure function of its token chain and absolute position, so equal
  digests mean interchangeable payloads within an engine's lifetime.
- **LRU-by-bytes**: an ``OrderedDict`` holding packed payloads, evicted
  oldest-first when ``max_bytes`` overflows. With the disk level on
  (``"host+disk"``), RAM evictions overflow to digest-named files under
  their own byte budget instead of being dropped; reads promote back to
  RAM.
- **Checksummed**: every payload stores its own blake2b checksum, and
  ``get`` re-verifies before returning — a corrupted payload (bit rot,
  truncated file) is dropped and reported as a miss, never scattered
  into the pool. The engine falls back to recompute-prefill on any miss.

The engine's scheduler thread is the only mutator (no locks, like the
prefix cache); ``stats()`` reads are GIL-atomic ints. Dropped entries
fire ``on_evict(digest)`` so the owner can prune the radix tree's
spilled nodes — a dangling spilled node would promise a restore the
tier can no longer honor. Events go to ``logging``; the reference's
event bus and span sink wait for the port's observability slice.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np


log = logging.getLogger(__name__)

_MAGIC = b"KVT1"
_CHECKSUM_SIZE = 16


def pack_kv_payload(
    kq: np.ndarray, ks: np.ndarray, vq: np.ndarray, vs: np.ndarray
) -> bytes:
    """Pack one spilled block — int8 K/V ``[L, Hkv, bs, D]`` plus their
    per-(layer, head, token) f32 scales ``[L, Hkv, bs]`` — into a
    self-describing byte string: magic, dims, then the four raw buffers
    in order. ~= bs * L * Hkv * (2D + 8) bytes, a ~2x (bf16) to ~3.6x
    (f32) shrink versus the resident block."""
    if kq.dtype != np.int8 or vq.dtype != np.int8:
        raise ValueError("quantized K/V must be int8")
    L, Hkv, bs, D = kq.shape
    parts = [
        _MAGIC,
        struct.pack("<4I", L, Hkv, bs, D),
        kq.tobytes(),
        np.ascontiguousarray(ks, np.float32).tobytes(),
        vq.tobytes(),
        np.ascontiguousarray(vs, np.float32).tobytes(),
    ]
    return b"".join(parts)


def kv_payload_bytes(L: int, Hkv: int, bs: int, D: int) -> int:
    """The length of the KVT1 payload of one ``[L, Hkv, bs, D]`` block:
    magic, dims, int8 K and V, their f32 scales."""
    return 4 + 16 + 2 * L * Hkv * bs * D + 2 * 4 * L * Hkv * bs


def unpack_kv_payload(
    buf: bytes,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_kv_payload`. Raises ValueError on any
    structural mismatch (bad magic, short buffer) — the engine treats
    that as a miss and recomputes."""
    if buf[:4] != _MAGIC:
        raise ValueError("bad KV payload magic")
    L, Hkv, bs, D = struct.unpack_from("<4I", buf, 4)
    n_q, n_s = L * Hkv * bs * D, L * Hkv * bs
    want = kv_payload_bytes(L, Hkv, bs, D)
    if len(buf) != want:
        raise ValueError(f"KV payload length {len(buf)} != expected {want}")
    off = 20
    kq = np.frombuffer(buf, np.int8, n_q, off).reshape(L, Hkv, bs, D)
    off += n_q
    ks = np.frombuffer(buf, np.float32, n_s, off).reshape(L, Hkv, bs)
    off += 4 * n_s
    vq = np.frombuffer(buf, np.int8, n_q, off).reshape(L, Hkv, bs, D)
    off += n_q
    vs = np.frombuffer(buf, np.float32, n_s, off).reshape(L, Hkv, bs)
    return kq, ks, vq, vs


def _checksum(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=_CHECKSUM_SIZE).digest()


class HostKVTier:
    """Byte-budgeted host store for spilled KV blocks. See module
    docstring for the design; the API is put/get/discard over digest
    keys plus ``stats()`` for the engine's stats."""

    def __init__(
        self,
        max_bytes: int = 256 << 20,
        disk_dir: Optional[str] = None,
        disk_max_bytes: int = 2 << 30,
    ):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.max_bytes = int(max_bytes)
        self.disk_dir = disk_dir
        self.disk_max_bytes = int(disk_max_bytes)
        # digest -> (payload, checksum); insertion/move order = LRU
        self._ram: "OrderedDict[str, tuple[bytes, bytes]]" = OrderedDict()
        self._ram_bytes = 0
        self._disk: "OrderedDict[str, int]" = OrderedDict()  # digest -> nbytes
        self._disk_bytes = 0
        # fired when an entry leaves the tier ENTIRELY (dropped from RAM
        # with no disk level, or aged off disk) — the engine prunes the
        # matching spilled radix node so matches never dangle
        self.on_evict: Optional[Callable[[str], None]] = None
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.corrupt_dropped = 0
        self.evictions = 0

    # -- internals ---------------------------------------------------------
    def _path(self, digest: str) -> str:
        return os.path.join(self.disk_dir, f"{digest}.kv")

    def _drop(self, digest: str) -> None:
        """Entry left the tier entirely — tell the owner."""
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(digest)

    def _ram_evict_overflow(self) -> None:
        while self._ram_bytes > self.max_bytes and self._ram:
            digest, (payload, checksum) = self._ram.popitem(last=False)
            self._ram_bytes -= len(payload)
            if self.disk_dir is not None:
                self._disk_put(digest, payload, checksum)
            else:
                self._drop(digest)

    def _disk_put(self, digest: str, payload: bytes, checksum: bytes) -> None:
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            with open(self._path(digest), "wb") as f:
                f.write(checksum)
                f.write(payload)
        except OSError:
            self._drop(digest)  # disk refused it: gone for good
            return
        if digest in self._disk:
            self._disk_bytes -= self._disk.pop(digest)
        self._disk[digest] = _CHECKSUM_SIZE + len(payload)
        self._disk_bytes += self._disk[digest]
        while self._disk_bytes > self.disk_max_bytes and self._disk:
            old, nbytes = self._disk.popitem(last=False)
            self._disk_bytes -= nbytes
            self._disk_unlink(old)
            self._drop(old)

    def _disk_unlink(self, digest: str) -> None:
        try:
            os.unlink(self._path(digest))
        except OSError:
            pass

    def _disk_get(self, digest: str) -> Optional[bytes]:
        nbytes = self._disk.pop(digest, None)
        if nbytes is None:
            return None
        self._disk_bytes -= nbytes
        try:
            with open(self._path(digest), "rb") as f:
                buf = f.read()
        except OSError:
            buf = b""
        self._disk_unlink(digest)
        checksum, payload = buf[:_CHECKSUM_SIZE], buf[_CHECKSUM_SIZE:]
        if len(checksum) != _CHECKSUM_SIZE or _checksum(payload) != checksum:
            self.corrupt_dropped += 1
            log.error("kv tier: corrupt payload dropped (digest %s, disk)", digest[:16])
            return None
        return payload

    # -- api ---------------------------------------------------------------
    def put(self, digest: str, payload: bytes) -> None:
        """Retain one spilled block. Re-putting an existing digest
        refreshes its LRU position (the payload is content-addressed —
        equal digests mean equal bytes, so the old copy is kept)."""
        self.puts += 1
        if digest in self._ram:
            self._ram.move_to_end(digest)
            return
        if digest in self._disk:  # promote-by-rewrite: RAM is the hot level
            self._disk_bytes -= self._disk.pop(digest)
            self._disk_unlink(digest)
        self._ram[digest] = (payload, _checksum(payload))
        self._ram_bytes += len(payload)
        self._ram_evict_overflow()

    def get(self, digest: str) -> Optional[bytes]:
        """The payload for ``digest``, or None on miss. Integrity is
        re-verified on EVERY read; a checksum mismatch drops the entry
        and reports a miss — corrupted K/V is never handed back to be
        scattered into the pool."""
        entry = self._ram.get(digest)
        if entry is not None:
            payload, checksum = entry
            if _checksum(payload) != checksum:
                del self._ram[digest]
                self._ram_bytes -= len(payload)
                self.corrupt_dropped += 1
                self.misses += 1
                log.error("kv tier: corrupt payload dropped (digest %s, ram)", digest[:16])
                return None
            self._ram.move_to_end(digest)
            self.hits += 1
            return payload
        payload = self._disk_get(digest)
        if payload is not None:
            self.hits += 1
            # promote: recently-restored chains are likely to be hit again
            self._ram[digest] = (payload, _checksum(payload))
            self._ram_bytes += len(payload)
            self._ram_evict_overflow()
            return payload
        self.misses += 1
        return None

    def discard(self, digest: str) -> None:
        """Forget ``digest`` without firing ``on_evict`` — the owner
        already knows (it is the one discarding)."""
        entry = self._ram.pop(digest, None)
        if entry is not None:
            self._ram_bytes -= len(entry[0])
        nbytes = self._disk.pop(digest, None)
        if nbytes is not None:
            self._disk_bytes -= nbytes
            self._disk_unlink(digest)

    def clear(self) -> None:
        """Drop everything (the pool whose content this tier holds is
        gone — digests describe positions in a pool that no longer
        exists... content survives pool resets in principle, but the
        radix tree that maps digests to matches does not)."""
        self._ram.clear()
        self._ram_bytes = 0
        for digest in list(self._disk):
            self._disk_unlink(digest)
        self._disk.clear()
        self._disk_bytes = 0

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._ram) + len(self._disk)

    @property
    def resident_bytes(self) -> int:
        """Host RAM held right now (the gauge; disk bytes are separate)."""
        return self._ram_bytes

    def stats(self) -> dict:
        return {
            "entries": len(self._ram) + len(self._disk),
            "ram_entries": len(self._ram),
            "ram_bytes": self._ram_bytes,
            "disk_entries": len(self._disk),
            "disk_bytes": self._disk_bytes,
            "puts": self.puts,
            "hits": self.hits,
            "misses": self.misses,
            "corrupt_dropped": self.corrupt_dropped,
            "evictions": self.evictions,
        }


# -- KV migration wire format (disaggregated prefill/decode) --------------
#
# A chain envelope is the unit of KV migration between replicas: one
# self-describing byte string holding a contiguous run of packed KV
# blocks (each the exact ``pack_kv_payload`` bytes the host tier already
# stores — shapes and dtype ride in each block's own KVT1 header) plus
# enough redundancy to reject every transport failure cleanly:
#
#   magic     b"KVM1"
#   version   <H>  (skew -> WireFormatError, never a misparse)
#   chain     <H len><ascii>  the LEAF digest (names the whole chain)
#   count     <I>
#   blocks    count x [<H len><ascii digest> <16s checksum> <I len> payload]
#   trailer   16-byte blake2b over everything above
#
# The importer verifies the trailer, every per-block checksum, and each
# payload's KVT1 structure before anything touches the local tier — a
# truncated/bit-flipped/mis-versioned envelope raises WireFormatError
# and the decode engine falls back to recompute-prefill.

_WIRE_MAGIC = b"KVM1"
_WIRE_VERSION = 1


class WireFormatError(ValueError):
    """A chain envelope failed structural/integrity/version checks."""


def _validate_block_payload(digest: str, payload: bytes) -> None:
    """Structural check of one packed block (magic + dims-implied length)
    WITHOUT copying it out — shapes/dtype are declared by the KVT1
    header and must account for every byte."""
    if payload[:4] != _MAGIC:
        raise WireFormatError(f"block {digest[:16]}: bad payload magic")
    if len(payload) < 20:
        raise WireFormatError(f"block {digest[:16]}: truncated header")
    L, Hkv, bs, D = struct.unpack_from("<4I", payload, 4)
    n_q, n_s = L * Hkv * bs * D, L * Hkv * bs
    want = 4 + 16 + 2 * n_q + 2 * 4 * n_s
    if len(payload) != want:
        raise WireFormatError(
            f"block {digest[:16]}: payload length {len(payload)} != "
            f"{want} implied by dims ({L},{Hkv},{bs},{D})"
        )


def pack_chain_envelope(blocks: "list[tuple[str, bytes]]") -> bytes:
    """Pack an ordered (root->leaf) run of ``(digest, payload)`` blocks
    into one versioned wire envelope. The last digest names the chain."""
    if not blocks:
        raise ValueError("cannot pack an empty chain")
    leaf = blocks[-1][0].encode("ascii")
    parts = [
        _WIRE_MAGIC,
        struct.pack("<H", _WIRE_VERSION),
        struct.pack("<H", len(leaf)),
        leaf,
        struct.pack("<I", len(blocks)),
    ]
    for digest, payload in blocks:
        d = digest.encode("ascii")
        parts.append(struct.pack("<H", len(d)))
        parts.append(d)
        parts.append(_checksum(payload))
        parts.append(struct.pack("<I", len(payload)))
        parts.append(payload)
    body = b"".join(parts)
    return body + _checksum(body)


def unpack_chain_envelope(buf: bytes) -> "list[tuple[str, bytes]]":
    """Inverse of :func:`pack_chain_envelope`. Verifies the envelope
    trailer, per-block checksums and per-block KVT1 structure; raises
    :class:`WireFormatError` on ANY mismatch (truncation, bit flip,
    version skew) so a migration failure is always a clean rejection."""
    if len(buf) < 4 + 2 + 2 + 4 + _CHECKSUM_SIZE:
        raise WireFormatError("envelope too short")
    if buf[:4] != _WIRE_MAGIC:
        raise WireFormatError("bad envelope magic")
    body, trailer = buf[:-_CHECKSUM_SIZE], buf[-_CHECKSUM_SIZE:]
    if _checksum(body) != trailer:
        raise WireFormatError("envelope checksum mismatch")
    (version,) = struct.unpack_from("<H", buf, 4)
    if version != _WIRE_VERSION:
        raise WireFormatError(
            f"envelope version {version} != supported {_WIRE_VERSION}"
        )
    off = 6
    (dlen,) = struct.unpack_from("<H", buf, off)
    off += 2
    leaf = buf[off : off + dlen].decode("ascii")
    off += dlen
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    blocks: list[tuple[str, bytes]] = []
    end = len(body)
    for _ in range(count):
        if off + 2 > end:
            raise WireFormatError("envelope truncated in block header")
        (dlen,) = struct.unpack_from("<H", buf, off)
        off += 2
        digest = buf[off : off + dlen].decode("ascii")
        off += dlen
        checksum = buf[off : off + _CHECKSUM_SIZE]
        off += _CHECKSUM_SIZE
        if off + 4 > end:
            raise WireFormatError("envelope truncated in block header")
        (plen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + plen > end:
            raise WireFormatError("envelope truncated in block payload")
        payload = buf[off : off + plen]
        off += plen
        if _checksum(payload) != checksum:
            raise WireFormatError(f"block {digest[:16]}: checksum mismatch")
        _validate_block_payload(digest, payload)
        blocks.append((digest, payload))
    if off != end:
        raise WireFormatError("trailing bytes after last block")
    if not blocks or blocks[-1][0] != leaf:
        raise WireFormatError("leaf digest does not name the last block")
    return blocks


def export_chain(tier: HostKVTier, digests: "list[str]") -> Optional[bytes]:
    """Build a chain envelope from payloads the tier holds. Returns None
    when ANY digest misses (a partial chain is unrestorable below the
    gap — the caller serves what it can by trimming ``digests`` first)."""
    blocks: list[tuple[str, bytes]] = []
    for digest in digests:
        payload = tier.get(digest)
        if payload is None:
            return None
        blocks.append((digest, payload))
    if not blocks:
        return None
    return pack_chain_envelope(blocks)


def import_chain(tier: HostKVTier, buf: bytes) -> "list[str]":
    """Validate ``buf`` (raising :class:`WireFormatError`) and retain
    every block in the local tier. Returns the digests in chain order —
    the caller promotes the matching remote radix nodes to spilled."""
    blocks = unpack_chain_envelope(buf)
    for digest, payload in blocks:
        tier.put(digest, payload)
    return [digest for digest, _ in blocks]


class KVMigrateError(RuntimeError):
    """A chain fetch failed for a non-retryable reason (unknown digest
    at the source, migration disabled there)."""


class KVMigrationClient:
    """HTTP pull client for ``GET <source>/kv/chain/<digest>``, retried
    under :class:`~devspace_tpu_torch.resilience.policy.RetryPolicy`
    (transient transport errors only — a 404 means the source no longer
    holds the chain and fails fast as :class:`KVMigrateError`). A custom
    ``fetch_fn(source, digest) -> bytes`` replaces the HTTP transport
    for in-process tests."""

    def __init__(
        self,
        retry=None,
        timeout_s: float = 5.0,
        fetch_fn=None,
    ):
        if retry is None:
            from ..resilience.policy import RetryPolicy

            retry = RetryPolicy(
                max_attempts=3,
                base_delay=0.05,
                max_delay=0.5,
                jitter=0.5,
                retry_on=(OSError,),
                seed=0,
            )
        self.retry = retry
        self.timeout_s = timeout_s
        self._fetch_fn = fetch_fn

    def _fetch_once(self, source: str, digest: str) -> bytes:
        if self._fetch_fn is not None:
            return self._fetch_fn(source, digest)
        import urllib.error
        import urllib.request

        url = f"{source.rstrip('/')}/kv/chain/{digest}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KVMigrateError(f"chain not held by source: {url}") from None
            raise OSError(f"kv fetch http {e.code}: {url}") from None

    def fetch(self, source: str, digest: str) -> bytes:
        """The chain envelope for ``digest`` from ``source``. Raises
        :class:`KVMigrateError` (gone at source) or the resilience
        layer's exhaustion error; the engine maps either to
        recompute-prefill."""
        return self.retry.execute(
            self._fetch_once,
            source,
            digest,
            describe=f"kv chain fetch {digest[:16]}",
            reraise=True,
        )


def resolve_kv_tier(kv_tier: Optional[str]) -> str:
    """Tier-mode resolution, mirroring ``resolve_dispatch_depth``: the
    explicit constructor arg wins, then the ``DEVSPACE_KV_TIER`` env knob,
    default off. Returns ``"off"``, ``"host"`` or ``"host+disk"``."""
    val = (
        str(kv_tier).strip().lower()
        if kv_tier is not None
        else os.environ.get("DEVSPACE_KV_TIER", "").strip().lower()
    )
    if val in ("", "off", "0", "false", "no", "none"):
        return "off"
    if val in ("host", "ram", "on", "true", "yes", "1"):
        return "host"
    if val in ("host+disk", "host_disk", "hostdisk", "disk"):
        return "host+disk"
    raise ValueError(
        f"kv_tier must be off|host|host+disk, got {kv_tier!r}"
    )
