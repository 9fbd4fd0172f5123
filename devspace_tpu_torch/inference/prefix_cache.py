"""Radix-tree prefix cache for the paged-KV serving engine.

The port's own copy of ``devspace_tpu/inference/prefix_cache.py``: plain
host Python (no torch, no locks: the engine's scheduler thread is the
only caller), the same classes and the same semantics, pinned by
``tests/test_torch_prefix_cache.py`` against :class:`FlatPrefixCache`
and against the reference package's cache.

Full prompt blocks, once their K/V is written, are published in a radix
tree whose edges are one block's token tuple, so matching a prompt walks
the tree one block at a time (``Cursor.step``: O(block) hashing per
step, O(prompt) a match) and eviction walks only the evicted subtree
(``pop_victim``: a lazy min-heap over evictable candidates):

- a block is published under its content (the token chain from the
  root); first writer wins, duplicates stay private;
- matching touches the chain LRU-most-recent, publishing does not
  reorder existing entries;
- the eviction victim is the least-recently-touched block with no table
  references;
- evicting a mid-chain block unpublishes every descendant (a prefix
  chain is only matchable through its full ancestor line): ref-0
  descendants are freed immediately, in-use ones are unpublished so
  their table release frees them.

:class:`FlatPrefixCache` is the reference model behind the same API (an
``OrderedDict`` keyed by full token prefixes, a linear victim scan, a
full-key descendant sweep); the engine does not use it.

The cache owns no pool blocks: it maps block ids it is told about and
mirrors the engine's table refcounts via :meth:`RadixPrefixCache.ref` /
:meth:`RadixPrefixCache.release`.

Two more node states come with the copy and stay unused until the port
has a host KV tier: **spilled** (``track_digests=True``: an evicted
chain's nodes stay matchable with ``blk == -1`` while their K/V lives in
the host tier, and ``Cursor.step_tiered`` reports their content digests,
the incremental blake2b of the token chain) and **remote** (the payload
lives in another replica's tier; ``Cursor.publish_remote`` records the
source and ``promote_remote`` turns it spilled once fetched):

    resident --pop_victim(collect_spill)--> spilled --publish--> resident
    resident --pop_victim()------------------------------------> gone
    spilled --drop_spilled / broken ancestor chain-------------> gone
    (absent) --publish_remote--> remote --promote_remote--> spilled
    remote --publish (recompute republish)-----------------> resident
    remote --drop_spilled / broken ancestor chain----------> gone

With ``track_digests=False`` (the default) no spilled node can exist.
"""

from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Optional


def _chain_digest(parent_digest: str, edge: tuple) -> str:
    """Incremental content address: blake2b over the parent's digest and
    this block's token tuple — equal digests iff equal token chains from
    the root. O(block) per node, computed once at publish."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_digest.encode("ascii"))
    h.update(",".join(map(str, edge)).encode("ascii"))
    return h.hexdigest()


def fingerprint_chain(token_ids, block_size: int) -> list:
    """Block-digest chain of a token prefix: the blake2b content
    addresses of each complete ``block_size`` block, chained from the
    root exactly as the radix tree computes them (``_chain_digest`` with
    the root anchor ``""``). Two prefixes share their first K digests
    iff they share their first ``K * block_size`` tokens — which is what
    lets a component that never sees another process's radix tree (the
    serving router's shadow index, the stub replica's prefix memory)
    still reason about cache overlap in the tree's own currency. The
    trailing partial block is excluded: it can never be a published
    cache entry. O(len(token_ids)) hashing."""
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    digest = ""
    chain = []
    for i in range(0, len(token_ids) - block_size + 1, block_size):
        digest = _chain_digest(digest, tuple(token_ids[i:i + block_size]))
        chain.append(digest)
    return chain


class _Node:
    """One published block: ``edge`` is the block's own token tuple (the
    child key under ``parent``), ``blk`` the pool block id, ``refs`` the
    mirrored table refcount, ``touch`` the LRU stamp (monotonic clock;
    larger = more recently matched/published). ``digest`` is the chain
    content address (tiered mode only, else None). State encoding:
    resident (``blk >= 0``, in ``_by_block``), spilled (``blk == -1``,
    in ``_spilled``, still in ``parent.children``), remote (``blk ==
    -1``, in ``_remote``, payload on another replica), gone (detached).
    ``live`` is the heap-validity flag: True only while resident."""

    __slots__ = (
        "edge", "parent", "children", "blk", "refs", "touch", "live", "digest",
    )

    def __init__(self, edge, parent, blk, refs, touch):
        self.edge = edge
        self.parent = parent
        self.children: dict = {}
        self.blk = blk
        self.refs = refs
        self.touch = touch
        self.live = True
        self.digest: Optional[str] = None


class Cursor:
    """Incremental walk from the root, one block per step — the unit of
    hashing is ONE block's token tuple, never the whole prefix."""

    __slots__ = ("_cache", "_node")

    def __init__(self, cache: "RadixPrefixCache"):
        self._cache = cache
        self._node = cache._root

    def step(self, edge: tuple) -> Optional[int]:
        """Match one block: descend by ``edge`` and return the resident
        block id (touching it LRU-most-recent), or None when the chain
        ends here — a SPILLED child also ends the resident walk (its
        K/V is host-side; use :meth:`step_tiered` to keep matching
        through it). O(len(edge)) hashing."""
        child = self._node.children.get(edge)
        if child is None or child.blk < 0:
            return None
        self._cache._touch(child)
        self._node = child
        return child.blk

    def step_tiered(self, edge: tuple) -> Optional[tuple[str, object]]:
        """Tiered match step: ``("res", blk)`` for a resident child
        (LRU-touched, like :meth:`step`), ``("spill", digest)`` for a
        spilled one (no touch — spilled nodes are outside the LRU; the
        engine restores the digest's payload into a fresh block and
        revives the node via :meth:`publish`), ``("remote", digest)``
        for a remote one (payload on another replica — the engine
        fetches its wire envelope and promotes it to spilled before
        restoring), None when the chain ends."""
        child = self._node.children.get(edge)
        if child is None:
            return None
        if child.blk < 0:
            self._node = child
            if child.digest in self._cache._remote:
                return ("remote", child.digest)
            return ("spill", child.digest)
        self._cache._touch(child)
        self._node = child
        return ("res", child.blk)

    def publish_remote(self, edge: tuple, source: str) -> Optional[str]:
        """Record that the NEXT block of this chain is held by another
        replica (``source`` is its base URL): descend by ``edge``,
        inserting a REMOTE node (``blk == -1``, payload fetchable from
        ``source``) when the chain ends here. Returns the node's chain
        digest. An existing child in ANY state is left untouched (a
        resident/spilled copy is strictly better than a remote promise;
        an existing remote node keeps its original source) — the cursor
        just descends. Tiered mode only."""
        cache = self._cache
        if not cache._track_digests:
            raise RuntimeError("publish_remote requires track_digests=True")
        child = self._node.children.get(edge)
        if child is not None:
            self._node = child
            return child.digest
        node = _Node(edge, self._node, -1, 0, 0)
        node.live = False
        node.digest = _chain_digest(self._node.digest or "", edge)
        self._node.children[edge] = node
        cache._remote[node.digest] = (node, source)
        self._node = node
        return node.digest

    def publish(self, edge: tuple, blk: int, refs: int) -> int:
        """Publish one block: descend by ``edge``, inserting a node for
        ``blk`` (with ``refs`` mirrored table references) when the chain
        ends here. Returns the RESIDENT block id — ``blk`` itself when
        inserted, the first writer's block when the content is already
        cached (the caller's copy stays private). Existing entries are
        NOT LRU-touched (publish never reorders, matching the flat
        map). Publishing onto a SPILLED node revives it with ``blk`` —
        the restore path (the tier's payload scattered into a fresh
        block) and the recompute-fallback republish both land here."""
        child = self._node.children.get(edge)
        if child is not None:
            if child.blk >= 0:
                self._node = child
                return child.blk
            cache = self._cache
            cache._clock += 1
            child.blk = blk
            child.refs = refs
            child.touch = cache._clock
            child.live = True
            cache._by_block[blk] = child
            cache._spilled.pop(child.digest, None)
            cache._remote.pop(child.digest, None)
            if refs == 0:
                cache._evictable += 1
                heapq.heappush(cache._heap, (child.touch, id(child), child))
            self._node = child
            return blk
        cache = self._cache
        cache._clock += 1
        node = _Node(edge, self._node, blk, refs, cache._clock)
        if cache._track_digests:
            node.digest = _chain_digest(self._node.digest or "", edge)
        self._node.children[edge] = node
        cache._by_block[blk] = node
        if refs == 0:
            cache._evictable += 1
            heapq.heappush(cache._heap, (node.touch, id(node), node))
        self._node = node
        return blk


class RadixPrefixCache:
    """Tree-structured published-block index. See module docstring.

    ``track_digests=True`` enables tiered mode: nodes carry chain
    content digests and eviction can SPILL chains (keep them matchable
    with their K/V parked host-side) instead of dropping them. Off by
    default — the engine turns it on only with a host tier attached, so
    the untiered engine pays zero digest hashing and behaves
    byte-identically to before."""

    def __init__(self, track_digests: bool = False):
        self._track_digests = bool(track_digests)
        self._root = _Node(None, None, -1, 0, 0)
        self._root.live = False  # never a victim
        self._root.digest = ""  # digest chain anchor
        self._by_block: dict[int, _Node] = {}
        # digest -> spilled node (tiered mode; empty otherwise)
        self._spilled: dict[str, _Node] = {}
        # digest -> (remote node, source URL): payload on another replica
        self._remote: dict[str, tuple[_Node, str]] = {}
        self._clock = 0
        # lazy min-heap of (touch, tiebreak, node) eviction candidates:
        # entries go stale when the node is re-touched, re-referenced or
        # evicted; pop_victim discards them on the way out. Only ref-0
        # nodes are ever pushed, so the heap never scans live traffic.
        self._heap: list = []
        self._evictable = 0

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_block)

    def spilled_count(self) -> int:
        """Spilled (host-tier-backed) nodes currently matchable."""
        return len(self._spilled)

    def remote_count(self) -> int:
        """Remote (other-replica-backed) nodes currently matchable."""
        return len(self._remote)

    def remote_source(self, digest: str) -> Optional[str]:
        """The source URL a remote node's payload is fetchable from, or
        None when ``digest`` is not a remote node."""
        entry = self._remote.get(digest)
        return entry[1] if entry is not None else None

    def chain_to(self, digest: str) -> Optional[list[tuple[str, int]]]:
        """The root->leaf ``(digest, blk)`` line ending at the node whose
        chain digest is ``digest`` (``blk == -1`` for spilled/remote
        entries), or None when unknown. The KV export path uses this to
        serve a peer's migration pull. Resident leaves cost a scan of
        ``_by_block`` — no digest index is maintained because exports
        are rare (one per migration) and the hot paths stay lean."""
        node = self._spilled.get(digest)
        if node is None:
            entry = self._remote.get(digest)
            node = entry[0] if entry is not None else None
        if node is None:
            for n in self._by_block.values():
                if n.digest == digest:
                    node = n
                    break
        if node is None:
            return None
        chain: list[tuple[str, int]] = []
        while node is not None and node.parent is not None:
            chain.append((node.digest, node.blk))
            node = node.parent
        chain.reverse()
        return chain

    def promote_remote(self, digest: str) -> bool:
        """remote -> spilled: the payload for ``digest`` has been
        imported into the LOCAL tier (migration fetch succeeded), so the
        node is now restorable through the ordinary spilled ladder.
        Returns False for unknown digests."""
        entry = self._remote.pop(digest, None)
        if entry is None:
            return False
        self._spilled[digest] = entry[0]
        return True

    def is_published(self, blk: int) -> bool:
        return blk in self._by_block

    def evictable(self) -> int:
        """Published blocks with no table references — reclaimable. O(1)."""
        return self._evictable

    def evictable_excluding(self, blks) -> int:
        """Evictable count, not counting ``blks`` (an admission must not
        count the ref-0 cached blocks it is itself about to reference as
        evictable for its private pops). O(len(blks))."""
        n = self._evictable
        for b in blks:
            node = self._by_block.get(b)
            if node is not None and node.refs == 0:
                n -= 1
        return n

    # -- matching / publishing --------------------------------------------
    def cursor(self) -> Cursor:
        return Cursor(self)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.touch = self._clock
        if node.refs == 0:
            heapq.heappush(self._heap, (node.touch, id(node), node))

    # -- refcount mirror ---------------------------------------------------
    def ref(self, blk: int) -> None:
        """A slot table now references published block ``blk``."""
        node = self._by_block[blk]
        node.refs += 1
        if node.refs == 1:
            self._evictable -= 1

    def release(self, blk: int) -> None:
        """A slot table dropped its reference to published block ``blk``.
        At ref 0 the block becomes an eviction candidate at its LAST
        TOUCH position (matching survives the referenced span — the flat
        map's move_to_end happened at match time, not release time)."""
        node = self._by_block[blk]
        node.refs -= 1
        if node.refs == 0:
            self._evictable += 1
            heapq.heappush(self._heap, (node.touch, id(node), node))

    # -- eviction ----------------------------------------------------------
    def pop_victim(
        self,
        collect_spill: Optional[list] = None,
        dropped: Optional[list] = None,
    ) -> tuple[int, list[int]]:
        """Reclaim the least-recently-touched ref-0 block for private
        reuse. Returns ``(victim_blk, freed)`` where ``freed`` lists the
        victim's ref-0 DESCENDANT blocks, unpublished along with it (the
        chain below an evicted block is unmatchable — ``freed`` goes
        straight back to the allocator's free list; in-use descendants
        are unpublished so their table release frees them). Cost is the
        heap pop plus a walk of the evicted subtree — never a scan of
        the whole cache. Raises RuntimeError when nothing is evictable.

        Tiered mode: with ``collect_spill`` a list (and digests
        tracked), the victim and its ref-0 descendants transition to
        SPILLED instead of gone — they stay in the tree, matchable
        through :meth:`Cursor.step_tiered` — and ``(digest, blk)`` pairs
        are appended for the engine to copy device->host BEFORE reusing
        the returned blocks. In-use descendants still go gone (their
        chain would need the evicted ancestors resident to match...
        they re-publish on their own), and any already-spilled node
        below a gone one is pruned — its digest is appended to
        ``dropped`` so the caller can discard the tier payload."""
        victim = None
        while self._heap:
            touch, _, node = heapq.heappop(self._heap)
            if node.live and node.refs == 0 and node.touch == touch:
                victim = node
                break
        if victim is None:
            raise RuntimeError("allocator invariant: no block available")
        spill = collect_spill is not None and self._track_digests
        freed: list[int] = []
        victim_blk = victim.blk  # _spill_node overwrites blk with -1
        if spill:
            collect_spill.append((victim.digest, victim.blk))
            self._spill_node(victim)
        else:
            del victim.parent.children[victim.edge]
            self._unpublish(victim)
        # (node, chain_ok): ok while every ancestor up to the victim is
        # itself spilled — a spilled node is restorable only through an
        # unbroken ancestor line
        stack = [(n, spill) for n in victim.children.values()]
        while stack:
            n, ok = stack.pop()
            if n.blk < 0:  # spilled/remote from an earlier transition
                if not ok:
                    self._spilled.pop(n.digest, None)
                    self._remote.pop(n.digest, None)
                    if dropped is not None:
                        dropped.append(n.digest)
                    del n.parent.children[n.edge]
                    n.live = False
                stack.extend((c, ok) for c in n.children.values())
                continue
            if ok and n.refs == 0:
                collect_spill.append((n.digest, n.blk))
                freed.append(n.blk)
                self._spill_node(n)
                stack.extend((c, True) for c in n.children.values())
            else:
                if spill:
                    # the victim stays in the tree, so gone descendants
                    # must detach explicitly (untiered eviction detaches
                    # the whole subtree at the victim)
                    del n.parent.children[n.edge]
                self._unpublish(n)
                if n.refs == 0:
                    freed.append(n.blk)
                stack.extend((c, False) for c in n.children.values())
        return victim_blk, freed

    def _unpublish(self, node: _Node) -> None:
        del self._by_block[node.blk]
        node.live = False
        if node.refs == 0:
            self._evictable -= 1

    def _spill_node(self, node: _Node) -> None:
        """resident -> spilled: out of ``_by_block`` and the eviction
        pool (its block is being recycled), but still in the tree and
        indexed by digest for restores. Only ref-0 nodes spill."""
        del self._by_block[node.blk]
        node.live = False
        self._evictable -= 1
        node.blk = -1
        self._spilled[node.digest] = node

    def drop_spilled(self, digest: str) -> tuple[list[str], list[int]]:
        """Prune a spilled node whose payload the host tier no longer
        holds (restore miss, corrupt payload, tier LRU eviction) — a
        dangling spilled node would promise restores forever. The whole
        subtree goes with it (nothing below is matchable without it).
        Returns ``(dropped_digests, freed_blocks)``: descendant spilled
        digests for the caller to discard from the tier, plus the
        blocks of any resident ref-0 descendants (defensive — the
        spill/restore protocol revives top-down, so resident nodes
        below a spilled one should not arise). Also prunes REMOTE
        nodes (a failed migration drops its promised chain the same
        way a tier miss drops a spilled one). No-op for unknown
        digests."""
        node = self._spilled.pop(digest, None)
        if node is None:
            entry = self._remote.pop(digest, None)
            node = entry[0] if entry is not None else None
        dropped: list[str] = []
        freed: list[int] = []
        if node is None:
            return dropped, freed
        del node.parent.children[node.edge]
        node.live = False
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.blk < 0:
                self._spilled.pop(n.digest, None)
                self._remote.pop(n.digest, None)
                dropped.append(n.digest)
                n.live = False
            else:
                self._unpublish(n)
                if n.refs == 0:
                    freed.append(n.blk)
            stack.extend(n.children.values())
        return dropped, freed

    def reset(self) -> None:
        """Drop everything (the pool the blocks indexed is gone)."""
        self._root = _Node(None, None, -1, 0, 0)
        self._root.live = False
        self._root.digest = ""
        self._by_block.clear()
        self._spilled.clear()
        self._remote.clear()
        self._heap.clear()
        self._evictable = 0


class FlatPrefixCache:
    """The flat-map implementation behind the same API (OrderedDict keyed
    by full token prefixes, linear victim scan, full-key descendant
    sweep): the REFERENCE MODEL the randomized trace-equivalence test
    pins the radix cache to. Not used by the engine."""

    def __init__(self):
        self._map: "OrderedDict[tuple, int]" = OrderedDict()
        self._published: dict[int, tuple] = {}  # blk -> its key
        self._refs: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._published)

    def is_published(self, blk: int) -> bool:
        return blk in self._published

    def evictable(self) -> int:
        return sum(
            1 for b in self._published if self._refs.get(b, 0) == 0
        )

    def evictable_excluding(self, blks) -> int:
        excl = set(blks)
        return sum(
            1
            for b in self._published
            if self._refs.get(b, 0) == 0 and b not in excl
        )

    def cursor(self) -> "_FlatCursor":
        return _FlatCursor(self)

    def ref(self, blk: int) -> None:
        self._refs[blk] = self._refs.get(blk, 0) + 1

    def release(self, blk: int) -> None:
        self._refs[blk] = self._refs.get(blk, 0) - 1

    def pop_victim(self) -> tuple[int, list[int]]:
        victim = None
        for key, blk in self._map.items():  # LRU order: oldest first
            if self._refs.get(blk, 0) == 0:
                victim = (key, blk)
                break
        if victim is None:
            raise RuntimeError("allocator invariant: no block available")
        key, blk = victim
        del self._map[key]
        del self._published[blk]
        freed: list[int] = []
        n = len(key)
        for k2 in [k for k in self._map if len(k) > n and k[:n] == key]:
            b2 = self._map.pop(k2)
            del self._published[b2]
            if self._refs.get(b2, 0) == 0:
                freed.append(b2)
        return blk, freed

    def reset(self) -> None:
        self._map.clear()
        self._published.clear()
        self._refs.clear()


class _FlatCursor:
    """Full-prefix rehash per step — the O(L^2) shape being replaced."""

    __slots__ = ("_cache", "_prefix")

    def __init__(self, cache: FlatPrefixCache):
        self._cache = cache
        self._prefix: list = []

    def step(self, edge: tuple) -> Optional[int]:
        self._prefix.extend(edge)
        key = tuple(self._prefix)
        blk = self._cache._map.get(key)
        if blk is None:
            return None
        self._cache._map.move_to_end(key)  # LRU touch
        return blk

    def publish(self, edge: tuple, blk: int, refs: int) -> int:
        self._prefix.extend(edge)
        key = tuple(self._prefix)
        if blk in self._cache._published:
            return blk  # already matchable (e.g. matched at admission)
        existing = self._cache._map.get(key)
        if existing is not None:
            return existing  # another block already holds this content
        self._cache._map[key] = blk
        self._cache._published[blk] = key
        self._cache._refs[blk] = refs
        return blk
