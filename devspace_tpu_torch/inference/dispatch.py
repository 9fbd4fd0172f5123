"""Overlapped decode dispatch: a device-resident carry and an in-flight
window.

Counterpart of ``devspace_tpu/inference/dispatch.py``. The serial loop
uploads every slot's decode inputs, runs a decode chunk, reads its
tokens back and only then does the host work of emitting them, while the
card waits. Only the token readback has to wait for the card, so the
loop is built around it:

- **Device-resident carry** (``self.carry``): the per-slot decode inputs
  (``tokens``, ``positions``, ``temps``, ``top_ks``, ``top_ps``,
  ``seeds``, block ``tables``) live on the device in tensors allocated
  once and never reallocated (a captured CUDA graph holds their
  addresses; see ``inference/graphs.py``). Every decode chunk reads them
  and writes its advanced tokens and positions back in place. Host-side
  slot changes (prefill completion, table growth or release) set
  per-slot dirty flags; the next dispatch that includes a dirty slot
  folds every dirty participating row in with ONE packed host upload and
  one masked merge done in place, the ``apply_carry_update`` of the
  reference engine. Rows that are not dirty are device-authoritative and
  never clobbered by stale host state. The reference keys draws by
  ``self._keys``; this port keys them by each slot's seed, which rides
  in the carry.

- **Dispatch-ahead window** (``self.window``, depth ``dispatch_depth``):
  since the carry chains on the device, chunk N+1 is dispatched before
  chunk N's tokens are read. After each replay the chunk's tokens are
  copied into a pinned host buffer of its window lane and an event is
  recorded; entries drain in dispatch order, without blocking while
  their event has not completed (``torch.cuda.Event.query``), and the
  host blocks, on the oldest entry's event, only when the window is
  full. Emitting chunk N thus overlaps chunk N+1 on the card. On the CPU
  there is no event and an entry reports itself not ready, the
  reference's conservative fallback: the window fills and the blocking
  drain runs. Depth 1 is the serial loop (``DEVSPACE_ENGINE_OVERLAP=off``)
  and the reference the equivalence tests compare against.

- **Overshoot and zombies**: a slot that finishes while later chunks
  still reference it becomes a zombie: its blocks stay allocated
  (``pending_free``) and the slot is not re-admitted (``slot_busy``)
  until every in-flight chunk referencing it has drained, so in-flight
  writes land in its own blocks, never a peer's.

- **Host-tier restores**: the engine's restores (``_restore_spilled``)
  queue their uploads and scatters on the same stream as the window's
  replays, behind the in-flight chunks, and run while the host drains
  tokens; ``note_restores`` counts the blocks restored and those that
  found chunks in flight (``kv_restores``, ``kv_restores_overlapped``).

- **Failure**: ``abandon()`` drops the whole window without reading it
  (the engine fails every slot-resident request and zeroes the pool) and
  marks every carry row dirty; the carry tensors themselves stay, since
  the graphs hold their addresses.

A slot's n-th token depends only on (prompt, seed, n): draws are keyed
by the slot's seed and the absolute position sampled from
(``inference/sampling.py``), attention reads only the slot's own blocks,
and the carry row chains on the device from the slot's prefill. So the
window's depth, chunk sizes, co-resident slots and preemption points do
not change a stream (``tests/test_torch_dispatch.py``).

Left out until the port's observability slice: the reference's event
bus and timeline hooks (``_events.emit`` and the per-lane decode and
readback tracks).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ..obs import events as _events
from ..obs.tracing import TRACK_READBACK, device_decode_track

if TYPE_CHECKING:  # pragma: no cover - types only
    from .engine import InferenceEngine

# packed upload columns: participation, state and table masks, then the
# state row (token, position, top_k, seed, and the float32 bits of
# temperature and top_p); the table row follows
_ACTIVE, _STATE, _TABLE, _INTS, _FLOATS, _COLS = 0, 1, 2, 3, 7, 9
_INT_FIELDS = ("tokens", "positions", "top_ks", "seeds")


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the card: through
    pinned memory (whose caching allocator keeps the block until the copy
    has run) with a non-blocking copy. A copy from pageable memory would
    wait for every chunk still queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _InFlight:
    """One dispatched-but-unread decode chunk."""

    __slots__ = ("event", "lane", "slots", "gens", "k_steps", "t_dispatch")

    def __init__(self, event, lane: int, slots: list[int], gens: list[int], k_steps: int):
        self.event = event  # recorded after the readback copy (None on the CPU)
        self.lane = lane  # window lane: which pinned host buffer holds the tokens
        self.slots = slots  # participating slot indices
        self.gens = gens  # slot.gen at dispatch (re-admission guard)
        self.k_steps = k_steps
        # in a timeline capture: the host clock at dispatch, so the chunk's
        # residency [dispatch, readback] is drawn on its lane's track
        self.t_dispatch = 0.0


def _toks_ready(entry: _InFlight) -> bool:
    """Non-blocking readiness probe: the entry's event on the card; on the
    CPU, NOT ready (the conservative direction: an opportunistic drain is
    skipped, and the window-full blocking drain bounds the queue)."""
    if entry.event is None:
        return False
    try:
        return entry.event.query()
    except RuntimeError:  # a device fault: take the blocking path so it surfaces there
        return True


class DecodeDispatcher:
    """Owns the in-flight decode window and the device-resident carry of
    one :class:`~devspace_tpu_torch.inference.engine.InferenceEngine`.

    The engine's scheduler thread is the only caller; nothing here is
    locked. The dispatcher emits and frees blocks on drain where the
    serial loop did; the engine keeps the scheduling policy (admission,
    preemption, spec interleaving, chunk sizing)."""

    def __init__(self, engine: "InferenceEngine", depth: int):
        if not 1 <= int(depth) <= 8:
            raise ValueError(f"dispatch_depth must be in 1..8, got {depth}")
        self.engine = engine
        self.depth = int(depth)
        B, mb, dev = engine.max_slots, engine.max_blocks, engine.device
        self.window: deque[_InFlight] = deque()
        # per-slot count of in-flight chunks / in-flight decode steps
        self.refs = [0] * B
        self.inflight_steps = [0] * B
        # finished slots still referenced by in-flight chunks: their blocks
        # are freed when the last reference drains
        self.pending_free: set[int] = set()
        self._state_dirty = [True] * B
        self._table_dirty = [True] * B

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.carry = {
            "tokens": zeros(B), "positions": zeros(B), "top_ks": zeros(B), "seeds": zeros(B),
            "temps": zeros(B, dtype=torch.float32),
            "top_ps": torch.ones((B,), dtype=torch.float32, device=dev),
            "tables": zeros(B, mb, dtype=torch.int32),
        }
        # the rows a program decodes; every other row is parked
        self.active = zeros(B, dtype=torch.bool)
        # the decode programs' token output, and one pinned host buffer
        # per window lane that each replay's tokens are copied into
        self.toks_out = zeros(engine.chunk_max, B)
        self._host = [
            torch.zeros((engine.chunk_max, B), dtype=torch.int64, pin_memory=dev.type == "cuda")
            for _ in range(self.depth)
        ]
        self.dispatches = 0
        self.carry_updates = 0
        self.occupancy_sum = 0  # window depth summed at each dispatch
        self.readback_wait_s = 0.0  # host time blocked on token readback
        self.loop_busy_s = 0.0  # scheduler-iteration time (the engine adds)
        self.kv_restores = 0  # blocks restored from the host tier
        self.kv_restores_overlapped = 0  # of those, restored behind in-flight chunks

    # -- carry -------------------------------------------------------------
    def invalidate_state(self, i: int) -> None:
        """The host is now authoritative for slot i's token, position and
        sampling row (prefill completion); the next dispatch that includes
        i uploads it."""
        self._state_dirty[i] = True

    def invalidate_table(self, i: int) -> None:
        """Slot i's block table changed (``_alloc``/``_free_slot_blocks``)."""
        self._table_dirty[i] = True

    def sync_carry(self, rows: list[int]) -> None:
        """Make ``rows`` the active rows and fold every dirty one of them
        into the carry: ONE packed upload, one masked merge in place."""
        eng = self.engine
        up = np.zeros((eng.max_slots, _COLS + eng.max_blocks), np.int64)
        up[rows, _ACTIVE] = 1
        dirty = [i for i in rows if self._state_dirty[i] or self._table_dirty[i]]
        for i in dirty:
            if self._state_dirty[i]:
                s = eng.slots[i]
                up[i, _STATE] = 1
                up[i, _INTS:_FLOATS] = (s.last_token, s.length - 1, s.req.top_k, eng._seeds[i])
                up[i, _FLOATS:_COLS] = np.array(
                    [s.req.temperature, s.req.top_p], np.float32).view(np.int32)
                self._state_dirty[i] = False
            if self._table_dirty[i]:
                up[i, _TABLE] = 1
                up[i, _COLS:] = eng._tables[i]
                self._table_dirty[i] = False
        u = upload(up, eng.device)
        self.active.copy_(u[:, _ACTIVE] != 0)
        if not dirty:
            return
        c = self.carry
        state = u[:, _STATE] != 0
        for j, name in enumerate(_INT_FIELDS):
            c[name].copy_(torch.where(state, u[:, _INTS + j], c[name]))
        floats = u[:, _FLOATS:_COLS].to(torch.int32).view(torch.float32)
        c["temps"].copy_(torch.where(state, floats[:, 0], c["temps"]))
        c["top_ps"].copy_(torch.where(state, floats[:, 1], c["top_ps"]))
        table = (u[:, _TABLE] != 0)[:, None]
        c["tables"].copy_(torch.where(table, u[:, _COLS:].to(torch.int32), c["tables"]))
        self.carry_updates += 1

    # -- window ------------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self.window)

    @property
    def full(self) -> bool:
        return len(self.window) >= self.depth

    def note_restores(self, n: int, overlapped: bool) -> None:
        """The engine restored ``n`` spilled KV blocks; ``overlapped`` when
        the window held in-flight chunks then, so the restore's device
        work queued behind them while the host went on draining."""
        self.kv_restores += n
        if overlapped:
            self.kv_restores_overlapped += n

    def slot_busy(self, i: int) -> bool:
        """True while in-flight chunks still reference slot i: a finished
        (zombie) slot must not be re-admitted until they drain, because
        their writes target its still-allocated blocks."""
        return self.refs[i] > 0

    def dispatch(self, plain: list[int], k_steps: int, mode: str) -> None:
        """Send one decode chunk for ``plain`` (returns once the replay and
        its readback copy are queued) and append it to the window."""
        eng = self.engine
        # the lane's host buffer is free: the window holds at most depth-1
        # entries here, none of them of this lane
        lane = self.dispatches % self.depth
        self.sync_carry(plain)
        eng._programs.run(("decode", k_steps, mode))
        host = self._host[lane]
        host[:k_steps].copy_(self.toks_out[:k_steps], non_blocking=True)
        event = None
        if eng.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        entry = _InFlight(event, lane, list(plain), [eng.slots[i].gen for i in plain], k_steps)
        if eng._timeline is not None:
            entry.t_dispatch = time.monotonic()
        self.window.append(entry)
        for i in plain:
            self.refs[i] += 1
            self.inflight_steps[i] += k_steps
        self.dispatches += 1
        self.occupancy_sum += len(self.window)
        _events.emit("dispatch", "depth_change", level="debug", depth=len(self.window),
                     direction="up", slots=len(plain))

    def drain(self, block: bool = False) -> int:
        """Retire in-flight chunks in dispatch order. ``block=True`` waits
        for the oldest entry (the window-full / idle path); after it, and
        always when ``block=False``, only entries whose tokens are already
        on the host are consumed. Returns the number drained."""
        drained = 0
        while self.window:
            if not block and not _toks_ready(self.window[0]):
                break
            self._consume_oldest()
            drained += 1
            block = False
        return drained

    def drain_all(self) -> None:
        """Blocking drain of the whole window: before anything that needs
        settled slot state (the preemption ladder, a speculative round)."""
        while self.window:
            self._consume_oldest()

    def _consume_oldest(self) -> None:
        entry = self.window.popleft()
        t0 = time.monotonic()
        try:
            if entry.event is not None:
                entry.event.synchronize()
            toks = self._host[entry.lane][: entry.k_steps].tolist()
        finally:
            t1 = time.monotonic()
            self.readback_wait_s += t1 - t0
        eng = self.engine
        tl = eng._timeline
        if tl is not None and entry.t_dispatch:
            # the chunk on its window lane, the host's blocked wait apart
            trace_ids = [
                eng.slots[i].req._obs_trace.trace_id
                for i, g in zip(entry.slots, entry.gens)
                if eng.slots[i].req is not None and eng.slots[i].gen == g
                and getattr(eng.slots[i].req, "_obs_trace", None) is not None
            ]
            tl.add(device_decode_track(entry.lane), f"decode x{entry.k_steps}",
                   entry.t_dispatch, t1, slots=list(entry.slots), k_steps=entry.k_steps,
                   trace_ids=trace_ids)
            tl.add(TRACK_READBACK, "readback", t0, t1)
        for n, i in enumerate(entry.slots):
            self.refs[i] -= 1
            self.inflight_steps[i] -= entry.k_steps
            slot = eng.slots[i]
            if slot.req is not None and slot.gen == entry.gens[n]:
                for j in range(entry.k_steps):
                    if slot.req is None:
                        break  # finished mid-chunk; the rest is overshoot
                    eng._emit(i, toks[j][i])
            if self.refs[i] == 0 and i in self.pending_free:
                self.pending_free.discard(i)
                eng._free_slot_blocks(i)
        _events.emit("dispatch", "depth_change", level="debug", depth=len(self.window),
                     direction="down")

    def abandon(self) -> None:
        """Drop the whole window without reading it (the failure path:
        ``_fail_outstanding`` calls this before failing slot-resident
        requests); zombie blocks are released and every carry row is
        marked dirty."""
        if self.window:
            _events.emit("dispatch", "window_abandoned", level="warn", dropped=len(self.window))
        self.window.clear()
        B = self.engine.max_slots
        self.refs = [0] * B
        self.inflight_steps = [0] * B
        for i in sorted(self.pending_free):
            self.engine._free_slot_blocks(i)
        self.pending_free.clear()
        self._state_dirty = [True] * B
        self._table_dirty = [True] * B

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        occ = round(self.occupancy_sum / self.dispatches, 3) if self.dispatches else 0.0
        return {
            "dispatch_depth": self.depth,
            "dispatch_depth_occupancy": occ,
            "decode_dispatches": self.dispatches,
            "readback_wait_s": round(self.readback_wait_s, 4),
            "host_sched_s": round(max(0.0, self.loop_busy_s - self.readback_wait_s), 4),
            "carry_updates": self.carry_updates,
            "kv_restores": self.kv_restores,
            "kv_restores_overlapped": self.kv_restores_overlapped,
        }


def resolve_dispatch_depth(dispatch_depth: Optional[int]) -> int:
    """Window depth: an explicit argument wins, then the
    ``DEVSPACE_ENGINE_OVERLAP`` environment knob (``off``/``0``/``serial``
    -> the serial depth-1 loop; an integer -> that depth); default 2 (one
    chunk on the card while the host drains the other)."""
    if dispatch_depth is not None:
        return int(dispatch_depth)
    env = os.environ.get("DEVSPACE_ENGINE_OVERLAP", "").strip().lower()
    if env in ("off", "0", "serial", "false", "no"):
        return 1
    if env in ("", "on", "true", "yes", "1", "default"):
        return 2
    try:
        return max(1, int(env))
    except ValueError:
        return 2
