"""The serving engine's program table: one function per key over static
buffers, replayed from a captured CUDA graph on the card.

Counterpart of the reference engine's program tables in
``devspace_tpu/inference/engine.py``: ``self._decode_chunk`` (one jitted
program per ``(k_steps, filters)``, with the pool and the carry donated
through) and ``self._spec_round_jit`` (one per ``filters``). Here a
program is a Python function with no arguments that reads only buffers
allocated once (the carry, the active mask, the sampling extras, the
pool, the draft cache) and writes its results into buffers allocated
once (the carry's tokens and positions, a static output buffer).

- **On the card** a program is captured into a ``torch.cuda.CUDAGraph``
  the first time it runs (or in ``prewarm``) and replayed from then on;
  no eager path is ever taken, and a failed capture or replay raises. A
  graph holds every address it was captured with, so the buffers it
  reads are written in place and never reallocated, and no block id is
  baked into one: tables reach it through the carry. Before capture the
  function runs once, eagerly, on the capture stream with every row
  parked (writes land in scratch block 0 and the draft cache's scratch
  tail): that builds the kernels and creates cuBLAS's handle and
  workspace, which must exist before capture. Capture runs with
  ``capture_error_mode="thread_local"``, so work other threads put on
  the card meanwhile does not break it. All graphs share one memory
  pool: what a graph hands on lives in buffers allocated outside any
  capture, and no two graphs run at once.
- **On the CPU** a program is called eagerly each time: the CPU tests run
  the same functions over the same buffers; only capture and replay are
  card-only.

``captures`` counts programs built: captures on the card, first uses on
the CPU. It stays flat once ``prewarm`` has built every key, the
counterpart of the reference's jit cache-size probe. Every table also
adds each build to the process-wide ``CAPTURES``, which
``lint.runtime.CompileWatch`` reads as the reference's watch reads XLA
compiles. The paged-decode
wrapper counts a launch where it runs, which for a graph is at capture;
so each graph's launches are recorded at capture and added to
``paged_decode_launches`` on every replay.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Hashable

import torch

from ..ops import paged_attention as pa

# programs built by every table of the process, monotone; tables may
# build on several engines' loop threads at once
CAPTURES = 0
_captures_lock = threading.Lock()


def _count_build() -> None:
    global CAPTURES
    with _captures_lock:
        CAPTURES += 1


class ProgramTable:
    """Programs by key; ``active`` is the [B] mask a program decodes,
    zeroed (all rows parked) while a program warms up."""

    def __init__(self, device: torch.device, active: torch.Tensor):
        self.device = device
        self.active = active
        self.captures = 0
        self.paged_decode_launches = 0  # launches made by replays
        self._fns: dict[Hashable, Callable[[], None]] = {}
        self._graphs: dict[Hashable, object] = {}  # key -> graph (None on the CPU)
        self._launches: dict[Hashable, int] = {}  # key -> launches per replay
        self._pool = None
        self._stream = None

    def define(self, key: Hashable, fn: Callable[[], None]) -> None:
        self._fns[key] = fn

    def keys(self) -> list:
        return list(self._fns)

    def build(self, key: Hashable) -> None:
        """Capture ``key`` (on the CPU: run it once) with every row parked;
        a no-op for a key already built."""
        if key in self._graphs:
            return
        if self.device.type == "cuda":
            self._capture(key)
            return
        self._run_parked(self._fns[key])
        self._graphs[key] = None
        self.captures += 1
        _count_build()

    def run(self, key: Hashable) -> None:
        """Run ``key`` once over the current buffers: replay its graph on
        the current stream (capturing it first if need be), or call it on
        the CPU."""
        if self.device.type != "cuda":
            if key not in self._graphs:
                self._graphs[key] = None
                self.captures += 1
                _count_build()
            self._fns[key]()
            return
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key)
        graph.replay()
        self.paged_decode_launches += self._launches[key]

    def _run_parked(self, fn: Callable[[], None]) -> None:
        saved = self.active.clone()
        self.active.zero_()
        fn()
        self.active.copy_(saved)

    def _capture(self, key: Hashable):
        fn = self._fns[key]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side, current = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run_parked(fn)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = pa.LAUNCHES
        # no garbage collection inside the capture: collecting an engine
        # that is gone would destroy its graphs, and freeing a graph's
        # memory on this thread breaks the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()
        self._launches[key] = pa.LAUNCHES - before
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[key] = graph
        self.captures += 1
        _count_build()
        return graph
