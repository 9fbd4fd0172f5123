"""A world of spawned processes for the port's parallel tests.

``World(size, tmp_dir)`` starts ``size`` processes (the ``spawn``
start method), each one rank of a gloo default process group whose
rendezvous is a ``FileStore`` under ``tmp_dir`` (no port is opened);
``backend="nccl"`` gives rank ``r`` card ``r`` instead (the multi-card
tests of ``test_torch_parallel_cuda.py``).
``world.run(fn, *args)`` runs the module-level function ``fn(*args)``
on every rank and returns the ranks' results in rank order; a failure
on any rank raises with its traceback, and the world is started afresh
for the next call. Collectives time out after ``COLLECTIVE_TIMEOUT``,
so a rank that fails cannot leave the others waiting for long.

This module imports neither JAX nor the JAX package, and neither may
the functions it runs: they are the port's side of each parity test,
the JAX side runs in the pytest process.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue
import traceback

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _serve(rank: int, size: int, store_path: str, backend: str, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, size), rank=rank,
                            world_size=size, timeout=COLLECTIVE_TIMEOUT)
    try:
        while True:
            item = tasks.get()
            if item is None:
                return
            module, name, args = item
            try:
                fn = getattr(importlib.import_module(module), name)
                results.put((rank, True, fn(*args)))
            except BaseException:  # reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, size: int, tmp_dir: str, backend: str = "gloo"):
        self.size, self.tmp_dir, self.backend, self.generation = size, str(tmp_dir), backend, 0
        self.procs: list = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self.generation += 1
        store = os.path.join(self.tmp_dir, f"store-{self.generation}")
        self.tasks = [ctx.Queue() for _ in range(self.size)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, self.size, store, self.backend,
                                                      self.tasks[r], self.results), daemon=True)
                      for r in range(self.size)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 240.0) -> list:
        if not self.procs:
            self._start()
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args))
        out: list = [None] * self.size
        errors = []
        try:
            for _ in range(self.size):
                rank, ok, value = self.results.get(timeout=timeout)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            errors.append(f"no answer from every rank within {timeout} s")
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in getattr(self, "tasks", []):
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []
