#!/usr/bin/env python3
"""Where the host time of the layer-by-layer FSDP step goes, on one card.

    python scripts/fsdp_step_profile_torch.py [--steps 5] [--warmup 2]

The bench LM (chip_smoke.BENCH_LM, bf16, 8 x 2048, AdamW) at one NCCL
rank, through ``make_fsdp_train_step`` (each sharded leaf gathered where
the forward reads it and again for the backward) and through the mesh
step on the same layout without gathers (``make_lm_train_step(mesh=)``,
the TP spec at ``{"data": 1, "model": 1}``). For each: the host ms a
step (the steps queued back to back), the wall ms a step (until the card
is done), and for FSDP the host ms and calls of the gathers, of the
saved-tensor hooks' pack and unpack (an unpack of a gathered weight
gathers it again) and of the Python garbage collector. A step whose host
ms reaches its wall ms is host-bound. Prints one JSON line; needs CUDA.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from devspace_tpu_torch.models import transformer as tfm  # noqa: E402
from devspace_tpu_torch.parallel import fsdp as pfsdp  # noqa: E402
from devspace_tpu_torch.training import trainer as ttrainer  # noqa: E402


class Clock:
    """Host seconds and calls of wrapped functions and of gc's passes."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._gc_start = []

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def on_gc(self, phase, info):
        if phase == "start":
            self._gc_start.append(time.perf_counter())
        else:
            self.seconds["gc"] += time.perf_counter() - self._gc_start.pop()
            self.calls["gc"] += 1

    def per_step(self, steps: int) -> dict:
        return {name: {"ms": self.seconds[name] * 1e3 / steps, "calls": self.calls[name] / steps}
                for name in sorted(self.seconds)}


def timed_run(step, state, batch, warmup: int, steps: int, clock: Clock) -> dict:
    for _ in range(warmup):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    clock.seconds.clear()
    clock.calls.clear()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"host_ms": host * 1e3 / steps, "wall_ms": wall * 1e3 / steps,
            "loss": loss.item(), "parts": clock.per_step(steps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fsdp_step_profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.build(*cs.SOURCES)
    clock = Clock()
    tape = pfsdp._GatherTape
    for name in ("gather", "pack", "unpack"):
        setattr(tape, name, clock.wrap(name, getattr(tape, name)))
    gc.callbacks.append(clock.on_gc)
    cfg, opt = cs.BENCH_LM, ttrainer.adamw(cs.TRAIN_LR)
    out = {"card": cs.card_line(), "steps": args.steps, "warmup": args.warmup}
    with cs.pmesh.distributed(dev):
        mesh = cs.pmesh.create_mesh({"data": 1, "model": 1}, dev)
        base = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        batch = cs.shard_batch(cs.tdata.markov_sampler(device=dev)(
            cs.TRAIN_BATCH, cs.TRAIN_SEQ + 1, seed=1), mesh)
        for name in ("mesh", "fsdp", "mesh", "fsdp"):
            params = cs.trainable(base, dev)
            if name == "fsdp":
                fstep, shards, fopt = pfsdp.make_fsdp_train_step(
                    ttrainer.lm_loss(tfm.forward, cfg), opt, mesh, params)
                del params

                def step(state, batch, fstep=fstep):
                    shards, fopt, loss = fstep(state["params"], state["opt_state"], batch)
                    return {"params": shards, "opt_state": fopt}, loss

                state = {"params": shards, "opt_state": fopt}
            else:
                spec = tfm.param_partition_spec(cfg)
                state = ttrainer.init_train_state(cs.pmesh.shard_tree(params, spec, mesh), opt)
                step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt, mesh=mesh,
                                                   param_spec=spec)
                del params
            out.setdefault(name, []).append(
                timed_run(step, state, batch, args.warmup, args.steps, clock))
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
