"""Sequence-parallel LM training with ring attention, with the PyTorch port
(``devspace_tpu_torch``).

The port of ``examples/long-context/train.py``: the sequence of each
batch row is sharded over a ``seq`` mesh axis of ``min(n, 8)`` ranks
(the rest replicate data), K/V blocks rotate around the ring
(``parallel.ring_attention``), the loss is the vocab-parallel one over a
``model`` axis of one rank (it shards nothing at one; the LM head's
vocab is split when that axis grows), and every layer is recomputed in
the backward (remat). AdamW(3e-4, weight decay 0.1), one sequence per
ring, uniform random tokens, random weights from seed 0 on every rank.
Rank 0 prints the example's ``step N loss X R tokens/sec`` lines every
10 steps (step 0 excluded from the rate) and ``done``.

Sizes come from the example's environment variables: LONGCTX_SEQ_LEN
(32768), LONGCTX_STEPS (200), LONGCTX_VOCAB (32000), LONGCTX_DIM (2048),
LONGCTX_LAYERS (16), LONGCTX_HEADS (16), LONGCTX_KV_HEADS (8),
LONGCTX_FFN (5504). Runs on the card unless ``--device cpu`` is given
(gloo there, NCCL on the card); imports nothing of JAX.

Usage::

    torchrun --nproc-per-node 8 scripts/train_long_context_torch.py
    python scripts/train_long_context_torch.py [--device cpu]   # one rank
"""

import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from devspace_tpu_torch.device import resolve_device
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.parallel.data_parallel import shard_batch
from devspace_tpu_torch.parallel.mesh import create_mesh, distributed, mesh_shape_for, shard_tree
from devspace_tpu_torch.parallel.ring_attention import ring_attention
from devspace_tpu_torch.training.data import synthetic_tokens
from devspace_tpu_torch.training.trainer import (
    adamw,
    init_train_state,
    make_lm_train_step,
    param_leaves,
)

PER_RING_BATCH = 1  # sequences per (data-axis) group


def config_from_env() -> tuple:
    """(config, sequence length, steps) from the LONGCTX_* variables."""
    seq_len = int(os.environ.get("LONGCTX_SEQ_LEN", 32_768))
    cfg = tfm.TransformerConfig(
        vocab_size=int(os.environ.get("LONGCTX_VOCAB", 32_000)),
        dim=int(os.environ.get("LONGCTX_DIM", 2048)),
        n_layers=int(os.environ.get("LONGCTX_LAYERS", 16)),
        n_heads=int(os.environ.get("LONGCTX_HEADS", 16)),
        n_kv_heads=int(os.environ.get("LONGCTX_KV_HEADS", 8)),
        ffn_dim=int(os.environ.get("LONGCTX_FFN", 5504)),
        max_seq_len=seq_len,
    )
    return cfg, seq_len, int(os.environ.get("LONGCTX_STEPS", 200))


def build(cfg: tfm.TransformerConfig, device, lr: float = 3e-4, block_size: int = 512):
    """The example's mesh, sharded params, AdamW state and train step
    inside the current process group -> (step_fn, state, mesh, batch):
    ``batch`` is the global number of rows (one a ring)."""
    n = dist.get_world_size()
    axes = mesh_shape_for(n, {"data": -1, "seq": min(n, 8), "model": 1})
    mesh = create_mesh(axes, device)
    spec = tfm.param_partition_spec(cfg, model_axis="model")
    full = tfm.init_params(cfg, torch.Generator(device=mesh.device).manual_seed(0))
    for leaf in param_leaves(full):
        leaf.requires_grad_()
    params = shard_tree(full, spec, mesh)
    del full
    optimizer = adamw(lr, weight_decay=0.1)
    state = init_train_state(params, optimizer)
    attention = ring_attention(mesh, axis="seq", causal=True, batch_axis="data",
                               block_size=block_size)
    step_fn = make_lm_train_step(
        # remat: at 32k tokens the stored activations would dominate memory
        partial(tfm.forward, remat=True), cfg, optimizer, mesh=mesh, data_axis="data",
        param_spec=spec, attention_fn=attention, vocab_parallel_axis="model")
    return step_fn, state, mesh, PER_RING_BATCH * axes["data"]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> list:
    """Train; returns the losses read at the log steps (floats)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # one card a rank (torchrun's LOCAL_RANK)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    cfg, seq_len, steps = config_from_env()
    losses = []
    with distributed(dev):
        step_fn, state, mesh, batch = build(cfg, dev)
        lead = dist.get_rank() == 0
        if lead:
            print(f"process {dist.get_rank()}/{dist.get_world_size()}, mesh {mesh.shape}: "
                  f"ring of {mesh.size('seq')}", flush=True)
        tokens_iter = synthetic_tokens(batch, seq_len + 1, cfg.vocab_size, device="cpu")
        t0 = None
        for i in range(steps):
            state, loss = step_fn(state, shard_batch(next(tokens_iter), mesh))
            if i == 0:
                sync(mesh.device)
                t0 = time.time()  # exclude the first step's set-up
            elif i % 10 == 0 or i == steps - 1:
                losses.append(loss.item())  # lint: allow(JIT502) — the log line's readback
                rate = batch * seq_len * i / (time.time() - t0)
                if lead:
                    print(f"step {i:4d} loss {losses[-1]:.3f} {rate:,.0f} tokens/sec",
                          flush=True)
        if lead:
            print("done", flush=True)
    return losses


if __name__ == "__main__":
    main()
