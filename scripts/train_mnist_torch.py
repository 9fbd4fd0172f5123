"""MNIST-scale MLP training on one GPU with the PyTorch port
(``devspace_tpu_torch``).

The port of ``examples/jax-mnist/train.py``: the MLP ``(512, 256, 10)``
on ``synthetic_mnist`` batches of 256 with Adam 1e-3 over a ``data``
mesh of every rank (each rank takes its rows of the batch, the
gradients are averaged over the axis), rank 0 printing the example's
``step N loss X (R imgs/s)`` line every 100 steps (``--log-every``) and
``done``. One process is a world of one; ``torchrun`` starts more. Runs
on the card unless ``--device cpu`` is given; imports nothing of JAX.

Usage::

    python scripts/train_mnist_torch.py [--device cpu] [--steps 1000] [--log-every 100]
    torchrun --nproc-per-node N scripts/train_mnist_torch.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from devspace_tpu_torch.device import resolve_device
from devspace_tpu_torch.models.mlp import MLP
from devspace_tpu_torch.parallel.data_parallel import shard_batch
from devspace_tpu_torch.parallel.mesh import create_mesh, distributed
from devspace_tpu_torch.training.data import synthetic_mnist
from devspace_tpu_torch.training.trainer import adam, init_train_state, make_classifier_train_step

LEARNING_RATE = 1e-3
BATCH_SIZE = 256
STEPS = 1000
LOG_EVERY = 100


def main(argv=None) -> list:
    """Train; returns the losses printed (floats)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--log-every", type=int, default=LOG_EVERY,
                    help="steps between loss lines")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # one card a rank (torchrun's LOCAL_RANK)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    losses = []
    with distributed(dev):
        mesh = create_mesh({"data": -1}, dev)
        lead = dist.get_rank() == 0
        if lead:
            print(f"device: {dev}, mesh {mesh.shape}, backend {dist.get_backend()}, "
                  f"world {dist.get_world_size()}", flush=True)
        model = MLP(features=(512, 256, 10), device=dev)
        optimizer = adam(LEARNING_RATE)
        state = init_train_state(model, optimizer)
        step_fn = make_classifier_train_step(model, optimizer, mesh=mesh)
        batch_iter = synthetic_mnist(BATCH_SIZE, device=dev)
        t0 = time.time()
        for i in range(args.steps):
            state, loss = step_fn(state, shard_batch(next(batch_iter), mesh))
            if i % args.log_every == 0:
                losses.append(loss.item())  # lint: allow(JIT502) — the log line's readback
                if lead:
                    print(f"step {i:4d} loss {losses[-1]:.4f} "
                          f"({BATCH_SIZE * (i + 1) / (time.time() - t0):.0f} imgs/s)",
                          flush=True)
        if lead:
            print("done", flush=True)
    return losses


if __name__ == "__main__":
    main()
