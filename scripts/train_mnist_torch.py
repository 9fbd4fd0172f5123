"""MNIST-scale MLP training on one GPU with the PyTorch port
(``devspace_tpu_torch``).

The port of ``examples/jax-mnist/train.py`` on one device: the MLP
``(512, 256, 10)`` on ``synthetic_mnist`` batches of 256 with Adam 1e-3,
printing the example's ``step N loss X (R imgs/s)`` line every 100 steps
and ``done``. The mesh part waits for the port of ``parallel/``. Runs on
the card unless ``--device cpu`` is given; imports nothing of JAX.

Usage::

    python scripts/train_mnist_torch.py [--device cpu] [--steps 1000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from devspace_tpu_torch.device import resolve_device
from devspace_tpu_torch.models.mlp import MLP
from devspace_tpu_torch.training.data import synthetic_mnist
from devspace_tpu_torch.training.trainer import adam, init_train_state, make_classifier_train_step

LEARNING_RATE = 1e-3
BATCH_SIZE = 256
STEPS = 1000


def main(argv=None) -> list:
    """Train; returns the losses printed (floats)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}", flush=True)
    model = MLP(features=(512, 256, 10), device=dev)
    optimizer = adam(LEARNING_RATE)
    state = init_train_state(model, optimizer)
    step_fn = make_classifier_train_step(model, optimizer)
    batch_iter = synthetic_mnist(BATCH_SIZE, device=dev)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        state, loss = step_fn(state, next(batch_iter))
        if i % 100 == 0:
            losses.append(loss.item())  # lint: allow(JIT502) — the log line's readback
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({BATCH_SIZE * (i + 1) / (time.time() - t0):.0f} imgs/s)", flush=True)
    print("done", flush=True)
    return losses


if __name__ == "__main__":
    main()
