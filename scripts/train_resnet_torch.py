"""ResNet-50 training on one GPU with the PyTorch port
(``devspace_tpu_torch``).

The port of ``examples/jax-resnet-tpu/train.py``: ResNet-50 (the
example's ``conv7`` stem, bf16 compute, float32 params) on synthetic
ImageNet batches over a ``data`` mesh of every rank, SGD at ``0.1 *
B / 256`` (B the global batch) with momentum 0.9, BatchNorm running
statistics of the global batch updated every step. The global batch is
made on the host, sliced to this process's rows (``host_shard``) and
kept two ahead on the card by ``prefetch_to_device``, whose copies run
from pinned memory on a side stream under the running step; the
gradients are averaged over the axis. Rank 0 prints the example's
``step N loss X R imgs/sec`` lines (step 0 excluded from the rate: it
includes cuDNN's first-call setup) and ``done``. One process is a world
of one; ``torchrun`` starts more.

Sizes come from the example's environment variables:
DEVSPACE_EXAMPLE_BATCH (the batch on each card, default 128),
DEVSPACE_EXAMPLE_IMAGE (224), DEVSPACE_EXAMPLE_STEPS (500),
DEVSPACE_EXAMPLE_LOG_EVERY (20). Runs on the card unless ``--device cpu``
is given; imports nothing of JAX.

Usage::

    python scripts/train_resnet_torch.py [--device cpu] [--stem space_to_depth]
    torchrun --nproc-per-node N scripts/train_resnet_torch.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from devspace_tpu_torch.device import resolve_device
from devspace_tpu_torch.models.resnet import ResNet50
from devspace_tpu_torch.parallel.mesh import create_mesh, distributed
from devspace_tpu_torch.training.data import host_shard, prefetch_to_device, synthetic_imagenet
from devspace_tpu_torch.training.trainer import (
    init_train_state,
    make_classifier_train_step,
    sgd,
)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> list:
    """Train; returns the per-step losses (floats, read at log steps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--stem", default="conv7", choices=("conv7", "space_to_depth"))
    args = ap.parse_args(argv)
    batch = int(os.environ.get("DEVSPACE_EXAMPLE_BATCH", 128))
    image = int(os.environ.get("DEVSPACE_EXAMPLE_IMAGE", 224))
    steps = int(os.environ.get("DEVSPACE_EXAMPLE_STEPS", 500))
    log_every = int(os.environ.get("DEVSPACE_EXAMPLE_LOG_EVERY", 20))
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # one card a rank (torchrun's LOCAL_RANK)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    losses = []
    with distributed(dev):
        mesh = create_mesh({"data": -1}, dev)
        lead = dist.get_rank() == 0
        global_batch = batch * mesh.size("data")
        if lead:
            print(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                     if dev.type == "cuda" else "")
                  + f", mesh {mesh.shape}", flush=True)
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, stem=args.stem, device=dev)
        optimizer = sgd(0.1 * global_batch / 256, momentum=0.9)
        state = init_train_state(model, optimizer)
        step_fn = make_classifier_train_step(model, optimizer, has_batch_stats=True, mesh=mesh)
        # every process makes the global batch and keeps its rows
        batches = prefetch_to_device(
            (host_shard(b) for b in synthetic_imagenet(global_batch, image, device="cpu")),
            size=2, device=dev)
        t0 = None
        for i in range(steps):
            state, loss = step_fn(state, next(batches))
            if i == 0:
                sync(dev)
                t0 = time.time()
            if i == 0 or i % log_every == 0 or i == steps - 1:
                losses.append(loss.item())  # lint: allow(JIT502) — the log line's readback
                if i and lead:
                    rate = global_batch * i / (time.time() - t0)
                    print(f"step {i:4d} loss {losses[-1]:.3f} {rate:.0f} imgs/sec",
                          flush=True)
        if lead:
            print("done", flush=True)
    return losses


if __name__ == "__main__":
    main()
