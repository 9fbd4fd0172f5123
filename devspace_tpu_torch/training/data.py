"""Synthetic data and the input pipeline for training and benchmarks.

Counterpart of ``devspace_tpu/training/data.py``. The generators
(``synthetic_mnist``, ``synthetic_imagenet``, ``synthetic_tokens``,
``markov_sampler``, ``markov_tokens``) make the same numpy RNG draws as
the reference, so both packages see byte-identical data from the same
seeds; the batches arrive as tensors on a device (the card unless the
caller asks for the CPU) instead of JAX arrays: images NHWC float32
``[B, H, W, C]``, labels and tokens ``torch.int64``.

The pipeline keeps the reference's iterator contract: a batch is a tree
(dicts, lists, tuples) of tensors or numpy arrays. ``from_torch`` adapts
a ``DataLoader``, ``host_shard`` slices this process's part of a global
batch, ``prefetch_to_device`` keeps batches in flight on the card,
copied from pinned host memory on a side stream.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import shard_tensor

Device = Optional[Union[str, torch.device]]


def synthetic_mnist(batch_size: int, seed: int = 0, device: Device = None) -> Iterator[dict]:
    """Deterministic fake MNIST, ``{"image": [B, 28, 28, 1] float32,
    "label": [B] int64}``: class-dependent blobs plus noise, so a model
    can fit them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(10, 28, 28, 1)).astype(np.float32)
    while True:
        labels = rng.integers(0, 10, size=batch_size)
        noise = rng.normal(scale=0.3, size=(batch_size, 28, 28, 1)).astype(np.float32)
        yield {"image": torch.from_numpy(templates[labels] + noise).to(dev),
               "label": torch.from_numpy(labels).to(dev)}


def synthetic_imagenet(batch_size: int, image_size: int = 224, num_classes: int = 1000,
                       seed: int = 0, device: Device = None) -> Iterator[dict]:
    """Random ImageNet-shaped batches, ``{"image": [B, S, S, 3] float32
    unit normals, "label": [B] int64}``, a fresh batch each time."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        images = rng.normal(size=(batch_size, image_size, image_size, 3)).astype(np.float32)
        labels = rng.integers(0, num_classes, size=batch_size)
        yield {"image": torch.from_numpy(images).to(dev), "label": torch.from_numpy(labels).to(dev)}


def synthetic_tokens(
    batch_size: int, seq_len: int, vocab_size: int, seed: int = 0, device: Device = None
) -> Iterator[torch.Tensor]:
    """Uniform random tokens [batch_size, seq_len], a fresh batch each
    time (nothing to learn; for throughput)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        yield torch.from_numpy(rng.integers(0, vocab_size, size=(batch_size, seq_len))).to(dev)


def markov_sampler(active: int = 256, noise: float = 0.02, seed: int = 0, device: Device = None):
    """LEARNABLE synthetic LM corpus: an order-2 deterministic transition
    table over tokens ``1..active-1`` with ``noise`` resample probability,
    so next-token entropy is near zero but needs two tokens of context.

    Returns ``sample(n, length, seed)`` -> int64 tensor ``[n, length]``
    on ``device``; the table is a pure function of ``(active, seed)``."""
    dev = resolve_device(device)
    table = np.random.default_rng(seed).integers(1, active, size=(active, active))

    def sample(n: int, length: int, seed: int = 1) -> torch.Tensor:
        g = np.random.default_rng(seed)
        seq = np.empty((n, length), np.int64)
        seq[:, :2] = g.integers(1, active, size=(n, 2))
        for t in range(2, length):
            nxt = table[seq[:, t - 2], seq[:, t - 1]]
            flip = g.random(n) < noise
            seq[:, t] = np.where(flip, g.integers(1, active, size=n), nxt)
        return torch.from_numpy(seq).to(dev)

    return sample


def markov_tokens(batch_size: int, seq_len: int, active: int = 256, noise: float = 0.02,
                  seed: int = 0, device: Device = None) -> Iterator[torch.Tensor]:
    """``markov_sampler`` behind the train-loop iterator contract: a
    fresh ``[batch_size, seq_len]`` batch per step, the n-th drawn with
    seed ``seed + n``."""
    sample = markov_sampler(active=active, noise=noise, seed=seed, device=device)
    step = 0
    while True:
        step += 1
        yield sample(batch_size, seq_len, seed=seed + step)


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a batch tree: dicts, lists, tuples and
    namedtuples keep their types; anything else is a leaf."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def prefetch_to_device(iterator: Iterator, size: int = 2, device: Device = None,
                       sharding=None) -> Iterator:
    """Keep ``size`` batches in flight on ``device`` ahead of the
    consumer, in order, with the same values.

    ``sharding`` (``parallel.mesh.sharding(mesh, "data")``): each leaf is
    a global batch and this rank keeps its block under the spec, on the
    mesh's device (which ``device`` must then be, if given). A process
    that loads only its own rows (``host_shard``) passes no sharding.

    On the card each host leaf is copied into pinned memory and from
    there to the device on a side CUDA stream, so the copy of batch N+1
    runs under the step on batch N; when a batch is handed out, the
    consumer's stream waits for its copies and every tensor is recorded
    on that stream (``record_stream``), so the allocator does not reuse
    its memory while the step still reads it. A leaf already on the
    device passes as it is. On the CPU the leaves become tensors and
    nothing more happens."""
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    if sharding is not None:
        if device is not None and resolve_device(device) != sharding.mesh.device:
            raise ValueError(f"device {device} is not the mesh's {sharding.mesh.device}")
        device = sharding.mesh.device
        iterator = (_tree_map(lambda x: shard_tensor(torch.as_tensor(x), sharding.spec,
                                                     sharding.mesh), batch)
                    for batch in iterator)
    dev = resolve_device(device)
    queue: collections.deque = collections.deque()
    if dev.type == "cuda":
        stream = torch.cuda.Stream(dev)

        def to_device(x):
            t = torch.as_tensor(x)
            if t.device == dev:
                return t
            return t.pin_memory().to(dev, non_blocking=True)

        def put(batch):
            with torch.cuda.stream(stream):
                out = _tree_map(to_device, batch)
                done = torch.cuda.Event()
                done.record(stream)
            return out, done

        def take(item):
            out, done = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in _tree_leaves(out):
                t.record_stream(consumer)
            return out
    else:
        def put(batch):
            return _tree_map(lambda x: torch.as_tensor(x).to(dev), batch)

        def take(item):
            return item

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) < size:
            continue
        yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())


def host_shard(batch: Any, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Any:
    """This process's contiguous slice of a globally batched tree: every
    leaf's leading dim split into ``process_count`` equal parts.
    ``process_index`` and ``process_count`` default to this process's
    rank and the world size when ``torch.distributed`` is initialised,
    else 0 and 1. Raises ``ValueError`` when a leaf's batch does not
    divide."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None else process_count

    def slice_leaf(x):
        n = x.shape[0]
        if n % pc:
            raise ValueError(f"global batch {n} not divisible by {pc} hosts")
        per = n // pc
        return x[pi * per: (pi + 1) * per]

    return _tree_map(slice_leaf, batch)


def from_torch(loader) -> Iterator:
    """Adapt a ``torch.utils.data.DataLoader`` (or any iterable of
    tensors, numpy arrays or trees of them: tuples, lists, dicts, as
    ``default_collate`` makes them) to the iterator contract: the same
    trees with CPU tensors at the leaves, detached, ready for
    ``host_shard`` and ``prefetch_to_device``."""
    for batch in loader:
        yield _tree_map(lambda x: torch.as_tensor(x).detach().cpu(), batch)
