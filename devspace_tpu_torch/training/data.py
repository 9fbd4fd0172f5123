"""Synthetic token corpora for training and benchmarks.

Counterpart of ``synthetic_tokens`` and ``markov_sampler`` in
``devspace_tpu/training/data.py``: the same numpy RNG draws, so both
packages see byte-identical corpora from the same seeds; the batches
arrive as ``torch.int64`` tensors on a device (the card unless the
caller asks for the CPU) instead of JAX arrays.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

Device = Optional[Union[str, torch.device]]


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
