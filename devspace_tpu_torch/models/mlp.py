"""MNIST-scale MLP in PyTorch: the smallest end-to-end training workload.

Counterpart of ``devspace_tpu/models/mlp.py``: flatten, then ``Dense``
layers (``Dense_0``, ``Dense_1``, ... as flax names them) with ReLU
between them. flax infers the input width at init; here it is
``in_features`` (28 x 28 x 1 for MNIST).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from .layers import Dense, init_weights


class MLP(nn.Module):
    """``model(x [B, ...], train=True) -> logits [B, features[-1]]`` in
    ``dtype``; ``train`` is accepted for the trainer's API, as in flax."""

    def __init__(self, features: Sequence[int] = (512, 256, 10), in_features: int = 28 * 28,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.n_layers = len(features)
        for i, (fan_in, feat) in enumerate(zip([in_features, *features[:-1]], features)):
            self.add_module(f"Dense_{i}", Dense(fan_in, feat, dtype=dtype, device=device))
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x
