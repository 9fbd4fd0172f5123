"""ResNet v1.5 in PyTorch: the repo's headline throughput model.

Counterpart of ``devspace_tpu/models/resnet.py``: the same blocks, both
stems (``conv7``, the classic 7x7/s2, and ``space_to_depth``, 2x2 pixel
blocks packed into channels under a 4x4/s1 conv padded ((1, 2), (1,
2))), bf16 compute with float32 params and running statistics, flax's
SAME padding and BatchNorm (``models/layers.py``). Inputs come NHWC
float32 ``[B, H, W, 3]``, as the data generators hand them out; the
model views them as NCHW once (``channels_last``, no copy) and the
convolutions are cuDNN's, as the reference leaves them to XLA. Logits
are float32 ``[B, num_classes]``.

Submodules carry flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>`` with ``Conv_0..2``, ``BatchNorm_0..2``,
``conv_proj``, ``norm_proj``; the head ``Dense_0``), so a flax variable
tree converts name for name (``models/convert.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from .layers import BatchNorm, Conv, Dense, init_weights, max_pool_same


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (carrying the stride, v1.5) -> 1x1 x4, each with
    BatchNorm, ReLU between, the last BatchNorm's scale initialised to
    zero; a projected shortcut where the shapes differ."""

    def __init__(self, in_features: int, filters: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        self.BatchNorm_2 = norm(filters * 4, scale_init_zero=True)
        if in_features != filters * 4 or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, num_classes, num_filters, dtype, stem)``:
    ``model(images [B, H, W, 3], train=True) -> logits [B, classes]``.
    ``train=True`` normalises with batch statistics and updates the
    running ones (flax's ``mutable=["batch_stats"]``). Weights from
    ``seed`` with flax's initialisers, on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv7", device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.stem = dtype, stem
        if stem == "space_to_depth":
            self.conv_init = Conv(4 * 3, num_filters, (4, 4), (1, 1),
                                  padding=((1, 2), (1, 2)), dtype=dtype, device=device)
        elif stem == "conv7":
            self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), dtype=dtype,
                                  device=device)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.bn_init = BatchNorm(num_filters, dtype=dtype, device=device)
        blocks, features = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blocks.append(BottleneckBlock(features, num_filters * 2 ** i, strides, dtype,
                                              device))
                features = num_filters * 2 ** i * 4
        self.n_blocks = len(blocks)
        for i, block in enumerate(blocks):
            self.add_module(f"BottleneckBlock_{i}", block)
        self.Dense_0 = Dense(features, num_classes, dtype=torch.float32, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"space_to_depth needs even H and W, got {h}x{w}")
            x = (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(b, h // 2, w // 2, 4 * c))
        x = x.permute(0, 3, 1, 2)  # NHWC memory viewed as NCHW: channels_last
        x = torch.relu(self.bn_init(self.conv_init(x), train))
        x = max_pool_same(x, 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x, train)
        # jnp.mean over a bf16 array sums in float32 and returns bf16
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.Dense_0(x).float()


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
