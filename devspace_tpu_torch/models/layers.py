"""flax.linen's layers with flax's numerics, as torch modules: the building
blocks of the vision models (``resnet.py``, ``vit.py``, ``mlp.py``).

Each module keeps flax's parameter names (``kernel``, ``bias``,
``scale``; BatchNorm's running ``mean`` and ``var`` as buffers) so a
flax variable tree maps onto ``state_dict`` names one to one
(``models/convert.py``). Parameters are float32; ``dtype`` is the
compute type, as in flax: a layer casts its input and its parameters to
``dtype`` in the forward pass, so the gradient of a float32 parameter
stays float32.

Where flax and torch disagree, these follow flax:

- ``padding="SAME"`` pads each spatial side ``lo = total // 2``, ``hi =
  total - lo`` with ``total = max((ceil(n / s) - 1) * s + k - n, 0)``:
  asymmetric where torch's ``padding=k // 2`` is not (a 3x3/s2 conv on
  an even size pads (0, 1)). ``same_pads`` computes it; the pad is
  explicit (``F.pad``), -inf for max pooling.
- BatchNorm keeps flax's ``momentum=0.9`` (torch's 0.1) and updates its
  running variance with the BIASED batch variance (torch's
  ``BatchNorm2d`` takes the unbiased one): ``ra = 0.9 * ra + 0.1 *
  var``. Statistics are float32 whatever the input type; the
  normalisation ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` is
  float32 and its output is ``dtype``.
- LayerNorm: ``epsilon=1e-6``, float32 statistics with flax's fast
  variance ``max(0, E[x^2] - E[x]^2)``, output in ``dtype``.

Convolutions take NCHW tensors (the vision models permute their NHWC
input once: a contiguous NHWC tensor viewed as NCHW is ``channels_last``,
the layout cuDNN's fast kernels read) and kernels OIHW, flax's HWIO
transposed. Dense kernels stay flax's ``[in..., out...]`` and compute
``x @ kernel``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import psum

Padding = Union[str, Sequence[Sequence[int]]]

# flax's lecun_normal: a normal truncated at two standard deviations,
# widened by this factor so the kept values have variance 1 / fan_in
# (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of one spatial axis under flax/XLA ``SAME``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_nchw(x: torch.Tensor, pads: Sequence[Sequence[int]], value: float = 0.0) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``((h_lo, h_hi), (w_lo, w_hi))``."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    if h_lo or h_hi or w_lo or w_hi:
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)
    return x


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``flax.linen.max_pool(x, (w, w), strides=(s, s), padding="SAME")``
    on NCHW: pads with -inf, flax's asymmetric split."""
    pads = [same_pads(n, window, stride) for n in x.shape[2:]]
    return F.max_pool2d(pad_nchw(x, pads, float("-inf")), window, stride)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _shape(s: Union[int, Sequence[int]]) -> tuple[int, ...]:
    return (s,) if isinstance(s, int) else tuple(s)


class Dense(nn.Module):
    """``flax.linen.Dense`` / ``DenseGeneral`` over the trailing axes:
    ``kernel`` ``[*in_shape, *out_shape]`` float32, ``bias`` ``out_shape``;
    input, kernel and bias cast to ``dtype``; the product accumulates in
    float32 and rounds to ``dtype``, then the bias is added in ``dtype``."""

    def __init__(self, in_shape, out_shape, dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.in_shape, self.out_shape = _shape(in_shape), _shape(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape, device=device))
        self.bias = (nn.Parameter(torch.zeros(self.out_shape, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = (x.to(self.dtype).reshape(*lead, -1) @ w).reshape(*lead, *self.out_shape)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: ``kernel`` OIHW float32, ``padding``
    ``"SAME"`` (flax's split), ``"VALID"`` or ``((h_lo, h_hi), (w_lo,
    w_hi))``; input and kernel cast to ``dtype``, bias added after."""

    def __init__(self, in_features: int, features: int, kernel_size, strides=(1, 1),
                 padding: Padding = "SAME", use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((features, in_features, *self.kernel_size),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def pads(self, h: int, w: int) -> tuple:
        if self.padding == "SAME":
            return tuple(same_pads(n, k, s) for n, k, s in zip((h, w), self.kernel_size,
                                                               self.strides))
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_nchw(x.to(self.dtype), self.pads(*x.shape[2:]))
        y = F.conv2d(x, self.kernel.to(self.dtype), None, self.strides)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)``
    over NCHW's channel axis. ``train=True`` normalises with the batch's
    statistics and folds them into the running ones; ``train=False``
    uses the running ones. ``scale_init_zero``: flax's
    ``scale_init=zeros`` (the last BatchNorm of a residual block).

    The batch statistics come from one ``_native_batch_norm_legit`` pass
    (float32 mean and inverse std for any input type): its variance is
    the biased two-pass one, flax's fast ``E[x^2] - E[x]^2`` to float32
    rounding, and its gradient is the same function's.

    ``group``: the process group of a data axis of more than one rank
    (set by ``trainer.make_classifier_train_step(mesh=...)``). Then the
    statistics are the global batch's, as the reference's ``jit`` over a
    sharded batch takes them: float32 sums of ``x`` and ``x^2`` and the
    count summed over the group (``parallel.collectives.psum``, whose
    backward sums too), flax's ``max(0, E[x^2] - E[x]^2)``."""

    group = None

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 scale_init_zero: bool = False, device=None):
        super().__init__()
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon
        self.scale_init_zero = scale_init_zero
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.scale_init_zero else 1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                             self.epsilon)
            return y.to(self.dtype)
        if self.group is not None:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.ops.aten._native_batch_norm_legit(
                x, self.scale, self.bias, True, 0.0, self.epsilon)
            var = invstd.detach().float().pow(-2) - self.epsilon
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean.float())
            self.var.copy_(m * self.var + (1 - m) * var)
        return y.to(self.dtype)

    def _global_batch_norm(self, x: torch.Tensor):
        x32 = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        count = torch.tensor([x.numel() // x.shape[1]], dtype=torch.float32, device=x.device)
        sums = psum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]), self.group)
        c = x.shape[1]
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        shape = [1, c] + [1] * (x.dim() - 2)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var + self.epsilon).view(shape)
        y = y * self.scale.view(shape) + self.bias.view(shape)
        return y, mean.detach(), var.detach()


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=dtype)`` over the last axis."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-6, device=None):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype)


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded weights with flax's initialisers: every layer's
    ``reset_parameters`` in module order (lecun-normal kernels, zero
    biases, unit scales); returns ``module``. The draws cannot reproduce
    ``jax.random``: parity tests convert a flax tree instead
    (``models/convert.py``)."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
