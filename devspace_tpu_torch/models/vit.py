"""Vision Transformer (ViT) in PyTorch.

Counterpart of ``devspace_tpu/models/vit.py``: the patch-embedding conv,
the ``cls`` token, learned ``pos_embed``, pre-LayerNorm encoder blocks
and the ``head``, bf16 compute with float32 params, float32 logits.
Submodules carry flax's names (``patch_embed``, ``block_<i>`` with
``LayerNorm_0``, ``MultiHeadDotProductAttention_0`` (``query``, ``key``,
``value``, ``out``), ``LayerNorm_1``, ``MlpBlock_0`` (``Dense_0``,
``Dense_1``); ``final_norm``, ``head``) so a flax variable tree converts
name for name (``models/convert.py``). flax infers the token count at
init; here it follows from ``image_size``.

flax's ``MultiHeadDotProductAttention`` is no Pallas kernel, and its
counterpart here is plain torch math on flax's rules (flax 0.12.3):
q/k/v are ``DenseGeneral`` layers with kernels ``[D, H, hd]`` and
biases, the out projection's kernel is ``[H, hd, D]``; q is divided by
``sqrt(hd)`` in the compute type before the product; the softmax is
taken in the compute type (``force_fp32_for_softmax=False``), as
``jax.nn.softmax`` computes it: ``exp(s - max)`` divided by its sum,
which is accumulated in float32 and rounded to the compute type. GELU is
flax's default tanh approximation.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Conv, Dense, LayerNorm, init_weights


def softmax_in_dtype(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in ``s``'s own dtype."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(s.dtype)


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.dtype, self.head_dim = dtype, dim // num_heads
        proj = partial(Dense, dim, (num_heads, self.head_dim), dtype=dtype, device=device)
        self.query, self.key, self.value = proj(), proj(), proj()
        self.out = Dense((num_heads, self.head_dim), dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, hd]
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=torch.float32).to(self.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        ctx = torch.einsum("bhqk,bkhd->bqhd", softmax_in_dtype(s), v)
        return self.out(ctx)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.Dense_0 = Dense(dim, mlp_dim, dtype=dtype, device=device)
        self.Dense_1 = Dense(mlp_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype, device=device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads, dtype, device)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype, device=device)
        self.MlpBlock_0 = MlpBlock(dim, mlp_dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.MlpBlock_0(self.LayerNorm_1(x))


class ViT(nn.Module):
    """``model(images [B, H, W, 3], train=True) -> logits [B, classes]``
    float32 (``train`` is accepted for the trainer's API; the model has
    no dropout and no running statistics). Weights from ``seed`` with
    flax's initialisers (``pos_embed`` normal with std 0.02, ``cls``
    zeros), on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if image_size % patch_size:
            raise ValueError(f"image {image_size} does not divide into {patch_size}-pixel patches")
        self.dtype, self.patch_size, self.depth = dtype, patch_size, depth
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = Conv(3, hidden_dim, (patch_size, patch_size),
                                (patch_size, patch_size), padding="VALID", use_bias=True,
                                dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, hidden_dim, device=device))
        for i in range(depth):
            self.add_module(f"block_{i}", EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype,
                                                       device))
        self.final_norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        self.head = Dense(hidden_dim, num_classes, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        init_weights(self, gen)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
            self.cls.zero_()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} does not divide into {p}-pixel patches")
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))  # [B, D, h/p, w/p]
        x = x.flatten(2).transpose(1, 2)  # tokens in row-major patch order, as flax's reshape
        x = torch.cat([self.cls.to(self.dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.final_norm(x)[:, 0]  # the cls token
        return self.head(x).float()


ViT_S16 = partial(ViT, hidden_dim=384, depth=12, num_heads=6, mlp_dim=1536)
ViT_B16 = partial(ViT, hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072)
ViT_L16 = partial(ViT, hidden_dim=1024, depth=24, num_heads=16, mlp_dim=4096)
