"""int8 quantization of KV blocks for the host KV tier.

The port's copy of the KV-block part of
``devspace_tpu/inference/quantization.py``: ``quantize_kv_block`` and
``dequantize_kv_block`` on numpy, with the scale floor ``KV_SCALE_EPS``
that ``ops.paged_attention.quantize_kv`` shares. The weight-only
quantization of that module (``QuantizedLinear`` and the functions over
a parameter tree) waits for the int8-weights slice.
"""

from __future__ import annotations

import numpy as np

from ..ops.paged_attention import KV_SCALE_EPS

__all__ = ["KV_SCALE_EPS", "quantize_kv_block", "dequantize_kv_block"]


def quantize_kv_block(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of one KV block ``[L, Hkv, bs, D]``
    for the host tier (``inference/kv_tier.py``): a per-(layer, head,
    token) scale that maps max|x| over the head dim D to 127, rounding
    half to even — the convention of ``ops.paged_attention.quantize_kv``,
    so a block spilled from a float pool carries the noise the int8 pool
    already has (~0.5%; greedy near-ties can flip)."""
    x32 = np.asarray(x, np.float32)
    amax = np.max(np.abs(x32), axis=-1)  # [L, Hkv, bs]
    scale = np.maximum(amax, KV_SCALE_EPS) / 127.0
    q = np.clip(np.rint(x32 / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_kv_block(q: np.ndarray, scale: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Host-side inverse of :func:`quantize_kv_block` (tests and
    debugging; the engine's restore dequantizes on the device)."""
    return (q.astype(np.float32) * np.asarray(scale, np.float32)[..., None]).astype(dtype)
