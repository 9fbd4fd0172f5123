"""Self-attention dispatch: the reference math and the route to the kernels.

Counterpart of ``devspace_tpu/ops/attention.py``. ``fused_attention``
takes the reference's route: sequences longer than ``FLASH_THRESHOLD``
with T a multiple of 256 stream through flash attention
(``ops/flash_attention.py``); a T that the short-sequence kernel's query
block does not divide takes ``attention_reference``, which the reference
computes there even on a TPU. What remains is the short-sequence fused
kernel (``_attention_kernel``), not ported yet (ROADMAP B4): CPU tensors
take ``attention_reference`` and CUDA tensors raise rather than run the
plain version on the card.
"""

from __future__ import annotations

import math

import torch

from .dispatch import on_cuda
from .flash_attention import flash_attention

NEG_INF = -1e30

# Beyond this many keys the reference streams through the flash kernel.
FLASH_THRESHOLD = 1024


def attention_reference(q, k, v, causal: bool = True):
    """q, k, v [B, H, T, D] -> [B, H, T, D] in q's dtype; f32 scores and
    softmax, the ``-1e30`` causal mask."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def fused_attention(q, k, v, causal: bool = True, block_q: int = 256):
    """[B, H, T, D] attention along the reference's route (see the module
    docstring)."""
    t = q.shape[2]
    if t > FLASH_THRESHOLD and t % 256 == 0:
        return flash_attention(q, k, v, causal=causal)
    if t % min(block_q, t):
        return attention_reference(q, k, v, causal)
    if on_cuda(q, k, v):
        raise NotImplementedError(
            f"attention at T={t} runs the short-sequence fused-attention kernel "
            "(devspace_tpu/ops/attention.py:_attention_kernel), which the port "
            "has not ported yet (ROADMAP B4)"
        )
    return attention_reference(q, k, v, causal)
