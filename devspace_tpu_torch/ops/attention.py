"""Self-attention: the short-sequence Hopper kernel
(``csrc/attention.cu``), its plain PyTorch version, and the route between
them and flash attention.

Counterpart of ``devspace_tpu/ops/attention.py``. ``fused_attention``
takes the reference's route: sequences longer than ``FLASH_THRESHOLD``
with T a multiple of 256 stream through flash attention
(``ops/flash_attention.py``); a T that the short-sequence kernel's query
block does not divide takes ``attention_reference``, which the reference
computes there even on a TPU; every other T (any T up to 256, and 512,
768, 1024) runs the short-sequence kernel. The kernel is forward only:
its gradient is that of ``attention_reference``, recomputed from the
saved q, k, v, as the reference's custom VJP does.

Dispatch follows the tensors (``ops/dispatch.py``): CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .dispatch import on_cuda
from .flash_attention import HEAD_DIMS, flash_attention

NEG_INF = -1e30

# Beyond this many keys the reference streams through the flash kernel.
FLASH_THRESHOLD = 1024

# Last dispatch decision and the launches of the short-sequence kernel:
# a run reads them to show which path it took. The count moves only where
# the CUDA kernel was launched.
LAST_DISPATCH = {"impl": None}
LAUNCHES = 0

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        fn = _build.library("attention").attention_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"attention kernel: {msg}")


def attention_fwd(q, k, v, causal: bool = True):
    """The forward alone, q, k, v [B, H, T, D] -> [B, H, T, D]: the kernel
    on CUDA tensors, ``attention_reference`` on CPU tensors."""
    global LAUNCHES
    if not on_cuda(q, k, v):
        LAST_DISPATCH["impl"] = "reference"
        return attention_reference(q, k, v, causal)
    _check(q.dim() == 4, f"tensors must be [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    _check(q.dtype in (torch.float32, torch.bfloat16), f"dtype {q.dtype}")
    _check(d in HEAD_DIMS, f"head_dim {d} not one of {HEAD_DIMS}")
    flat = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(tuple(x.shape) == (b, h, t, d), f"{name} shape {tuple(x.shape)} != {(b, h, t, d)}")
        _check(x.dtype == q.dtype, f"{name} dtype {x.dtype} != {q.dtype}")
        x = x.reshape(b * h, t, d).contiguous()
        _check(x.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        flat.append(x)
    out = torch.empty((b * h, t, d), dtype=q.dtype, device=q.device)
    if b * h == 0 or t == 0:
        return out.view(b, h, t, d)
    err = _kernel()(
        int(q.dtype == torch.bfloat16), *(x.data_ptr() for x in flat), out.data_ptr(),
        b * h, t, d, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_DISPATCH["impl"] = "cuda"
    return out.view(b, h, t, d)


class _Attention(torch.autograd.Function):
    """The custom VJP of the reference (``_attention``): the forward keeps
    only q, k, v (no [B, H, T, T] tensor); the backward differentiates
    ``attention_reference`` on them, in plain torch."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return attention_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v, ctx.causal)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def short_attention(q, k, v, causal: bool = True, block_q: int = 256):
    """The reference's ``attention_pallas``: the kernel with the plain
    version's gradient where ``min(block_q, T)`` divides T, else
    ``attention_reference``. ``block_q`` decides only that; the kernel's
    own tile takes any T."""
    t = q.shape[2]
    if t % min(block_q, t):
        return attention_reference(q, k, v, causal)
    return _Attention.apply(q, k, v, causal)


def fused_attention(q, k, v, causal: bool = True, block_q: int = 256):
    """[B, H, T, D] attention along the reference's route (see the module
    docstring)."""
    t = q.shape[2]
    if t > FLASH_THRESHOLD and t % 256 == 0:
        return flash_attention(q, k, v, causal=causal)
    return short_attention(q, k, v, causal=causal, block_q=block_q)
