"""Fused RMSNorm: the Hopper kernel (``csrc/rms_norm.cu``) and its plain
PyTorch version.

Counterpart of ``devspace_tpu/ops/normalization.py``: one pass computes
the mean square, the rsqrt and the scale, accumulating in float32
whatever the input dtype, with the output in x's dtype. The gradient is
analytic tensor code, as in the reference (no backward kernel there
either). As in the reference, no model calls this op (the models use
``models.transformer.rms_norm``); it is part of the op surface.

Dispatch follows the tensors (``ops/dispatch.py``): CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import on_cuda

# Last dispatch decision and the launches of the kernel; the count moves
# only where the CUDA kernel was launched.
LAST_DISPATCH = {"impl": None}
LAUNCHES = 0

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        fn = _build.library("rms_norm").rms_norm_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def rms_norm_reference(x, weight, eps: float = 1e-5):
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rms_norm kernel: {msg}")


def rms_norm_fwd(x, weight, eps: float = 1e-5):
    """The forward alone, x [..., d] and weight [d] -> x's shape and
    dtype: the kernel on CUDA tensors, ``rms_norm_reference`` on CPU
    tensors."""
    global LAUNCHES
    if not on_cuda(x, weight):
        LAST_DISPATCH["impl"] = "reference"
        return rms_norm_reference(x, weight, eps)
    d = x.shape[-1]
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    _check(weight.dtype == torch.float32, f"weight dtype {weight.dtype} (float32)")
    _check(tuple(weight.shape) == (d,), f"weight shape {tuple(weight.shape)} != {(d,)}")
    _check(weight.is_contiguous(), "weight must be contiguous")
    xf = x.reshape(-1, d).contiguous()
    rows = xf.shape[0]
    out = torch.empty_like(xf)
    if rows == 0 or d == 0:
        return out.view(x.shape)
    err = _kernel()(
        int(x.dtype == torch.bfloat16), xf.data_ptr(), weight.data_ptr(), out.data_ptr(),
        rows, d, float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_DISPATCH["impl"] = "cuda"
    return out.view(x.shape)


class _RmsNorm(torch.autograd.Function):
    """The custom VJP of the reference (``_rms_norm``): with
    r = rsqrt(mean(x²) + eps), dx = r·(g·w) − x·r³/d·Σ(g·w·x) and
    dw = Σ_rows(g·x·r), in float32; dx in x's dtype, dw in w's."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = x.shape[-1]
        x32, g32, w32 = x.float(), g.float(), w.float()
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + ctx.eps)
        gw = g32 * w32
        dx = r * gw - x32 * (r**3 / d) * torch.sum(gw * x32, dim=-1, keepdim=True)
        dw = (g32 * x32 * r).reshape(-1, d).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def fused_rms_norm(x, weight, eps: float = 1e-5, block_rows: int = 256):
    """RMSNorm over the last dim along the reference's route: where
    ``min(block_rows, rows)`` does not divide the row count the reference
    computes ``rms_norm_reference`` even on a TPU, and so does this;
    otherwise the kernel, with the analytic gradient. ``block_rows``
    decides only that: the kernel takes any row count."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows == 0 or rows % min(block_rows, rows):
        return rms_norm_reference(x, weight, eps)
    return _RmsNorm.apply(x, weight, eps)
