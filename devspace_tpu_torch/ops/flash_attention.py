"""Flash attention: the Hopper kernels — forward
(``csrc/flash_attention.cu``), backward dq and backward dk/dv
(``csrc/flash_backward.cu``) — and their plain PyTorch versions.

Counterpart of ``devspace_tpu/ops/flash_attention.py``. The forward
streams K/V tiles through an online softmax and keeps the f32
logsumexp; the backward recomputes P = exp(S·scale − lse) from it, so no
``[T, T]`` matrix reaches device memory in either direction. The plain
versions compute the same functions with whole ``[T, T]`` matrices in
the reference's formulation (the ``-1e30`` mask; P rounded to V's dtype
for P·V; dS rounded to K's dtype for dS·K; dK = dSᵀQ and dV = PᵀdO in
f32): they are the CPU path and what the kernels are held against on the
card.

Dispatch follows the tensors (``ops/dispatch.py``): CPU tensors take the
plain versions, CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .dispatch import on_cuda

NEG_INF = -1e30

# Last dispatch decision and the launches of each kernel: a run reads
# them to show which path it took. Each count moves only where its CUDA
# kernel was launched.
LAST_DISPATCH = {"impl": None}
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

HEAD_DIMS = (16, 32, 64, 128)

_KERNELS: dict = {}


def _kernel(name: str):
    fn = _KERNELS.get(name)
    if fn is None:
        source, n_ptr = {"flash_fwd": ("flash_attention", 5),
                         "flash_bwd_dq": ("flash_backward", 7),
                         "flash_bwd_dkv": ("flash_backward", 8)}[name]
        fn = getattr(_build.library(source), name)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


# -- plain versions -----------------------------------------------------------
def _scores(q, k, causal):
    """S·scale in f32 with the reference's mask: [BH, T, T]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool = True):
    """q, k, v [BH, T, D] -> (o [BH, T, D] in q's dtype, lse f32 [BH, T]).
    P·V takes P unnormalized and rounded to V's dtype, divided by the
    f32 row sum afterwards, as the TPU kernel does."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs(q, k, lse, causal):
    return torch.exp(_scores(q, k, causal) - lse[..., None])


def _dscores(q, k, v, do, lse, delta, causal):
    """(P, dS) in f32: P from the lse, dS = P∘(dO Vᵀ − δ)·scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = True):
    """dq [BH, T, D] (q's dtype) = dS·K with dS rounded to K's dtype."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) [BH, T, D] in k's and v's dtypes: dk = dSᵀQ and dv = PᵀdO,
    both in f32."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ----------------------------------------------------------
def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_inputs(named: dict, rows: dict) -> tuple[int, int, int]:
    """Shapes, dtypes, contiguity and 16-byte alignment of the [BH, T, D]
    tensors in ``named`` and the f32 [BH, T] tensors in ``rows``."""
    first = next(iter(named.values()))
    _check(first.dim() == 3, f"tensors must be [BH, T, D], got {tuple(first.shape)}")
    bh, t, d = first.shape
    _check(first.dtype in (torch.float32, torch.bfloat16), f"dtype {first.dtype}")
    _check(d in HEAD_DIMS, f"head_dim {d} not one of {HEAD_DIMS}")
    for name, x in named.items():
        _check(tuple(x.shape) == (bh, t, d), f"{name} shape {tuple(x.shape)} != {(bh, t, d)}")
        _check(x.dtype == first.dtype, f"{name} dtype {x.dtype} != {first.dtype}")
        _check(x.is_contiguous(), f"{name} must be contiguous")
        _check(x.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    for name, x in rows.items():
        _check(tuple(x.shape) == (bh, t), f"{name} shape {tuple(x.shape)} != {(bh, t)}")
        _check(x.dtype == torch.float32, f"{name} dtype {x.dtype} (float32)")
        _check(x.is_contiguous(), f"{name} must be contiguous")
    return bh, t, d


def _launch(name: str, count: str, first: torch.Tensor, ptrs: list, bh, t, d, causal):
    if bh == 0 or t == 0:
        return
    err = _kernel(name)(
        int(first.dtype == torch.bfloat16), *ptrs, bh, t, d, int(causal),
        torch.cuda.current_stream(first.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[count] += 1
    LAST_DISPATCH["impl"] = "cuda"


def flash_fwd(q, k, v, causal: bool = True):
    """Forward kernel on CUDA tensors, plain version on CPU tensors:
    q, k, v [BH, T, D] -> (o, lse f32 [BH, T])."""
    if not on_cuda(q, k, v):
        LAST_DISPATCH["impl"] = "reference"
        return flash_fwd_reference(q, k, v, causal)
    bh, t, d = _check_inputs({"q": q, "k": k, "v": v}, {})
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "fwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()],
            bh, t, d, causal)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq kernel on CUDA tensors, plain version on CPU tensors."""
    if not on_cuda(q, k, v, do, lse, delta):
        LAST_DISPATCH["impl"] = "reference"
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    bh, t, d = _check_inputs({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", "bwd_dq", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr()],
            bh, t, d, causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """dk/dv kernel on CUDA tensors, plain version on CPU tensors."""
    if not on_cuda(q, k, v, do, lse, delta):
        LAST_DISPATCH["impl"] = "reference"
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    bh, t, d = _check_inputs({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", "bwd_dkv", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            bh, t, d, causal)
    return dk, dv


# -- public op ----------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """The custom VJP of the reference (``_flash``): the forward keeps
    (q, k, v, o, lse); the backward takes δ = rowsum(dO∘O) in plain torch
    and runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 256, block_k: int = 256):
    """[B, H, T, D] flash attention, differentiable. T must divide by the
    block sizes, as in the reference (callers fall back to the reference
    path otherwise); the kernels' own tiles are their choice and take any
    T."""
    b, h, t, d = q.shape
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq len {t} not divisible by blocks ({block_q}, {block_k})")
    bh = b * h
    out = _Flash.apply(
        q.reshape(bh, t, d).contiguous(),
        k.reshape(bh, t, d).contiguous(),
        v.reshape(bh, t, d).contiguous(),
        causal,
    )
    return out.reshape(b, h, t, d)
