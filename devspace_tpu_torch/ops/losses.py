"""Fused softmax cross-entropy: the Hopper kernel (``csrc/cross_entropy.cu``)
and its plain PyTorch version.

Counterpart of ``devspace_tpu/ops/losses.py``. The forward computes the
per-row ``logsumexp(logits) - logits[label]`` in one pass over the row
and keeps the lse as the only residual; the backward
``(softmax - onehot) * g`` is plain tensor math, as in the reference,
with the one-hot replaced by a subtraction at the label (a one-hot of a
``[16384, 32000]`` batch would be another 2.1 GB of f32).

Dispatch follows the tensors (``ops/dispatch.py``): CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.

``vocab_parallel_cross_entropy`` is the Megatron loss over vocab-sharded
logits (plain torch and three all-reduces; the reference computes it in
``jnp`` too).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_
from . import _build
from .dispatch import on_cuda

# Last dispatch decision and the kernel's launches (moved only where the
# CUDA kernel was launched).
LAST_DISPATCH = {"impl": None}
LAUNCHES = 0

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        fn = _build.library("cross_entropy").cross_entropy_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def cross_entropy_reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B, V] f32/bf16, labels [B] int -> [B] f32 losses."""
    return _xent_fwd_reference(logits, labels)[0]


def _label_columns(labels, v):
    """(column, valid) per row: a label in ``[-V, V)`` picks column
    ``label mod V``, as JAX's ``take_along_axis`` wraps a negative index;
    any other label is not valid (column 0 stands in for it)."""
    labels = labels.long()
    valid = (labels >= -v) & (labels < v)
    return torch.where(valid, labels % v, 0), valid


def _xent_fwd_reference(logits, labels):
    """(loss, lse), each f32 [B]: the plain version of the kernel. A label
    outside ``[-V, V)`` gives a NaN loss, as the reference's gather does."""
    f32 = logits.float()
    lse = torch.logsumexp(f32, dim=-1)
    col, valid = _label_columns(labels, f32.shape[-1])
    picked = f32.gather(-1, col[:, None])[:, 0]
    return lse - torch.where(valid, picked, float("nan")), lse


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"cross_entropy kernel: {msg}")


def _launch_kernel(logits, labels):
    """Validate, allocate (loss, lse), launch on the current stream.
    Labels are taken as int64, as tokens arrive; a label in [-V, 0)
    wraps to label + V, any other outside [0, V) gives a NaN loss."""
    global LAUNCHES
    _check(logits.dim() == 2, f"logits must be [B, V], got {tuple(logits.shape)}")
    _check(logits.dtype in (torch.float32, torch.bfloat16), f"logits dtype {logits.dtype}")
    b, v = logits.shape
    _check(tuple(labels.shape) == (b,), f"labels shape {tuple(labels.shape)} != {(b,)}")
    _check(labels.dtype == torch.int64, f"labels dtype {labels.dtype} (int64)")
    _check(logits.is_contiguous() and labels.is_contiguous(), "inputs must be contiguous")
    _check(v > 0, "empty vocabulary")
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty(b, dtype=torch.float32, device=logits.device)
    if b == 0:
        return loss, lse
    err = _kernel()(
        int(logits.dtype == torch.bfloat16), logits.data_ptr(), labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), b, v,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cross_entropy kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_DISPATCH["impl"] = "cuda"
    return loss, lse


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """(loss, lse) f32 [B]: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not on_cuda(logits, labels):
        LAST_DISPATCH["impl"] = "reference"
        return _xent_fwd_reference(logits, labels)
    return _launch_kernel(logits, labels)


def xent_bwd(logits, labels, lse, g):
    """d loss / d logits = (softmax - onehot) * g, in the logits' dtype;
    the one-hot is a subtraction at each row's label column, and a label
    outside ``[-V, V)`` has none (the gradient of the reference's gather)."""
    grad = torch.exp(logits.float() - lse[:, None])
    col, valid = _label_columns(labels, grad.shape[-1])
    grad[torch.arange(grad.shape[0], device=grad.device), col] -= valid.float()
    return grad.mul_(g[:, None]).to(logits.dtype)


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_bwd(logits, labels, lse, g), None


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example losses [B] f32, differentiable in the logits (take the
    mean outside; the caller keeps the choice of reduction)."""
    return _Xent.apply(logits.contiguous(), labels.long().contiguous())


class _VocabParallelXent(torch.autograd.Function):
    """Per-row loss over this rank's vocab block; the backward is the
    softmax minus the one-hot on the block, with no collective: the
    per-row cotangent is the same on every rank of the axis."""

    @staticmethod
    def forward(ctx, logits, labels, group, lo):
        f32 = logits.float()
        v_local = f32.shape[-1]
        # the max shift cancels in log(sum(exp(x - m))) + m: no gradient
        # flows through it (the reference's stop_gradient)
        gmax = all_reduce_(f32.amax(-1), group, op=dist.ReduceOp.MAX)
        sumexp = all_reduce_(torch.exp(f32 - gmax[:, None]).sum(-1), group)
        lse = torch.log(sumexp) + gmax
        local = labels.long() - lo
        in_shard = (local >= 0) & (local < v_local)
        col = local.clamp(0, v_local - 1)
        picked_here = f32.gather(-1, col[:, None])[:, 0]
        picked = all_reduce_(torch.where(in_shard, picked_here, 0.0), group)
        ctx.save_for_backward(logits, col, in_shard, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, col, in_shard, lse = ctx.saved_tensors
        grad = torch.exp(logits.float() - lse[:, None])
        grad[torch.arange(grad.shape[0], device=grad.device), col] -= in_shard.float()
        return grad.mul_(g[:, None]).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(mesh, axis: str = "model"):
    """Cross-entropy over VOCAB-SHARDED logits (the Megatron-LM trick):
    with the LM head column-sharded over ``axis``, each rank computes its
    local max, sum-exp and picked logit, and three small all-reduces (a
    max and two sums) give the exact loss; the ``[B, V]`` logits are
    never gathered. Returns ``loss_fn(logits, labels) -> [B] f32`` where
    ``logits`` is this rank's vocab block ``[B, V/n]`` (block ``i`` of
    rank ``i``) of its rows and ``labels`` ``[B]`` global vocab ids; the
    losses are the same on every rank of ``axis``. Differentiable in the
    logits."""
    group = mesh.group(axis)

    def loss_fn(logits, labels):
        lo = mesh.index(axis) * logits.shape[-1]
        return _VocabParallelXent.apply(logits.contiguous(), labels.contiguous(), group, lo)

    return loss_fn
