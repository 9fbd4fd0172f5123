"""Tensor parallelism over a ``model`` mesh axis.

Counterpart of ``devspace_tpu/parallel/tensor_parallel.py``:
Megatron-style column- and row-parallel linear layers, ``y = act(x @
W1_col) @ W2_row`` with one all-reduce at the block's output. Each rank
holds its weight shards as plain tensors (``shard_columnwise``,
``shard_rowwise``); ``x`` and ``y`` are the same on every rank of the
axis.

The f/g pair makes such a block differentiable: ``copy_fwd_psum_bwd``
marks the block's input (identity forward; the backward sums the
partial input gradients the ranks' shards produced) and
``psum_fwd_copy_bwd`` its output (sum forward; the cotangent passes
through). The transformer's ``layer_apply`` takes them as its
``pre_block``/``post_block`` hooks.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from .collectives import copy_fwd_psum_bwd, psum_fwd_copy_bwd
from .mesh import Mesh, P, shard_tensor

__all__ = ["copy_fwd_psum_bwd", "psum_fwd_copy_bwd", "shard_columnwise", "shard_rowwise",
           "tp_mlp", "tp_attention_projections", "block_hooks"]

gelu = partial(F.gelu, approximate="tanh")  # jax.nn.gelu's default


def shard_columnwise(w: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of the output (last) dim of ``w``."""
    return shard_tensor(w, P(*([None] * (w.dim() - 1)), axis), mesh).contiguous()


def shard_rowwise(w: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of the input (first) dim of ``w``."""
    return shard_tensor(w, P(axis), mesh).contiguous()


def block_hooks(mesh: Mesh, axis: str = "model") -> dict:
    """``{"pre_block": f, "post_block": g}`` over ``axis``, for
    ``models.transformer.layer_apply``/``forward``."""
    group = mesh.group(axis)
    return {"pre_block": partial(copy_fwd_psum_bwd, group=group),
            "post_block": partial(psum_fwd_copy_bwd, group=group)}


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result (``preferred_element_type``)."""
    return a.float() @ b.float()


def tp_mlp(mesh: Mesh, axis: str = "model", activation: Callable = gelu) -> Callable:
    """The canonical TP MLP block: ``f(x, w_up, w_down) -> y`` with
    ``w_up`` this rank's column block ``[D, F/n]``, ``w_down`` its row
    block ``[F/n, D]``; x and y whole on every rank of ``axis``."""
    hooks = block_hooks(mesh, axis)

    def block(x, w_up, w_down):
        x_in = hooks["pre_block"](x)
        h = activation(_f32_product(x_in, w_up)).to(x.dtype)
        return hooks["post_block"](_f32_product(h, w_down)).to(x.dtype)

    return block


def tp_attention_projections(mesh: Mesh, axis: str = "model") -> Callable:
    """Head-parallel attention projections: ``f(x, wq, wk, wv, wo,
    attn_fn) -> y`` with the Q/K/V weights' column blocks (this rank's
    heads) and ``wo``'s row block; ``attn_fn(q, k, v)`` runs on the local
    heads ``[..., H_local * Dh]``, one all-reduce at the output."""
    hooks = block_hooks(mesh, axis)

    def block(x, wq, wk, wv, wo, attn_fn):
        x_in = hooks["pre_block"](x)
        ctx = attn_fn(x_in @ wq, x_in @ wk, x_in @ wv)
        return hooks["post_block"](_f32_product(ctx, wo)).to(x.dtype)

    return block
