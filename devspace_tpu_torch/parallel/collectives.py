"""Collectives over one mesh axis, with the gradients explicit SPMD needs.

Every rank runs the same program on its own shards, and the collectives
are ``torch.distributed`` calls on the axis's process group. Where a
collective sits inside a differentiated function, its backward is
written out here (``torch.autograd.Function``), because its transpose
depends on what the ranks hold:

- ``copy_fwd_psum_bwd`` / ``psum_fwd_copy_bwd``: the Megatron f/g pair
  (``parallel/tensor_parallel.py``): the ranks of the axis hold the same
  value downstream, so a sum's cotangent is passed through unchanged and
  a copy's cotangents are summed;
- ``psum``: a sum the ranks use differently (each on its own batch), so
  its cotangents are summed too;
- ``all_to_all``: tiled along dim 0, its own transpose;
- ``all_gather_split_bwd``: the ranks hold the same gathered value
  downstream (vocab-parallel logits before a replicated loss), so the
  backward keeps this rank's slice of the cotangent;
- ``all_gather_scatter_bwd``: the ranks compute different things from
  the gathered value (FSDP's weights against each rank's batch), so the
  backward sums the cotangents and scatters them (a reduce-scatter);
- ``ring_shift``: send to the next rank of the axis and receive from the
  previous one (ring attention's K/V hops); no autograd.

Gradient convention of the train steps (``training/trainer.py``): each
rank backpropagates its own part of the loss; afterwards a parameter's
gradient is summed over every axis along which the ranks saw different
data (``data``, ``seq``) unless the parameter is sharded along it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group``; returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_coalesced_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, one all-reduce per dtype
    (the tensors flattened into one buffer and copied back)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


class _CopyFwdPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _PsumFwdCopyBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_fwd_psum_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """f: identity forward; the backward sums the cotangents over ``group``."""
    return _CopyFwdPsumBwd.apply(x, group)


def psum_fwd_copy_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """g: sum over ``group`` forward; the backward passes the cotangent on."""
    return _PsumFwdCopyBwd.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` where the ranks compute different things from
    the sum (BatchNorm's batch statistics over ``data``): the backward
    sums the ranks' cotangents."""
    return _Psum.apply(x, group)


def psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` with ``psum_fwd_copy_bwd``'s backward
    divided by the axis size: a rank's own term gets ``1 / n`` of the
    cotangent, so summing the parameters' gradients over the axis
    afterwards gives the gradient of the mean."""
    return psum_fwd_copy_bwd(x, group) / axis_size(group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` ``[n, ...]``: chunk ``i`` of dim 0 goes to rank ``i`` of
    ``group``, and chunk ``j`` of the result came from rank ``j``."""
    if x.shape[0] != axis_size(group):
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, the axis has {axis_size(group)}")
    return _AllToAll.apply(x, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = axis_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _rank_slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    return g.chunk(axis_size(group), dim=dim)[dist.get_rank(group)]


class _GatherSplitBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _rank_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherScatterBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.group)
        front = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, front, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather_split_bwd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim``; the backward keeps
    this rank's slice of the cotangent."""
    return _GatherSplitBwd.apply(x, dim, group)


def all_gather_scatter_bwd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim``; the backward sums the
    ranks' cotangents and keeps this rank's slice (a reduce-scatter)."""
    return _GatherScatterBwd.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` (no autograd)."""
    return _gather(x.detach(), dim, group)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> tuple[list, list]:
    """Post a send of each tensor to the next rank of ``group`` and a
    receive of its counterpart from the previous one -> (received
    buffers, requests); wait on the requests before reading the buffers
    or writing the tensors sent."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_shift sends contiguous tensors")
    n = axis_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prev = dist.get_global_rank(group, (me - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prev, group) for r in recv]
    return recv, dist.batch_isend_irecv(ops)
