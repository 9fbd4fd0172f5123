"""Data parallelism: each rank takes its rows of the batch, the gradients
are averaged over the ``data`` axis by one all-reduce.

Counterpart of ``devspace_tpu/parallel/data_parallel.py``. The reference
annotates shardings and lets the partitioner emit the gradient psum;
here the psum is explicit: every rank backpropagates its own mean loss
over ``n`` (its share of the global mean, since the rows split evenly),
the gradients are summed over ``data`` (one all-reduce per dtype), and
each rank's optimizer takes the same step on the same replicated
params. The loss returned is the global mean, as under the reference's
``jit``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import all_reduce_, all_reduce_coalesced_, psum_mean
from .mesh import Mesh, P, shard_tensor, spec_axes, spec_leaves, tree_leaves


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows (the leading dim split over ``axis``) of every
    leaf of a batch tree (dicts, lists, tuples), on the mesh's device."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return shard_tensor(torch.as_tensor(batch), P(axis), mesh).to(mesh.device).contiguous()


def reduce_gradients(leaves: list, specs: list, mesh: Mesh, axes: tuple) -> None:
    """Sum each leaf's ``.grad`` over every axis of ``axes`` its spec does
    not shard it along (a leaf without a gradient counts as zeros)."""
    for axis in axes:
        grads = []
        for p, s in zip(leaves, specs):
            if axis in spec_axes(s):
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if grads:
            all_reduce_coalesced_(grads, mesh.group(axis))


def make_train_step(
    loss_fn: Callable,
    optimizer: Callable,
    mesh: Mesh,
    data_axis: str = "data",
    param_spec=None,
) -> Callable:
    """A data-parallel train step ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``.

    ``loss_fn(params, batch) -> scalar`` is the mean over the rows it is
    given; ``batch`` holds this rank's rows (``shard_batch``);
    ``opt_state`` is the torch optimizer over ``tree_leaves(params)``
    (``optimizer`` is its factory, unused here and kept so the signature
    matches the reference's). ``param_spec`` defaults to replicated; a
    leaf sharded over ``data_axis`` is FSDP's (``make_fsdp_train_step``)
    and raises ``ValueError``. The step updates the params in place."""
    del optimizer

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        specs = spec_leaves(param_spec, params)
        if any(data_axis in spec_axes(s) for s in specs):
            raise ValueError(f"a leaf sharded over {data_axis!r} is FSDP's: use "
                             "parallel.fsdp.make_fsdp_train_step")
        opt_state.zero_grad(set_to_none=True)
        local = loss_fn(params, batch)
        group = mesh.group(data_axis)
        (local / mesh.size(data_axis)).backward()
        reduce_gradients(leaves, specs, mesh, (data_axis,))
        opt_state.step()
        loss = all_reduce_(local.detach().float().clone(), group) / mesh.size(data_axis)
        return params, opt_state, loss

    return step


def make_eval_step(apply_fn: Callable, mesh: Mesh, data_axis: str = "data") -> Callable:
    """``eval(params, batch) -> apply_fn(params, batch)`` on this rank's
    rows, without gradients; the output holds this rank's rows."""
    del mesh, data_axis

    @torch.no_grad()
    def step(params, batch):
        return apply_fn(params, batch)

    return step


def psum_mean_loss(loss_fn: Callable, mesh: Mesh, axis: str = "data") -> Callable:
    """The per-shard mean loss averaged over ``axis`` (the north star's
    literal psum over the interconnect). Its gradient reaches each rank's
    own loss scaled by ``1 / n``, so summing the params' gradients over
    ``axis`` afterwards gives the gradient of the global mean."""

    def wrapped(params, batch):
        return psum_mean(loss_fn(params, batch), mesh.group(axis))

    return wrapped
