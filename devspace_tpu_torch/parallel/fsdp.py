"""FSDP (fully-sharded data parallel, ZeRO-3) over ``torch.distributed``.

Counterpart of ``devspace_tpu/parallel/fsdp.py``. Parameters and the
optimizer state are sharded over the ``data`` axis leaf by leaf
(``fsdp_leaf_spec``: the reference's rule, so the same leaves are
sharded along the same dims); the batch is sharded over the same axis.
Where the reference leaves the schedule to the partitioner, the step
here is written out: every sharded leaf is all-gathered before the
loss, whose backward reduce-scatters its gradient
(``collectives.all_gather_scatter_bwd``); a replicated leaf's gradient
is summed over the axis; the optimizer steps the shards. The gathered
weights live for one step's forward and backward.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import all_gather_scatter_bwd, all_reduce_
from .data_parallel import reduce_gradients
from .mesh import Mesh, P, map_with_spec, shard_tree, spec_leaves, tree_leaves, tree_map
from .mesh import opt_state_partition_spec as opt_state_spec

__all__ = ["fsdp_leaf_spec", "fsdp_spec", "shard_params", "opt_state_spec",
           "make_fsdp_train_step"]


def fsdp_leaf_spec(shape, axis: str, axis_size: int, min_size: int = 1024) -> P:
    """Spec for one param: shard the largest divisible dim over ``axis``.

    Ties go to the earliest largest dim. Tiny leaves (< min_size elements —
    biases, norm scales) and leaves with no divisible dim stay replicated;
    gathering them costs more than storing them.
    """
    if not shape:
        return P()
    n = 1
    for d in shape:
        n *= d
    if n < min_size:
        return P()
    best = None
    for i, d in enumerate(shape):
        if d % axis_size == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return P()
    spec: list = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def fsdp_spec(params: Any, mesh: Mesh, axis: str = "data", min_size: int = 1024):
    """``PartitionSpec`` tree mirroring ``params`` for FSDP over ``axis``."""
    size = mesh.size(axis)
    return tree_map(lambda p: fsdp_leaf_spec(tuple(p.shape), axis, size, min_size), params)


def shard_params(params: Any, mesh: Mesh, axis: str = "data", min_size: int = 1024,
                 spec: Any = None):
    """This rank's shards of ``params`` under their FSDP specs (``spec``
    overrides the derived tree when the caller already has it)."""
    if spec is None:
        spec = fsdp_spec(params, mesh, axis, min_size)
    return shard_tree(params, spec, mesh)


def _gather_leaf(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather_scatter_bwd(x, dim, mesh.group(axis))
    return x


def make_fsdp_train_step(
    loss_fn: Callable,
    optimizer: Callable,
    mesh: Mesh,
    params: Any,
    axis: str = "data",
    min_size: int = 1024,
):
    """Build ``(step, sharded_params, opt_state)``.

    ``loss_fn(params, batch) -> scalar`` (the mean over the rows it is
    given) sees the whole params; ``step(params, opt_state, batch) ->
    (params, opt_state, loss)`` holds the params and the optimizer
    (``optimizer(shard leaves)``, a torch optimizer whose moments live on
    the shards) sharded over ``axis``; ``batch`` is this rank's rows
    (``data_parallel.shard_batch``). The loss is the global mean."""
    p_spec = fsdp_spec(params, mesh, axis, min_size)
    sharded = shard_params(params, mesh, spec=p_spec)
    opt_state = optimizer(tree_leaves(sharded))
    n = mesh.size(axis)

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        full = map_with_spec(lambda x, s: _gather_leaf(x, s, mesh), params, p_spec)
        local = loss_fn(full, batch)
        (local / n).backward()
        reduce_gradients(tree_leaves(params), spec_leaves(p_spec, params), mesh, (axis,))
        opt_state.step()
        loss = all_reduce_(local.detach().float().clone(), mesh.group(axis)) / n
        return params, opt_state, loss

    return step, sharded, opt_state
