"""FSDP (fully-sharded data parallel, ZeRO-3) over ``torch.distributed``.

Counterpart of ``devspace_tpu/parallel/fsdp.py``. Parameters and the
optimizer state are sharded over the ``data`` axis leaf by leaf
(``fsdp_leaf_spec``: the reference's rule, so the same leaves are
sharded along the same dims); the batch is sharded over the same axis.
Where the reference leaves the schedule to the partitioner, the step
here is written out, and it keeps the reference's promise of
O(params / data) plus one transiently-gathered layer:

- a params tree with a ``layers`` list (the transformer's, the MoE
  LM's) reaches the loss as a lazy view: each sharded leaf is
  all-gathered where the forward reads it (``_gather_leaf``) and dropped
  after its use. Autograd would keep a gathered weight for the backward
  (``x @ W`` saves ``W``); a ``saved_tensors_hooks`` pair keeps only the
  shard instead and gathers the weight again when the backward needs it.
  The gather's backward reduce-scatters the weight's gradient right
  there (``collectives.all_gather_scatter_bwd``), once per read;
- any other tree (an MLP's ``{"w1", "w2", "b"}``) is gathered whole
  before the loss, and the gathered weights live for the step's forward
  and backward.

A replicated leaf's gradient is summed over the axis; the optimizer
steps the shards. ``step.stats["gathered_peak_bytes"]`` is the largest
number of gathered bytes alive at once in the last step.
"""

from __future__ import annotations

import weakref
from collections.abc import Mapping, Sequence
from typing import Any, Callable

import torch

from .collectives import all_gather_scatter_bwd, all_reduce_, gather
from .data_parallel import reduce_gradients
from .mesh import Mesh, P, map_with_spec, shard_tree, spec_axes, spec_leaves, tree_leaves, tree_map
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


class _Regather:
    """What a saved gathered weight is packed to: its shard, and where in
    the gathered storage the saved tensor sat."""

    __slots__ = ("shard", "spec", "size", "stride", "offset")

    def __init__(self, shard, spec, t: torch.Tensor):
        self.shard, self.spec = shard, spec
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class _GatherTape:
    """One step's gathered weights: ``gather`` is the forward's read of
    a leaf; ``pack``/``unpack`` are the saved-tensor hooks that store a
    gathered weight as its shard and gather it again for the backward.
    A gathered tensor is known by its storage for as long as the storage
    lives (a ``weakref.finalize`` on it forgets it), so a saved view of
    it is known too; ``alive``/``peak`` count the bytes of the gathered
    storages alive, forward and backward."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.live: dict = {}  # storage pointer -> (shard, spec)
        self.alive = 0
        self.peak = 0

    def _track(self, t: torch.Tensor, entry=None) -> None:
        storage = t.untyped_storage()
        nbytes, ptr = storage.nbytes(), storage.data_ptr()
        self.alive += nbytes
        self.peak = max(self.peak, self.alive)
        if entry is not None:
            self.live[ptr] = entry
        weakref.finalize(storage, self._release, nbytes, ptr, entry)

    def _release(self, nbytes: int, ptr: int, entry) -> None:
        self.alive -= nbytes
        if entry is not None and self.live.get(ptr) is entry:
            del self.live[ptr]

    def gather(self, x: torch.Tensor, spec: P) -> torch.Tensor:
        if not spec_axes(spec):
            return x
        full = _gather_leaf(x, spec, self.mesh)
        self._track(full, (x, spec))
        return full

    def pack(self, t: torch.Tensor):
        entry = self.live.get(t.untyped_storage().data_ptr())
        return t if entry is None else _Regather(entry[0], entry[1], t)

    def unpack(self, packed):
        if not isinstance(packed, _Regather):
            return packed
        full = packed.shard.detach()
        for dim, axis in enumerate(packed.spec):
            if axis is not None:
                full = gather(full, dim, self.mesh.group(axis))
        self._track(full)
        return full.as_strided(packed.size, packed.stride, packed.offset)


def _spec_at(spec: Any, key) -> Any:
    return spec if isinstance(spec, P) else spec[key]


class _LazyDict(Mapping):
    """A params dict whose sharded leaves are gathered when read."""

    def __init__(self, tree: dict, spec: Any, tape: _GatherTape):
        self._tree, self._spec, self._tape = tree, spec, tape

    def __getitem__(self, key):
        return _lazy(self._tree[key], _spec_at(self._spec, key), self._tape)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


class _LazyList(Sequence):
    """A params list (``layers``) whose sharded leaves are gathered when
    read."""

    def __init__(self, tree: Sequence, spec: Any, tape: _GatherTape):
        self._tree, self._spec, self._tape = tree, spec, tape

    def __getitem__(self, i):
        return _lazy(self._tree[i], _spec_at(self._spec, i), self._tape)

    def __len__(self) -> int:
        return len(self._tree)


def _lazy(tree: Any, spec: Any, tape: _GatherTape) -> Any:
    if isinstance(tree, dict):
        return _LazyDict(tree, spec, tape)
    if isinstance(tree, (list, tuple)):
        return _LazyList(tree, spec, tape)
    return tape.gather(tree, spec)


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
    given) sees the whole params: for a tree with a ``layers`` list, a
    read-only mapping that gathers each sharded leaf where it is read
    (index it by key; the module docstring), else the gathered tree;
    ``step(params, opt_state, batch) -> (params, opt_state, loss)`` holds
    the params and the optimizer (``optimizer(shard leaves)``, a torch
    optimizer whose moments live on the shards) sharded over ``axis``;
    ``batch`` is this rank's rows (``data_parallel.shard_batch``). The
    loss is the global mean. ``step.stats`` holds the last step's
    ``gathered_peak_bytes``."""
    p_spec = fsdp_spec(params, mesh, axis, min_size)
    sharded = shard_params(params, mesh, spec=p_spec)
    opt_state = optimizer(tree_leaves(sharded))
    n = mesh.size(axis)
    by_layer = isinstance(params, dict) and isinstance(params.get("layers"), (list, tuple))

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        tape = _GatherTape(mesh)
        if by_layer:
            with torch.autograd.graph.saved_tensors_hooks(tape.pack, tape.unpack):
                local = loss_fn(_lazy(params, p_spec, tape), batch)
        else:
            local = loss_fn(map_with_spec(tape.gather, params, p_spec), batch)
        (local / n).backward()
        reduce_gradients(tree_leaves(params), spec_leaves(p_spec, params), mesh, (axis,))
        opt_state.step()
        loss = all_reduce_(local.detach().float().clone(), mesh.group(axis)) / n
        step.stats = {"gathered_peak_bytes": tape.peak, "layerwise": by_layer}
        return params, opt_state, loss

    step.stats = {"gathered_peak_bytes": 0, "layerwise": by_layer}
    return step, sharded, opt_state
