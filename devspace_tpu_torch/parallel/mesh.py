"""Named device meshes over ``torch.distributed``, and partition specs.

Counterpart of ``devspace_tpu/parallel/mesh.py``. The reference lets
XLA insert the collectives from shardings over a named ``jax`` mesh; the
port is explicit SPMD: each process is one rank of the default process
group, holds its own shards as plain tensors, and calls the collectives
itself on one process group per mesh axis
(``torch.distributed.device_mesh.init_device_mesh``). The backend is
NCCL on the card and gloo on the CPU, taken from the device; a mesh on
the card without NCCL raises, and nothing falls back to another backend.

``PartitionSpec`` is the reference's: one entry per dimension, an axis
name or ``None``; a spec tree mirrors a param tree, and a spec at a
subtree covers every leaf under it. ``shard_tree`` cuts a full tree
down to this rank's shards by such a tree, ``gather_tree`` puts the
full tensors back together.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import collectives


class PartitionSpec(tuple):
    """``P(None, "model")``: dim 1 sharded over the ``model`` axis, dim 0
    whole. Dims past the spec's length are whole."""

    def __new__(cls, *parts):
        for p in parts:
            if p is not None and not isinstance(p, str):
                raise TypeError(f"a spec entry is an axis name or None, got {p!r}")
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def mesh_shape_for(
    n_devices: int, axes: dict[str, int]
) -> dict[str, int]:
    """Resolve -1 entries: the leftover device count goes to the (single)
    -1 axis. ``axes`` preserves insertion order. Axis sizes must be
    integers >= 1 (or the one -1 wildcard) — a zero/negative axis would
    otherwise surface as a baffling reshape error deep in mesh build."""
    known = 1
    wildcard = None
    for name, size in axes.items():
        if size == -1:
            if wildcard is not None:
                raise ValueError("only one mesh axis may be -1")
            wildcard = name
        elif not isinstance(size, int) or isinstance(size, bool) or size < 1:
            raise ValueError(
                f"mesh axis {name!r} must be a positive integer or -1 "
                f"(got {size!r})"
            )
        else:
            known *= size
    if wildcard is not None:
        if n_devices % known:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes ({known})"
            )
        axes = {**axes, wildcard: n_devices // known}
    total = math.prod(axes.values())
    if total != n_devices:
        raise ValueError(
            f"mesh {axes} needs {total} devices but {n_devices} are available"
        )
    return axes


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


class Mesh:
    """This rank's view of a named mesh: ``shape`` (axis -> size, in
    order), ``group(axis)`` (the process group of the ranks that differ
    from this one along ``axis`` only), ``index(axis)`` (this rank's
    coordinate, ``jax.lax.axis_index``) and the ``device`` its shards
    live on."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    def group(self, axis: str):
        self._check(axis)
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        self._check(axis)
        return self.device_mesh.get_local_rank(axis)

    def size(self, axis: str) -> int:
        self._check(axis)
        return self.shape[axis]

    def _check(self, axis: str) -> None:
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


@contextlib.contextmanager
def distributed(device=None, logger=None):
    """The default process group of a run, for the ``with`` block: formed
    from the environment (``multihost_initialize``), else a world of one
    process whose rendezvous is a file in a temporary directory (no port
    is opened); destroyed on exit if it was formed here. An existing
    group is used as it is."""
    if dist.is_initialized():
        yield
        return
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="devspace-world-") as tmp:
        if not multihost_initialize(logger, dev):
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group(backend_for(dev), store=store, rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def create_mesh(axes: Optional[dict[str, int]] = None, device=None) -> Mesh:
    """A named mesh over the default process group. Default: every rank
    on one ``data`` axis.

    ``axes`` maps axis name -> size, one size may be -1 (inferred from
    the world size), e.g. ``{"data": -1, "model": 2}`` over 8 ranks ->
    data=4, model=2; ranks are laid out row-major, the last axis
    innermost. ``device`` is where this rank's shards live (``None``:
    the card). It needs the default process group (``distributed``),
    whose backend must be the device's (NCCL for ``cuda``, gloo for
    ``cpu``), else ``ValueError``: nothing falls back to another
    backend."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = backend_for(dev)
    if not dist.is_initialized():
        raise RuntimeError("no default process group: form one with "
                           "parallel.mesh.distributed() or torch.distributed")
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"a mesh on {dev.type} needs the {backend} backend; the default "
                         f"process group uses {have}")
    axes = mesh_shape_for(dist.get_world_size(), dict(axes or {"data": -1}))
    device_mesh = init_device_mesh(dev.type, tuple(axes.values()),
                                   mesh_dim_names=tuple(axes.keys()))
    return Mesh(device_mesh, dev)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``): where a batch
    leaf lives (``training/data.prefetch_to_device``)."""

    mesh: Mesh
    spec: PartitionSpec


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def multihost_initialize(logger=None, device=None) -> bool:
    """Form the default process group from the environment the repo's
    charts wire into slice pods (``JAX_COORDINATOR_ADDRESS``,
    ``TPU_WORKER_ID``, ``JAX_NUM_PROCESSES``) or that ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). No-op
    (returns False) for one process. A world that was asked for and does
    not form raises (``torch.distributed``'s own error). The backend
    follows ``device`` (``None``: the card, NCCL)."""
    backend = backend_for(resolve_device(device))
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if coordinator and n > 1:
        pid = int(os.environ.get("TPU_WORKER_ID", "0"))
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=n, rank=pid)
        how = coordinator
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        pid, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dist.init_process_group(backend, init_method="env://", world_size=n, rank=pid)
        how = "env://"
    else:
        return False
    if logger:
        logger.info("[torch] distributed init: process %d/%d via %s", pid, n, how)
    return True


# -- spec trees ---------------------------------------------------------------
def spec_leaves(spec: Any, tree: Any) -> list:
    """The spec of each leaf of ``tree`` (dicts by sorted key, lists in
    order, as ``trainer.param_leaves`` lists them). A ``PartitionSpec``
    at a node covers its whole subtree; ``None`` for the whole tree is
    replicated."""
    if spec is None:
        spec = P()
    if isinstance(spec, PartitionSpec):
        return [spec] * len(tree_leaves(tree))
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(spec[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for sub_spec, sub in zip(spec, tree, strict=True)
                for s in spec_leaves(sub_spec, sub)]
    raise TypeError(f"spec {spec!r} for a leaf")


def tree_leaves(tree: Any) -> list:
    """A tree's leaves in ``spec_leaves``' order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def map_with_spec(fn, tree: Any, spec: Any) -> Any:
    """``fn(leaf, leaf_spec)`` over ``tree``, keeping its dicts and lists."""
    if spec is None:
        spec = P()
    if isinstance(spec, PartitionSpec):
        if isinstance(tree, dict):
            return {k: map_with_spec(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(map_with_spec(fn, v, spec) for v in tree)
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: map_with_spec(fn, v, spec[k]) for k, v in tree.items()}
    return type(tree)(map_with_spec(fn, v, s) for v, s in zip(tree, spec, strict=True))


def tree_map(fn, tree: Any) -> Any:
    """``fn(leaf)`` over ``tree``, keeping its dicts and lists."""
    return map_with_spec(lambda x, _: fn(x), tree, None)


def spec_axes(spec: PartitionSpec) -> tuple:
    return tuple(a for a in spec if a is not None)


def opt_state_partition_spec(opt_state: torch.optim.Optimizer, param_spec, params) -> list:
    """The spec of each state tensor of a torch optimizer over
    ``tree_leaves(params)``: one dict per parameter (in that order),
    state name -> spec; a state tensor shaped like its parameter (Adam's
    moments, SGD's momentum) inherits the parameter's spec, anything else
    (step counts) is replicated. ``param_spec`` may be a prefix tree (a
    spec covering a whole subtree). A parameter the optimizer has not
    stepped yet has no state (an empty dict)."""
    out = []
    for p, spec in zip(tree_leaves(params), spec_leaves(param_spec, params), strict=True):
        state = opt_state.state.get(p, {})
        out.append({name: spec if torch.is_tensor(v) and v.shape == p.shape and v.dim() else P()
                    for name, v in state.items()})
    return out


def shard_tensor(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view). Raises
    ``ValueError`` where a sharded dim does not divide by its axis."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than {tuple(x.shape)} has dims")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by axis "
                             f"{axis!r} ({n})")
        x = x.chunk(n, dim=dim)[mesh.index(axis)]
    return x


def shard_tree(tree: Any, spec: Any, mesh: Mesh) -> Any:
    """Each leaf cut to this rank's block (a fresh contiguous tensor on
    the mesh's device; a leaf that required grad is a leaf that does)."""

    def cut(x, s):
        block = shard_tensor(x.detach(), s, mesh).to(mesh.device).contiguous().clone()
        return block.requires_grad_(x.requires_grad)

    return map_with_spec(cut, tree, spec)


def gather_tensor(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec`` (no autograd)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = collectives.gather(x, dim, mesh.group(axis))
    return x.detach()


def gather_tree(tree: Any, spec: Any, mesh: Mesh) -> Any:
    return map_with_spec(lambda x, s: gather_tensor(x, s, mesh), tree, spec)
