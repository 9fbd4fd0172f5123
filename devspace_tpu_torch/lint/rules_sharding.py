"""Static sharding/mesh preflight for the port's ``PartitionSpec`` trees —
no card and no process group in the loop.

Counterpart of ``devspace_tpu/lint/rules_sharding.py`` (SHD300-304).
The port is explicit SPMD over ``torch.distributed``: a spec naming an
axis the mesh lacks, or a dim its axis size does not divide, first fails
at a collective (or in ``shard_tensor``) inside a multi-rank world. These
rules check the same invariants from shapes alone, before any rank
starts. Specs are ``parallel.mesh.PartitionSpec`` (or plain tuples,
whose entries may also be tuples of axis names, as the reference's
allow).

Entry points:

- :func:`sharding_preflight` — specs vs a declared mesh (axis names,
  divisibility, duplicate axis use);
- :func:`tree_shardings` — a param tree and its spec tree (a spec at a
  subtree covers its leaves, as ``parallel.mesh.map_with_spec`` reads
  them) as the flat ``{name: (leaf, spec)}`` the preflight takes;
- :func:`donation_preflight` — donated arguments vs the outputs they
  must be written back into. The reference runs ``fn`` under
  ``jax.eval_shape``; here ``fn`` runs on ``torch.device("meta")``
  tensors, which carry shapes and dtypes and no data, so nothing is
  computed and no device is touched (the kernel wrappers take their
  plain versions for meta tensors, ``ops.dispatch.on_cuda``);
- :func:`mesh_axes_for_tpu` — resolve a deployment block (any object with
  ``topology``/``workers``/``chips_per_worker``) into concrete mesh axis
  sizes via ``parallel.mesh.mesh_shape_for``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .engine import ERROR, WARNING, Finding, LintContext, rule, run_rules


def _spec_entries(spec):
    """PartitionSpec (or plain tuple) -> tuple of per-dim entries."""
    return tuple(spec)


def _entry_axes(entry) -> tuple:
    """One spec dim entry (None | name | tuple-of-names) -> axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _shape_of(value) -> Optional[tuple]:
    """Shape tuple from a tensor / ``torch.Size`` / plain tuple."""
    shape = getattr(value, "shape", value)
    try:
        return tuple(int(d) for d in shape)
    except TypeError:
        return None


@rule(
    "SHD300",
    severity=ERROR,
    category="sharding",
    description="The declared mesh must be buildable for the configured "
    "device count (axis sizes multiply to the device count)",
)
def _mesh_buildable(ctx: LintContext):
    # Synthesized by sharding_preflight() where the mesh is actually
    # resolved; registered so SHD300 appears in the rule catalog.
    return ()


@rule(
    "SHD301",
    severity=ERROR,
    category="sharding",
    description="PartitionSpec axis names must exist in the declared mesh",
)
def check_axis_names(ctx: LintContext):
    if ctx.shardings is None or ctx.mesh_axes is None:
        return
    known = sorted(ctx.mesh_axes)
    for name in sorted(ctx.shardings):
        _, spec = ctx.shardings[name]
        for dim, entry in enumerate(_spec_entries(spec)):
            for axis in _entry_axes(entry):
                if axis not in ctx.mesh_axes:
                    yield (
                        name,
                        f"PartitionSpec dim {dim} names mesh axis {axis!r} "
                        f"but the mesh declares {known} — every rank would "
                        f"fail at its first collective over that axis",
                    )


@rule(
    "SHD302",
    severity=ERROR,
    category="sharding",
    description="Sharded dims must be divisible by the product of their "
    "mesh axis sizes",
)
def check_divisibility(ctx: LintContext):
    if ctx.shardings is None or ctx.mesh_axes is None:
        return
    for name in sorted(ctx.shardings):
        value, spec = ctx.shardings[name]
        shape = _shape_of(value)
        if shape is None:
            yield (name, f"unshapeable value {value!r}")
            continue
        entries = _spec_entries(spec)
        if len(entries) > len(shape):
            yield (
                name,
                f"PartitionSpec has {len(entries)} dims but the array is "
                f"rank {len(shape)} (shape {shape})",
            )
            continue
        for dim, entry in enumerate(entries):
            axes = [a for a in _entry_axes(entry) if a in ctx.mesh_axes]
            if not axes:
                continue
            shards = math.prod(ctx.mesh_axes[a] for a in axes)
            if shards and shape[dim] % shards:
                yield (
                    name,
                    f"dim {dim} of size {shape[dim]} is not divisible by "
                    f"{'x'.join(axes)} = {shards} shards — shard_tensor "
                    f"refuses it and the ranks' shards would differ",
                )


@rule(
    "SHD303",
    severity=ERROR,
    category="sharding",
    description="A mesh axis may appear at most once per PartitionSpec",
)
def check_duplicate_axis_use(ctx: LintContext):
    if ctx.shardings is None:
        return
    for name in sorted(ctx.shardings):
        _, spec = ctx.shardings[name]
        seen: dict = {}
        for dim, entry in enumerate(_spec_entries(spec)):
            for axis in _entry_axes(entry):
                if axis in seen:
                    yield (
                        name,
                        f"mesh axis {axis!r} used by dims {seen[axis]} and "
                        f"{dim} of the same PartitionSpec — an axis can "
                        f"shard only one dim",
                    )
                else:
                    seen[axis] = dim
    return


def _tensor_leaves(tree: Any) -> list:
    """Tensor leaves of dicts / lists / tuples, in order; anything else is
    no buffer and is skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _to_meta(tree: Any) -> Any:
    """The same tree with every tensor on the meta device (a meta tensor
    is kept as it is, so the caller's leaves stay the ones ``fn`` sees)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "meta":
            return tree
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta").requires_grad_(
            tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


@rule(
    "SHD304",
    severity=WARNING,
    category="sharding",
    description="Donated buffers must be written back into an output of "
    "matching shape+dtype or the donation buys nothing",
)
def check_donation(ctx: LintContext):
    if not ctx.donation:
        return
    fn = ctx.donation["fn"]
    args = _to_meta(tuple(ctx.donation["args"]))
    kwargs = _to_meta(dict(ctx.donation.get("kwargs") or {}))
    donate = tuple(ctx.donation.get("donate_argnums") or ())
    out = fn(*args, **kwargs)
    # The port's donation is an in-place write-back: a donated input is
    # updated where it lies and handed back as an output of identical
    # shape+dtype. Count outputs per (shape, dtype) and drain them
    # donation by donation; a donated leaf with no remaining match has
    # nowhere to go, and a fresh buffer is allocated beside it.
    available: dict = {}
    for leaf in _tensor_leaves(out):
        key = (tuple(leaf.shape), str(leaf.dtype))
        available[key] = available.get(key, 0) + 1
    for argnum in donate:
        if argnum >= len(args):
            yield (
                f"arg {argnum}",
                f"donate_argnums={argnum} but the function takes only "
                f"{len(args)} positional argument(s)",
            )
            continue
        for leaf in _tensor_leaves(args[argnum]):
            shape = tuple(leaf.shape)
            dtype = str(leaf.dtype)
            key = (shape, dtype)
            if available.get(key, 0) > 0:
                available[key] -= 1
            else:
                yield (
                    f"arg {argnum}",
                    f"donated buffer (shape {shape}, dtype {dtype}) "
                    f"matches no remaining output — it cannot be written "
                    f"back in place, so both buffers stay live",
                )


def mesh_axes_for_tpu(tpu, axes: dict) -> dict:
    """Resolve declared mesh axes (one ``-1`` wildcard allowed) against
    the device count a deployment block implies: the topology product
    when a topology is set, else workers x chips (cards) per worker."""
    from ..parallel.mesh import mesh_shape_for
    from ..utils.topology import parse_topology

    if tpu is not None and tpu.topology:
        n_devices = parse_topology(tpu.topology)
    else:
        n_devices = ((tpu.workers if tpu else None) or 1) * (
            (tpu.chips_per_worker if tpu else None) or 1
        )
    return mesh_shape_for(n_devices, dict(axes))


def tree_shardings(tree: Any, spec: Any, prefix: str = "") -> dict:
    """``{dotted name: (leaf, spec)}`` for every leaf of ``tree`` under
    its spec tree: a ``PartitionSpec`` (or ``None``, replicated) at a
    node covers the node's whole subtree."""
    from ..parallel.mesh import PartitionSpec

    if spec is None:
        spec = PartitionSpec()
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub = spec if isinstance(spec, PartitionSpec) else spec[k]
            out.update(tree_shardings(v, sub, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = spec if isinstance(spec, PartitionSpec) else spec[i]
            out.update(tree_shardings(v, sub, f"{prefix}{i}."))
    else:
        if not isinstance(spec, tuple):
            raise TypeError(f"{prefix.rstrip('.')}: spec {spec!r} for a leaf")
        out[prefix.rstrip(".")] = (tree, spec)
    return out


def sharding_preflight(
    mesh_axes: dict,
    shardings: dict,
    n_devices: Optional[int] = None,
    tpu=None,
) -> list[Finding]:
    """Validate ``{name: (shape-like, PartitionSpec)}`` against a mesh.

    ``mesh_axes`` may contain one ``-1`` wildcard when ``n_devices`` or
    ``tpu`` pins the total device count; a mesh that cannot be built at
    all is itself returned as a SHD300 finding rather than raised."""
    axes = dict(mesh_axes)
    try:
        if tpu is not None:
            axes = mesh_axes_for_tpu(tpu, axes)
        elif n_devices is not None:
            from ..parallel.mesh import mesh_shape_for

            axes = mesh_shape_for(n_devices, axes)
        elif any(s == -1 for s in axes.values()):
            raise ValueError(
                "mesh has a -1 wildcard axis but no device count to "
                "resolve it (pass n_devices= or tpu=)"
            )
    except ValueError as e:
        return [
            Finding(
                rule_id="SHD300",
                severity=ERROR,
                category="sharding",
                message=f"mesh cannot be built: {e}",
                location="mesh",
            )
        ]
    ctx = LintContext(mesh_axes=axes, shardings=dict(shardings))
    return run_rules(ctx, categories={"sharding"})


def donation_preflight(fn, args, donate_argnums=(), kwargs=None) -> list[Finding]:
    """Run the donated-buffer check with ``fn`` on meta tensors: ``args``
    are trees of tensors on any device (meta tensors are used as they
    are, others replaced by meta tensors of their shape and dtype), so
    nothing is computed."""
    ctx = LintContext(
        donation={
            "fn": fn,
            "args": tuple(args),
            "kwargs": dict(kwargs or {}),
            "donate_argnums": tuple(donate_argnums),
        }
    )
    return run_rules(ctx, categories={"sharding"})
