"""Checkpoint save and restore, step-managed, in a format torch alone reads.

Counterpart of ``devspace_tpu/training/checkpoint.py``. The reference
writes Orbax checkpoints; the card's machine has neither orbax nor
safetensors, so the port has a format of its own, and
``scripts/convert_checkpoint.py`` carries checkpoints between the two.

A checkpoint is one directory:

- ``params.pt``: the parameter tree flattened to ``{name: tensor}``
  (``layers.3.wq``), written by ``torch.save`` from CPU tensors and read
  with ``torch.load(weights_only=True, mmap=True)``, so a restore maps
  the file instead of reading it into memory. Every dtype, bf16 too, is
  kept bit for bit;
- ``opt_state.pt``, only for a train state: the optimizer's
  ``state_dict()``, which keys each parameter's moments by its position
  in the optimizer, plus ``param_names``: the parameter's name at each
  position. A restore of the params alone never opens it;
- ``meta.json``: the format and its version, the kind (``params`` for a
  bare tree, ``train_state`` for ``{"params", "opt_state", "step"}``),
  the step, the tree's structure, every leaf's shape and dtype, and for
  a train state ``opt_names``, the same names in optimizer order.

A ``torch.nn.Module`` in the tree (the classifiers' train state is
``{"params": <module>, ...}``) is written through its ``state_dict()``:
its parameters and BatchNorm running statistics under their flax names
(``Dense_0.kernel``, ``bn_init.mean``), and restored in place.

Moments are bound by name: a restore into an optimizer matches each
saved name to the template's parameter of that name, remapping where
the order differs and raising where the names differ. Version 1 wrote
no names, so its train states' moments are refused (their params still
restore, ``partial=True``); a version 1 bare params tree loads as ever.

A save writes a temporary sibling (``step_00000010.tmp-...``) and
renames it into place, so a reader never sees half a checkpoint and
``list_step_dirs`` skips the sibling, as the reference skips Orbax's tmp
directories. The train state is the port's
(``training.trainer.init_train_state``): the optimizer is a live
``torch.optim.Optimizer`` over the param tensors, so restoring into a
template fills its tensors in place and loads the optimizer's state.

Meshes (``parallel/mesh.py``; the reference's Orbax does both for a
``jax`` mesh):

- **Elastic restore.** ``sharded_template(state, mesh, spec_tree)``
  describes each leaf's block on a mesh (``ShardedLeaf``: its logical
  shape and dtype, the mesh and its spec). A restore into it maps the
  full logical array from the file, as every restore does, and keeps
  this rank's block on the mesh's device, so a checkpoint saved at one
  layout (one process, a pipe mesh, FSDP) restores at another. For a
  whole train state (``{"params", "opt_state": an optimizer factory,
  "step"}``) the template holds this rank's parameter blocks and the
  optimizer built over them; the restore fills the blocks in place and
  cuts each saved moment by its parameter's spec into this rank's block
  (the inverse of the save's gather), so training resumes with its
  moments on the new mesh.
- **Layouts.** The pipeline's stacked layouts
  (``parallel/pipeline.py``: ``{"stages"}`` ``[S, K, ...]`` or
  ``[V, S, K, ...]``) and the flat ``{"layers"}`` tree are one model:
  a restore into a template of another layout re-stacks the saved
  params and moments to it.
- **Saves from a mesh.** ``save_checkpoint(..., mesh=, spec_tree=)`` (and
  ``CheckpointManager(mesh=, spec_tree=)``) gathers a state sharded over
  any axes (``pipe``, ``model``, FSDP's ``data``) to its logical arrays,
  the optimizer's moments by their params' specs, and rank 0 writes it,
  behind a barrier: every rank then sees the complete step directory,
  in the same format (version 2, ``meta.json``, ``opt_names``) as a
  save from one process.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

FORMAT = "devspace-torch-checkpoint"
VERSION = 2
# versions read_meta accepts: 1 wrote no optimizer names
READABLE_VERSIONS = (1, 2)
PARAMS_FILE, OPT_FILE, META_FILE = "params.pt", "opt_state.pt", "meta.json"
_TRAIN_KEYS = ("params", "opt_state", "step")


def is_train_state(state: Any) -> bool:
    return isinstance(state, dict) and "params" in state and "opt_state" in state


# a module's skeleton: {MODULE_KEY: {state_dict key: leaf name}}
MODULE_KEY = "$module"


def _flatten(tree: Any, prefix: str, flat: dict) -> Any:
    """The JSON skeleton of ``tree`` (each leaf replaced by its name),
    filling ``flat`` with name -> tensor. A module's leaves are its
    ``state_dict`` entries, the parameters themselves (``keep_vars``)."""
    if isinstance(tree, torch.nn.Module):
        return {MODULE_KEY: {k: _flatten(v, f"{prefix}{k}.", flat)
                             for k, v in tree.state_dict(keep_vars=True).items()}}
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}{k}.", flat) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}{i}.", flat) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        name = prefix[:-1]
        flat[name] = tree
        return name
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf at {prefix[:-1]!r}")


def _unflatten(skeleton: Any, flat: dict) -> Any:
    """The saved tree; a module comes back as its state dict."""
    if isinstance(skeleton, dict) and set(skeleton) == {MODULE_KEY}:
        return {k: flat[name] for k, name in skeleton[MODULE_KEY].items()}
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, flat) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, flat) for v in skeleton]
    return flat[skeleton]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor owning exactly ``t``'s bytes (``torch.save`` writes a
    view's whole storage, so views are copied)."""
    t = t.detach().to("cpu")
    if not t.is_contiguous() or t.untyped_storage().nbytes() != t.nbytes:
        t = t.clone()
    return t


def _host_tree(x: Any) -> Any:
    """An optimizer ``state_dict`` (or any nested value) with every
    tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return x


def param_names(params: Any, optimizer: torch.optim.Optimizer) -> list[str]:
    """The names (checkpoint leaf names) of ``optimizer``'s parameters, in
    its order across its param groups: the order its ``state_dict`` keys
    moments by. ``ValueError`` for a parameter outside ``params``."""
    flat: dict = {}
    _flatten(params, "", flat)
    by_id = {id(t): name for name, t in flat.items()}
    names = [by_id.get(id(p)) for g in optimizer.param_groups for p in g["params"]]
    if None in names:
        raise ValueError("the optimizer holds a tensor that is not in the params tree: "
                         "its moments cannot be bound to a name")
    return names


@dataclass(frozen=True)
class ShardedLeaf:
    """A restore template's leaf on a mesh: the logical array's ``shape``
    and ``dtype``, and the block of it under ``spec`` that this rank
    keeps, on ``mesh.device``; ``target``, where set, is the tensor the
    block is copied into (a train state's parameter, which its optimizer
    holds)."""

    shape: tuple
    dtype: torch.dtype
    mesh: Any
    spec: Any
    target: Optional[torch.Tensor] = field(default=None, compare=False)

    def cut(self, saved: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``saved`` (a view)."""
        from ..parallel.mesh import shard_tensor

        return shard_tensor(saved, self.spec, self.mesh)

    def block(self, saved: torch.Tensor) -> torch.Tensor:
        if self.target is not None:
            with torch.no_grad():
                self.target.copy_(self.cut(saved))
            return self.target
        x = self.cut(saved).to(self.mesh.device, self.dtype)
        x = x.contiguous()
        return x.clone() if x.untyped_storage().nbytes() != x.nbytes else x


def sharded_template(state: Any, mesh, spec_tree: Any = None) -> Any:
    """A restore template placing every leaf of ``state`` on ``mesh``: the
    elastic-restore mechanism. ``state`` gives the structure, shapes and
    dtypes of the LOGICAL arrays (tensors, e.g. ``init_params(cfg, gen,
    device="meta")``); ``spec_tree`` is a spec tree over it
    (``PartitionSpec`` at a node covers its subtree; ``None`` replicates
    everything). ``restore_checkpoint(path, template)`` then returns this
    rank's blocks, each a fresh tensor on ``mesh.device``.

    A train state ``{"params", "opt_state", "step"}`` whose ``opt_state``
    is an optimizer factory (``trainer.adamw(lr)``) gives a train-state
    template: its params' blocks are allocated here (trainable, on
    ``mesh.device``), ``opt_state`` is the factory's optimizer over them
    (in ``trainer.param_leaves`` order, as ``init_train_state``), and a
    full restore fills the blocks in place, binds each parameter's saved
    moments cut to its block, and returns the step saved."""
    from ..parallel.mesh import map_with_spec, shard_tensor, tree_leaves

    if not is_train_state(state):
        return map_with_spec(lambda x, s: ShardedLeaf(tuple(x.shape), x.dtype, mesh, s), state,
                             spec_tree)
    factory = state["opt_state"]
    if isinstance(factory, torch.optim.Optimizer) or not callable(factory):
        raise ValueError("a train-state template's opt_state is an optimizer factory "
                         "(trainer.adamw(lr)): its optimizer is built over the blocks")

    def leaf(x, s):
        shape = shard_tensor(torch.empty(x.shape, device="meta"), s, mesh).shape
        block = torch.empty(shape, dtype=x.dtype, device=mesh.device, requires_grad=True)
        return ShardedLeaf(tuple(x.shape), x.dtype, mesh, s, block)

    params = map_with_spec(leaf, state["params"], spec_tree)
    blocks = [x.target for x in tree_leaves(params)]
    return {"params": params, "opt_state": factory(blocks), "step": state.get("step", 0)}


def _leaf_names(tree: Any, prefix: str = "") -> dict:
    """Leaf name (as ``_flatten`` names it) -> leaf, for any leaf type."""
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items() for n, x in _leaf_names(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {n: x for i, v in enumerate(tree)
                for n, x in _leaf_names(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


# -- layouts: the flat tree and the pipeline's stacked ones ----------------------
def _layout(params: Any) -> Optional[tuple]:
    """``("flat",)``, ``("1f1b", S)``, ``("interleaved", V, S)`` or None
    (not a transformer tree) from a tree's structure and its ``wq``
    shape."""
    if not isinstance(params, dict):
        return None
    if isinstance(params.get("layers"), (list, tuple)):
        return ("flat",)
    stages = params.get("stages")
    if not isinstance(stages, dict) or "wq" not in stages:
        return None
    shape = tuple(stages["wq"].shape)
    return ("1f1b", shape[0]) if len(shape) == 4 else ("interleaved", shape[0], shape[1])


def _to_layout(tree: dict, have: tuple, want: tuple) -> dict:
    """A transformer tree re-stacked from layout ``have`` to ``want``."""
    from ..parallel import pipeline

    if have[0] == "1f1b":
        tree = pipeline.transformer_unstage_params(tree)
    elif have[0] == "interleaved":
        tree = pipeline.transformer_uninterleave_params(tree)
    if want[0] == "1f1b":
        tree = pipeline.transformer_stage_params(tree, want[1])
    elif want[0] == "interleaved":
        tree = pipeline.transformer_interleaved_stage_params(tree, want[2], want[1])
    return tree


def _relayout_moments(path: str, opt: dict, skeleton: Any, have: tuple, want: tuple,
                      new_names: list) -> dict:
    """A saved optimizer state dict with each parameter's moments moved
    as ``_to_layout`` moves the params (whose new leaf names are
    ``new_names``): a moment shaped like its parameter is re-stacked with
    it; a scalar one (AdamW's ``step``), the same for every parameter,
    is given to each new one."""
    if len(opt["param_groups"]) != 1:
        raise ValueError(f"{path}: a restore across layouts needs one param group")
    group = {**opt["param_groups"][0], "params": list(range(len(new_names)))}
    out = {**opt, "state": {}, "param_groups": [group], "param_names": list(new_names)}
    if not opt["state"]:
        return out
    names = list(opt["param_names"])
    entries = [opt["state"].get(i) for i in range(len(names))]
    keys = set(entries[0] or ())
    if any(e is None or set(e) != keys for e in entries):
        raise ValueError(f"{path}: a restore across layouts needs every parameter's moments")
    moved: dict = {}
    for key in keys:
        values = {n: e[key] for n, e in zip(names, entries)}
        first = values[names[0]]
        if all(v.dim() == 0 for v in values.values()):
            if any(not torch.equal(v, first) for v in values.values()):
                raise ValueError(f"{path}: moment {key!r} differs between parameters")
            moved[key] = {n: first.clone() for n in new_names}
        else:
            moved[key] = _leaf_names(_to_layout(_unflatten(skeleton, values), have, want))
    out["state"] = {i: {k: moved[k][n].contiguous() for k in keys}
                    for i, n in enumerate(new_names)}
    return out


def _named_specs(params: Any, spec_tree: Any) -> dict:
    """Leaf name (as ``_flatten`` names it) -> the leaf's spec."""
    from ..parallel.mesh import map_with_spec

    names: dict = {}

    def walk(tree, specs, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], specs[k], f"{prefix}{k}.")
        elif isinstance(tree, (list, tuple)):
            for i, (t, s) in enumerate(zip(tree, specs)):
                walk(t, s, f"{prefix}{i}.")
        else:
            names[prefix[:-1]] = specs

    walk(params, map_with_spec(lambda x, s: s, params, spec_tree), "")
    return names


def _gathered(state: Any, mesh, spec_tree: Any) -> Any:
    """A mesh-sharded state with its logical arrays: the params gathered by
    ``spec_tree``, an optimizer's moments by their params' specs (a
    state tensor shaped like its param takes the param's spec; others,
    such as step counts, are the same on every rank). Collective over
    the mesh: every rank calls it."""
    from ..parallel.mesh import gather_tensor, gather_tree

    train = is_train_state(state)
    params = state["params"] if train else state
    full = gather_tree(params, spec_tree, mesh)
    if not train:
        return full
    opt = state["opt_state"]
    if not isinstance(opt, torch.optim.Optimizer):
        raise ValueError("a save from a mesh gathers a train state's optimizer, not a state dict")
    names = param_names(params, opt)
    specs = _named_specs(params, spec_tree)
    tensors = [p for g in opt.param_groups for p in g["params"]]
    sd = opt.state_dict()
    moments = {}
    for i, entry in sd["state"].items():
        moments[i] = {k: gather_tensor(v, specs[names[i]], mesh)
                      if torch.is_tensor(v) and v.dim() and v.shape == tensors[i].shape else v
                      for k, v in entry.items()}
    return {**state, "params": full,
            "opt_state": {"state": moments, "param_groups": sd["param_groups"],
                          "param_names": names}}


def snapshot(state: Any, mesh=None, spec_tree: Any = None) -> dict:
    """What a save writes, copied to the host: ``{"meta", "params",
    "opt_state"}`` (``opt_state`` None for a bare params tree). A train
    state's optimizer state carries ``param_names`` (an optimizer's are
    read off it; a state dict must already hold them). With ``mesh``, the
    state is this rank's shards under ``spec_tree`` and the snapshot its
    logical arrays (``_gathered``: collective over the mesh)."""
    if mesh is not None:
        state = _gathered(state, mesh, spec_tree)
    train = is_train_state(state)
    params = state["params"] if train else state
    flat: dict = {}
    skeleton = _flatten(params, "", flat)
    flat = {name: _host_copy(t) for name, t in flat.items()}
    opt = None
    step = None
    names = None
    if train:
        opt = state["opt_state"]
        if isinstance(opt, torch.optim.Optimizer):
            names = param_names(params, opt)
            opt = {**opt.state_dict(), "param_names": names}
        elif "param_names" not in opt:
            raise ValueError("an optimizer state dict without param_names cannot be "
                             "bound to the params by name")
        else:
            names = list(opt["param_names"])
        opt = _host_tree(opt)
        step = int(state.get("step", 0))
    meta = {
        "format": FORMAT, "version": VERSION,
        "kind": "train_state" if train else "params", "step": step, "tree": skeleton,
        "leaves": {n: {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}
                   for n, t in flat.items()},
    }
    if train:
        meta["opt_names"] = names
    return {"meta": meta, "params": flat, "opt_state": opt}


def write_snapshot(path: str, snap: dict, force: bool = True) -> None:
    """Write ``snap`` (from :func:`snapshot`) as the checkpoint ``path``:
    into a temporary sibling, then renamed into place."""
    path = os.path.abspath(path.rstrip(os.sep))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(snap["params"], os.path.join(tmp, PARAMS_FILE))
        if snap["opt_state"] is not None:
            torch.save(snap["opt_state"], os.path.join(tmp, OPT_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(snap["meta"], f)
        if os.path.exists(path):
            old = f"{tmp}-old"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _is_writer(mesh) -> bool:
    return mesh is None or dist.get_rank() == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier()


def save_checkpoint(path: str, state: Any, force: bool = True, mesh=None,
                    spec_tree: Any = None) -> None:
    """Save a params tree, or a train state ``{"params", "opt_state",
    "step"}``, as the checkpoint directory ``path``. With ``mesh``: every
    rank calls it with its shards under ``spec_tree``; the logical state
    is gathered and rank 0 writes it; every rank returns once it is
    written."""
    snap = snapshot(state, mesh, spec_tree)
    try:
        if _is_writer(mesh):
            write_snapshot(path, snap, force=force)
    finally:
        _barrier(mesh)


def read_meta(path: str) -> dict:
    """The checkpoint's ``meta.json``; ``ValueError`` for a directory that
    is not a checkpoint of this format (an Orbax one: convert it with
    ``scripts/convert_checkpoint.py``)."""
    try:
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        if not os.path.isdir(path):
            raise
        raise ValueError(
            f"{path} holds no {META_FILE}: not a checkpoint of the port's format "
            f"(an Orbax checkpoint converts with scripts/convert_checkpoint.py)"
        ) from None
    if meta.get("format") != FORMAT or meta.get("version") not in READABLE_VERSIONS:
        raise ValueError(f"{path}: unknown checkpoint format {meta.get('format')!r} "
                         f"version {meta.get('version')!r}")
    return meta


def _fill(saved: Any, template: Any, where: str) -> Any:
    """``saved`` laid out as ``template``: a tensor leaf on the meta device
    becomes the saved tensor in the template's dtype (still mapped from
    the file where the dtype is the saved one); a tensor leaf anywhere
    else is filled in place."""
    if isinstance(template, torch.nn.Module):
        want = template.state_dict(keep_vars=True)
        if not isinstance(saved, dict) or set(saved) != set(want):
            raise ValueError(f"{where or 'module'}: the saved entries differ from the "
                             f"module's state_dict {sorted(want)}")
        for k, t in want.items():
            _fill(saved[k], t, f"{where}.{k}".lstrip("."))
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{where or 'tree'}: the saved keys differ from the template's "
                             f"{sorted(template)}")
        return {k: _fill(saved[k], template[k], f"{where}.{k}".lstrip(".")) for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"{where}: the saved entries differ from the template's "
                             f"{len(template)}")
        return type(template)(_fill(s, t, f"{where}.{i}")
                              for i, (s, t) in enumerate(zip(saved, template)))
    if isinstance(template, ShardedLeaf):
        if tuple(saved.shape) != template.shape:
            raise ValueError(f"{where}: saved shape {tuple(saved.shape)} != template's "
                             f"{template.shape}")
        return template.block(saved)
    if not isinstance(template, torch.Tensor):
        raise TypeError(f"{where}: template leaf must be a tensor, got {type(template).__name__}")
    if tuple(saved.shape) != tuple(template.shape):
        raise ValueError(f"{where}: saved shape {tuple(saved.shape)} != template's "
                         f"{tuple(template.shape)}")
    if template.device.type == "meta":
        return saved.to(dtype=template.dtype)
    with torch.no_grad():
        template.copy_(saved)
    return template


def _bind_moments(path: str, meta: dict, saved: dict, optimizer: torch.optim.Optimizer,
                  params: Any, leaves: Optional[dict] = None) -> None:
    """Load ``saved`` (an optimizer state dict written with its names)
    into ``optimizer``, each parameter's moments going to the template's
    parameter of the same name, wherever the optimizer holds it. A
    parameter whose template leaf (``leaves``: name -> leaf) is a
    ``ShardedLeaf`` gets each saved moment shaped like the logical array
    cut to its block, by the spec the save gathered it by."""
    if meta["version"] < 2 or "param_names" not in saved:
        raise ValueError(
            f"{path}: a version {meta['version']} train state keys its optimizer moments "
            f"by position, with no parameter names, so they cannot be bound safely; "
            f"restore its params alone (partial=True) and start the optimizer afresh")
    if params is None:
        raise ValueError(f"{path}: binding the optimizer's moments by name needs the "
                         f"template's params")
    saved_names = list(saved["param_names"])
    names = param_names(params, optimizer)
    if sorted(saved_names) != sorted(names) or len(set(names)) != len(names):
        raise ValueError(f"{path}: the saved optimizer's parameters "
                         f"{sorted(set(saved_names) ^ set(names))} differ from the template's")
    pos = {n: i for i, n in enumerate(saved_names)}
    groups = optimizer.state_dict()["param_groups"]
    if len(groups) != len(saved["param_groups"]):
        raise ValueError(f"{path}: {len(saved['param_groups'])} saved param groups, "
                         f"the optimizer has {len(groups)}")
    tensors = [p for g in optimizer.param_groups for p in g["params"]]
    state, new_groups = {}, []
    for sg, tg in zip(saved["param_groups"], groups):
        if {saved_names[i] for i in sg["params"]} != {names[j] for j in tg["params"]}:
            raise ValueError(f"{path}: a saved param group holds other parameters than "
                             f"the optimizer's")
        for j in tg["params"]:
            entry = saved["state"].get(pos[names[j]])
            if entry is None:
                continue
            leaf = (leaves or {}).get(names[j])
            if isinstance(leaf, ShardedLeaf):
                entry = {key: leaf.cut(v).contiguous().clone()
                         if torch.is_tensor(v) and v.dim() and tuple(v.shape) == leaf.shape else v
                         for key, v in entry.items()}
            for key, value in entry.items():
                if value.dim() and tuple(value.shape) != tuple(tensors[j].shape):
                    raise ValueError(f"{path}: moment {key!r} of {names[j]!r} has shape "
                                     f"{tuple(value.shape)}, the parameter "
                                     f"{tuple(tensors[j].shape)}")
            state[j] = entry
        new_groups.append({**sg, "params": list(tg["params"])})
    optimizer.load_state_dict({"state": state, "param_groups": new_groups})


def restore_checkpoint(path: str, template: Optional[Any] = None, partial: bool = False) -> Any:
    """Restore the checkpoint ``path``.

    Without a template: the tree as saved, its tensors mapped from the
    file on the CPU; a train state's ``opt_state`` is the optimizer's
    ``state_dict`` and ``step`` an int.

    With a template (the tree to restore, or a train state's dict), the
    saved tree must have its structure and shapes (``ValueError``
    otherwise): a template tensor on the meta device becomes the saved
    tensor in the template's dtype on the CPU, a ``ShardedLeaf``
    (``sharded_template``) this rank's block of it on the mesh's device,
    any other template tensor is filled in place; an optimizer loads the saved state, and
    ``step`` is the saved step; the optimizer's moments are bound by
    parameter name (remapped where the order differs, ``ValueError``
    where the names differ or the checkpoint is a version 1 train state,
    which named none). ``partial=True`` (needs a template)
    restores only the parts of a train state the template names:
    ``{"params": ...}`` reads the params and never opens
    ``opt_state.pt``."""
    path = os.path.abspath(path)
    meta = read_meta(path)
    train = meta["kind"] == "train_state"
    if partial and template is None:
        raise ValueError("partial restore needs a template naming the subtree")
    if template is not None and train:
        parts = set(template) if isinstance(template, dict) else set()
        if not parts or not parts <= set(_TRAIN_KEYS):
            raise ValueError(f"{path} holds a train state: the template must name parts "
                             f"of {_TRAIN_KEYS}")
        if not partial and parts != set(_TRAIN_KEYS):
            raise ValueError(f"{path}: a full restore needs all of {_TRAIN_KEYS} "
                             f"(partial=True restores a part)")
    elif template is not None and is_train_state(template):
        raise ValueError(f"{path} holds a bare params tree, not a train state")
    flat = torch.load(os.path.join(path, PARAMS_FILE), weights_only=True, mmap=True,
                      map_location="cpu")
    params = _unflatten(meta["tree"], flat)
    t_params = template.get("params") if train and template is not None else template
    have, want = _layout(params), _layout(t_params)
    relayout = have is not None and want is not None and have != want
    if relayout:
        params = _to_layout(params, have, want)
    if template is None:
        if not train:
            return params
        opt = torch.load(os.path.join(path, OPT_FILE), weights_only=True, map_location="cpu")
        return {"params": params, "opt_state": opt, "step": meta["step"]}
    if not train:
        return _fill(params, template, "")
    out = {}
    if "params" in template:
        out["params"] = _fill(params, template["params"], "params")
    if "opt_state" in template:
        opt = torch.load(os.path.join(path, OPT_FILE), weights_only=True, map_location="cpu")
        target = template["opt_state"]
        if relayout:
            opt = _relayout_moments(path, opt, meta["tree"], have, want, list(_leaf_names(params)))
        if isinstance(target, torch.optim.Optimizer):
            # the restored params: a train-state template's targets, the
            # tensors its optimizer holds
            _bind_moments(path, meta, opt, target, out.get("params", t_params),
                          _leaf_names(t_params))
            opt = target
        out["opt_state"] = opt
    if "step" in template:
        out["step"] = meta["step"]
    return out


def list_step_dirs(root: str) -> list[tuple[int, str]]:
    """All ``root/step_NNNNNNNN`` checkpoint dirs as (step, path), numeric
    order — the one parser of the step-dir naming convention."""
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for d in names:
        if d.startswith("step_"):
            try:
                out.append((int(d[len("step_"):]), os.path.join(root, d)))
            except ValueError:
                continue  # e.g. a save's temporary sibling
    return sorted(out)


def latest_step_dir(root: str) -> Optional[str]:
    """Step-numbered checkpoint dirs: root/step_00000010 etc."""
    steps = list_step_dirs(root)
    return steps[-1][1] if steps else None


class CheckpointManager:
    """Step-managed checkpointing with retention and resume.

    ``maybe_save`` checkpoints every ``save_interval`` steps into
    ``root/step_NNNNNNNN`` and keeps the newest ``max_to_keep``;
    ``restore_or_init`` makes a cold start and a resumed run the same
    call site. ``use_async=True`` copies the state to the host in
    ``save`` and writes it on a thread, overlapping the next steps; a
    save waits for the one before it, and ``wait_until_finished`` (which
    ``restore``, ``close`` and ``train_loop`` call) commits the last and
    raises its error, if any.

    ``mesh``/``spec_tree``: every rank of a mesh holds its shards and
    makes the same calls; a save gathers the logical state (collective)
    and rank 0 writes it and prunes old steps. A synchronous save returns
    on every rank once the step is written; an asynchronous one
    synchronizes the ranks in ``wait_until_finished``."""

    def __init__(self, root: str, save_interval: int = 100, max_to_keep: int = 3,
                 use_async: bool = False, mesh=None, spec_tree: Any = None):
        self.root = os.path.abspath(root)
        self.save_interval = max(1, int(save_interval))
        self.max_to_keep = max(1, int(max_to_keep))
        self.use_async = use_async
        self.mesh, self.spec_tree = mesh, spec_tree
        self._writer: Optional[threading.Thread] = None
        self._pending_barrier = False
        self._error: Optional[BaseException] = None
        if _is_writer(mesh):
            os.makedirs(self.root, exist_ok=True)
        _barrier(mesh)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        return [step for step, _ in list_step_dirs(self.root)]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> str:
        path = self._dir(step)
        if not self.use_async:
            save_checkpoint(path, state, force=True, mesh=self.mesh, spec_tree=self.spec_tree)
            if _is_writer(self.mesh):
                self._gc()
            _barrier(self.mesh)
            return path
        self.wait_until_finished()
        # the device -> host copy, before the state moves on
        snap = snapshot(state, self.mesh, self.spec_tree)
        self._pending_barrier = self.mesh is not None
        if not _is_writer(self.mesh):
            return path

        def write():
            try:
                write_snapshot(path, snap, force=True)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — raised by wait_until_finished
                self._error = e

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return path

    def wait_until_finished(self) -> None:
        """Block until an in-flight asynchronous save has committed; raise
        the error it met."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._pending_barrier:
            self._pending_barrier = False
            _barrier(self.mesh)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        """Commit any in-flight save. Idempotent."""
        self.wait_until_finished()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        """Save when the policy says so (every ``save_interval`` steps);
        returns the path when a checkpoint was written."""
        if step % self.save_interval:
            return None
        return self.save(step, state)

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_checkpoint(self._dir(step), template)

    def restore_or_init(self, init_fn, template: Any = None) -> tuple[Any, int]:
        """``(state, step)``: the latest checkpoint, or ``(init_fn(), 0)``
        on a cold start. Without a ``template`` the checkpoint is restored
        into ``init_fn()``'s state: its tensors filled in place and its
        optimizer loaded, so the optimizer keeps its hold on the params."""
        self.wait_until_finished()
        step = self.latest_step()
        if step is None:
            return init_fn(), 0
        if template is None:
            template = init_fn()
        return self.restore(step, template), step

    def _gc(self) -> None:
        for step in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._dir(step), ignore_errors=True)
