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

The reference's ``sharded_template`` and its mesh placement wait for
the port of ``parallel/``: here every restore lands on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import torch

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


def snapshot(state: Any) -> dict:
    """What a save writes, copied to the host: ``{"meta", "params",
    "opt_state"}`` (``opt_state`` None for a bare params tree). A train
    state's optimizer state carries ``param_names`` (an optimizer's are
    read off it; a state dict must already hold them)."""
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


def save_checkpoint(path: str, state: Any, force: bool = True) -> None:
    """Save a params tree, or a train state ``{"params", "opt_state",
    "step"}``, as the checkpoint directory ``path``."""
    write_snapshot(path, snapshot(state), force=force)


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
                  params: Any) -> None:
    """Load ``saved`` (an optimizer state dict written with its names)
    into ``optimizer``, each parameter's moments going to the template's
    parameter of the same name, wherever the optimizer holds it."""
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
    tensor in the template's dtype on the CPU, any other template
    tensor is filled in place; an optimizer loads the saved state, and
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
        if isinstance(target, torch.optim.Optimizer):
            _bind_moments(path, meta, opt, target, template.get("params"))
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
    raises its error, if any."""

    def __init__(self, root: str, save_interval: int = 100, max_to_keep: int = 3,
                 use_async: bool = False):
        self.root = os.path.abspath(root)
        self.save_interval = max(1, int(save_interval))
        self.max_to_keep = max(1, int(max_to_keep))
        self.use_async = use_async
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.root, exist_ok=True)

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
            save_checkpoint(path, state, force=True)
            self._gc()
            return path
        self.wait_until_finished()
        snap = snapshot(state)  # the device -> host copy, before the state moves on

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
