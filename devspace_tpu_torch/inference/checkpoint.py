"""Serving-side checkpoint loading — the train -> serve seam.

Counterpart of ``devspace_tpu/inference/checkpoint.py``. Training writes
step-managed checkpoints of the train state (``training/checkpoint.py``
``CheckpointManager``) or a bare params tree; serving needs only the
params. ``load_serving_params`` restores them alone (a train state's
``opt_state.pt``, ~2x the param bytes under Adam, is never opened),
checks every shape against the serving config, places them on one
device leaf by leaf from the mapped file (host memory never holds the
tree a second time), and optionally quantizes each matmul weight to
int8 as it lands. Under a tensor-parallel ``mesh`` each rank keeps only
its shards of the mapped logical arrays (``_params_template``: the
training checkpoint's ``sharded_template`` by
``param_partition_spec``), the placement the engine serves with
(``quantization.shard_serving_params``); an int8 weight is quantized
whole, then cut, so its scales are those of the whole weight.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ..device import resolve_device
from ..models import transformer as tfm
from ..training.checkpoint import (
    list_step_dirs,
    read_meta,
    restore_checkpoint,
    sharded_template,
)
from .quantization import _is_matmul_leaf, quantize_weight, shard_serving_params


def _resolve_step_dir(path: str, step: Optional[int]) -> tuple[str, Optional[int]]:
    """``path`` is either a training root full of ``step_NNNNNNNN`` dirs
    (pick ``step`` or the latest) or one checkpoint dir directly."""
    path = os.path.abspath(path)
    steps = list_step_dirs(path)
    if steps:
        if step is None:
            return steps[-1][1], steps[-1][0]
        for s, p in steps:
            if s == step:
                return p, s
        raise FileNotFoundError(
            f"no step_{step:08d} under {path} (available steps: {[s for s, _ in steps]})"
        )
    if step is not None:
        raise FileNotFoundError(
            f"{path} contains no step_NNNNNNNN dirs to select step {step} from"
        )
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    base = os.path.basename(path.rstrip(os.sep))
    found = (
        int(base[len("step_"):])
        if base.startswith("step_") and base[len("step_"):].isdigit()
        else None
    )
    return path, found


def _is_train_state(path: str) -> bool:
    """Whether the checkpoint holds a full train state (restore its
    ``params`` alone) or a bare params tree, from ``meta.json``; no
    tensor bytes are read. Unreadable metadata assumes the train-state
    layout, as the reference does (the restore then fails clearly)."""
    try:
        return read_meta(path)["kind"] == "train_state"
    except (OSError, ValueError, KeyError):
        return True


def _params_template(cfg: tfm.TransformerConfig, mesh, model_axis: str, quantize: bool):
    """The restore template of the serving params: the logical tree's
    shapes and dtypes (on the meta device, nothing materialized); under a
    ``mesh``, with each leaf's block by ``param_partition_spec`` (an int8
    restore takes the whole weights and cuts them after quantizing)."""
    shapes = tfm.init_params(cfg, torch.Generator(), device="meta")
    if mesh is None or quantize:
        return shapes
    return sharded_template(shapes, mesh, tfm.param_partition_spec(cfg, model_axis))


def _place(tree, device: torch.device, quantize: bool):
    """Each leaf of ``tree`` (mapped from the file) copied to ``device``,
    and a matmul weight quantized there, one leaf at a time."""

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        leaf = node.to(device)
        return quantize_weight(leaf) if quantize and _is_matmul_leaf(name, leaf) else leaf

    return walk(tree)


def load_serving_params(
    path: str,
    cfg: tfm.TransformerConfig,
    step: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    quantize: Optional[str] = None,
    mesh=None,
    model_axis: str = "model",
) -> tuple[dict, Optional[int]]:
    """Restore serving params from a checkpoint.

    ``path``: a training checkpoint root (``step_NNNNNNNN`` dirs — the
    latest, or ``step``, is chosen) or one checkpoint dir. Accepts both a
    train state (its params restored alone) and a bare params tree.
    Leaves land on ``device`` (``None`` means cuda, as every entry point)
    in ``cfg.dtype`` (norms float32), after their shapes are checked
    against ``init_params(cfg)`` built on the meta device; a mismatch is
    a ``ValueError``. ``quantize="int8"`` applies weight-only int8
    (``inference/quantization.py``). ``mesh`` (``parallel.mesh``): this
    rank's shards over ``model_axis`` instead, on ``mesh.device``, placed
    as ``InferenceEngine(mesh=)`` serves them. Returns ``(params, step)``,
    ``step`` None when the directory name carries no step number."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    dev = resolve_device(device if mesh is None else mesh.device)
    resolved, found_step = _resolve_step_dir(path, step)
    template = _params_template(cfg, mesh, model_axis, quantize == "int8")
    try:
        if _is_train_state(resolved):
            params = restore_checkpoint(resolved, {"params": template}, partial=True)["params"]
        else:
            params = restore_checkpoint(resolved, template)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 — surface the seam, keep the cause
        raise ValueError(
            f"checkpoint at {resolved} does not match the serving config "
            f"(wrong model config, or not a params/train-state checkpoint): {e}"
        ) from e
    if mesh is None:
        return _place(params, dev, quantize == "int8"), found_step
    if quantize == "int8":
        params = shard_serving_params(_place(params, dev, True), cfg, mesh, model_axis)
    return params, found_step
