"""Carry a parameter tree across from numpy, and back.

``params_from_numpy`` takes the reference's ``init_params`` tree with
every leaf a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's parameters: the same tree of tensors, same layout
(linear weights stay ``[in, out]``; the port computes ``x @ w`` as the
reference does), so both packages compute the same function.

bfloat16 arrays (numpy's ``bfloat16`` extension dtype, as JAX hands them
out) are carried bit for bit through their ``uint16`` view; the port
needs no bfloat16 numpy package for that. ``params_to_numpy`` is the
inverse (for trained params or grads); handing bf16 back as numpy's
``bfloat16`` needs the ``ml_dtypes`` package, imported only then.

A weight quantized to int8 (``inference.quantization.QuantizedLinear``)
crosses as the pair ``(q, scale)``, int8 and float32, both ways: on the
JAX side that pair is ``QuantizedLinear.tree_flatten()[0]``.

The vision models (``ResNet``, ``MLP``, ``ViT``) are torch modules whose
names are flax's: ``module_from_flax`` and ``module_to_flax`` carry a
flax variable tree ``{"params", "batch_stats"}`` into a module and back
(the mapping is written out above ``module_from_flax``).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..inference.quantization import QuantizedLinear

_NORMS = ("attn_norm", "ffn_norm", "final_norm")


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding exactly ``arr``'s values and dtype (bf16 bit
    for bit; int8 for a quantized weight)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype not in (np.float32, np.int8):
        raise TypeError(f"unsupported parameter dtype {arr.dtype} (float32, bfloat16 or int8)")
    return torch.from_numpy(arr.copy())


def params_from_numpy(
    tree: dict,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    trainable: bool = False,
) -> dict:
    """Reference param tree of numpy arrays -> the port's params on
    ``device`` (``None`` means cuda, as every entry point): the LM's
    tree, or the MoE's, whose layers hold a ``moe`` dict. ``dtype`` casts
    the weight matrices (embed, projections, experts, lm_head); norms and
    the MoE router (``moe/w_gate``) stay float32 as ``init_params`` makes
    them. Without ``dtype`` every leaf keeps its dtype exactly.
    ``trainable=True`` makes every leaf a leaf tensor that requires grad,
    as a trainer takes them. A ``(q, scale)`` pair becomes a
    ``QuantizedLinear`` (neither cast nor trainable)."""
    dev = resolve_device(device)

    def conv(path: tuple, arr):
        if isinstance(arr, dict):
            return {name: conv(path + (name,), a) for name, a in arr.items()}
        if isinstance(arr, (tuple, list)) and arr and isinstance(arr[0], dict):
            return [conv(path, a) for a in arr]
        name = "/".join(path)
        if isinstance(arr, (tuple, list)):
            q, scale = (tensor_from_numpy(np.asarray(a)).to(dev) for a in arr)
            if q.dtype != torch.int8 or scale.dtype != torch.float32:
                raise TypeError(f"{name}: a quantized weight is (int8 q, float32 scale)")
            return QuantizedLinear(q, scale)
        t = tensor_from_numpy(np.asarray(arr))
        if dtype is not None and path[-1] not in _NORMS and path[-2:] != ("moe", "w_gate"):
            t = t.to(dtype)
        return t.to(dev).requires_grad_(trainable)

    return conv((), tree)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy array holding exactly ``t``'s values (bf16 bit for bit, as
    numpy's ``bfloat16``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def leaf_to_numpy(leaf):
    """A tensor -> numpy (``tensor_to_numpy``); a ``QuantizedLinear`` ->
    its ``(q, scale)`` pair of numpy arrays."""
    if isinstance(leaf, QuantizedLinear):
        return tensor_to_numpy(leaf.q), tensor_to_numpy(leaf.scale)
    return tensor_to_numpy(leaf)


def params_to_numpy(params: dict) -> dict:
    """The port's param tree (or a tree of grads in its shape) -> the same
    tree of numpy arrays, the inverse of ``params_from_numpy``."""
    if isinstance(params, dict):
        return {name: params_to_numpy(node) for name, node in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(node) for node in params]
    return leaf_to_numpy(params)


# -- flax variable trees of the vision models -------------------------------
# ``{"params": ..., "batch_stats": ...}`` of ``ResNet``, ``MLP`` and ``ViT``
# (``jax.tree.map(np.asarray, variables)``) against the port's modules.
# flax's module path is the port's submodule path and its leaf names are
# the port's parameter and buffer names, one to one:
#
#   flax                                       port (state_dict name)
#   params/conv_init/kernel   [kh, kw, I, O]   conv_init.kernel   [O, I, kh, kw]
#   params/bn_init/{scale,bias}                bn_init.{scale,bias}
#   batch_stats/bn_init/{mean,var}             bn_init.{mean,var} (buffers)
#   params/BottleneckBlock_3/Conv_1/kernel     BottleneckBlock_3.Conv_1.kernel
#   params/BottleneckBlock_3/BatchNorm_2/...   BottleneckBlock_3.BatchNorm_2....
#   params/BottleneckBlock_3/{conv_proj,norm_proj}/...
#   params/Dense_0/{kernel [in, out], bias}    Dense_0.{kernel [in, out], bias}
#   params/patch_embed/{kernel, bias}          patch_embed.{kernel (OIHW), bias}
#   params/{cls, pos_embed}                    cls, pos_embed
#   params/block_0/MultiHeadDotProductAttention_0/query/kernel [D, H, hd]
#                                              block_0.MultiHeadDotProductAttention_0.query.kernel
#   params/block_0/MultiHeadDotProductAttention_0/out/kernel   [H, hd, D] (same shape)
#   params/block_0/{LayerNorm_0,LayerNorm_1}, MlpBlock_0/{Dense_0,Dense_1}, final_norm, head
#
# The one layout change: a convolution kernel (a 4-D ``kernel``) is HWIO
# in flax and OIHW in the port. Dense kernels keep flax's ``[in..., out...]``.


def _flatten_tree(tree, prefix: tuple = ()) -> dict:
    flat = {}
    for name, node in tree.items():
        if isinstance(node, dict) or hasattr(node, "items"):
            flat.update(_flatten_tree(node, prefix + (name,)))
        else:
            flat[prefix + (name,)] = node
    return flat


def module_from_flax(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Copy a flax variable tree of numpy arrays into ``module``'s
    parameters (``"params"``) and buffers (``"batch_stats"``), in place,
    on the module's device and in its leaves' dtypes; returns ``module``.
    Raises ``KeyError`` unless the names match one to one and
    ``ValueError`` on a shape that differs."""
    own = {"params": dict(module.named_parameters()), "batch_stats": dict(module.named_buffers())}
    for collection in variables:
        if collection not in own:
            raise KeyError(f"unknown flax collection {collection!r}")
    for collection, targets in own.items():
        flat = {".".join(path): arr
                for path, arr in _flatten_tree(variables.get(collection, {})).items()}
        if set(flat) != set(targets):
            raise KeyError(f"{collection}: flax-only {sorted(set(flat) - set(targets))}, "
                           f"port-only {sorted(set(targets) - set(flat))}")
        for name, arr in flat.items():
            t = tensor_from_numpy(np.asarray(arr))
            if name.endswith("kernel") and t.dim() == 4:
                t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            target = targets[name]
            if t.shape != target.shape:
                raise ValueError(f"{collection}/{name}: flax {tuple(t.shape)} "
                                 f"vs port {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(t)
    return module


def module_to_flax(module: torch.nn.Module) -> dict:
    """The inverse of ``module_from_flax``: ``{"params": ...,
    "batch_stats": ...}`` (the latter only where the module has buffers)
    as nested dicts of numpy arrays, convolution kernels back to HWIO."""
    out: dict = {}
    for collection, named in (("params", module.named_parameters()),
                              ("batch_stats", module.named_buffers())):
        for name, t in named:
            t = t.detach()
            if name.endswith("kernel") and t.dim() == 4:
                t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
            node = out.setdefault(collection, {})
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = tensor_to_numpy(t)
    return out
