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
    ``device`` (``None`` means cuda, as every entry point). ``dtype``
    casts the weight matrices (embed, projections, lm_head); norms stay
    float32 as ``init_params`` makes them. Without ``dtype`` every leaf
    keeps its dtype exactly. ``trainable=True`` makes every leaf a leaf
    tensor that requires grad, as a trainer takes them. A ``(q, scale)``
    pair becomes a ``QuantizedLinear`` (neither cast nor trainable)."""
    dev = resolve_device(device)

    def conv(name: str, arr):
        if isinstance(arr, (tuple, list)):
            q, scale = (tensor_from_numpy(np.asarray(a)).to(dev) for a in arr)
            if q.dtype != torch.int8 or scale.dtype != torch.float32:
                raise TypeError(f"{name}: a quantized weight is (int8 q, float32 scale)")
            return QuantizedLinear(q, scale)
        t = tensor_from_numpy(np.asarray(arr))
        if dtype is not None and name not in _NORMS:
            t = t.to(dtype)
        return t.to(dev).requires_grad_(trainable)

    return {
        "embed": conv("embed", tree["embed"]),
        "layers": [
            {name: conv(name, layer[name]) for name in layer}
            for layer in tree["layers"]
        ],
        "final_norm": conv("final_norm", tree["final_norm"]),
        "lm_head": conv("lm_head", tree["lm_head"]),
    }


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
    return {
        "embed": leaf_to_numpy(params["embed"]),
        "layers": [{name: leaf_to_numpy(t) for name, t in layer.items()}
                   for layer in params["layers"]],
        "final_norm": leaf_to_numpy(params["final_norm"]),
        "lm_head": leaf_to_numpy(params["lm_head"]),
    }
