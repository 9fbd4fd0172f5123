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
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device

_NORMS = ("attn_norm", "ffn_norm", "final_norm")


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding exactly ``arr``'s values (bf16 bit for bit)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype != np.float32:
        raise TypeError(f"unsupported parameter dtype {arr.dtype} (float32 or bfloat16)")
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
    tensor that requires grad, as a trainer takes them."""
    dev = resolve_device(device)

    def conv(name: str, arr) -> torch.Tensor:
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


def params_to_numpy(params: dict) -> dict:
    """The port's param tree (or a tree of grads in its shape) -> the same
    tree of numpy arrays, the inverse of ``params_from_numpy``."""
    return {
        "embed": tensor_to_numpy(params["embed"]),
        "layers": [{name: tensor_to_numpy(t) for name, t in layer.items()}
                   for layer in params["layers"]],
        "final_norm": tensor_to_numpy(params["final_norm"]),
        "lm_head": tensor_to_numpy(params["lm_head"]),
    }
