"""Weight-only int8 quantization for serving, and int8 KV blocks for the
host KV tier.

The port's copy of ``devspace_tpu/inference/quantization.py``.

Weights: each matmul weight ``[D_in, D_out]`` is stored as int8 with a
float32 scale per output column (``QuantizedLinear``); the product
dequantizes on the fly, ``x @ q * scale``. Activations stay in the model
dtype; no calibration. Embeddings (a gather) and norms stay dense.
``quantize_params`` turns a transformer param tree
(``models.transformer.init_params``) into one the model and the engine
serve unchanged: every weight use is ``x @ w``, which reaches
``QuantizedLinear.__rmatmul__`` (a tensor's ``__matmul__`` returns
``NotImplemented`` for a non-tensor).

The product. The reference computes ``dot_general(x, q,
preferred_element_type=f32) * scale`` and rounds once to ``x.dtype``:

- the plain version, ``((x.float() @ q.float()) * scale).to(x.dtype)``,
  is that in float32. It runs on the CPU and is the card's reference;
- on the card a bf16/fp16 ``x`` multiplies ``q`` upcast to ``x.dtype``
  (exact: |q| <= 127 fits the 8-bit significand) with float32 output
  (``torch.mm(..., out_dtype=torch.float32)``), then the scale in
  float32 and one rounding to ``x.dtype``: the same products summed in
  another order, so the two agree within one ulp of ``x.dtype``. Its one
  temporary is the upcast weight (262 MB for Llama-2-7B's lm_head),
  freed before the next product. A float32 ``x`` takes the plain version.

Under a tensor-parallel mesh (``shard_serving_params``) an int8 weight
shards like the dense one and its scale along the weight's out dim.

KV blocks: ``quantize_kv_block`` and ``dequantize_kv_block`` on numpy,
with the scale floor ``KV_SCALE_EPS`` that
``ops.paged_attention.quantize_kv`` shares.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..ops.paged_attention import KV_SCALE_EPS

__all__ = [
    "KV_SCALE_EPS", "QuantizedLinear", "quantize_weight", "quantize_params",
    "dequantize_params", "quantization_error", "quantize_kv_block", "dequantize_kv_block",
    "shard_serving_params",
]

# transformer matmul leaves worth quantizing (embeddings are gathers, norms
# are tiny)
_MATMUL_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scale)`` as the reference computes it: float32
    products and sums, one rounding to ``x.dtype``."""
    return ((x.float() @ q.float()) * scale).to(x.dtype)


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., D_in] @ q [D_in, D_out] * scale [D_out]`` in ``x.dtype``:
    the plain version on the CPU and for float32 ``x``; on the card a
    16-bit ``x`` goes through one matrix product with float32 output
    (module docstring)."""
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float16):
        return quantized_matmul_plain(x, q, scale)
    y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype), out_dtype=torch.float32)
    return (y * scale).to(x.dtype).view(*x.shape[:-1], q.shape[1])


class QuantizedLinear:
    """int8 weight ``q [D_in, D_out]`` and float32 ``scale [D_out]``;
    behaves like the dense weight under ``x @ w``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:  # what the dense weight would have been
        return torch.bfloat16

    def to(self, device: Union[str, torch.device]) -> "QuantizedLinear":
        return QuantizedLinear(self.q.to(device), self.scale.to(device))

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        return quantized_matmul(x, self.q, self.scale)

    def __repr__(self) -> str:
        return f"QuantizedLinear(shape={tuple(self.q.shape)})"


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-column int8 quantization of ``w [D_in,
    D_out]``: the scale maps each column's max |w| to 127 (1.0 for an
    all-zero column), ``w / scale`` divided in float32 and rounded half to
    even, clipped to +-127 — the reference's arithmetic, so ``q`` and
    ``scale`` are the same bytes on the CPU, on the card and in JAX."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=0)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some scales one ulp away from the CPU's
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(q, scale)


def _is_matmul_leaf(name: str, node) -> bool:
    return name in _MATMUL_LEAVES and isinstance(node, torch.Tensor) and node.ndim == 2


def quantize_params(params: dict) -> dict:
    """Quantize every matmul weight of a transformer param tree (see
    ``models.transformer.init_params``); other leaves pass through."""

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return quantize_weight(node) if _is_matmul_leaf(name, node) else node

    return walk(params)


def dequantize_params(params: dict) -> dict:
    """The inverse, for checkpointing or debugging: every
    ``QuantizedLinear`` back to a bf16 dense weight."""

    def walk(node):
        if isinstance(node, QuantizedLinear):
            return (node.q.float() * node.scale).to(torch.bfloat16)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantization_error(params: dict) -> float:
    """Max relative per-leaf reconstruction error over the matmul leaves
    of a DENSE tree (a sanity metric; ~<1% for normal-ish weights)."""
    errs = []

    def walk(node, name=""):
        if isinstance(node, QuantizedLinear):
            raise ValueError(
                "quantization_error needs the DENSE params (the original weights are gone "
                "from a quantized tree, so the error cannot be measured from it)"
            )
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, name)
        elif _is_matmul_leaf(name, node):
            ql = quantize_weight(node)
            w = node.float()
            deq = ql.q.float() * ql.scale
            errs.append(float(torch.linalg.norm(w - deq) / max(float(torch.linalg.norm(w)), 1e-9)))

    walk(params)
    return max(errs) if errs else 0.0


def quantize_kv_block(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of one KV block ``[L, Hkv, bs, D]``
    for the host tier (``inference/kv_tier.py``): a per-(layer, head,
    token) scale that maps max|x| over the head dim D to 127, rounding
    half to even — the convention of ``ops.paged_attention.quantize_kv``,
    so a block spilled from a float pool carries the noise the int8 pool
    already has (~0.5%; greedy near-ties can flip)."""
    x32 = np.asarray(x, np.float32)
    amax = np.max(np.abs(x32), axis=-1)  # [L, Hkv, bs]
    scale = np.maximum(amax, KV_SCALE_EPS) / 127.0
    q = np.clip(np.rint(x32 / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_kv_block(q: np.ndarray, scale: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Host-side inverse of :func:`quantize_kv_block` (tests and
    debugging; the engine's restore dequantizes on the device)."""
    return (q.astype(np.float32) * np.asarray(scale, np.float32)[..., None]).astype(dtype)


def shard_serving_params(params: dict, cfg, mesh, model_axis: str = "model") -> dict:
    """This rank's shards of a serving param tree on ``mesh.device``, placed
    by ``models.transformer.param_partition_spec`` (heads and FFN over
    ``model_axis``, the LM head's vocab, the rest replicated). An int8
    ``QuantizedLinear`` shards like the dense weight it replaces, its
    per-output-column scale on the out dim's axis (replicated when the
    out dim is), so the dequantizing product stays local to the rank and
    the block's all-reduce is unchanged. A leaf may arrive whole (it is
    cut) or already as this rank's shard (``load_serving_params(mesh=)``);
    a leaf already on the device at a model axis of one is served without
    a copy, and a block cut from a whole leaf owns its bytes. ``ValueError``
    for any other shape."""
    from ..models import transformer as tfm
    from ..parallel.mesh import P, shard_tensor

    n = mesh.size(model_axis)

    def local_shape(shape, spec):
        return tuple(d // n if i < len(spec) and spec[i] is not None else d
                     for i, d in enumerate(shape))

    def place(x: torch.Tensor, spec, full: tuple, where: str) -> torch.Tensor:
        if tuple(x.shape) == full:
            x = shard_tensor(x, spec, mesh)
        elif tuple(x.shape) != local_shape(full, spec):
            raise ValueError(f"{where}: shape {tuple(x.shape)} is neither the whole "
                             f"{full} nor its shard over {model_axis!r} ({n})")
        x = x.to(mesh.device).contiguous()
        # a block that is a view of a larger tensor owns its bytes: the
        # whole weight is not kept alive for it
        return x.clone() if x.untyped_storage().nbytes() != x.nbytes else x

    def walk(node, template, spec, where):
        if isinstance(node, dict):
            return {k: walk(node[k], template[k], spec[k], f"{where}.{k}") for k in node}
        if isinstance(node, list):
            return [walk(a, b, c, f"{where}.{i}")
                    for i, (a, b, c) in enumerate(zip(node, template, spec, strict=True))]
        full = tuple(template.shape)
        if isinstance(node, QuantizedLinear):
            out_axis = spec[1] if len(spec) > 1 else None
            return QuantizedLinear(place(node.q, spec, full, where),
                                   place(node.scale, P(out_axis), full[1:], where + ".scale"))
        return place(node, spec, full, where)

    template = tfm.init_params(cfg, torch.Generator(), device="meta")
    spec = tfm.param_partition_spec(cfg, model_axis=model_axis)
    return walk(params, template, spec, "params")
