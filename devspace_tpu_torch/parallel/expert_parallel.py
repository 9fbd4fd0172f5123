"""Expert parallelism: Mixture-of-Experts with all-to-all dispatch.

Counterpart of ``devspace_tpu/parallel/expert_parallel.py``: ``swiglu``,
``init_moe_params``, ``expert_capacity``, ``_route``,
``moe_ffn_reference`` (the experts applied densely on one device), and
the mesh part: ``moe_param_spec``, ``shard_moe_params`` and ``moe_ffn``
(experts sharded over a mesh axis, conventionally ``data``; tokens
moved to their expert's rank and back by two all-to-alls). Capacity, drop order and the Switch
load-balancing loss follow the reference step for step: each of the k
choices takes every token's best remaining expert; a token's slot in
its expert's queue is its rank among the tokens before it (earlier
tokens and earlier choices first); a token past ``capacity`` is dropped
(its combine weight is zero, so it passes through the residual); the
kept gates are normalised over the choices; ``aux = E * sum_e
fraction_dispatched_e * mean_prob_e`` on the first choice. Routing stays
in float32; the one-hot dispatch and combine products are
``torch.einsum`` (the reference leaves them to XLA).

Both expert products keep the reference's roundings at a compute type
below float32: the up-projection gives a float32 result, the activation
runs on it and rounds once (``_up_product``); the down-projection
accumulates in float32 and rounds once.

Capacity is per rank, as the reference's: ``moe_ffn`` routes each
rank's tokens alone with ``expert_capacity`` of its local count, so a
token the reference drops is dropped here too.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .collectives import all_to_all, psum_mean
from .mesh import Mesh, P, shard_tree

gelu = partial(F.gelu, approximate="tanh")  # jax.nn.gelu's default


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """SwiGLU over fused gate and up projections: ``h`` ``[..., 2F]``
    (gate | up on the last dim) -> ``[..., F]``."""
    f = h.shape[-1] // 2
    return F.silu(h[..., :f]) * h[..., f:]


def init_moe_params(generator: torch.Generator, dim: int, ffn_dim: int, num_experts: int,
                    dtype: torch.dtype = torch.bfloat16, scale: float = 0.02,
                    device: Optional[torch.device] = None) -> dict:
    """Seeded params on the generator's device: router ``w_gate`` ``[D,
    E]`` float32 (routing logits are precision-sensitive) and stacked
    expert FFNs ``w_up`` ``[E, D, F]``, ``w_down`` ``[E, F, D]`` in
    ``dtype``, each normal * ``scale``. The draws cannot reproduce
    ``jax.random``: parity tests carry the reference's params across."""
    device = generator.device if device is None else torch.device(device)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device) * scale

    return {
        "w_gate": normal((dim, num_experts)),
        "w_up": normal((num_experts, dim, ffn_dim)).to(dtype),
        "w_down": normal((num_experts, ffn_dim, dim)).to(dtype),
    }


def moe_param_spec(axis: Optional[str] = "data") -> dict:
    """``PartitionSpec`` tree matching ``init_moe_params``: experts
    sharded over ``axis``, the router replicated."""
    return {"w_gate": P(), "w_up": P(axis, None, None), "w_down": P(axis, None, None)}


def shard_moe_params(params: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's experts (``E / n`` of them) and the whole router."""
    return shard_tree(params, moe_param_spec(axis), mesh)


def expert_capacity(tokens_per_device: int, num_experts: int, capacity_factor: float,
                    k: int) -> int:
    """Slots per expert (static)."""
    return max(1, math.ceil(capacity_factor * k * tokens_per_device / num_experts))


def _route(probs: torch.Tensor, k: int, capacity: int):
    """probs ``[T, E]`` float32 -> (dispatch ``[T, E, C]`` bool, combine
    ``[T, E, C]`` float32, aux scalar). Differentiable in ``probs``
    through the combine weights and aux."""
    t, e = probs.shape
    remaining = probs
    counts = torch.zeros(e, dtype=torch.int32, device=probs.device)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=probs.device)
    gates, onehots = [], []
    for _ in range(k):
        idx = remaining.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
        onehot = F.one_hot(idx, e).to(probs.dtype)
        gate = (remaining * onehot).sum(-1)
        pos_matrix = torch.cumsum(onehot, dim=0) - 1 + counts[None, :].to(probs.dtype)
        pos = (pos_matrix * onehot).sum(-1).to(torch.int32)
        keep = pos < capacity
        # jax.nn.one_hot of an index past the last class is all zeros
        slot = F.one_hot(torch.where(keep, pos, capacity).long(), capacity + 1)
        slot = slot[:, :capacity].to(torch.float32)
        dispatch = dispatch | ((onehot[:, :, None] * slot[:, None, :]) > 0.5)
        counts = counts + (onehot * keep[:, None].to(probs.dtype)).sum(0).to(torch.int32)
        gates.append(torch.where(keep, gate, torch.zeros_like(gate)))
        onehots.append(onehot)
        remaining = remaining * (1.0 - onehot)
    gate_stack = torch.stack(gates, dim=0)
    gate_stack = gate_stack / gate_stack.sum(0, keepdim=True).clamp_min(1e-9)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=probs.device)
    for c in range(k):
        combine = combine + gate_stack[c][:, None, None] * (
            onehots[c][:, :, None] * dispatch.to(probs.dtype))
    frac = onehots[0].mean(0)
    mean_prob = probs.mean(0)
    aux = e * (frac * mean_prob).sum()
    return dispatch, combine, aux


class _UpProduct(torch.autograd.Function):
    """``a [E, C, D] @ b [E, D, F]`` of 16-bit inputs with a float32
    result, as the reference's ``preferred_element_type=float32``: one
    product with a float32 output on the card, the product of the widened
    inputs on the CPU. The backward rounds the incoming float32 gradient
    to the inputs' type and takes the usual products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda":
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        return torch.bmm(grad, b.mT), torch.bmm(a.mT, grad)


def _up_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ecd,edf->ecf`` in ``a``'s type with a float32 result."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _UpProduct.apply(a, b)


def moe_ffn_reference(x: torch.Tensor, params: dict, k: int = 1,
                      capacity_factor: float = 1.25, activation: Callable = gelu):
    """x ``[T, D]`` -> (y ``[T, D]`` in x's dtype, aux scalar float32):
    route with float32 router logits, gather each expert's tokens
    (``dispatch``), apply every expert to its ``C`` slots, scatter back
    weighted by ``combine``."""
    t, _ = x.shape
    e = params["w_gate"].shape[1]
    capacity = expert_capacity(t, e, capacity_factor, k)
    probs = torch.softmax(x.float() @ params["w_gate"], dim=-1)
    dispatch, combine, aux = _route(probs, k, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    expert_out = _expert_ffn(expert_in, params, activation, x.dtype)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return y, aux


def _expert_ffn(expert_in: torch.Tensor, params: dict, activation: Callable, dtype) -> torch.Tensor:
    h = activation(_up_product(expert_in, params["w_up"])).to(dtype)
    return torch.einsum("ecf,efd->ecd", h, params["w_down"]).to(dtype)


def moe_ffn(mesh: Mesh, axis: str = "data", k: int = 1, capacity_factor: float = 1.25,
            activation: Callable = gelu) -> Callable:
    """The expert-parallel MoE FFN: ``f(x, params) -> (y, aux)`` with
    ``x`` this rank's tokens ``[T/n, D]`` and ``params`` its shards
    (``shard_moe_params``: ``E/n`` experts). On each rank:

      route -> dispatch -> all_to_all (tokens to their expert's rank) ->
      batched expert FFN -> all_to_all back -> combine

    ``aux`` is the Switch load-balancing loss averaged over ``axis``
    (``collectives.psum_mean``: each rank's own term takes ``1/n`` of the
    gradient, the trainer sums the router's gradients over the axis).
    The experts' gradients arrive on their rank through the all-to-alls'
    backward."""
    group = mesh.group(axis)
    n = mesh.size(axis)

    def layer(x, params):
        t, d = x.shape
        e_local = params["w_up"].shape[0]
        e = params["w_gate"].shape[1]
        if e != e_local * n:
            raise ValueError(f"{e} experts over {n} ranks: each holds {e // n}, got {e_local}")
        capacity = expert_capacity(t, e, capacity_factor, k)
        probs = torch.softmax(x.float() @ params["w_gate"], dim=-1)
        dispatch, combine, aux = _route(probs, k, capacity)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)  # [E, C, D]
        # to the experts' ranks: [n, E/n, C, D] -> from each source rank
        got = all_to_all(expert_in.reshape(n, e_local, capacity, d), group)
        expert_in = got.permute(1, 0, 2, 3).reshape(e_local, n * capacity, d)
        expert_out = _expert_ffn(expert_in, params, activation, x.dtype)
        back = expert_out.reshape(e_local, n, capacity, d).permute(1, 0, 2, 3)
        expert_out = all_to_all(back, group).reshape(e, capacity, d)
        y = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
        return y, psum_mean(aux, group)

    return layer
