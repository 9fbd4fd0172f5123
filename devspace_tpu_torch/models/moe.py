"""Mixtral-style Mixture-of-Experts decoder-only transformer in PyTorch.

Counterpart of ``devspace_tpu/models/moe.py``: the attention stack of
``models/transformer.py`` (RoPE, GQA, RMSNorm, ``default_attention``,
so flash attention for T > 1024 with T a multiple of 256 and the
short-sequence kernel below) with the dense SwiGLU FFN replaced by a
routed expert layer: top-``experts_per_token`` of ``num_experts``
SwiGLU experts, stacked ``[E, D, 2F]`` (gate | up fused) and ``[E, F,
D]``, routed densely on one device
(``parallel/expert_parallel.moe_ffn_reference``). Parameters are a plain
dict in the reference's tree layout, linear weights ``[in, out]``.

``param_partition_spec`` lays the params out over a mesh; the
expert-parallel layer is ``moe_fn=parallel.expert_parallel.moe_ffn(mesh,
axis=..., k=cfg.experts_per_token, activation=swiglu)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from ..parallel.expert_parallel import moe_ffn_reference, moe_param_spec, swiglu
from ..parallel.mesh import P
from .transformer import apply_rope, default_attention, repeat_kv, rms_norm, rope_frequencies


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 2.0
    aux_weight: float = 1e-2
    max_seq_len: int = 32768
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


MIXTRAL_8X7B = MoEConfig()
TINY_MOE = MoEConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
    num_experts=4, experts_per_token=2, max_seq_len=128,
)


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> dict:
    """Seeded params ``{embed, layers: [{wq, wk, wv, wo, attn_norm,
    ffn_norm, moe: {w_gate [D, E] float32, w_up [E, D, 2F], w_down [E,
    F, D]}}], final_norm, lm_head}`` on the generator's device: normal *
    0.02 in ``cfg.dtype`` (the router float32), norms ones in float32.
    ``device="meta"`` (with a CPU generator) gives shapes without memory."""
    device = generator.device if device is None else torch.device(device)
    hd, e = cfg.head_dim, cfg.num_experts

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    def dense(shape):
        return normal(shape).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.dim, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense((cfg.dim, cfg.n_heads * hd)),
            "wk": dense((cfg.dim, cfg.n_kv_heads * hd)),
            "wv": dense((cfg.dim, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, cfg.dim)),
            "attn_norm": ones(),
            "ffn_norm": ones(),
            "moe": {
                "w_gate": normal((cfg.dim, e)),
                "w_up": dense((e, cfg.dim, 2 * cfg.ffn_dim)),
                "w_down": dense((e, cfg.ffn_dim, cfg.dim)),
            },
        })
    return {
        "embed": dense((cfg.vocab_size, cfg.dim)),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def param_partition_spec(cfg: MoEConfig, model_axis: Optional[str] = "model",
                         expert_axis: Optional[str] = "data") -> dict:
    """Attention tensor-parallel over ``model_axis``; experts sharded over
    ``expert_axis`` (ep-over-dp; ``None`` replicates either)."""
    layer = {
        "wq": P(None, model_axis),
        "wk": P(None, model_axis),
        "wv": P(None, model_axis),
        "wo": P(model_axis, None),
        "attn_norm": P(),
        "ffn_norm": P(),
        "moe": moe_param_spec(expert_axis),
    }
    return {
        "embed": P(),
        "layers": [dict(layer, moe=dict(layer["moe"])) for _ in range(cfg.n_layers)],
        "final_norm": P(),
        "lm_head": P(None, model_axis),
    }


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
            attention_fn: Optional[Callable] = None, moe_fn: Optional[Callable] = None,
            positions: Optional[torch.Tensor] = None):
    """tokens ``[B, T]`` -> (logits ``[B, T, vocab]`` float32, aux
    scalar): aux is the mean load-balancing loss over layers (add
    ``cfg.aux_weight * aux`` to the train loss). ``moe_fn(x2d,
    moe_params) -> (y2d, aux)`` works on flattened ``[B*T, D]`` tokens
    and defaults to the dense routing."""
    attn = attention_fn or partial(default_attention, causal=True)
    if moe_fn is None:
        moe_fn = partial(moe_ffn_reference, k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor, activation=swiglu)
    b, t = tokens.shape
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if positions is None:
        positions = torch.arange(t, device=tokens.device)
    cos, sin = rope_frequencies(cfg, positions)
    h = params["embed"][tokens]
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(b, t, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(b, t, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(b, t, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ctx = attn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))
        h = h + (ctx.reshape(b, t, -1) @ layer["wo"]).to(h.dtype)
        x = rms_norm(h, layer["ffn_norm"], cfg.norm_eps)
        y2d, aux = moe_fn(x.reshape(b * t, cfg.dim), layer["moe"])
        h = h + y2d.reshape(b, t, cfg.dim).to(h.dtype)
        aux_total = aux_total + aux
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).float()
    return logits, aux_total / cfg.n_layers
