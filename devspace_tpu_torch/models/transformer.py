"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``devspace_tpu/models/transformer.py``: the config and its
presets, parameter init, the tensor-parallel spec (``param_partition_spec``)
and per-shard config (``shard_config``), the building blocks, the training
and prefill forward (``layer_apply``, ``forward``; attention through
``ops/attention.py``), the dense KV cache with its decode functions
(``decode_tokens``, ``decode_block``, ``decode_step``, ``generate``: the
draft model's cache and the standalone speculative path), the paged KV
pool, and the functions the serving engine runs over it —
``decode_tokens_paged`` (one decode step for every slot),
``decode_block_paged`` (K tokens per slot: speculative verification) and
``prefill_chunk_paged`` (one prompt chunk of one slot). Parameters are a plain dict of tensors in the
reference's tree layout, linear weights ``[in, out]`` (``x @ w``), so a
converted JAX tree (``models/convert.py``) computes the same function.
RoPE, GQA and SwiGLU follow Llama-2; RMSNorm accumulates and logits come
out in float32.

Tensor-parallel serving (``tp=(mesh, axis)`` of the decode and prefill
functions): each rank of the model axis holds its shards of the params
(``param_partition_spec``) and its KV heads of the pool, computes with
the per-shard config, sums each block's output over the axis (one
all-reduce after ``wo`` and one after ``w_down``, the reference's
GSPMD-inserted collectives) and gathers the vocab-sharded logits, so
every rank holds the whole logits and samples the same token. The
paged-decode kernel reads the rank's local KV heads with no collective.

Unlike the reference, caches are written IN PLACE: the paged functions
mutate the pool tensors they are given and return the same dict, and the
dense decode functions mutate ``cache["k"]``/``cache["v"]`` and return
them (JAX donates the buffers to the same effect). An out-of-range write
position raises here where JAX drops the scatter, so callers size their
caches for every position they write.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_attention
from ..ops.paged_attention import dequantize_kv, paged_decode_attention, quantize_kv
from ..parallel.collectives import all_reduce_, gather
from ..parallel.mesh import P
from ..parallel.ring_attention import full_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # explicit head size: a per-shard config (``shard_config``) has
    # n_heads/tp local heads, where dim // n_heads is no longer the head size
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads


LLAMA2_7B = TransformerConfig()
LLAMA2_13B = TransformerConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, ffn_dim=13824)
TINY = TransformerConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
    max_seq_len=128,
)

# -- params -----------------------------------------------------------------
def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: Optional[torch.device] = None
) -> dict:
    """Seeded random params {embed, layers: [{wq,wk,wv,wo,w_gate,w_up,
    w_down, attn_norm, ffn_norm}], final_norm, lm_head} on the
    generator's device: normal * 0.02 in ``cfg.dtype``, norms ones in
    float32 — the reference's recipe. A CUDA generator makes Llama-2-7B
    in well under a second on the card. The draws cannot reproduce
    ``jax.random``, so parity tests convert JAX params instead
    (``models/convert.py``). ``device="meta"`` (with a CPU generator)
    gives the tree's shapes and dtypes without memory, the counterpart
    of ``jax.eval_shape(init_params)``."""
    device = generator.device if device is None else torch.device(device)
    hd = cfg.head_dim

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.dim, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense((cfg.dim, cfg.n_heads * hd)),
            "wk": dense((cfg.dim, cfg.n_kv_heads * hd)),
            "wv": dense((cfg.dim, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, cfg.dim)),
            "w_gate": dense((cfg.dim, cfg.ffn_dim)),
            "w_up": dense((cfg.dim, cfg.ffn_dim)),
            "w_down": dense((cfg.ffn_dim, cfg.dim)),
            "attn_norm": ones(),
            "ffn_norm": ones(),
        })
    return {
        "embed": dense((cfg.vocab_size, cfg.dim)),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def param_partition_spec(cfg: TransformerConfig, model_axis: Optional[str] = "model") -> dict:
    """Tensor-parallel ``PartitionSpec`` tree: heads and FFN sharded over
    ``model_axis``, norms and the embedding replicated, the LM head's
    vocab sharded (``None``: everything replicated)."""
    layer = {
        "wq": P(None, model_axis),
        "wk": P(None, model_axis),
        "wv": P(None, model_axis),
        "wo": P(model_axis, None),
        "w_gate": P(None, model_axis),
        "w_up": P(None, model_axis),
        "w_down": P(model_axis, None),
        "attn_norm": P(),
        "ffn_norm": P(),
    }
    return {
        "embed": P(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(),
        "lm_head": P(None, model_axis),
    }


def shard_config(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """The config one rank of a ``tp``-way model axis computes with: its
    local heads, KV heads and FFN width, the head size kept. Raises
    ``ValueError`` where a width does not divide by ``tp``."""
    for name in ("n_heads", "n_kv_heads", "ffn_dim"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} not divisible by the model axis ({tp})")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               ffn_dim=cfg.ffn_dim // tp, head_dim_override=cfg.head_dim)


# -- building blocks --------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (norm * weight).to(x.dtype)


def rope_frequencies(cfg: TransformerConfig, positions: torch.Tensor):
    """positions [T] -> (cos, sin) each [T, head_dim/2], float32."""
    half = cfg.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = cfg.rope_theta ** exponent
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, per_batch: bool = False):
    """x [B, T, H, D]; rotate pairs (split-halves convention). ``cos``/
    ``sin`` are [T, half] broadcast over batch, or with ``per_batch=True``
    [B, half] broadcast over T=1 (every sequence at its own position)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if per_batch:
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    else:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, Hkv*n_rep, D] (GQA broadcast)."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def _ffn(h: torch.Tensor, layer: dict, cfg: TransformerConfig, pre=None, post=None):
    pre = pre or _identity
    post = post or _identity
    x = pre(rms_norm(h, layer["ffn_norm"], cfg.norm_eps))
    gated = F.silu(x @ layer["w_gate"]) * (x @ layer["w_up"])
    return h + post(gated @ layer["w_down"]).to(h.dtype)


def _identity(x):
    return x


def tp_parts(cfg: TransformerConfig, tp):
    """What a tensor-parallel inference call computes with: the per-shard
    config, the sum of a block's output over the model axis, and the
    gather of the vocab-sharded logits (identities without ``tp``)."""
    if tp is None:
        return cfg, _identity, _identity
    mesh, axis = tp
    group = mesh.group(axis)
    return (shard_config(cfg, mesh.size(axis)),
            lambda x: all_reduce_(x.contiguous(), group),
            lambda logits: gather(logits, -1, group).contiguous())


# -- training forward -------------------------------------------------------
def default_attention(q, k, v, causal: bool = True):
    """[B, T, H, D] attention: self-attention (T_q == T_k) through
    ``fused_attention`` (flash for long T), else the plain
    ``full_attention``, as in the reference."""
    if q.shape[1] != k.shape[1]:
        return full_attention(q, k, v, causal=causal)
    out = fused_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def layer_apply(h, layer: dict, cfg: TransformerConfig, cos, sin, attention_fn=None,
                pre_block=None, post_block=None):
    """One transformer layer (attention + SwiGLU FFN with pre-RMSNorm
    residuals) -> (h', (k, v)), k and v roped, before the GQA repeat.

    ``pre_block``/``post_block`` wrap the entry and exit of each parallel
    block (after the norm, before the residual add): the Megatron f/g
    hooks of tensor parallelism (``parallel/tensor_parallel.block_hooks``).
    With a per-shard config (``shard_config``) and the layer's weight
    shards the same code computes one rank's part."""
    attn = attention_fn or partial(default_attention, causal=True)
    pre = pre_block or _identity
    post = post_block or _identity
    b, t, _ = h.shape
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    x = pre(rms_norm(h, layer["attn_norm"], cfg.norm_eps))
    q = (x @ layer["wq"]).view(b, t, cfg.n_heads, hd)
    k = (x @ layer["wk"]).view(b, t, cfg.n_kv_heads, hd)
    v = (x @ layer["wv"]).view(b, t, cfg.n_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ctx = attn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))
    h = h + post(ctx.reshape(b, t, -1) @ layer["wo"]).to(h.dtype)
    return _ffn(h, layer, cfg, pre, post), (k, v)


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    attention_fn: Optional[Callable] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    return_kv: bool = False,
    pre_block: Optional[Callable] = None,
    post_block: Optional[Callable] = None,
):
    """Training/prefill forward: tokens [B, T] -> logits [B, T, vocab]
    (float32).

    ``positions`` [T]: the tokens' global positions (RoPE), default
    ``0..T-1``; a sequence shard passes its own offsets.
    ``pre_block``/``post_block``: ``layer_apply``'s tensor-parallel
    hooks; ``pre_block`` also marks the LM head's input (the head is
    column-parallel: each rank computes its block of the vocab).

    ``attention_fn(q, k, v) -> ctx`` on [B, T, H, D] (K/V heads already
    repeated) defaults to causal ``default_attention``. ``remat=True``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``return_kv=True`` also returns the per-layer roped K/V stacks
    ([L, B, T, Hkv, D] each), the layout ``decode_tokens`` consumes, so a
    prefill is one full-sequence forward; it does not compose with
    ``remat``."""
    if return_kv and remat:
        raise ValueError("return_kv does not compose with remat")
    attn = attention_fn or partial(default_attention, causal=True)
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, device=tokens.device)
    cos, sin = rope_frequencies(cfg, positions)
    h = params["embed"][tokens.long()]

    kv_out = []

    def layer_fn(h, layer):
        h, kv = layer_apply(h, layer, cfg, cos, sin, attention_fn=attn, pre_block=pre_block,
                            post_block=post_block)
        if return_kv:
            kv_out.append(kv)
        return h

    for layer in params["layers"]:
        h = checkpoint(layer_fn, h, layer, use_reentrant=False) if remat else layer_fn(h, layer)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = ((pre_block or _identity)(h) @ params["lm_head"]).float()
    if return_kv:
        return logits, (torch.stack([k for k, _ in kv_out]), torch.stack([v for _, v in kv_out]))
    return logits


# -- dense KV cache ---------------------------------------------------------
def init_kv_cache(
    cfg: TransformerConfig,
    batch: int,
    max_len: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> dict:
    """{"k","v"} zeros [L, B, max_len, Hkv, D] in ``cfg.dtype`` plus a
    "length" counter (``decode_step``'s lockstep position)."""
    shape = (cfg.n_layers, batch, max_len or cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": 0,
    }


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, K, H, D] rotated at per-(b, k) positions (cos/sin [B*K, half])."""
    b, kk, h, d = x.shape
    return apply_rope(x.reshape(b * kk, 1, h, d), cos, sin, per_batch=True).reshape(b, kk, h, d)


def _dense_attention(q, k_cache, v_cache, positions, n_rep: int):
    """q [B, K, H, D] against a dense cache [B, T, Hkv, D]: each query
    sees the cache up to and including its own position ([B, K]). Float32
    scores and softmax with the ``-1e30`` mask, as the reference."""
    keys = repeat_kv(k_cache, n_rep)
    vals = repeat_kv(v_cache, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) / math.sqrt(q.shape[-1])
    t = k_cache.shape[1]
    mask = torch.arange(t, device=q.device)[None, None, :] <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vals.float()).to(q.dtype)


def decode_tokens(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One decode iteration with PER-SEQUENCE positions -> (logits
    [B, vocab] f32, {"k","v"}: the cache's own tensors, written in place).

    ``cache["k"]``/``["v"]`` [L, B, T, Hkv, D]; ``tokens`` [B] last token
    per sequence, ``positions`` [B] its write position. RoPE, the K/V
    write and the causal mask all follow ``positions``; a position is
    written before anything attends to it, so stale entries past a
    sequence's position never matter. Kept as its own body next to
    :func:`decode_block`, as in the reference. ``tp``: this rank's
    shards and KV heads of a tensor-parallel model (module docstring)."""
    gcfg, (cfg, post, gather_logits) = cfg, tp_parts(cfg, tp)
    b = tokens.shape[0]
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    positions = positions.long()
    cos, sin = rope_frequencies(gcfg, positions)
    rows = torch.arange(b, device=tokens.device)
    h = params["embed"][tokens.long()][:, None, :]
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(b, 1, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(b, 1, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(b, 1, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin, per_batch=True)
        k = apply_rope(k, cos, sin, per_batch=True)
        cache["k"][li][rows, positions] = k[:, 0]
        cache["v"][li][rows, positions] = v[:, 0]
        ctx = _dense_attention(q, cache["k"][li], cache["v"][li], positions[:, None], n_rep)
        h = h + post(ctx.reshape(b, 1, -1) @ layer["wo"]).to(h.dtype)
        h = _ffn(h, layer, cfg, post=post)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = gather_logits((h[:, 0] @ params["lm_head"]).float())
    return logits, {"k": cache["k"], "v": cache["v"]}


def decode_block(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
) -> tuple[torch.Tensor, dict]:
    """K-token generalization of ``decode_tokens`` -> (logits
    [B, K, vocab] f32, {"k","v"} written in place). ``tokens`` and
    ``positions`` are [B, K] (consecutive positions per sequence); every
    token attends the cache up to and including its own position. The
    verification forward of speculative decoding: one call scores all K
    drafted tokens."""
    b, kk = tokens.shape
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    positions = positions.long()
    pos_flat = positions.reshape(-1)
    cos, sin = rope_frequencies(cfg, pos_flat)
    rows = torch.arange(b, device=tokens.device).repeat_interleave(kk)
    h = params["embed"][tokens.long()]
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(b, kk, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(b, kk, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(b, kk, cfg.n_kv_heads, hd)
        q = _rope_rows(q, cos, sin)
        k = _rope_rows(k, cos, sin)
        cache["k"][li][rows, pos_flat] = k.reshape(b * kk, cfg.n_kv_heads, hd)
        cache["v"][li][rows, pos_flat] = v.reshape(b * kk, cfg.n_kv_heads, hd)
        ctx = _dense_attention(q, cache["k"][li], cache["v"][li], positions, n_rep)
        h = h + (ctx.reshape(b, kk, -1) @ layer["wo"]).to(h.dtype)
        h = _ffn(h, layer, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    # flattened projection [B*K, D] @ [D, V]: for K = 1 the very product
    # decode_tokens computes, so the two agree bit for bit
    logits = (h.reshape(b * kk, -1) @ params["lm_head"]).view(b, kk, -1).float()
    return logits, {"k": cache["k"], "v": cache["v"]}


def decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, cfg: TransformerConfig
) -> tuple[torch.Tensor, dict]:
    """One incremental decode step, every sequence at ``cache["length"]``
    -> (logits [B, vocab], cache with length + 1). ``tokens`` [B, 1]."""
    pos = cache["length"]
    positions = torch.full((tokens.shape[0],), pos, dtype=torch.int64, device=tokens.device)
    logits, kv = decode_tokens(params, cache, tokens[:, 0], positions, cfg)
    return logits, {"k": kv["k"], "v": kv["v"], "length": pos + 1}


def generate(
    params: dict,
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Greedy or temperature sampling: the prompt [B, T] is fed one token
    at a time, then ``max_new_tokens`` decode steps -> [B, max_new_tokens].
    Sampled draws are keyed by (seed, position) (``inference/sampling``);
    they cannot reproduce the reference's ``jax.random`` bits."""
    # the sampler lives with the engine, which imports this module
    from ..inference.sampling import sample_tokens

    b, t = prompt.shape
    dev = prompt.device
    cache = init_kv_cache(cfg, b, t + max_new_tokens, device=dev)
    for j in range(t):
        logits, cache = decode_step(params, cache, prompt[:, j:j + 1], cfg)
    temps = torch.full((b,), float(temperature), device=dev)
    zeros = torch.zeros((b,), dtype=torch.int64, device=dev)
    seeds = int(seed) + torch.arange(b, device=dev)  # one stream per sequence
    out = []
    for _ in range(max_new_tokens):
        pos = torch.full((b,), cache["length"] - 1, dtype=torch.int64, device=dev)
        tok = sample_tokens(logits, temps, zeros, temps.new_ones(b), seeds, pos,
                            sampling=temperature > 0, filters=False)
        out.append(tok)
        logits, cache = decode_step(params, cache, tok[:, None], cfg)
    return torch.stack(out, dim=1)


# -- paged KV cache ---------------------------------------------------------
def init_paged_pool(
    cfg: TransformerConfig,
    n_blocks: int,
    block_size: int,
    kv_dtype: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> dict:
    """Block pool: {"k","v"} of [L, n_blocks, Hkv, block_size, D] —
    head-major, each (block, head) a contiguous [bs, D] tile, the layout
    the paged-decode kernel reads. Block 0 is reserved as scratch by the
    engine (parked writes land there; unallocated table entries point at
    it). ``kv_dtype="int8"`` stores K/V quantized with per-token per-head
    amax/127 scales in "k_scale"/"v_scale" [L, n_blocks, Hkv, bs] f32."""
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    if kv_dtype in ("int8", torch.int8):
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    if kv_dtype is not None and kv_dtype != cfg.dtype:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (use 'int8', None, or the model dtype)")
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _quantize_kv_values(k: torch.Tensor, v: torch.Tensor) -> dict:
    """Quantize a K/V pair for an int8 pool — the one place the scale
    convention lives; every pool write scatters exactly these values."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _paged_pool_write(pool: dict, li: int, blk, off, k, v) -> None:
    """Scatter per-token K/V ([M, Hkv, D] each, at (blk[m], :, off[m]))
    into layer ``li`` of the pool IN PLACE, quantizing when it is int8."""
    vals = _quantize_kv_values(k, v) if "k_scale" in pool else {"k": k, "v": v}
    for key, val in vals.items():
        pool[key][li][blk, :, off] = val


def _gather_pages(pool_layer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[n_blocks, H, bs, D] gathered by table [B, max_blocks] ->
    [B, max_blocks*bs, H, D] (a slot's logical cache view)."""
    b, mb = table.shape
    _, h, bs, d = pool_layer.shape
    return pool_layer[table].transpose(2, 3).reshape(b, mb * bs, h, d)


def _gather_scales(scale_layer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[n_blocks, H, bs] scales gathered by table [B, max_blocks] ->
    [B, max_blocks*bs, H] (aligned with _gather_pages)."""
    b, mb = table.shape
    _, h, bs = scale_layer.shape
    return scale_layer[table].transpose(2, 3).reshape(b, mb * bs, h)


def decode_tokens_paged(
    params: dict,
    pool: dict,
    tables: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One decode step for every sequence -> (logits [B, vocab] f32, pool).

    ``tables`` [B, max_blocks] block ids, ``tokens`` [B] last token per
    sequence, ``positions`` [B] its logical write position. The new
    token's K/V is written in place at (table[pos // bs], pos % bs), then
    attention reads each slot's blocks through ``paged_decode_attention``
    (the CUDA kernel on the card, the gather version on the CPU). ``tp``:
    this rank's shards, and the pool its KV heads (module docstring)."""
    gcfg, (cfg, post, gather_logits) = cfg, tp_parts(cfg, tp)
    b = tokens.shape[0]
    hd = cfg.head_dim
    bs = pool["k"].shape[3]
    positions = positions.long()
    cos, sin = rope_frequencies(gcfg, positions)
    rows = torch.arange(b, device=tokens.device)
    blk = tables.long()[rows, positions // bs]
    off = positions % bs
    tables32 = tables.to(torch.int32).contiguous()
    lengths = (positions + 1).to(torch.int32)  # valid entries incl. the new token
    h = params["embed"][tokens.long()][:, None, :]
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(b, 1, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(b, 1, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(b, 1, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin, per_batch=True)
        k = apply_rope(k, cos, sin, per_batch=True)
        _paged_pool_write(pool, li, blk, off, k[:, 0], v[:, 0])
        ctx = paged_decode_attention(
            q[:, 0].contiguous(), pool["k"][li], pool["v"][li], tables32, lengths,
            pool["k_scale"][li] if "k_scale" in pool else None,
            pool["v_scale"][li] if "v_scale" in pool else None, tp=tp,
        )  # [B, H, D]
        h = h + post(ctx.reshape(b, 1, -1) @ layer["wo"]).to(h.dtype)
        h = _ffn(h, layer, cfg, post=post)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = gather_logits((h[:, 0] @ params["lm_head"]).float())
    return logits, pool


def decode_block_paged(
    params: dict,
    pool: dict,
    tables: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """K-token generalization of ``decode_tokens_paged`` -> (logits
    [B, K, vocab] f32, pool): the verification forward of the engine's
    speculative decoding.

    Each token (b, j) writes its K/V at ``(tables[b, p // bs], p % bs)``
    and attends its slot's pooled cache up to and including its own
    position: the flat (b, j) rows go to ``paged_decode_attention`` as
    B*K independent queries that share their slot's table, with per-row
    ``lengths = position + 1``, so one kernel serves one-token decode and
    K-token verification. All K writes of a layer land before that layer
    attends, so a previous round's rejected K/V at positions >= the
    block's start is rewritten before anything reads it. Parked slots
    arrive with a zeroed table row and positions from 0: their writes
    land in scratch block 0. ``tp`` as in ``decode_tokens_paged``."""
    gcfg, (cfg, post, gather_logits) = cfg, tp_parts(cfg, tp)
    b, kk = tokens.shape
    hd = cfg.head_dim
    bs = pool["k"].shape[3]
    pos_flat = positions.long().reshape(-1)
    cos, sin = rope_frequencies(gcfg, pos_flat)
    rows = torch.arange(b, device=tokens.device).repeat_interleave(kk)
    blk = tables.long()[rows, pos_flat // bs]
    off = pos_flat % bs
    tables_flat = tables.to(torch.int32).repeat_interleave(kk, dim=0).contiguous()
    lengths = (pos_flat + 1).to(torch.int32)
    h = params["embed"][tokens.long()]
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(b, kk, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(b, kk, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(b, kk, cfg.n_kv_heads, hd)
        q = _rope_rows(q, cos, sin)
        k = _rope_rows(k, cos, sin)
        _paged_pool_write(pool, li, blk, off, k.reshape(b * kk, cfg.n_kv_heads, hd),
                          v.reshape(b * kk, cfg.n_kv_heads, hd))
        ctx = paged_decode_attention(
            q.reshape(b * kk, cfg.n_heads, hd).contiguous(), pool["k"][li], pool["v"][li],
            tables_flat, lengths,
            pool["k_scale"][li] if "k_scale" in pool else None,
            pool["v_scale"][li] if "v_scale" in pool else None, tp=tp,
        )  # [B*K, H, D]
        h = h + post(ctx.reshape(b, kk, -1) @ layer["wo"]).to(h.dtype)
        h = _ffn(h, layer, cfg, post=post)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    # flattened projection, for bit-parity with decode_tokens_paged at K = 1
    logits = gather_logits((h.reshape(b * kk, -1) @ params["lm_head"]).float())
    return logits.view(b, kk, -1), pool


def prefill_chunk_paged(
    params: dict,
    pool: dict,
    table: torch.Tensor,
    tokens: torch.Tensor,
    offset: int,
    cfg: TransformerConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One prompt chunk of chunked prefill -> (logits [C, vocab] f32, pool).

    ``table`` [max_blocks] is ONE slot's block table, ``tokens`` [C] the
    chunk (may be padded), ``offset`` the logical position of tokens[0].
    The chunk's K/V is written in place at positions offset..offset+C-1,
    then it attends with the block-causal mask (every chunk token sees
    all cache positions <= its own); chained over chunks this equals the
    full-sequence forward. Pad-tail writes land at positions >= the true
    prompt length; decode overwrites each position in the same step that
    first attends to it, so they are never read. Attention here is a
    gather plus float32 einsums, as in the reference (no kernel), on the
    rank's local heads under ``tp`` (as in ``decode_tokens_paged``)."""
    gcfg, (cfg, post, gather_logits) = cfg, tp_parts(cfg, tp)
    c = tokens.shape[0]
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    bs = pool["k"].shape[3]
    table = table.long()
    t_alloc = table.shape[0] * bs
    positions = offset + torch.arange(c, device=tokens.device)
    cos, sin = rope_frequencies(gcfg, positions)
    blk = table[positions // bs]
    off = positions % bs
    mask = torch.arange(t_alloc, device=tokens.device)[None, :] <= positions[:, None]
    quantized = "k_scale" in pool
    h = params["embed"][tokens.long()][None]  # [1, C, D]
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = (x @ layer["wq"]).view(1, c, cfg.n_heads, hd)
        k = (x @ layer["wk"]).view(1, c, cfg.n_kv_heads, hd)
        v = (x @ layer["wv"]).view(1, c, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        _paged_pool_write(pool, li, blk, off, k[0], v[0])
        keys = _gather_pages(pool["k"][li], table[None])
        vals = _gather_pages(pool["v"][li], table[None])
        if quantized:
            keys = dequantize_kv(keys, _gather_scales(pool["k_scale"][li], table[None]), h.dtype)
            vals = dequantize_kv(vals, _gather_scales(pool["v_scale"][li], table[None]), h.dtype)
        keys = repeat_kv(keys, n_rep)
        vals = repeat_kv(vals, n_rep)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) / math.sqrt(hd)
        scores = scores.masked_fill(~mask[None, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vals.float()).to(h.dtype)
        h = h + post(ctx.reshape(1, c, -1) @ layer["wo"]).to(h.dtype)
        h = _ffn(h, layer, cfg, post=post)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = gather_logits((h[0] @ params["lm_head"]).float())  # [C, vocab]
    return logits, pool
