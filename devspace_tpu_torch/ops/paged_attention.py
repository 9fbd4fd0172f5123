"""Paged-attention decode: the Hopper kernel (``csrc/paged_decode.cu``) and
its plain PyTorch version.

Counterpart of ``devspace_tpu/ops/paged_attention.py``. The serving
engine keeps K/V in a block pool with per-slot block tables (vLLM
layout, head-major ``[N, Hkv, bs, D]``). The plain version materializes
each slot's logical cache view with ``pool[tables]`` — a gather of the
whole allocated cache every step, per layer. The kernel streams each
slot's blocks straight from the pool with an online softmax, so K/V are
read once and never copied; GQA query heads of one KV head share every
tile they read. Long rows are split over several blocks of the kernel
(flash-decoding): ``plan_splits`` picks the number of splits from shapes
alone, so a launch never reads ``lengths`` back to the host and can be
captured in a CUDA graph.

Dispatch follows the tensors (``ops/dispatch.py``): CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .dispatch import on_cuda

NEG_INF = -1e30

# int8 KV quantization: one scale per (token, head) vector, amax/127 —
# the reference's convention, so int8 payloads agree bit for bit.
KV_SCALE_EPS = 1e-8


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float -> (int8 [..., D], f32 scale [...]): symmetric
    per-vector quantization with amax/127 scales (round half to even)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=KV_SCALE_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_kv (up to rounding), rounded to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def paged_decode_reference(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-based plain version. q [B, H, D]; pool_k/v [N, Hkv, bs, D];
    tables [B, MB] int; lengths [B] int (valid cache entries per slot,
    INCLUDING the current token) -> ctx [B, H, D] (q's dtype).
    ``k_scale``/``v_scale`` [N, Hkv, bs] mark an int8 pool; K/V are
    dequantized to q's dtype before use, the rounding the kernel applies.
    A dead slot (length 0) softmaxes all-masked scores to a uniform
    average, as the JAX reference does; the kernel writes zeros there.
    Table entries are clamped to the pool, as JAX's gather and the kernel
    clamp them."""
    b, h, d = q.shape
    n, hkv, bs, _ = pool_k.shape
    mb = tables.shape[1]
    n_rep = h // hkv
    t_alloc = mb * bs
    idx = tables.long().clamp(0, n - 1)
    keys = pool_k[idx].transpose(2, 3).reshape(b, t_alloc, hkv, d)
    vals = pool_v[idx].transpose(2, 3).reshape(b, t_alloc, hkv, d)
    if k_scale is not None:
        ks = k_scale[idx].transpose(2, 3).reshape(b, t_alloc, hkv)
        vs = v_scale[idx].transpose(2, 3).reshape(b, t_alloc, hkv)
        keys = dequantize_kv(keys, ks, q.dtype)
        vals = dequantize_kv(vals, vs, q.dtype)
    if n_rep > 1:
        keys = keys.repeat_interleave(n_rep, dim=2)
        vals = vals.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), keys.float()) / math.sqrt(d)
    pos = torch.arange(t_alloc, device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", probs, vals.float()).to(q.dtype)


# The kernel's split plan. A block keeps a ring of `stages` K/V stages,
# 2 * bs * D * elem bytes each (+ 8 * bs bytes of int8 scales), in shared
# memory, and RING_BYTES is the ring a block aims for: 2 stages at bf16,
# D = 128, block 64; 3 at int8. It is also what an SM needs in flight:
# on an H100 one bf16 block an SM streams K/V fastest, an int8 one needs
# two (PERF.md). A row's cache is split only to give every SM those
# blocks (splitting costs the combine pass and a ring fill a split),
# each split covering at least MIN_SPLIT_TILES table columns.
RING_BYTES = 64 * 1024
MAX_STAGES = 4
SMEM_PER_BLOCK = 227 * 1024
MIN_SPLIT_TILES = 2


def stage_bytes(bs: int, d: int, elem: int, int8: bool) -> int:
    """Shared memory of one ring stage: a [bs, D] K and V tile pair, and
    their f32 scales for an int8 pool."""
    return 2 * bs * d * elem + (8 * bs if int8 else 0)


class SplitPlan(NamedTuple):
    n_split: int  # blocks sharing each (row, query-head chunk)
    stages: int  # depth of each block's tile ring


def plan_splits(b: int, hkv: int, mb: int, bs: int, d: int, elem: int, int8: bool,
                sms: int = 132) -> SplitPlan:
    """How the kernel cuts its work, from shapes alone (never from
    ``lengths``, which live on the card): the ring depth that fits the
    shared-memory budget, and the number of splits of each row's cache
    — 1 where the grid of rows × KV heads already gives every SM the
    blocks it needs in flight, else enough to."""
    stage = stage_bytes(bs, d, elem, int8)
    stages = max(1, min(MAX_STAGES, RING_BYTES // stage))
    if stages == 1 and 2 * stage <= SMEM_PER_BLOCK:
        stages = 2
    per_sm = -(-RING_BYTES // (stages * stage))  # blocks an SM needs in flight
    n_split = sms * per_sm // max(1, b * hkv)  # b * hkv blocks a split, more for wide GQA
    return SplitPlan(max(1, min(n_split, mb // MIN_SPLIT_TILES)), stages)


def split_range(s: int, n_blk: int, n_split: int) -> tuple[int, int]:
    """Table columns [j0, j1) of a row's ``n_blk`` live blocks that split
    ``s`` walks: near-equal runs in order, the kernel's own cut."""
    return s * n_blk // n_split, (s + 1) * n_blk // n_split


def scratch_floats(plan: SplitPlan, b: int, h: int, d: int) -> int:
    """f32 scratch the split kernel writes its partials to: acc [S, B, H,
    D], then (m, l) [S, B, H, 2]; none for one split."""
    return plan.n_split * b * h * (d + 2) if plan.n_split > 1 else 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Last dispatch decision and the number of kernel launches: a run reads
# them to show which path it took (a silent fallback to the plain
# version on the card is exactly what they guard against). LAUNCHES
# counts launches of the CUDA kernel and nothing else.
LAST_DISPATCH = {"impl": None, "tp": False}
LAUNCHES = 0

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        fn = _build.library("paged_decode").paged_decode
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int
        ] * 9 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode kernel: {msg}")


def _launch_kernel(q, pool_k, pool_v, tables, lengths, k_scale, v_scale):
    """Validate what the kernel takes, plan the splits, allocate the
    output and the partials' scratch, launch on the current stream;
    raises on anything the kernel does not take and on a refused launch.
    Counts one launch for each call that launched the kernel (and, for
    more than one split, its combine pass): an empty batch or pool
    launches nothing."""
    global LAUNCHES
    _check(q.dim() == 3, f"q must be [B, H, D], got {tuple(q.shape)}")
    _check(q.dtype in (torch.float32, torch.bfloat16), f"q dtype {q.dtype}")
    b, h, d = q.shape
    _check(pool_k.dim() == 4, f"pool must be [N, Hkv, bs, D], got {tuple(pool_k.shape)}")
    n, hkv, bs, pd = pool_k.shape
    _check(pool_v.shape == pool_k.shape, "pool_k and pool_v shapes differ")
    _check(pool_v.dtype == pool_k.dtype, "pool_k and pool_v dtypes differ")
    _check(pd == d, f"pool head_dim {pd} != q head_dim {d}")
    _check(h % hkv == 0, f"{h} query heads not a multiple of {hkv} KV heads")
    int8 = pool_k.dtype == torch.int8
    if int8:
        _check(k_scale is not None, "an int8 pool needs k_scale/v_scale")
        for sc in (k_scale, v_scale):
            _check(sc.dtype == torch.float32, f"scale dtype {sc.dtype}")
            _check(tuple(sc.shape) == (n, hkv, bs), f"scale shape {tuple(sc.shape)}")
            _check(sc.is_contiguous(), "scales must be contiguous")
            _check(sc.data_ptr() % 16 == 0, "scales must be 16-byte aligned")
        # each tile's scales are one 16-byte-multiple bulk copy
        _check(bs % 4 == 0, f"an int8 pool needs a block size divisible by 4, got {bs}")
    else:
        _check(k_scale is None, "scales given for a non-int8 pool")
        _check(pool_k.dtype == q.dtype, f"pool dtype {pool_k.dtype} != q dtype {q.dtype}")
    _check(tables.dtype == torch.int32 and lengths.dtype == torch.int32,
           "tables and lengths must be int32")
    _check(tables.dim() == 2 and tables.shape[0] == b, f"tables shape {tuple(tables.shape)}")
    _check(tuple(lengths.shape) == (b,), f"lengths shape {tuple(lengths.shape)}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("tables", tables), ("lengths", lengths)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    # 16-byte tile loads: every [bs, D] tile starts on a 16-byte boundary
    _check((d * pool_k.element_size()) % 16 == 0, f"head_dim {d} rows are not 16-byte multiples")
    _check(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned")
    elem = pool_k.element_size()
    _check(d // (16 // elem) <= 64, f"head_dim {d} wider than 64 16-byte vectors")
    _check(stage_bytes(bs, d, elem, int8) <= SMEM_PER_BLOCK,
           f"a [{bs}, {d}] K/V tile pair does not fit in shared memory")
    out = torch.empty_like(q)
    if b == 0 or n == 0:
        return out
    mb = tables.shape[1]
    plan = plan_splits(b, hkv, mb, bs, d, elem, int8, _sm_count(q.device.index))
    scratch = None
    if plan.n_split > 1:
        scratch = torch.empty(scratch_floats(plan, b, h, d), dtype=torch.float32, device=q.device)
    err = _kernel()(
        int(q.dtype == torch.bfloat16),
        int(int8),
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, hkv, d, bs, mb, n, plan.n_split, plan.stages,
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_DISPATCH["impl"] = "cuda"
    return out


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """One decode step of paged attention: q [B, H, D] against each slot's
    pooled cache -> ctx [B, H, D]. The CUDA kernel for CUDA tensors (no
    gather materialization), the plain version for CPU tensors.
    ``k_scale``/``v_scale`` [N, Hkv, bs] mark an int8 pool (quantize_kv).
    On the card, tables and lengths must be int32.

    ``tp=(mesh, axis)``: the call is one rank's part of a tensor-parallel
    model, and ``q``, the pools and the scales hold this rank's heads
    (``Hkv / tp`` KV heads and their query heads): attention is
    head-parallel, so the kernel runs on them with no collective, where
    the reference pins the same partitioning with a ``shard_map``.
    ``LAST_DISPATCH["tp"]`` records it."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    LAST_DISPATCH["tp"] = tp is not None
    tensors = [q, pool_k, pool_v, tables, lengths]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if not on_cuda(*tensors):
        LAST_DISPATCH["impl"] = "reference"
        return paged_decode_reference(q, pool_k, pool_v, tables, lengths, k_scale, v_scale)
    return _launch_kernel(q, pool_k, pool_v, tables, lengths, k_scale, v_scale)
