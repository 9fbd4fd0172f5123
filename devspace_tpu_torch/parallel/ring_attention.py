"""Ring attention: sequence parallelism for long context.

Counterpart of ``devspace_tpu/parallel/ring_attention.py``. The query
sequence stays sharded over the ``seq`` mesh axis; key/value blocks
rotate around the ring (``batch_isend_irecv`` to the next rank) while
each rank accumulates its queries' attention with an online softmax
(running max, sum and weighted values). After ``ring`` hops every query
block has attended to the whole sequence, with O(seq/ring) memory per
rank. Causal masking uses global offsets, so the result is full causal
attention's.

Flash-within-ring: each hop's K/V is consumed in sub-blocks of
``block_size`` keys with the same accumulators, so a score tile is
``[B, H, t_local, block_size]``. A sub-block a causal query row cannot
see is skipped (rows before it, or the whole sub-block), which leaves
the accumulators as the reference's masked update does.

The backward (``torch.autograd.Function``) recomputes each hop's scores
from the saved row statistics (log-sum-exp) instead of keeping them: it
saves q, k, v, the output and one float32 per row. K/V travel the ring
once more with their gradient accumulators beside them; after the last
hop every block and its dK/dV are back home.

Plain torch (the reference computes it in ``jnp`` outside any Pallas
kernel). Scores are float32; with 16-bit inputs the probability and
gradient products take the inputs' type with a float32 result, as the
flash kernels do (``torch.bmm(out_dtype=float32)`` on the card).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from .collectives import axis_size, ring_shift
from .mesh import Mesh

NEG_INF = -1e30


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result; ``b`` is cast to ``a``'s type."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def sub_block_size(t_local: int, block_size: Optional[int]) -> Optional[int]:
    """The reference's sub-block choice: ``block_size`` when it is below
    ``t_local`` and divides it, else the largest divisor below it if that
    is at least ``max(16, block_size // 4)``, else none (whole-block
    hops, with a warning)."""
    blk = block_size if block_size and block_size < t_local else None
    if blk is not None and t_local % blk:
        d = blk
        while t_local % d:
            d -= 1
        if d >= max(16, blk // 4):
            blk = d
        else:
            warnings.warn(
                f"ring_attention: t_local={t_local} has no usable "
                f"divisor near block_size={blk}; falling back to a "
                f"whole-block [{t_local},{t_local}] score tile",
                stacklevel=3,
            )
            blk = None
    return blk


def _pieces(t: int, blk: int, q_offset: int, kv_offset: int, causal: bool):
    """(key start within the block, first query row, needs a mask) for
    each ``blk``-key sub-block a query row of this rank can see."""
    for start in range(0, t, blk):
        k0 = kv_offset + start
        r0 = max(0, k0 - q_offset) if causal else 0
        if r0 >= t:
            continue
        yield start, r0, causal and k0 + blk - 1 > q_offset + r0


def _scores(q, k, r0, q_offset, k0, scale, masked):
    """q ``[N, t, D]`` rows ``r0:`` against k ``[N, blk, D]`` -> float32
    scores with the causal mask at global offsets."""
    s = _mm(q[:, r0:], k.transpose(1, 2)) * scale
    if masked:
        q_pos = q_offset + r0 + torch.arange(s.shape[1], device=s.device)
        k_pos = k0 + torch.arange(s.shape[2], device=s.device)
        s.masked_fill_(q_pos[:, None] < k_pos[None, :], NEG_INF)
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, ring, idx, causal, blk):
        # [B, t, H, D] -> [B*H, t, D]
        b, t, h, d = q.shape
        qh, kh, vh = (x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous() for x in (q, k, v))
        scale = 1.0 / math.sqrt(d)
        blk = blk or t
        q_offset = idx * t
        acc = torch.zeros((b * h, t, d), dtype=torch.float32, device=q.device)
        row_max = torch.full((b * h, t), NEG_INF, dtype=torch.float32, device=q.device)
        row_sum = torch.zeros((b * h, t), dtype=torch.float32, device=q.device)
        k_blk, v_blk = kh, vh
        for step in range(ring):
            pending = ring_shift([k_blk, v_blk], group) if step < ring - 1 else None
            kv_offset = ((idx - step) % ring) * t
            for start, r0, masked in _pieces(t, blk, q_offset, kv_offset, causal):
                ks, vs = k_blk[:, start:start + blk], v_blk[:, start:start + blk]
                s = _scores(qh, ks, r0, q_offset, kv_offset + start, scale, masked)
                m = row_max[:, r0:]
                new_max = torch.maximum(m, s.amax(-1))
                safe = torch.where(new_max <= NEG_INF / 2, 0.0, new_max)
                corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - safe))
                p = torch.exp(s - safe[..., None])
                p = torch.where(s <= NEG_INF / 2, 0.0, p)
                acc[:, r0:] = acc[:, r0:] * corr[..., None] + _mm(p.to(vs.dtype), vs)
                row_sum[:, r0:] = row_sum[:, r0:] * corr + p.sum(-1)
                row_max[:, r0:] = new_max
            if pending is not None:
                (k_blk, v_blk), reqs = pending
                for r in reqs:
                    r.wait()
        denom = torch.where(row_sum == 0.0, 1.0, row_sum)
        out = (acc / denom[..., None]).to(q.dtype)
        # a row that saw no key keeps lse = -inf: its probabilities are 0
        lse = torch.where(row_sum == 0.0, NEG_INF, row_max + torch.log(denom))
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.meta = (group, ring, idx, causal, blk, (b, t, h, d))
        return out.view(b, h, t, d).permute(0, 2, 1, 3).contiguous()

    @staticmethod
    def backward(ctx, g_out):
        qh, kh, vh, out, lse = ctx.saved_tensors
        group, ring, idx, causal, blk, (b, t, h, d) = ctx.meta
        scale = 1.0 / math.sqrt(d)
        q_offset = idx * t
        do = g_out.permute(0, 2, 1, 3).reshape(b * h, t, d).to(qh.dtype)
        delta = (do.float() * out.float()).sum(-1)  # rowsum(dO * O)
        dq = torch.zeros((b * h, t, d), dtype=torch.float32, device=qh.device)
        k_blk, v_blk = kh, vh
        dk_blk = torch.zeros((b * h, t, d), dtype=torch.float32, device=qh.device)
        dv_blk = torch.zeros_like(dk_blk)
        for step in range(ring):
            kv_offset = ((idx - step) % ring) * t
            for start, r0, masked in _pieces(t, blk, q_offset, kv_offset, causal):
                ks, vs = k_blk[:, start:start + blk], v_blk[:, start:start + blk]
                s = _scores(qh, ks, r0, q_offset, kv_offset + start, scale, masked)
                p = torch.exp(s - lse[:, r0:, None])
                p = torch.where(s <= NEG_INF / 2, 0.0, p)
                dv_blk[:, start:start + blk] += _mm(p.transpose(1, 2).to(vs.dtype), do[:, r0:])
                dp = _mm(do[:, r0:], vs.transpose(1, 2))
                ds = (p * (dp - delta[:, r0:, None])).to(qh.dtype)
                dq[:, r0:] += _mm(ds, ks) * scale
                dk_blk[:, start:start + blk] += _mm(ds.transpose(1, 2), qh[:, r0:]) * scale
            if ring > 1:
                # the block and its gradients move on; after the last hop
                # they are home
                send = [dk_blk, dv_blk] if step == ring - 1 else [k_blk, v_blk, dk_blk, dv_blk]
                recv, reqs = ring_shift(send, group)
                for r in reqs:
                    r.wait()
                if step == ring - 1:
                    dk_blk, dv_blk = recv
                else:
                    k_blk, v_blk, dk_blk, dv_blk = recv

        def back(x):
            return x.view(b, h, t, d).permute(0, 2, 1, 3).to(qh.dtype)

        return back(dq), back(dk_blk), back(dv_blk), None, None, None, None, None


class RingAttention:
    """``f(q, k, v) -> out`` on this rank's sequence block ``[B, T/ring,
    H, D]`` (the output is the same block). ``seq_axis`` names the axis
    the sequence is sharded over: the train steps slice their tokens by
    it (``training/trainer.py``)."""

    def __init__(self, mesh: Mesh, axis: str, causal: bool, block_size: Optional[int]):
        self.mesh, self.seq_axis, self.causal, self.block_size = mesh, axis, causal, block_size

    def __call__(self, q, k, v):
        group = self.mesh.group(self.seq_axis)
        blk = sub_block_size(q.shape[1], self.block_size)
        return _Ring.apply(q, k, v, group, axis_size(group), self.mesh.index(self.seq_axis),
                           self.causal, blk)


def ring_attention(
    mesh: Mesh,
    axis: str = "seq",
    causal: bool = True,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
    block_size: Optional[int] = 512,
) -> RingAttention:
    """Build ``f(q, k, v) -> out`` with q/k/v ``[B, T, H, D]`` sharded on
    T over ``axis``: each rank passes its block and gets its block back.
    ``batch_axis``/``head_axis`` name the axes B and H are co-sharded
    over (data and tensor parallelism in one mesh); a rank's tensors
    already hold only its rows and heads, so they are checked against
    the mesh and change nothing else. ``block_size`` bounds the
    within-hop score tile (``None``: whole-block hops)."""
    for name in (axis, batch_axis, head_axis):
        if name is not None:
            mesh.size(name)  # raises for an axis the mesh lacks
    return RingAttention(mesh, axis, causal, block_size)


def full_attention(q, k, v, causal: bool = True):
    """Unsharded reference attention ``[B, T, H, D]`` (the tests hold
    ring and Ulysses against it): float32 scores, the causal mask at
    ``-1e30``, softmax, the output in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tkv = q.shape[1], k.shape[1]
        mask = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tkv, device=q.device)
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
