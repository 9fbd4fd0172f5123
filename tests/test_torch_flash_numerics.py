"""The rounding of the Hopper attention kernels (``csrc/attention_fwd.cuh``,
``csrc/attention.cu``, ``csrc/flash_backward.cu``), emulated in plain
torch, against the JAX package's ``attention_reference`` and ``jax.vjp``
of it, at the training paths' lengths.

The card holds each kernel to its plain version with a per-head relative
error of 1e-2 (``chip_smoke.BF16_HEAD_REL``: the largest error in a
(batch, head) over that head's largest reference value). That bound must
also cover what the kernels round on purpose, at the T the main path
runs, where an f32 sum over many bf16 products could drift. So these
tests replay the kernels' arithmetic tile by tile, in their own
accumulation order, from bf16-valued inputs (unit normals from a numpy
seed):

- the flash forward: k-tiles of 128 keys (64 at D = 128) in order; at
  each, the running max m of S·scale·log2 e over the tiles seen so far,
  p = 2^(S·scale·log2 e − m) in f32 rounded to bf16 for P·V, l summing
  the unrounded p, O and l rescaled by 2^(m_old − m); then O/l rounded to
  bf16 and lse = m·ln 2 + log l in f32; δ = rowsum(dO∘O) in f32, as the
  autograd Function takes it;
- the backward: P = 2^(S·scale·log2 e − lse·log2 e) in f32 from S = QKᵀ
  (bf16 products, f32 sums), masked to 0 above the diagonal;
- dq: dS = P∘(dP − δ)·scale rounded to bf16, dQ += dS·K over the dq
  kernel's k-tiles in order (128 keys; 64 at D = 128), in f32;
- dk/dv: P and dS as bf16 hi + lo terms (hi = bf16(x), lo = bf16(x −
  hi)), dV += hiᵀdO + loᵀdO and dK += hiᵀQ + loᵀQ over q-tiles in order
  (64 rows; 32 at D = 128), in f32;
- short attention at T = 128 (one pass): P = 2^(S·scale·log2 e − m)/l in
  f32 over the whole row, rounded to bf16 for P·V;
- every output rounded to bf16;

and holds O, dq, dk and dv to the reference's f32 values for the same
bf16-valued inputs with the card's per-head bound, 1e-2: one bf16 ulp of
an output near its head's largest value is 2^-7 of it, and the rounding
of P, O and dS adds less than that.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops.attention import attention_reference

HEAD_REL = 1e-2  # chip_smoke.BF16_HEAD_REL
LOG2E = 1.4426950408889634


def bf16(x):
    return x.to(torch.bfloat16).float()


def probs(q, k, lse, causal, rows, cols):
    """P[rows, cols] in f32 as the kernels form it: [BH, len(rows), len(cols)]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q[:, rows], k[:, cols].transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse[:, rows, None] * LOG2E)
    if causal:
        keep = torch.arange(rows.start, rows.stop)[:, None] >= torch.arange(cols.start, cols.stop)
        p = p * keep
    return p


def dscores(q, k, v, do, lse, delta, causal, rows, cols):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = probs(q, k, lse, causal, rows, cols)
    dp = torch.matmul(do[:, rows], v[:, cols].transpose(-1, -2))
    return p, p * (dp - delta[:, rows, None]) * scale


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def emulated_fwd(q, k, v, causal):
    """(o, lse) [BH, T, D], [BH, T] as the forward kernel rounds them; q, k,
    v are bf16-valued f32."""
    bh, t, d = q.shape
    bk = 64 if d > 64 else 128
    scale_log2 = LOG2E / math.sqrt(d)
    m = torch.full((bh, t, 1), -math.inf)
    l = torch.zeros((bh, t, 1))
    acc = torch.zeros_like(q)
    for k0 in range(0, t, bk):  # k-tiles in order
        keys = slice(k0, min(k0 + bk, t))
        s = torch.matmul(q, k[:, keys].transpose(-1, -2))
        if causal:
            s = s.masked_fill(torch.arange(t)[:, None] < torch.arange(keys.start, keys.stop),
                              -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.matmul(bf16(p), v[:, keys])
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return bf16(acc / l), (m / LOG2E + torch.log(l))[..., 0]


def emulated_short_attention(q, k, v, causal):
    """o [BH, T, D] as the one-pass short-attention kernel rounds it."""
    t, d = q.shape[1], q.shape[2]
    scale_log2 = LOG2E / math.sqrt(d)
    s = torch.matmul(q, k.transpose(-1, -2))
    if causal:
        s = s.masked_fill(torch.arange(t)[:, None] < torch.arange(t), -math.inf)
    p = torch.exp2(s * scale_log2 - s.amax(-1, keepdim=True) * scale_log2)
    return bf16(torch.matmul(bf16(p / p.sum(-1, keepdim=True)), v))


def emulated_grads(q, k, v, do, causal):
    """(dq, dk, dv) [BH, T, D] as the kernels round them; q, k, v, do are
    bf16-valued f32."""
    bh, t, d = q.shape
    o, lse = emulated_fwd(q, k, v, causal)
    delta = (do * o).sum(-1)
    everything = slice(0, t)
    dq = torch.zeros_like(q)
    bk = 64 if d > 64 else 128
    for k0 in range(0, t, bk):  # dq: k-tiles in order
        keys = slice(k0, min(k0 + bk, t))
        _, ds = dscores(q, k, v, do, lse, delta, causal, everything, keys)
        dq += torch.matmul(bf16(ds), k[:, keys])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    bq = 32 if d > 64 else 64
    for q0 in range(0, t, bq):  # dk/dv: q-tiles in order
        rows = slice(q0, min(q0 + bq, t))
        p, ds = dscores(q, k, v, do, lse, delta, causal, rows, everything)
        for hi_lo in split(p):
            dv += torch.matmul(hi_lo.transpose(-1, -2), do[:, rows])
        for hi_lo in split(ds):
            dk += torch.matmul(hi_lo.transpose(-1, -2), q[:, rows])
    return bf16(dq), bf16(dk), bf16(dv)


def head_rel(got, want):
    """Per (batch·head): the largest error over the head's largest value."""
    return (got - want).abs().flatten(1).amax(-1) / want.abs().flatten(1).amax(-1)


def inputs(shape, n, seed=7):
    rng = np.random.default_rng(seed)
    return [bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32))) for _ in range(n)]


def reference_grads(q, k, v, do, causal):
    """jax.vjp of attention_reference: [B, H, T, D] f32."""
    _, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


CAUSAL = pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
TRAIN_SHAPES = pytest.mark.parametrize("shape", [(1, 2, 2048, 64), (1, 1, 2048, 128)],
                                       ids=["D64", "D128"])


@CAUSAL
@TRAIN_SHAPES
def test_kernel_rounding_stays_within_card_bound(shape, causal):
    q, k, v, do = inputs(shape, 4)
    b, h, t, d = shape
    got = emulated_grads(*(x.reshape(b * h, t, d) for x in (q, k, v, do)), causal)
    want = reference_grads(*(x.numpy() for x in (q, k, v, do)), causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        err = head_rel(g, torch.from_numpy(np.array(r)).reshape(b * h, t, d))
        assert err.max().item() <= HEAD_REL, (name, err.tolist())


@CAUSAL
@TRAIN_SHAPES
def test_forward_rounding_stays_within_card_bound(shape, causal):
    """The flash forward's O, rounded tile by tile at the kernel's k-tile,
    against the JAX package's attention_reference at T = 2048."""
    q, k, v = inputs(shape, 3, seed=8)
    b, h, t, d = shape
    o, lse = emulated_fwd(*(x.reshape(b * h, t, d) for x in (q, k, v)), causal)
    want = np.array(attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal))
    err = head_rel(o, torch.from_numpy(want).reshape(b * h, t, d))
    assert err.max().item() <= HEAD_REL, err.tolist()
    assert torch.isfinite(lse).all()


@CAUSAL
@pytest.mark.parametrize("shape", [(2, 4, 128, 128), (2, 4, 128, 64)], ids=["target", "draft"])
def test_short_attention_rounding_stays_within_card_bound(shape, causal):
    """The one-pass short-attention kernel's rounding at the pair's
    training length (T = 128, the target's and the draft's head dims)
    against the JAX package's attention_reference."""
    q, k, v = inputs(shape, 3, seed=9)
    b, h, t, d = shape
    o = emulated_short_attention(*(x.reshape(b * h, t, d) for x in (q, k, v)), causal)
    want = np.array(attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal))
    err = head_rel(o, torch.from_numpy(want).reshape(b * h, t, d))
    assert err.max().item() <= HEAD_REL, err.tolist()
