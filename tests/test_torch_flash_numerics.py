"""The rounding of the Hopper flash backward kernels (``csrc/flash_backward.cu``),
emulated in plain torch, against ``jax.vjp`` of the JAX package's
``attention_reference`` at the training path's full length.

The card holds each kernel to its plain version with a per-head relative
error of 1e-2 (``chip_smoke.BF16_HEAD_REL``: the largest error in a
(batch, head) over that head's largest reference value). That bound must
also cover what the kernels round on purpose, at the T the main path
runs (2048), where an f32 sum over many bf16 products could drift. So
this test replays the kernels' arithmetic tile by tile, in their own
accumulation order, from bf16-valued inputs (unit normals from a numpy
seed):

- the forward's O rounded to bf16 and its f32 lse (the plain forward);
  δ = rowsum(dO∘O) in f32, as the autograd Function takes it;
- P = 2^(S·scale·log2 e − lse·log2 e) in f32 from S = QKᵀ (bf16 products,
  f32 sums), masked to 0 above the diagonal;
- dq: dS = P∘(dP − δ)·scale rounded to bf16, dQ += dS·K over 64-key
  tiles in order, in f32;
- dk/dv: P and dS as bf16 hi + lo terms (hi = bf16(x), lo = bf16(x −
  hi)), dV += hiᵀdO + loᵀdO and dK += hiᵀQ + loᵀQ over q-tiles in order
  (64 rows; 32 at D = 128), in f32;
- every output rounded to bf16;

and holds dq, dk and dv to the reference's f32 gradients of the same
bf16-valued inputs with the card's per-head bound, 1e-2: one bf16 ulp of
an output near its head's largest value is 2^-7 of it, and the rounding
of O and dS adds less than that.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops.attention import attention_reference
from devspace_tpu_torch.ops import flash_attention as tfa

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


def emulated_grads(q, k, v, do, causal):
    """(dq, dk, dv) [BH, T, D] as the kernels round them; q, k, v, do are
    bf16-valued f32."""
    bh, t, d = q.shape
    o, lse = tfa.flash_fwd_reference(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                     v.to(torch.bfloat16), causal)
    delta = (do * o.float()).sum(-1)
    everything = slice(0, t)
    dq = torch.zeros_like(q)
    for k0 in range(0, t, 64):  # dq: k-tiles in order
        keys = slice(k0, min(k0 + 64, t))
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


def reference_grads(q, k, v, do, causal):
    """jax.vjp of attention_reference: [B, H, T, D] f32."""
    _, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(1, 2, 2048, 64), (1, 1, 2048, 128)], ids=["D64", "D128"])
def test_kernel_rounding_stays_within_card_bound(shape, causal):
    rng = np.random.default_rng(7)
    q, k, v, do = [bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
                   for _ in range(4)]
    b, h, t, d = shape
    got = emulated_grads(*(x.reshape(b * h, t, d) for x in (q, k, v, do)), causal)
    want = reference_grads(*(x.numpy() for x in (q, k, v, do)), causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        r = torch.from_numpy(np.array(r)).reshape(b * h, t, d)
        err = (g - r).abs().flatten(1).amax(-1) / r.abs().flatten(1).amax(-1)
        assert err.max().item() <= HEAD_REL, (name, err.tolist())
