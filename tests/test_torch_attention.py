"""The port's short-sequence attention op (ops/attention.py: the autograd
Function around the kernel's wrapper) against the JAX package's
``attention_pallas`` with its Pallas kernel in interpret mode.

The same float32 unit normals from a numpy seed go through both; forward
and the grads of q, k and v agree to ``atol=rtol=2e-4``, the tolerance
tests/test_models_ops.py holds the Pallas kernel to. On CPU tensors the
wrapper computes the plain version and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import attention as jattn
from devspace_tpu_torch.ops import attention as tattn

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def inputs(seed, t, b=1, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [7, 64, 256, 512])
def test_forward_and_grads_match_jax(t, causal):
    q, k, v, g = inputs(t, t)
    before = tattn.LAUNCHES
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.short_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    assert tattn.LAUNCHES == before and tattn.LAST_DISPATCH["impl"] == "reference"

    ref, vjp = jax.vjp(lambda q, k, v: jattn.attention_pallas(q, k, v, causal=causal),
                       *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [100, 300, 640])
def test_fused_attention_route_matches_jax(t):
    """``fused_attention`` end to end at lengths on both sides of the
    route (300 and 640: 256 does not divide them, the plain version in
    both packages)."""
    q, k, v, _ = inputs(t + 1, t, b=2)
    got = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jattn.fused_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_function_saves_only_q_k_v():
    """The forward keeps q, k, v and no [B, H, T, T] tensor."""
    q, k, v, _ = [torch.from_numpy(x).requires_grad_() for x in inputs(3, 32)]
    out = tattn.short_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == q.shape for s in saved)


def test_bf16_grads_come_back_in_the_inputs_dtype():
    q, k, v, g = [torch.from_numpy(x).to(torch.bfloat16) for x in inputs(4, 48)]
    q, k, v = [x.requires_grad_() for x in (q, k, v)]
    out = tattn.short_attention(q, k, v)
    out.backward(g)
    assert out.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape for x in (q, k, v))
    ref = tattn.attention_reference(q.detach(), k.detach(), v.detach())
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)  # the same plain code on the CPU
