"""The route of the port's ``fused_attention`` (ops/attention.py) against
the JAX package's: flash for long sequences, the plain version where the
query block does not divide T, the short-sequence kernel's wrapper
everywhere else.

Numerics are held to the JAX package's own dispatch at the same inputs
(unit normals from a numpy seed, float32): ``atol=2e-4, rtol=2e-4``, the
tolerance tests/test_models_ops.py holds its attention kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import attention as jattn
from devspace_tpu_torch.ops import attention as tattn
from devspace_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)


def inputs(seed, t, h=1, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, h, t, d)).astype(np.float32) for _ in range(3)]


def test_attention_reference_matches_jax():
    for causal in (True, False):
        q, k, v = inputs(0, 48, h=2)
        got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)
        ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_long_sequence_goes_to_flash(monkeypatch):
    """T = 1280 > FLASH_THRESHOLD with T % 256 == 0: the flash path."""
    assert tattn.FLASH_THRESHOLD == jattn.FLASH_THRESHOLD == 1024
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or tfa.flash_attention(*a, **kw))
    q, k, v = inputs(1, 1280)
    got = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)))
    assert calls == [{"causal": True}]
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_indivisible_length_goes_to_reference_as_in_jax(monkeypatch):
    """T = 1100: not a flash length, and 256 does not divide it, so the
    reference computes attention_reference even on a TPU; so does the
    port, on any device."""
    monkeypatch.setattr(tattn, "on_cuda", lambda *t: True)  # as on the card
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **kw: pytest.fail("flash"))
    q, k, v = inputs(2, 1100)
    got = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)))
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")
    ref = jattn.fused_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_short_sequence_on_cpu_takes_the_reference():
    q, k, v = inputs(3, 512)
    got = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("t", [512, 64, 1024, 7, 256, 768])
def test_short_sequence_takes_the_kernel_wrapper(monkeypatch, t):
    """Every T the JAX route sends to its kernel goes to the kernel's
    wrapper (``attention_fwd``: the kernel on a CUDA tensor), and the
    forward never computes the plain version beside it."""
    calls = []
    monkeypatch.setattr(tattn, "attention_fwd",
                        lambda q, k, v, causal: calls.append(causal) or torch.zeros_like(q))
    monkeypatch.setattr(tattn, "attention_reference", lambda *a, **kw: pytest.fail("plain"))
    q = torch.zeros(1, 1, t, 16)
    out = tattn.fused_attention(q, q, q, causal=False)
    assert calls == [False] and out.shape == q.shape


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper raises on a head dim or dtype outside
    the kernel's set; it never computes the plain version there."""
    monkeypatch.setattr(tattn, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(tattn, "attention_reference", lambda *a, **kw: pytest.fail("plain"))
    with pytest.raises(ValueError, match="head_dim 24"):
        tattn.attention_fwd(*[torch.zeros(1, 1, 8, 24)] * 3)
    with pytest.raises(ValueError, match="dtype torch.float16"):
        tattn.attention_fwd(*[torch.zeros(1, 1, 8, 16, dtype=torch.float16)] * 3)
