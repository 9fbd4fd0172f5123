"""The port's fused RMSNorm op (ops/normalization.py) against the JAX
package's ``fused_rms_norm`` with its Pallas kernel in interpret mode.

The same values from a numpy seed go through both: forward, dx and dw
agree to ``atol=rtol=1e-5`` in float32 (the same float32 arithmetic,
summed in another order). In bf16 both compute in float32 and round the
output once: within one bf16 ulp (``rtol=2**-7``), dw (a float32 sum over
rows of bf16-rounded terms) to ``rtol=1e-2``. Row counts that 256 divides
take the kernel's route, others the plain version, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import normalization as jnorm
from devspace_tpu_torch.ops import normalization as tnorm

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, w, g


SHAPES = [(512, 64), (8, 256), (2, 128, 32), (300, 64), (3, 5, 24)]
IDS = ["512x64-dividing", "8x256-dividing", "2x128x32-dividing", "300x64-not", "3x5x24-dividing"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_float32_forward_dx_dw_match_jax(shape):
    x, w, g = inputs(1, shape)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = tnorm.LAUNCHES
    out = tnorm.fused_rms_norm(tx, tw)
    out.backward(torch.from_numpy(g))
    assert tnorm.LAUNCHES == before  # CPU tensors launch nothing
    ref, vjp = jax.vjp(jnorm.fused_rms_norm, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **F32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_bfloat16_forward_dx_dw_match_jax(shape):
    x, w, g = inputs(2, shape)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tg = torch.from_numpy(g).to(torch.bfloat16)
    out = tnorm.fused_rms_norm(tx, tw)
    out.backward(tg)
    assert out.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert tw.grad.dtype == torch.float32
    jx = jnp.asarray(tx.detach().float().numpy()).astype(jnp.bfloat16)
    jg = jnp.asarray(tg.float().numpy()).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(jnorm.fused_rms_norm, jx, jnp.asarray(w))
    dx, dw = vjp(jg)
    as_np = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    np.testing.assert_allclose(out.detach().float().numpy(), as_np(ref), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(tx.grad.float().numpy(), as_np(dx), rtol=2**-6, atol=2e-2)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=1e-2, atol=1e-2)


def test_route_follows_the_row_count(monkeypatch):
    """``min(block_rows, rows)`` must divide the row count for the
    kernel's route; otherwise the plain version, as in the JAX package."""
    calls = []
    monkeypatch.setattr(tnorm, "rms_norm_fwd",
                        lambda x, w, eps: calls.append(x.shape) or torch.zeros_like(x))
    w = torch.ones(8)
    tnorm.fused_rms_norm(torch.ones(512, 8), w)
    tnorm.fused_rms_norm(torch.ones(7, 8), w)  # fewer rows than the block: one block of 7
    assert len(calls) == 2
    tnorm.fused_rms_norm(torch.ones(300, 8), w)  # 300 % 256
    tnorm.fused_rms_norm(torch.ones(12, 8), w, block_rows=8)
    assert len(calls) == 2


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(tnorm, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(tnorm, "rms_norm_reference", lambda *a, **kw: pytest.fail("plain"))
    with pytest.raises(ValueError, match="weight dtype"):
        tnorm.rms_norm_fwd(torch.ones(4, 8), torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weight shape"):
        tnorm.rms_norm_fwd(torch.ones(4, 8), torch.ones(4))
    with pytest.raises(ValueError, match="x dtype"):
        tnorm.rms_norm_fwd(torch.ones(4, 8, dtype=torch.float16), torch.ones(8))


def test_reference_matches_the_models_rms_norm():
    """The op's plain version and the model's own ``rms_norm`` are one
    function."""
    from devspace_tpu_torch.models.transformer import rms_norm

    x, w, _ = inputs(3, (6, 64))
    a = tnorm.rms_norm_reference(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    b = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 2048, 2056, 4096, 1001])
def test_plain_version_matches_jax_reference_at_kernel_widths(dtype, d):
    """The plain version the card holds the kernel to, against JAX's
    ``rms_norm_reference``, at widths on each side of the register
    kernel's instances (one warp a row up to 2048 bf16 / 1024 f32, four
    warps up to 8192 / 4096) and an unaligned one: float32 ``F32``, bf16
    within one bf16 ulp (``rtol=2**-7``)."""
    x, w, _ = inputs(4, (4, d))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tnorm.rms_norm_reference(tx, torch.from_numpy(w))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    ref = jnorm.rms_norm_reference(jx, jnp.asarray(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = F32 if dtype == "float32" else dict(rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)
