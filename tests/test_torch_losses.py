"""The port's fused cross-entropy (plain version on the CPU) vs the JAX
package's Pallas kernel in interpret mode.

Inputs from a numpy seed: ``[32, 100]`` logits with 16-row blocks on the
JAX side, and a 32000-wide vocabulary at 8 rows. Tolerances (float32):
losses ``rtol=1e-5, atol=1e-5`` and gradients ``rtol=1e-4, atol=1e-6``,
the bounds tests/test_models_ops.py holds the Pallas loss to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import losses as jlosses
from devspace_tpu_torch.ops import losses as tlosses

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def inputs(seed, b, v, scale=1.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.normal(size=(b, v))).astype(np.float32)
    labels = rng.integers(0, v, size=b)
    return logits, labels


@pytest.mark.parametrize("shape", [(32, 100, 16), (8, 32000, 8)], ids=["32x100", "8x32000"])
def test_loss_and_grad_match_jax_kernel(pallas_interpret, shape):
    b, v, block_rows = shape
    logits, labels = inputs(0, b, v, scale=3.0)
    w = np.random.default_rng(1).normal(size=b).astype(np.float32)  # a non-uniform g

    def jloss(lg):
        return jlosses.cross_entropy_pallas(lg, jnp.asarray(labels, jnp.int32), block_rows)

    jl, vjp = jax.vjp(jloss, jnp.asarray(logits))
    (jg,) = vjp(jnp.asarray(w))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = tlosses.fused_cross_entropy(tl, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(w))
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (b,)
    assert tlosses.LAST_DISPATCH["impl"] == "reference"
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl), **LOSS_TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), **GRAD_TOL)


def test_plain_backward_equals_autograd_of_reference():
    logits, labels = inputs(2, 16, 300, scale=2.0)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=16).astype(np.float32))
    tl = torch.from_numpy(logits).requires_grad_()
    tlosses.cross_entropy_reference(tl, torch.from_numpy(labels)).backward(g)
    x = torch.from_numpy(logits)
    _, lse = tlosses.xent_fwd(x, torch.from_numpy(labels))
    got = tlosses.xent_bwd(x, torch.from_numpy(labels), lse, g)
    torch.testing.assert_close(got, tl.grad, rtol=1e-5, atol=1e-7)


def test_bf16_logits_grad_keeps_their_dtype():
    logits, labels = inputs(4, 8, 64)
    tl = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    loss = tlosses.fused_cross_entropy(tl, torch.from_numpy(labels).int())
    ref = tlosses.cross_entropy_reference(tl.detach().float(), torch.from_numpy(labels))
    torch.testing.assert_close(loss.detach(), ref, rtol=0, atol=0)  # the loss is f32 math
    loss.sum().backward()
    assert tl.grad.dtype == torch.bfloat16


def test_kernel_wrapper_checks_reach_the_cpu(monkeypatch):
    """On a CUDA tensor the wrapper checks before it launches; with the
    device check patched the checks run here and raise before any launch."""
    monkeypatch.setattr(tlosses, "on_cuda", lambda *t: True)
    logits = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="int64"):
        tlosses.xent_fwd(logits, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="labels shape"):
        tlosses.xent_fwd(logits, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="logits dtype"):
        tlosses.xent_fwd(logits.double(), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tlosses.xent_fwd(torch.zeros(10, 4).t(), torch.zeros(4, dtype=torch.int64))
    assert tlosses.LAUNCHES == 0


# labels outside [0, V): the reference function (cross_entropy_reference,
# the path the JAX package takes off a TPU) wraps a label in [-V, 0) to
# label + V and gives NaN for any other; its gradient has no one-hot term
# for such a row. Logits RandomState(0).randn(4, 16).
OUT_OF_RANGE_LABELS = [[0, 3, 16, -1], [0, 3, -17, -20]]


@pytest.mark.parametrize("labels", OUT_OF_RANGE_LABELS, ids=["16,-1", "-17,-20"])
def test_out_of_range_labels_follow_the_reference(labels):
    logits = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    labels = np.asarray(labels)
    g = np.random.default_rng(5).normal(size=4).astype(np.float32)
    jl = jlosses.cross_entropy_reference(jnp.asarray(logits), jnp.asarray(labels))
    (jg,) = jax.grad(lambda a: jnp.sum(jlosses.cross_entropy_reference(a, jnp.asarray(labels))
                                       * jnp.asarray(g)), argnums=(0,))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = tlosses.fused_cross_entropy(tl, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl), **LOSS_TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), **GRAD_TOL)
    # the autograd of the plain version agrees with the Function's backward
    tr = torch.from_numpy(logits).requires_grad_()
    tlosses.cross_entropy_reference(tr, torch.from_numpy(labels)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tr.grad.numpy(), tl.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_out_of_range_label_values():
    """The reference's values on the CPU: label 16 is NaN, -1 picks column
    15; the -1 row's gradient carries the one-hot at column 15, the NaN
    rows' gradients are softmax * g alone."""
    logits = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    tl = torch.from_numpy(logits).requires_grad_()
    loss = tlosses.fused_cross_entropy(tl, torch.tensor([0, 3, 16, -1]))
    np.testing.assert_allclose(loss.detach().numpy(), [2.0146, 4.4181, np.nan, 4.1927],
                               rtol=0, atol=1e-4)
    loss.backward(torch.ones(4))
    softmax = torch.softmax(torch.from_numpy(logits), -1)
    torch.testing.assert_close(tl.grad[2], softmax[2])
    torch.testing.assert_close(tl.grad[3], softmax[3] - torch.eye(16)[15])
    t2 = torch.from_numpy(logits).requires_grad_()
    loss2 = tlosses.fused_cross_entropy(t2, torch.tensor([0, 3, -17, -20]))
    assert torch.isnan(loss2[2:]).all() and torch.isfinite(loss2[:2]).all()
    loss2.backward(torch.ones(4))
    torch.testing.assert_close(t2.grad[2:], softmax[2:])
