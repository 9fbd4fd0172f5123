"""The port's flash attention (plain versions on the CPU) vs the JAX
package's Pallas kernels, run in interpret mode.

Inputs are unit normals from a numpy seed at ``[1, 2, 256, 32]`` with
64-row blocks on the JAX side (the kernels' own tiles are their choice
on the card). Tolerances, float32 throughout: the forward O and lse
``atol=2e-4, rtol=2e-4`` and the gradients ``atol=2e-3, rtol=2e-3``, as
tests/test_models_ops.py holds the Pallas kernels to reference math;
each plain backward function against the JAX kernel fed the same δ at
the forward's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import flash_attention as jfa
from devspace_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
B, H, T, D = 1, 2, 256, 32
BLOCK = 64


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def inputs(seed, shape=(B * H, T, D), n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_matches_jax_kernel(pallas_interpret, causal):
    q, k, v, _ = inputs(0)
    jo, jlse = jfa._flash_fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                   BLOCK, BLOCK)
    o, lse = tfa.flash_fwd(*to_torch(q, k, v), causal)
    assert tfa.LAST_DISPATCH["impl"] == "reference"
    assert o.dtype == torch.float32 and tuple(lse.shape) == (B * H, T)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_backward_functions_match_jax_kernels(pallas_interpret, causal):
    """dq and dk/dv from the same residuals and the same δ on both sides."""
    q, k, v, do = inputs(1)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_fwd_call(jq, jk, jv, causal, BLOCK, BLOCK)
    jdq, jdk, jdv = jfa._flash_bwd_call(jq, jk, jv, jo, jlse, jdo, causal, BLOCK, BLOCK)
    tq, tk, tv, tdo = to_torch(q, k, v, do)
    lse = to_torch(np.asarray(jlse)[..., 0])[0]
    delta = (tdo * to_torch(jo)[0]).sum(-1)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **FWD_TOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **FWD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_autograd_matches_jax_vjp(pallas_interpret, causal):
    q, k, v, g = inputs(2, shape=(B, H, T, D))

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = [t.requires_grad_() for t in to_torch(q, k, v)]
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"d{name}", **GRAD_TOL)


def test_block_divisibility_check_matches_reference():
    q = torch.zeros(1, 1, 320, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q, q, q)  # 320 % 256
    with pytest.raises(ValueError, match="not divisible"):
        jfa.flash_attention(jnp.zeros((1, 1, 320, 16)), jnp.zeros((1, 1, 320, 16)),
                            jnp.zeros((1, 1, 320, 16)))
    # T below the block takes one block of T, as in the reference
    assert tfa.flash_attention(q[:, :, :100], q[:, :, :100], q[:, :, :100]).shape == (1, 1, 100, 16)


def test_plain_path_counts_no_launch():
    q, k, v, _ = inputs(3, shape=(2, 64, 16))
    before = dict(tfa.LAUNCHES)
    tfa.flash_fwd(*to_torch(q, k, v))
    assert tfa.LAUNCHES == before and tfa.LAST_DISPATCH["impl"] == "reference"


def test_kernel_wrapper_checks_reach_the_cpu():
    """The checks a CUDA launch runs are plain Python, so they can be held
    here without a card."""
    q = torch.zeros(2, 64, 16)
    assert tfa._check_inputs({"q": q, "k": q}, {"lse": torch.zeros(2, 64)}) == (2, 64, 16)
    with pytest.raises(ValueError, match="head_dim 24"):
        tfa._check_inputs({"q": torch.zeros(2, 64, 24)}, {})
    with pytest.raises(ValueError, match="dtype"):
        tfa._check_inputs({"q": q, "k": q.double()}, {})
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_inputs({"q": q, "k": torch.zeros(2, 16, 64).transpose(1, 2)}, {})
    with pytest.raises(ValueError, match="lse dtype"):
        tfa._check_inputs({"q": q}, {"lse": torch.zeros(2, 64, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        tfa.flash_fwd(q, q.to("meta"), q)
