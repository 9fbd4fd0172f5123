"""The port's training forward (models/transformer.py ``forward``) vs the
JAX package's, with the JAX kernels in interpret mode.

float32 TINY (GQA: 4 heads over 2 KV heads), JAX params carried across
through numpy, tokens from a numpy seed. Tolerance: logits ``atol=1e-4``
(float32, the same math in another order; the bound
tests/test_torch_transformer.py holds the serving functions to).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.ops import flash_attention as jfa
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
from devspace_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t)).astype(np.int64)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_logits_match_jax(model, pallas_interpret, remat):
    jcfg, tcfg, jparams, tparams = model
    toks = tokens(0, 2, 64)
    ref = jtfm.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, remat=remat)
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg, remat=remat)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_forward_with_flash_attention_fn_matches_jax(model, pallas_interpret):
    """T = 256 through flash attention on both sides (64-row blocks for
    the JAX kernels), passed as ``attention_fn`` on [B, T, H, D]."""
    jcfg, tcfg, jparams, tparams = model

    def jflash(q, k, v):
        tr = partial(jnp.transpose, axes=(0, 2, 1, 3))
        return tr(jfa.flash_attention(tr(q), tr(k), tr(v), causal=True, block_q=64, block_k=64))

    def tflash(q, k, v):
        out = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True, block_q=64, block_k=64)
        return out.transpose(1, 2)

    toks = tokens(1, 1, 256)
    ref = jtfm.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, attention_fn=jflash)
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg, attention_fn=tflash)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_remat_keeps_the_gradients(model):
    """``remat=True`` recomputes each layer in the backward pass and must
    give the same gradients as keeping the activations."""
    _, tcfg, _, tparams = model
    toks = torch.from_numpy(tokens(2, 2, 32))
    grads = []
    for remat in (False, True):
        params = {
            "embed": tparams["embed"].clone().requires_grad_(),
            "layers": [{k: v.clone().requires_grad_() for k, v in layer.items()}
                       for layer in tparams["layers"]],
            "final_norm": tparams["final_norm"].clone().requires_grad_(),
            "lm_head": tparams["lm_head"].clone().requires_grad_(),
        }
        ttfm.forward(params, toks, tcfg, remat=remat).square().mean().backward()
        grads.append([params["embed"].grad, params["layers"][0]["wq"].grad,
                      params["layers"][1]["w_down"].grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_positions_and_layer_kv_match_jax(model):
    """``layer_apply`` returns the roped K/V before the GQA repeat, as the
    reference's does; explicit positions shift RoPE."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(3)
    h = rng.normal(size=(1, 16, 64)).astype(np.float32)
    pos = np.arange(5, 21)
    jcos, jsin = jtfm.rope_frequencies(jcfg, jnp.asarray(pos))
    tcos, tsin = ttfm.rope_frequencies(tcfg, torch.from_numpy(pos))
    jh, (jk, jv) = jtfm.layer_apply(jnp.asarray(h), jparams["layers"][0], jcfg, jcos, jsin)
    th, (tk, tv) = ttfm.layer_apply(torch.from_numpy(h), tparams["layers"][0], tcfg, tcos, tsin)
    assert tuple(tk.shape) == (1, 16, 2, 16)
    for got, ref in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    toks = tokens(4, 1, 16)
    ref = jtfm.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, positions=jnp.asarray(pos))
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
