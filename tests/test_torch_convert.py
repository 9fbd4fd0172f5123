"""Carrying the JAX package's parameter tree into the port
(models/convert.py): leaves arrive bit for bit (bfloat16 through its
uint16 view), in the same [in, out] layout, and the converted model
computes the JAX model's prefill logits (float32: ``atol=1e-4``;
bfloat16: both sides round activations to bf16 at every layer, in
different orders, so ``atol=2e-2`` on logits of magnitude ~0.3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy, tensor_from_numpy


LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "ffn_norm")


def leaves(tree):
    return [tree["embed"], tree["final_norm"], tree["lm_head"]] + [
        layer[k] for layer in tree["layers"] for k in LAYER_KEYS
    ]


def bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trees(request):
    cfg = jtfm.TINY
    if request.param == "float32":
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, jax.tree.map(np.asarray, jparams)


def test_convert_is_bit_exact_and_keeps_layout(trees):
    cfg, _, tree = trees
    params = params_from_numpy(tree, "cpu")
    assert set(params) == {"embed", "layers", "final_norm", "lm_head"}
    assert len(params["layers"]) == cfg.n_layers
    for got, ref in zip(leaves(params), leaves(tree)):
        # linear weights stay [in, out]: the port computes x @ w, no transpose
        assert tuple(got.shape) == ref.shape
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(bits(got), np_bits(ref))
    wq = params["layers"][0]["wq"]
    assert tuple(wq.shape) == (cfg.dim, cfg.n_heads * cfg.head_dim)
    expect = torch.bfloat16 if cfg.dtype == jnp.bfloat16 else torch.float32
    assert wq.dtype == expect and params["final_norm"].dtype == torch.float32


def test_convert_dtype_casts_weights_not_norms(trees):
    _, _, tree = trees
    params = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"][1]["w_down"].dtype == torch.bfloat16
    assert params["layers"][1]["ffn_norm"].dtype == torch.float32


def test_convert_refuses_unknown_dtype_and_missing_cuda(monkeypatch):
    with pytest.raises(TypeError):
        tensor_from_numpy(np.zeros(3, np.float64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"embed": np.zeros((2, 2), np.float32), "layers": [],
            "final_norm": np.ones(2, np.float32), "lm_head": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(tree)  # the default device is cuda: no silent CPU


def test_converted_model_reproduces_jax_prefill_logits(trees):
    cfg, jparams, tree = trees
    tcfg = ttfm.TransformerConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ttfm.TransformerConfig)
           if f.name != "dtype"},
        dtype=torch.float32 if cfg.dtype == jnp.float32 else torch.bfloat16,
    )
    params = params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, size=11).astype(np.int32)
    table = np.array([2, 1], np.int32)
    jlog, _ = jtfm.prefill_chunk_paged(
        jparams, jtfm.init_paged_pool(cfg, 3, 8), jnp.asarray(table), jnp.asarray(toks),
        jnp.asarray(0, jnp.int32), cfg,
    )
    tlog, _ = ttfm.prefill_chunk_paged(
        params, ttfm.init_paged_pool(tcfg, 3, 8), torch.from_numpy(table),
        torch.from_numpy(toks), 0, tcfg,
    )
    atol = 1e-4 if cfg.dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol)


def test_params_to_numpy_inverts_the_conversion(trees):
    """Trained params and grads go back to numpy bit for bit (bf16 as
    numpy's bfloat16), in the reference's tree, so tests can hold them
    against JAX's; ``trainable=True`` makes leaves that take grads."""
    _, _, tree = trees
    params = params_from_numpy(tree, "cpu", trainable=True)
    assert all(t.requires_grad and t.is_leaf for t in leaves(params))
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, ref in zip(leaves(back), leaves(tree)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(np_bits(got), np_bits(ref))
    assert not params_from_numpy(tree, "cpu")["embed"].requires_grad
