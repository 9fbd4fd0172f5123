"""Weight-only int8 (devspace_tpu_torch/inference/quantization.py) against
the JAX package's, on the CPU.

The same numpy-seeded weights go through both packages' functions.
Tolerances:

- ``quantize_weight``'s ``q`` and ``scale``, and ``dequantize_params``:
  byte-equal (the same float32 division and half-to-even rounding);
- the ``QuantizedLinear`` product: float32 within ``rtol=1e-5,
  atol=1e-6`` (the same float32 products summed in another order); bf16
  within one bf16 ulp (both round one float32 result once);
- ``quantization_error``: within 1e-6;
- logits of ``forward``, ``decode_tokens_paged`` and
  ``prefill_chunk_paged`` on a float32 copy of TINY with int8 weights:
  ``atol=1e-4``, the bound of tests/test_torch_forward.py;
- greedy streams: equal token for token, every run under 24 new tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JaxEngine
from devspace_tpu.inference import quantization as jq
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference import quantization as tq
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
ATOL = 1e-4
BS, N_BLOCKS = 8, 7
PROMPTS = [[5, 1, 4], [2, 9, 9, 7], list(range(1, 21))]


def jax_to_numpy(tree):
    """A JAX param tree -> numpy, each QuantizedLinear as its (q, scale)
    pair (``tree_flatten``'s children)."""
    return jax.tree.map(
        lambda x: tuple(np.asarray(c) for c in x.tree_flatten()[0])
        if isinstance(x, jq.QuantizedLinear) else np.asarray(x),
        tree, is_leaf=lambda x: isinstance(x, jq.QuantizedLinear))


@pytest.fixture(scope="module")
def dense():
    jparams = jtfm.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def quantized(dense):
    """JAX's int8 tree, and the port's carried across from it."""
    jq_params = jq.quantize_params(dense[0])
    return jq_params, params_from_numpy(jax_to_numpy(jq_params), "cpu")


def weight(seed, dtype, shape=(96, 80)):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    w[:, 5] = 0.0  # a zero column: scale 1.0, q all 0
    return jnp.asarray(w, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_weight_bytes_equal_jax(dtype):
    w = weight(0, dtype)
    ref = jq.quantize_weight(w)
    got = tq.quantize_weight(tensor_from_numpy(np.asarray(w)))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(ref.scale).view(np.uint32))
    assert got.scale[5].item() == 1.0 and not got.q[:, 5].any()


def test_quantize_params_covers_exactly_the_matmul_leaves(dense):
    assert tq._MATMUL_LEAVES == jq._MATMUL_LEAVES
    qp = tq.quantize_params(dense[1])
    quantized = {k for k, v in qp.items() if isinstance(v, tq.QuantizedLinear)}
    quantized |= {k for layer in qp["layers"] for k, v in layer.items()
                  if isinstance(v, tq.QuantizedLinear)}
    assert quantized == set(tq._MATMUL_LEAVES)
    for layer in qp["layers"]:
        for name in ("attn_norm", "ffn_norm"):
            assert isinstance(layer[name], torch.Tensor)
    assert isinstance(qp["embed"], torch.Tensor) and isinstance(qp["final_norm"], torch.Tensor)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantized_linear_product_matches_jax(dtype):
    w = weight(1, dtype)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((3, 5, 96)), dtype)
    ref = np.asarray((x @ jq.quantize_weight(w)).astype(jnp.float32))
    tx = tensor_from_numpy(np.asarray(x))
    got = tx @ tq.quantize_weight(tensor_from_numpy(np.asarray(w)))
    assert got.dtype == tx.dtype and tuple(got.shape) == (3, 5, 80)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:  # one bf16 ulp is at most 2^-7 of the value
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-6)


def test_quantized_linear_behaves_like_a_weight():
    ql = tq.quantize_weight(tensor_from_numpy(np.asarray(weight(3, jnp.float32))))
    assert ql.shape == (96, 80) and ql.dtype == torch.bfloat16  # as the reference's
    moved = ql.to("cpu")
    assert moved.q.device.type == "cpu" and torch.equal(moved.q, ql.q)
    assert torch.equal(moved.scale, ql.scale)
    assert "96, 80" in repr(ql)


def test_dequantize_params_bytes_equal_jax(quantized):
    jq_params, tq_params = quantized
    ref = jax.tree.map(np.asarray, jq.dequantize_params(jq_params))
    got = params_to_numpy(tq.dequantize_params(tq_params))
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))


def test_quantization_error_matches_jax_and_refuses_a_quantized_tree(dense, quantized):
    ref = jq.quantization_error(dense[0])
    got = tq.quantization_error(dense[1])
    assert abs(got - ref) <= 1e-6 and 0 < got < 0.02
    with pytest.raises(ValueError, match="DENSE"):
        tq.quantization_error(quantized[1])


def test_params_carry_quantized_pairs_both_ways(quantized):
    jq_params, tq_params = quantized
    ref = jax_to_numpy(jq_params)
    back = params_to_numpy(tq_params)
    assert isinstance(back["lm_head"], tuple) and back["lm_head"][0].dtype == np.int8
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))
    again = params_from_numpy(back, "cpu", dtype=torch.bfloat16)  # dtype leaves pairs alone
    assert torch.equal(again["layers"][1]["w_down"].q, tq_params["layers"][1]["w_down"].q)
    assert tensor_to_numpy(tensor_from_numpy(back["lm_head"][0])).dtype == np.int8
    with pytest.raises(TypeError, match="quantized"):
        params_from_numpy({**back, "lm_head": (back["lm_head"][1], back["lm_head"][1])}, "cpu")


def test_forward_logits_with_int8_weights_match_jax(quantized):
    jq_params, tq_params = quantized
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 24))
    ref = jtfm.forward(jq_params, jnp.asarray(toks, jnp.int32), JCFG)
    got = ttfm.forward(tq_params, torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_logits_with_int8_weights_match_jax(quantized):
    """A prefill of two chunks, then three decode steps of a continuing
    row and a fresh one (a third parked), through both packages."""
    jq_params, tq_params = quantized
    prompt = np.random.default_rng(5).integers(1, 256, size=13).tolist()
    table = [3, 5, 1]
    jpool = jtfm.init_paged_pool(JCFG, N_BLOCKS, BS)
    tpool = ttfm.init_paged_pool(CFG, N_BLOCKS, BS)
    for toks, offset in ((prompt[:8], 0), (prompt[8:] + [0] * 3, 8)):
        jlog, jpool = jtfm.prefill_chunk_paged(
            jq_params, jpool, jnp.asarray(table, jnp.int32), jnp.asarray(toks, jnp.int32),
            jnp.asarray(offset, jnp.int32), JCFG)
        tlog, tpool = ttfm.prefill_chunk_paged(
            tq_params, tpool, torch.tensor(table), torch.tensor(toks), offset, CFG)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    tables = np.array([table, [2, 0, 0], [0, 0, 0]], np.int32)
    tokens = np.array([7, 9, 4], np.int32)
    positions = np.array([13, 0, 0], np.int32)
    for _ in range(3):
        jlog, jpool = jtfm.decode_tokens_paged(
            jq_params, jpool, jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(positions),
            JCFG)
        tlog, tpool = ttfm.decode_tokens_paged(
            tq_params, tpool, torch.from_numpy(tables), torch.from_numpy(tokens),
            torch.from_numpy(positions), CFG)
        np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], atol=ATOL)
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        positions = positions + np.array([1, 1, 0], np.int32)


def port_streams(params, prompts, n, **kw):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=64, **kw).start()
    try:
        return [h.result(timeout=120) for h in [engine.submit(p, n) for p in prompts]]
    finally:
        engine.stop()


def test_engine_with_int8_weights_equals_generate(quantized):
    """The port's engine serves int8 params with the streams of its own
    standalone greedy ``generate`` over them (tests/test_inference.py's
    check of the JAX engine), with and without a draft."""
    tq_params = quantized[1]
    with torch.no_grad():
        ref = [ttfm.generate(tq_params, torch.tensor([p]), CFG, 20)[0].tolist() for p in PROMPTS]
    assert port_streams(tq_params, PROMPTS, 20) == ref
    assert port_streams(tq_params, PROMPTS, 20, draft_params=tq_params, draft_cfg=CFG,
                        spec_k=3) == ref


def test_engine_with_int8_weights_equals_jax_engine(quantized):
    """Greedy streams of the port's engine and the JAX engine over the
    same int8 params (float32 TINY) are equal token for token."""
    jq_params, tq_params = quantized
    engine = JaxEngine(jq_params, JCFG, max_slots=2, max_len=64).start()
    try:
        ref = [h.result(timeout=300) for h in [engine.submit(p, 16) for p in PROMPTS]]
    finally:
        engine.stop()
    assert port_streams(tq_params, PROMPTS, 16) == ref
