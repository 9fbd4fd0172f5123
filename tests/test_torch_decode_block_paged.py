"""The port's ``decode_block_paged`` (models/transformer.py) on the CPU
against the JAX package's, float32 TINY, JAX weights converted through
numpy: the K-token verification forward over the paged pool, float and
int8 pools.

Logits and pool contents agree to ``atol=rtol=2e-4`` (float32, sums in
other orders; int8 payloads may differ by one step where a value sits on
a rounding boundary, so the int8 pool is compared dequantized to 2e-2).
At K = 1 it equals ``decode_tokens_paged`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
from devspace_tpu_torch.ops import paged_attention as tpa

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
B, T0, KK, BS, MB = 2, 5, 3, 8, 4
TABLES = np.asarray([[1 + i * MB + j for j in range(MB)] for i in range(B)], np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def prefilled_pools(jparams, params, kv):
    """Both packages' pools after prefilling each slot's prompt."""
    prompt = np.random.default_rng(0).integers(1, CFG.vocab_size, (B, T0))
    jpool = jtfm.init_paged_pool(JCFG, 1 + B * MB, BS, kv_dtype=jnp.int8 if kv else None)
    tpool = ttfm.init_paged_pool(CFG, 1 + B * MB, BS, kv)
    with torch.no_grad():
        for i in range(B):
            _, jpool = jtfm.prefill_chunk_paged(jparams, jpool, jnp.asarray(TABLES[i]),
                                                jnp.asarray(prompt[i], jnp.int32),
                                                jnp.asarray(0, jnp.int32), JCFG)
            ttfm.prefill_chunk_paged(params, tpool, torch.from_numpy(TABLES[i]),
                                     torch.from_numpy(prompt[i]), 0, CFG)
    return jpool, tpool


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_decode_block_paged_matches_jax(jparams, params, kv):
    jpool, tpool = prefilled_pools(jparams, params, kv)
    toks = np.asarray([[7, 3, 9], [1, 4, 2]])
    positions = T0 + np.tile(np.arange(KK), (B, 1))
    jl, jpool = jtfm.decode_block_paged(jparams, jpool, jnp.asarray(TABLES),
                                        jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(positions, jnp.int32), JCFG)
    with torch.no_grad():
        tl, out_pool = ttfm.decode_block_paged(params, tpool, torch.from_numpy(TABLES),
                                               torch.from_numpy(toks),
                                               torch.from_numpy(positions), CFG)
    assert out_pool is tpool  # written in place
    assert tuple(tl.shape) == (B, KK, CFG.vocab_size) and tl.dtype == torch.float32
    if kv is None:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tpool["k"].numpy(), np.asarray(jpool["k"]), **TOL)
        np.testing.assert_allclose(tpool["v"].numpy(), np.asarray(jpool["v"]), **TOL)
    else:
        # quantization noise (~0.5% of a head's amax) reaches the logits
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
        for key in ("k", "v"):
            got = tpa.dequantize_kv(tpool[key], tpool[f"{key}_scale"], torch.float32).numpy()
            want = np.asarray(jpool[key], np.float32) * np.asarray(jpool[f"{key}_scale"])[..., None]
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_block_equals_sequential_paged_decode(jparams, params, kv):
    """K tokens in one call against K one-token calls: the same logits
    and the same pool."""
    _, tpool = prefilled_pools(jparams, params, kv)
    seq_pool = {k: v.clone() for k, v in tpool.items()}
    toks = torch.tensor([[7, 3, 9], [1, 4, 2]])
    positions = T0 + torch.arange(KK).repeat(B, 1)
    tables = torch.from_numpy(TABLES)
    with torch.no_grad():
        blk, _ = ttfm.decode_block_paged(params, tpool, tables, toks, positions, CFG)
        seq = [ttfm.decode_tokens_paged(params, seq_pool, tables, toks[:, j], positions[:, j],
                                        CFG)[0] for j in range(KK)]
    torch.testing.assert_close(blk, torch.stack(seq, dim=1), rtol=2e-4, atol=2e-5)
    for key in tpool:
        torch.testing.assert_close(tpool[key].float(), seq_pool[key].float(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_k1_is_decode_tokens_paged_bit_for_bit(jparams, params, kv):
    _, base = prefilled_pools(jparams, params, kv)
    other = {k: v.clone() for k, v in base.items()}
    tables = torch.from_numpy(TABLES)
    toks, pos = torch.tensor([7, 1]), torch.tensor([T0, T0 - 2])
    with torch.no_grad():
        one, _ = ttfm.decode_tokens_paged(params, base, tables, toks, pos, CFG)
        blk, _ = ttfm.decode_block_paged(params, other, tables, toks[:, None], pos[:, None], CFG)
    assert torch.equal(blk[:, 0], one)
    assert all(torch.equal(base[k], other[k]) for k in base)


def test_parked_rows_write_scratch_block_zero(params):
    """A parked slot (zeroed table, positions from 0) lands every write in
    block 0 and leaves the live slot's blocks and logits alone."""
    pool = ttfm.init_paged_pool(CFG, 1 + B * MB, BS)
    tables = torch.from_numpy(TABLES.copy())
    toks = torch.tensor([[7, 3, 9], [1, 4, 2]])
    positions = torch.arange(KK).repeat(B, 1)
    with torch.no_grad():
        both, _ = ttfm.decode_block_paged(params, pool, tables, toks, positions, CFG)
        live_blocks = pool["k"][:, TABLES[1]].clone()
        parked = tables.clone()
        parked[0] = 0
        pool2 = ttfm.init_paged_pool(CFG, 1 + B * MB, BS)
        alone, _ = ttfm.decode_block_paged(params, pool2, parked, toks, positions, CFG)
    assert torch.equal(alone[1], both[1])
    assert torch.equal(pool2["k"][:, TABLES[1]], live_blocks)
    assert pool2["k"][:, TABLES[0]].abs().sum() == 0  # the parked slot's own blocks stay empty
    assert pool2["k"][:, 0, :, :KK].abs().sum() > 0  # its writes went to scratch block 0
