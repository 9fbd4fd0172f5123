"""The port's transformer (serving subset) vs the JAX package.

JAX params are carried across through numpy (models/convert.py); the
same tokens go through both packages. Configs: float32 TINY (GQA) and a
2-layer narrow MHA config (n_kv_heads == n_heads, like Llama-2-7B).
Tolerance: logits and float pool contents ``atol=1e-4`` (float32, same
math in another order). An int8 pool may round a value that sits on a
quantization boundary to the neighbouring step, so int8 payloads are
held to one step and scales to float32 rounding.
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

CONFIGS = {
    "tiny": dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                 max_seq_len=128),
    "mha": dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=96,
                max_seq_len=128),
}
ATOL = 1e-4
BS, N_BLOCKS, MB = 8, 7, 3


def configs(name):
    fields = CONFIGS[name]
    return (jtfm.TransformerConfig(dtype=jnp.float32, **fields),
            ttfm.TransformerConfig(dtype=torch.float32, **fields))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = configs(request.param)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def assert_pools_close(tpool, jpool):
    assert set(tpool) == set(jpool)
    for key in jpool:
        got, ref = tpool[key].numpy(), np.asarray(jpool[key])
        assert got.dtype == ref.dtype, key
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1, key
        elif key.endswith("_scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=key)


def test_rms_norm_and_rope_match_jax():
    jcfg, tcfg = configs("tiny")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jtfm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5,
    )
    xh = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.array([0, 3, 17, 64, 127], np.int32)
    tcos, tsin = ttfm.rope_frequencies(tcfg, torch.from_numpy(pos))
    jcos, jsin = jtfm.rope_frequencies(jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(
        ttfm.apply_rope(torch.from_numpy(xh), tcos, tsin).numpy(),
        np.asarray(jtfm.apply_rope(jnp.asarray(xh), jcos, jsin)),
        atol=1e-5,
    )
    # per-batch form (decode: every row at its own position)
    pb = pos[:2]
    tcos, tsin = ttfm.rope_frequencies(tcfg, torch.from_numpy(pb))
    jcos, jsin = jtfm.rope_frequencies(jcfg, jnp.asarray(pb))
    np.testing.assert_allclose(
        ttfm.apply_rope(torch.from_numpy(xh[:, :1]), tcos, tsin, per_batch=True).numpy(),
        np.asarray(jtfm.apply_rope(jnp.asarray(xh[:, :1]), jcos, jsin, per_batch=True)),
        atol=1e-5,
    )


def prefill_both(model, kv, table, chunks):
    """Chained prefill chunks (tokens, offset) through both packages."""
    jcfg, tcfg, jparams, tparams = model
    jpool = jtfm.init_paged_pool(jcfg, N_BLOCKS, BS, kv_dtype="int8" if kv == "int8" else None)
    tpool = ttfm.init_paged_pool(tcfg, N_BLOCKS, BS, kv_dtype="int8" if kv == "int8" else None)
    for toks, offset in chunks:
        jlog, jpool = jtfm.prefill_chunk_paged(
            jparams, jpool, jnp.asarray(table, jnp.int32), jnp.asarray(toks, jnp.int32),
            jnp.asarray(offset, jnp.int32), jcfg,
        )
        tlog, tpool = ttfm.prefill_chunk_paged(
            tparams, tpool, torch.tensor(table), torch.tensor(toks), offset, tcfg,
        )
        yield tlog, jlog, tpool, jpool


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_prefill_chunk_paged_matches_jax(model, kv):
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, 256, size=13).tolist()
    # chunk 1: 8 tokens; chunk 2: the last 5 padded to a bucket of 8
    chunks = [(prompt[:8], 0), (prompt[8:] + [0] * 3, 8)]
    for tlog, jlog, tpool, jpool in prefill_both(model, kv, [3, 5, 1], chunks):
        assert tuple(tlog.shape) == (8, 256) and tlog.dtype == torch.float32
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    assert_pools_close(tpool, jpool)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_decode_tokens_paged_matches_jax(model, kv):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, 256, size=12).tolist()
    *_, tpool, jpool = list(prefill_both(model, kv, [3, 5, 1], [(prompt, 0)]))[-1]
    # row 0 continues the prefilled slot; row 1 is a fresh slot at
    # position 0; row 2 is parked (all-zero table -> scratch block 0)
    tables = np.array([[3, 5, 1], [2, 0, 0], [0, 0, 0]], np.int32)
    tokens = np.array([7, 9, 4], np.int32)
    positions = np.array([12, 0, 0], np.int32)
    for step in range(3):
        jlog, jpool = jtfm.decode_tokens_paged(
            jparams, jpool, jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(positions), jcfg,
        )
        tlog, tpool = ttfm.decode_tokens_paged(
            tparams, tpool, torch.from_numpy(tables), torch.from_numpy(tokens),
            torch.from_numpy(positions), tcfg,
        )
        live = [0, 1]
        np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live], atol=ATOL)
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        positions = positions + np.array([1, 1, 0], np.int32)
    pool_keys = [k for k in jpool]
    # block 0 is scratch (parked writes race there); compare real blocks
    assert_pools_close({k: tpool[k][:, 1:] for k in pool_keys},
                       {k: jpool[k][:, 1:] for k in pool_keys})
