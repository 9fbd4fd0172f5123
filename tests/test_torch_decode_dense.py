"""The port's dense-cache decode functions (models/transformer.py) on the
CPU against the JAX package's, float32 TINY, JAX weights converted
through numpy: ``forward(return_kv=True)``, ``decode_tokens``,
``decode_block``, ``decode_step`` and ``generate``.

Logits and caches agree to ``atol=rtol=2e-4`` (float32, sums in other
orders). ``decode_block`` at K = 1 equals ``decode_tokens`` bit for bit
(the flattened ``[B*K, D] @ lm_head`` projection). Greedy tokens are
equal for runs under ~30 new tokens, before the exact float32 logit tie
this TINY/seed-0 trajectory reaches near 38.
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

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
B, T0, HORIZON = 2, 5, 12


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(1, CFG.vocab_size, (B, T0))


def seeded_caches(jparams, params, prompt):
    """Both packages' caches seeded from their own return_kv prefill."""
    _, (jk, jv) = jtfm.forward(jparams, jnp.asarray(prompt, jnp.int32), JCFG, return_kv=True)
    jcache = jtfm.init_kv_cache(JCFG, B, HORIZON)
    jcache = {"k": jcache["k"].at[:, :, :T0].set(jk), "v": jcache["v"].at[:, :, :T0].set(jv),
              "length": jnp.asarray(T0, jnp.int32)}
    with torch.no_grad():
        _, (tk, tv) = ttfm.forward(params, torch.from_numpy(prompt), CFG, return_kv=True)
    tcache = ttfm.init_kv_cache(CFG, B, HORIZON)
    tcache["k"][:, :, :T0] = tk
    tcache["v"][:, :, :T0] = tv
    tcache["length"] = T0
    return jcache, tcache


def test_forward_return_kv_matches_jax(jparams, params, prompt):
    jl, (jk, jv) = jtfm.forward(jparams, jnp.asarray(prompt, jnp.int32), JCFG, return_kv=True)
    with torch.no_grad():
        tl, (tk, tv) = ttfm.forward(params, torch.from_numpy(prompt), CFG, return_kv=True)
    assert tuple(tk.shape) == (CFG.n_layers, B, T0, CFG.n_kv_heads, CFG.head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_return_kv_refuses_remat(params, prompt):
    with pytest.raises(ValueError, match="remat"):
        ttfm.forward(params, torch.from_numpy(prompt), CFG, remat=True, return_kv=True)


def test_init_kv_cache_shape_and_dtype():
    cache = ttfm.init_kv_cache(ttfm.TINY, 3, 10)
    shape = (ttfm.TINY.n_layers, 3, 10, ttfm.TINY.n_kv_heads, ttfm.TINY.head_dim)
    assert tuple(cache["k"].shape) == shape == tuple(cache["v"].shape)
    assert cache["k"].dtype == torch.bfloat16 and cache["length"] == 0
    assert ttfm.init_kv_cache(ttfm.TINY, 1)["k"].shape[2] == ttfm.TINY.max_seq_len


def test_decode_tokens_matches_jax(jparams, params, prompt):
    """Three steps at per-sequence positions (the second sequence one
    behind the first): logits and caches against JAX."""
    jcache, tcache = seeded_caches(jparams, params, prompt)
    toks = np.asarray([[7, 1], [3, 4], [9, 2]])
    pos = np.asarray([[T0, T0 - 1], [T0 + 1, T0], [T0 + 2, T0 + 1]])
    with torch.no_grad():
        for step_toks, step_pos in zip(toks, pos):
            jl, kv = jtfm.decode_tokens(jparams, jcache, jnp.asarray(step_toks, jnp.int32),
                                        jnp.asarray(step_pos, jnp.int32), JCFG)
            jcache = {"k": kv["k"], "v": kv["v"], "length": jcache["length"]}
            tl, tkv = ttfm.decode_tokens(params, tcache, torch.from_numpy(step_toks),
                                         torch.from_numpy(step_pos), CFG)
            assert tkv["k"] is tcache["k"]  # written in place
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), **TOL)


def test_decode_block_matches_jax_and_sequential_decode(jparams, params, prompt):
    jcache, tcache = seeded_caches(jparams, params, prompt)
    toks = np.asarray([[7, 3, 9], [1, 4, 2]])
    positions = T0 + np.tile(np.arange(3), (B, 1))
    jl, jkv = jtfm.decode_block(jparams, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(positions, jnp.int32), JCFG)
    seq_cache = {k: v.clone() if torch.is_tensor(v) else v for k, v in tcache.items()}
    with torch.no_grad():
        tl, _ = ttfm.decode_block(params, tcache, torch.from_numpy(toks),
                                  torch.from_numpy(positions), CFG)
        seq = [ttfm.decode_tokens(params, seq_cache, torch.from_numpy(toks[:, j]),
                                  torch.from_numpy(positions[:, j]), CFG)[0] for j in range(3)]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jkv["k"]), **TOL)
    torch.testing.assert_close(tl, torch.stack(seq, dim=1), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tcache["k"], seq_cache["k"], rtol=1e-5, atol=1e-6)


def test_decode_block_k1_is_decode_tokens_bit_for_bit(jparams, params, prompt):
    _, base = seeded_caches(jparams, params, prompt)
    other = {k: v.clone() if torch.is_tensor(v) else v for k, v in base.items()}
    toks, pos = torch.tensor([7, 1]), torch.tensor([T0, T0 - 2])
    with torch.no_grad():
        one, _ = ttfm.decode_tokens(params, base, toks, pos, CFG)
        blk, _ = ttfm.decode_block(params, other, toks[:, None], pos[:, None], CFG)
    assert torch.equal(blk[:, 0], one)
    assert torch.equal(base["k"], other["k"]) and torch.equal(base["v"], other["v"])


def test_decode_step_advances_length(jparams, params, prompt):
    jcache, tcache = seeded_caches(jparams, params, prompt)
    tok = np.asarray([[7], [1]])
    jl, jcache = jtfm.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32), JCFG)
    with torch.no_grad():
        tl, tcache = ttfm.decode_step(params, tcache, torch.from_numpy(tok), CFG)
    assert tcache["length"] == T0 + 1 == int(jcache["length"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_out_of_range_write_raises(params):
    """JAX drops a scatter past the cache; the port raises, so callers
    size their caches for every position they write."""
    cache = ttfm.init_kv_cache(CFG, 1, 4)
    with pytest.raises(IndexError), torch.no_grad():
        ttfm.decode_tokens(params, cache, torch.tensor([3]), torch.tensor([4]), CFG)


@pytest.mark.parametrize("prompt_ids,n", [([[5, 1, 4]], 24), ([[2, 9, 9], [7, 3, 1]], 12),
                                          ([[9, 8, 7, 6, 5, 4, 3]], 8)])
def test_generate_matches_jax_greedy(jparams, params, prompt_ids, n):
    ref = jtfm.generate(jparams, jnp.asarray(prompt_ids, jnp.int32), JCFG, max_new_tokens=n)
    with torch.no_grad():
        got = ttfm.generate(params, torch.tensor(prompt_ids), CFG, n)
    assert got.tolist() == np.asarray(ref).tolist()


def test_generate_sampled_is_seeded(params):
    prompt = torch.tensor([[5, 1, 4], [5, 1, 4]])
    with torch.no_grad():
        a = ttfm.generate(params, prompt, CFG, 10, temperature=0.9, seed=3)
        b = ttfm.generate(params, prompt, CFG, 10, temperature=0.9, seed=3)
        c = ttfm.generate(params, prompt, CFG, 10, temperature=0.9, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a[0].tolist() != a[1].tolist()  # one stream per sequence
    assert ((0 <= a) & (a < CFG.vocab_size)).all()
