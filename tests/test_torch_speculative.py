"""The port's standalone speculative decoding (inference/speculative.py)
on the CPU, float32 TINY, JAX weights converted through numpy:
``generate_speculative`` is greedy-lossless (equal to ``generate``, the
port's and the JAX package's, token for token) with a same-weights and an
unrelated draft; the cache horizon covers a frozen sequence's writes; the
greedy rows of ``spec_accept_commit`` equal the JAX package's on the same
inputs; the draft's propose loop seals its last proposal's K/V.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import speculative as jspec
from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import speculative as tspec
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)


def converted(key):
    return params_from_numpy(jax.tree.map(np.asarray, jtfm.init_params(JCFG, key)), "cpu")


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def other():
    return converted(jax.random.PRNGKey(123))


PROMPT = [[5, 1, 4], [2, 9, 9]]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("draft", ["same", "unrelated"])
def test_generate_speculative_equals_generate(jparams, params, other, draft, k):
    n = 14
    ref = np.asarray(jtfm.generate(jparams, jnp.asarray(PROMPT, jnp.int32), JCFG, max_new_tokens=n))
    prompt = torch.tensor(PROMPT)
    got, stats = tspec.generate_speculative(
        params, params if draft == "same" else other, prompt, CFG, CFG, n, k=k)
    assert got.tolist() == ref.tolist()
    with torch.no_grad():
        assert got.tolist() == ttfm.generate(params, prompt, CFG, n).tolist()
    assert stats.rounds > 0 and stats.proposed == k * sum(a >= 0 for r in stats.accept_hist for a in r)
    if draft == "same":
        assert stats.acceptance_rate > 0.9 and stats.tokens_per_round > 1.5
    else:
        assert stats.acceptance_rate < 0.2
    assert stats.committed >= 2 * n - 2  # every sequence committed its n (the first is the prefill's)


def test_speculative_stats_match_jax(jparams, params):
    """Same weights, same prompt: the round structure (accepted counts per
    round) is the JAX package's."""
    n, k = 10, 3
    _, jstats = jspec.generate_speculative(
        jparams, jparams, jnp.asarray(PROMPT, jnp.int32), JCFG, JCFG, n, k=k)
    _, tstats = tspec.generate_speculative(params, params, torch.tensor(PROMPT), CFG, CFG, n, k=k)
    assert tstats.accept_hist == jstats.accept_hist
    assert (tstats.rounds, tstats.proposed, tstats.accepted, tstats.committed) == (
        jstats.rounds, jstats.proposed, jstats.accepted, jstats.committed)


def test_cache_horizon_covers_frozen_overrun(params, other, monkeypatch):
    """A FROZEN sequence (done, waiting for a slower batchmate) keeps
    writing positions up to t_prompt + max_new + 2k - 1: the caches are
    sized for it, and no write leaves them (torch would raise)."""
    captured = []
    real_init = ttfm.init_kv_cache

    def spy(cfg, batch, max_len=None, device=None):
        captured.append(max_len)
        return real_init(cfg, batch, max_len, device)

    monkeypatch.setattr(tspec.tfm, "init_kv_cache", spy)
    n_new, k = 6, 4
    # the first sequence drafts for itself (commits k+1 a round and
    # freezes early); the second gets what the same draft proposes for a
    # different target only through the shared batch
    got, _ = tspec.generate_speculative(params, other, torch.tensor(PROMPT), CFG, CFG, n_new, k=k)
    assert captured == [3 + n_new + 2 * k] * 2
    assert tuple(got.shape) == (2, n_new)


def test_spec_accept_commit_greedy_rows_match_jax():
    rng = np.random.default_rng(0)
    B, k, V = 5, 4, 11
    props = rng.integers(0, V, (B, k))
    t_logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    # make some rows accept a prefix, one row everything
    choices = t_logits.argmax(-1)
    props[0] = choices[0, :k]
    props[1, :2] = choices[1, :2]
    d_probs = rng.dirichlet(np.ones(V), (B, k)).astype(np.float32)
    jcommit, jn, _ = jspec.spec_accept_commit(
        jnp.asarray(props, jnp.int32), jnp.asarray(d_probs), jnp.asarray(t_logits),
        jnp.zeros((B,), jnp.float32), jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))
    for sampling in (True, False):
        commit, n = tspec.spec_accept_commit(
            torch.from_numpy(props), torch.from_numpy(d_probs) if sampling else None,
            torch.from_numpy(t_logits), torch.zeros(B), torch.arange(B), torch.full((B,), 7))
        assert n.tolist() == np.asarray(jn).tolist()
        for i in range(B):
            assert commit[i, : n[i]].tolist() == np.asarray(jcommit)[i, : int(jn[i])].tolist()
    assert int(jn[0]) == k + 1 and int(jn[1]) >= 3


def test_draft_propose_matches_jax_and_seals_last_proposal(jparams, params):
    prompt = np.asarray(PROMPT)
    t0, k, horizon = prompt.shape[1], 3, 12
    _, (jk, jv) = jtfm.forward(jparams, jnp.asarray(prompt, jnp.int32), JCFG, return_kv=True)
    jcache = jtfm.init_kv_cache(JCFG, 2, horizon)
    jcache = {"k": jcache["k"].at[:, :, :t0].set(jk), "v": jcache["v"].at[:, :, :t0].set(jv),
              "length": jnp.asarray(t0, jnp.int32)}
    jprops, jcache = jspec._draft_propose(jparams, jcache, jnp.asarray([7, 3], jnp.int32),
                                          jnp.asarray([t0, t0], jnp.int32), JCFG, k)
    with torch.no_grad():
        _, (tk, tv) = ttfm.forward(params, torch.from_numpy(prompt), CFG, return_kv=True)
        cache = ttfm.init_kv_cache(CFG, 2, horizon)
        cache["k"][:, :, :t0], cache["v"][:, :, :t0] = tk, tv
        props, cache = tspec._draft_propose(params, cache, torch.tensor([7, 3]),
                                            torch.tensor([t0, t0]), CFG, k)
    assert props.tolist() == np.asarray(jprops).tolist()
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=2e-4, atol=2e-4)
    # k+1 steps: the last proposal's K/V (position t0 + k) is written too
    assert cache["k"][:, :, t0 + k].abs().sum() > 0
    assert cache["k"][:, :, t0 + k + 1:].abs().sum() == 0


def test_spec_stats_properties():
    st = tspec.SpecStats()
    assert st.acceptance_rate == 0.0 and st.tokens_per_round == 0.0
    st = tspec.SpecStats(rounds=4, proposed=16, accepted=8, committed=12)
    assert st.acceptance_rate == 0.5 and st.tokens_per_round == 3.0
