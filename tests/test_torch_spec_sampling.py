"""Stochastic speculative sampling in the port (Leviathan-style
accept/resample): the distributional checks tests/test_speculative_sampling.py
holds the JAX package to, against the port's ``spec_accept_commit`` and
its counter-based draws.

Stochastic rows must commit tokens distributed EXACTLY as sequential
temperature sampling from the target alone: pinned by the analytic
acceptance probability ``sum_x min(p_t(x), p_d(x))`` and a Monte-Carlo
marginal of the first committed token against ``p_t`` (fixed seeds, so
deterministic), plain and top-k filtered. The port's draws are keyed by
(seed, position, purpose) and cannot equal JAX's threefry bits, so the two
packages are compared in distribution, each against the same analytic
target.
"""

import dataclasses

import numpy as np
import pytest
import torch

from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.sampling import (ACCEPT, CORRECT, DRAFT, PLAIN, gumbel_noise,
                                                   uniform_noise)
from devspace_tpu_torch.inference.speculative import _draft_propose_sampled, spec_accept_commit
from devspace_tpu_torch.models import transformer as ttfm

CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return ttfm.init_params(CFG, torch.Generator().manual_seed(0))


def monte_carlo(p_t, p_d, n, seed0, top_k=None):
    """n independent one-proposal rounds: proposals drawn from p_d by the
    port's DRAFT draws, then the accept/correct rule."""
    vocab = len(p_t)
    seeds = torch.arange(seed0, seed0 + n)
    pos = torch.full((n,), 11)
    d_probs = torch.tensor(p_d, dtype=torch.float32).expand(n, 1, vocab)
    props = torch.argmax(torch.log(d_probs[:, 0]) + gumbel_noise(seeds, pos, vocab, DRAFT), dim=-1)
    t_logits = torch.log(torch.tensor(p_t, dtype=torch.float32)).expand(n, 2, vocab)
    kw = {} if top_k is None else dict(top_ks=torch.full((n,), top_k), top_ps=torch.ones(n))
    commit, n_commit = spec_accept_commit(props[:, None], d_probs, t_logits, torch.ones(n), seeds,
                                          pos, use_filters=top_k is not None, **kw)
    return props.numpy(), commit.numpy(), n_commit.numpy()


def test_stochastic_first_token_marginal_matches_target():
    rng = np.random.default_rng(1)
    V, N = 8, 40_000
    p_t = rng.dirichlet(np.ones(V) * 0.7)
    p_d = rng.dirichlet(np.ones(V) * 0.7)  # deliberately mismatched draft
    props, commit, n_commit = monte_carlo(p_t, p_d, N, 500_000)
    # the DRAFT draws do sample p_d
    assert 0.5 * np.abs(np.bincount(props, minlength=V) / N - p_d).sum() < 0.02
    emp = np.bincount(commit[:, 0], minlength=V) / N
    tv = 0.5 * np.abs(emp - p_t).sum()
    assert tv < 0.02, f"first-token marginal TV {tv:.4f} vs p_t"
    acc_rate = float((n_commit - 1).mean())
    want = float(np.minimum(p_t, p_d).sum())
    assert abs(acc_rate - want) < 0.02, (acc_rate, want)


def test_stochastic_filtered_marginal_matches_filtered_target():
    rng = np.random.default_rng(3)
    V, N, TOPK = 8, 40_000, 3
    p_t = rng.dirichlet(np.ones(V) * 0.7)
    p_d = rng.dirichlet(np.ones(V) * 0.7)
    keep = np.argsort(np.log(p_t))[::-1][:TOPK]
    p_t_filt = np.zeros(V)
    p_t_filt[keep] = p_t[keep] / p_t[keep].sum()
    _, commit, n_commit = monte_carlo(p_t, p_d, N, 900_000, top_k=TOPK)
    emp = np.bincount(commit[:, 0], minlength=V) / N
    tv = 0.5 * np.abs(emp - p_t_filt).sum()
    assert tv < 0.02, f"filtered marginal TV {tv:.4f}"
    assert emp[[i for i in range(V) if i not in set(keep)]].sum() == 0  # out-of-filter never commits
    acc = float((n_commit - 1).mean())
    want = float(np.minimum(p_t_filt, p_d).sum())
    assert abs(acc - want) < 0.02, (acc, want)


def test_bonus_token_follows_target_when_all_accept():
    """Draft == target: every proposal accepts (u * p_d < p_t fails only at
    measure zero) and the bonus is drawn from p_t at the last position."""
    rng = np.random.default_rng(4)
    V, N = 6, 20_000
    p = rng.dirichlet(np.ones(V))
    _, commit, n_commit = monte_carlo(p, p, N, 100)
    assert (n_commit == 2).all()
    emp = np.bincount(commit[:, 1], minlength=V) / N
    assert 0.5 * np.abs(emp - p).sum() < 0.02


def test_mixed_batch_shapes_and_greedy_rows_unaffected():
    rng = np.random.default_rng(2)
    B, k, V = 6, 4, 13
    props = torch.from_numpy(rng.integers(0, V, (B, k)))
    d_probs = torch.from_numpy(rng.dirichlet(np.ones(V), (B, k)).astype(np.float32))
    t_logits = torch.from_numpy(rng.normal(size=(B, k + 1, V)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.7, 0.0, 1.3, 0.0])
    seeds, pos = torch.arange(B), torch.full((B,), 5)
    commit, n_commit = spec_accept_commit(props, d_probs, t_logits, temps, seeds, pos)
    assert tuple(commit.shape) == (B, k + 1) and tuple(n_commit.shape) == (B,)
    assert ((1 <= n_commit) & (n_commit <= k + 1)).all()
    assert ((0 <= commit) & (commit < V)).all()
    greedy, n_greedy = spec_accept_commit(props, None, t_logits, torch.zeros(B), seeds, pos)
    for i in (0, 3, 5):
        n = int(n_commit[i])
        assert n == int(n_greedy[i]) and commit[i, :n].tolist() == greedy[i, :n].tolist()


def test_draws_are_keyed_by_seed_position_and_purpose():
    """A replayed round draws the same numbers; another seed, position or
    purpose draws others; the plain sample's stream is untouched by the
    purposes added for speculation."""
    seeds, pos = torch.tensor([3, 3, 4]), torch.tensor([9, 10, 9])
    for purpose in (PLAIN, DRAFT, ACCEPT, CORRECT):
        u = uniform_noise(seeds, pos, purpose)
        assert torch.equal(u, uniform_noise(seeds, pos, purpose))
        assert ((0 < u) & (u < 1)).all() and len(set(u.tolist())) == 3
    g = {p: gumbel_noise(seeds, pos, 64, p) for p in (PLAIN, DRAFT, CORRECT)}
    assert not torch.equal(g[PLAIN], g[DRAFT]) and not torch.equal(g[DRAFT], g[CORRECT])
    assert torch.equal(g[PLAIN], gumbel_noise(seeds, pos, 64))
    many = uniform_noise(torch.arange(20_000), torch.zeros(20_000, dtype=torch.int64), ACCEPT)
    assert abs(many.mean().item() - 0.5) < 0.01 and abs(many.var().item() - 1 / 12) < 0.005


def test_draft_propose_sampled_rows(params):
    """Greedy rows argmax, sampled rows follow their seed; probs are the
    draft's temperature distribution; k+1 positions are written."""
    k, t0 = 3, 4
    cur, pos0 = torch.tensor([7, 7, 7]), torch.full((3,), t0)
    temps, seeds = torch.tensor([0.0, 0.9, 0.9]), torch.tensor([1, 1, 2])
    outs = []
    with torch.no_grad():
        for _ in range(2):
            cache = ttfm.init_kv_cache(CFG, 3, 12)
            props, probs, _ = _draft_propose_sampled(params, cache, cur, pos0, CFG, k, seeds, temps)
            outs.append(props)
    assert torch.equal(outs[0], outs[1])  # replayed: the same draws
    assert tuple(props.shape) == (3, k) and tuple(probs.shape) == (3, k, CFG.vocab_size)
    torch.testing.assert_close(probs.sum(-1), torch.ones(3, k))
    assert props[1].tolist() != props[2].tolist()  # another seed, another stream
    assert cache["k"][:, :, t0 + k].abs().sum() > 0  # the sealing step


def test_engine_temperature_rides_speculative_path(params):
    """A temperature request is spec-eligible, well formed, and repeats
    from its seed on a fresh engine; a top-k request rides spec too."""
    def engine():
        return InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=64,
                               draft_params=params, draft_cfg=CFG, spec_k=3, spec_depth=2).start()

    e = engine()
    try:
        toks = e.submit([4, 8, 1], 14, temperature=0.8, seed=7).result(timeout=120)
        rounds_after_temp = e.spec_rounds
        topk = e.submit([4, 8, 1], 6, temperature=0.8, top_k=5, seed=7).result(timeout=120)
        rounds_after_topk = e.spec_rounds
    finally:
        e.stop()
    assert rounds_after_temp > 0 and rounds_after_topk > rounds_after_temp
    assert len(toks) == 14 and len(topk) == 6
    assert all(0 <= t < CFG.vocab_size for t in toks + topk)
    e = engine()
    try:
        again = e.submit([4, 8, 1], 14, temperature=0.8, seed=7).result(timeout=120)
        other = e.submit([4, 8, 1], 14, temperature=0.8, seed=8).result(timeout=120)
    finally:
        e.stop()
    assert again == toks and other != toks


def test_engine_greedy_unchanged_with_stochastic_neighbor(params):
    prompt = [5, 1, 4]
    with torch.no_grad():
        ref = ttfm.generate(params, torch.tensor([prompt]), CFG, 8)[0].tolist()
    e = InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=64,
                        draft_params=params, draft_cfg=CFG, spec_k=3, spec_depth=2).start()
    try:
        h_greedy = e.submit(prompt, 8)
        h_temp = e.submit([2, 2, 6], 8, temperature=1.1, seed=3)
        assert h_greedy.result(timeout=120) == ref
        assert len(h_temp.result(timeout=120)) == 8
    finally:
        e.stop()
