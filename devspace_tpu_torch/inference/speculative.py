"""Speculative decoding: draft-model proposals, target-model verification.

Counterpart of ``devspace_tpu/inference/speculative.py``. A small DRAFT
model proposes ``k`` tokens per round; the TARGET model scores all of
them in one ``decode_block`` call (k+1 positions) and the longest
matching prefix commits plus one corrected or bonus token, so each target
call yields 1..k+1 tokens. Greedy speculative decoding is LOSSLESS: the
committed stream equals greedy decoding with the target alone; the draft
only changes how fast tokens commit.

Both models keep dense positional KV caches, and rewinding after a
rejection is free: every decode writes a position's K/V before anything
attends to it, so a rejected proposal's stale entry is overwritten the
moment the corrected token is fed at that position.

Random draws are counter-based (``inference/sampling.py``), keyed by the
request's seed, the absolute position a draw belongs to and its purpose
(proposal, accept test, corrected token), where the reference re-anchors
a key chain at the round's verify position: a replayed round draws the
same numbers either way. The caches are written in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models import transformer as tfm
from .sampling import ACCEPT, CORRECT, DRAFT, filter_scaled_logits, gumbel_noise, uniform_noise


@dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0  # draft proposals accepted (excl. corrected/bonus)
    committed: int = 0  # total tokens committed (incl. corrected/bonus)
    accept_hist: list = field(default_factory=list)  # per-round accept count

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_round(self) -> float:
        return self.committed / self.rounds if self.rounds else 0.0


def _draft_propose(params, cache, cur, pos0, cfg, k, tp=None):
    """Greedy-propose k tokens per sequence -> (proposals [B, k], cache).

    The loop runs k+1 steps: the extra step feeds the LAST proposal so
    its K/V is written to the draft cache too (otherwise a fully accepted
    round would leave a permanent zero hole at that position that every
    later draft query attends); its own proposal is discarded. ``tp``:
    the draft's shards and cache heads of a tensor-parallel engine."""
    props = []
    for j in range(k + 1):
        logits, _ = tfm.decode_tokens(params, cache, cur, pos0 + j, cfg, tp=tp)
        cur = torch.argmax(logits, dim=-1)
        props.append(cur)
    return torch.stack(props[:k], dim=1), cache


def _draft_propose_sampled(params, cache, cur, pos0, cfg, k, seeds, temps, tp=None):
    """Propose k tokens per sequence, SAMPLING rows with temps > 0 from
    the draft's temperature distribution and argmaxing the rest ->
    (proposals [B, k], draft probs [B, k, V], cache). The probs are the
    draft's full distribution per proposal position, what the residual
    needs at a rejection. The same k+1 steps as :func:`_draft_propose`.
    The draw for the token at position p + 1 is keyed by (seed, p, DRAFT)."""
    safe_t = torch.clamp(temps.float(), min=1e-6)[:, None]
    props, probs = [], []
    for j in range(k + 1):
        logits, _ = tfm.decode_tokens(params, cache, cur, pos0 + j, cfg, tp=tp)
        scaled = logits / safe_t
        noise = gumbel_noise(seeds, pos0 + j, logits.shape[-1], DRAFT)
        sampled = torch.argmax(scaled + noise, dim=-1)
        cur = torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))
        props.append(cur)
        probs.append(torch.softmax(scaled, dim=-1))
    return torch.stack(props[:k], dim=1), torch.stack(probs[:k], dim=1), cache


def spec_accept_commit(
    props: torch.Tensor,
    d_probs: Optional[torch.Tensor],
    t_logits: torch.Tensor,
    temps: torch.Tensor,
    seeds: torch.Tensor,
    pos0: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    use_filters: bool = True,
):
    """Per-slot acceptance + correction for one speculative round ->
    ``(commit_tokens [B, k+1], n_commit [B])``; the committed tokens of a
    slot are ``commit_tokens[i, :n_commit[i]]``.

    ``props`` [B, k] are the draft's proposals, ``d_probs`` [B, k, V] its
    distributions, ``t_logits`` [B, k+1, V] the target's logits over the
    verification block, ``pos0`` [B] the block's first position.

    Greedy rows (``temps <= 0``): the exact rule — leading proposals that
    match the target's argmax commit, then the target's corrected or
    bonus token.

    Stochastic rows: speculative SAMPLING (Leviathan et al. 2023) —
    proposal ``x_i`` accepts with probability ``min(1, p_t(x_i)/p_d(x_i))``;
    at the first rejection the corrected token is drawn from the
    normalized residual ``max(p_t - p_d, 0)``; full acceptance draws the
    bonus from ``p_t`` at the last position. The committed stream is
    distributed exactly as sequential temperature sampling from the
    target alone. ``top_ks``/``top_ps`` make the target distribution the
    FILTERED one (``filter_scaled_logits``, the filter the plain path
    samples with); the draft still proposes from its unfiltered
    distribution and out-of-filter proposals reject (p_t = 0).

    ``use_filters=False`` (no row filters) and ``d_probs=None`` (no row
    samples: the proposals came from :func:`_draft_propose`) skip work
    whose result would be discarded; they never change a row's tokens."""
    b, k = props.shape
    sampling = d_probs is not None
    greedy_choices = torch.argmax(t_logits, dim=-1)  # [B, k+1]
    g_match = (props == greedy_choices[:, :k]).long()
    n_acc = torch.cumprod(g_match, dim=1).sum(dim=1)  # [B] in 0..k
    if sampling:
        stoch = temps > 0
        vocab = t_logits.shape[-1]
        if use_filters:
            if top_ks is None:
                top_ks = torch.zeros((b,), dtype=torch.int64, device=props.device)
            if top_ps is None:
                top_ps = torch.ones((b,), dtype=torch.float32, device=props.device)
            # one filter row per (slot, block position)
            filtered = filter_scaled_logits(
                t_logits.reshape(b * (k + 1), vocab), temps.repeat_interleave(k + 1),
                top_ks.repeat_interleave(k + 1), top_ps.repeat_interleave(k + 1),
            ).view(b, k + 1, vocab)
        else:
            filtered = t_logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None, None]
        t_probs = torch.softmax(filtered, dim=-1)  # [B, k+1, V]
        p_t_prop = t_probs[:, :k].gather(-1, props[..., None])[..., 0]
        p_d_prop = d_probs.gather(-1, props[..., None])[..., 0]
        steps = torch.arange(k, device=props.device)
        u = uniform_noise(seeds[:, None].expand(b, k), pos0[:, None] + steps[None], ACCEPT)
        ok = (u * torch.clamp(p_d_prop, min=1e-30) < p_t_prop).long()
        s_acc = torch.cumprod(ok, dim=1).sum(dim=1)
        n_acc = torch.where(stoch, s_acc, n_acc)
        # correction distribution at the rejection position (or the bonus
        # at k): t_probs has k+1 positions, so n_acc <= k is valid there;
        # d_probs has k
        t_at = t_probs.gather(1, n_acc[:, None, None].expand(b, 1, vocab))[:, 0]
        d_at = d_probs.gather(1, torch.clamp(n_acc, max=k - 1)[:, None, None].expand(b, 1, vocab))[:, 0]
        residual = torch.clamp(t_at - d_at, min=0.0)
        rsum = residual.sum(dim=-1, keepdim=True)
        # a rejection under identical distributions has probability 0;
        # the numeric guard falls back to p_t, the same limit
        corr_dist = torch.where(
            (n_acc < k)[:, None] & (rsum > 1e-9), residual / torch.clamp(rsum, min=1e-30), t_at
        )
        noise = gumbel_noise(seeds, pos0 + n_acc, vocab, CORRECT)
        sampled_corr = torch.argmax(torch.log(torch.clamp(corr_dist, min=1e-30)) + noise, dim=-1)
    corr = greedy_choices.gather(1, n_acc[:, None])[:, 0]
    if sampling:
        corr = torch.where(stoch, sampled_corr, corr)
    padded = torch.cat([props, torch.zeros((b, 1), dtype=props.dtype, device=props.device)], dim=1)
    at_corr = torch.arange(k + 1, device=props.device)[None] == n_acc[:, None]
    return torch.where(at_corr, corr[:, None], padded), n_acc + 1


def _verify(params, cache, block, positions, cfg):
    """Target scores the whole block -> (greedy choices [B, K], cache)."""
    logits, kv = tfm.decode_block(params, cache, block, positions, cfg)
    return torch.argmax(logits, dim=-1), kv


def generate_speculative(
    target_params: dict,
    draft_params: dict,
    prompt: torch.Tensor,
    target_cfg: tfm.TransformerConfig,
    draft_cfg: tfm.TransformerConfig,
    max_new_tokens: int,
    k: int = 4,
) -> tuple[torch.Tensor, SpecStats]:
    """Greedy speculative generation -> (tokens [B, max_new_tokens],
    stats). The output is exactly ``tfm.generate(target_params, prompt,
    target_cfg, max_new_tokens)`` (greedy losslessness). ``prompt`` is
    [B, T_prompt]; both models prefill it in one full-sequence forward."""
    b, t_prompt = prompt.shape
    dev = prompt.device
    # Cache horizon: a FROZEN sequence (n >= max_new) keeps riding
    # draft/verify rounds while slower batchmates finish, writing
    # positions pos0..pos0+k every round at its frozen
    # pos0 = t_prompt + n - 1 <= t_prompt + max_new + k - 1 (commits can
    # overshoot max_new by up to k), so the largest write position is
    # t_prompt + max_new + 2k - 1 and the horizon covers it: an
    # out-of-range write raises here
    horizon = t_prompt + max_new_tokens + 2 * k
    with torch.no_grad():
        t_logits, t_kv = tfm.forward(target_params, prompt, target_cfg, return_kv=True)
        _, d_kv = tfm.forward(draft_params, prompt, draft_cfg, return_kv=True)

        def seed(cfg, kv):
            cache = tfm.init_kv_cache(cfg, b, horizon, device=dev)
            cache["k"][:, :, :t_prompt] = kv[0]
            cache["v"][:, :, :t_prompt] = kv[1]
            cache["length"] = t_prompt
            return cache

        t_cache = seed(target_cfg, t_kv)
        d_cache = seed(draft_cfg, d_kv)

        out = np.zeros((b, max_new_tokens + k + 1), np.int64)
        out[:, 0] = torch.argmax(t_logits[:, -1], dim=-1).cpu().numpy()
        n = np.ones((b,), np.int64)  # committed tokens per sequence
        stats = SpecStats()
        steps = torch.arange(k + 1, device=dev)

        while int(n.min()) < max_new_tokens:
            cur = torch.from_numpy(out[np.arange(b), n - 1]).to(dev)  # last committed
            pos0 = torch.from_numpy(t_prompt + n - 1).to(dev)  # its position
            props, d_cache = _draft_propose(draft_params, d_cache, cur, pos0, draft_cfg, k)
            # verification block: [last committed, prop_0..prop_{k-1}] at
            # positions pos0..pos0+k; choice[:, j] is the target's token
            # for position pos0+j+1, compared with prop_j; choice[:, k] is
            # the bonus token when everything matches
            block = torch.cat([cur[:, None], props], dim=1)
            choices, _ = _verify(target_params, t_cache, block, pos0[:, None] + steps[None],
                                 target_cfg)
            # one readback per round for both arrays
            both = torch.cat([props, choices], dim=1).cpu().numpy()
            props_h, choices_h = both[:, :k], both[:, k:]
            match = props_h == choices_h[:, :k]
            accepts = np.where(match.all(axis=1), k, match.argmin(axis=1))
            round_accepts = []
            for s in range(b):
                if n[s] >= max_new_tokens:
                    # finished sequences freeze: no commits, no stats, no
                    # growth past the out buffer or the cache horizon
                    round_accepts.append(-1)
                    continue
                a = int(accepts[s])
                out[s, n[s]: n[s] + a] = props_h[s, :a]
                out[s, n[s] + a] = choices_h[s, a]
                n[s] += a + 1
                stats.accepted += a
                stats.committed += a + 1
                stats.proposed += k
                round_accepts.append(a)
            stats.rounds += 1
            stats.accept_hist.append(round_accepts)

    return torch.from_numpy(out[:, :max_new_tokens]).to(dev), stats
