"""Token sampling on the device: greedy, temperature, top-k and top-p.

Counterpart of ``engine.sample_logits`` and
``speculative.filter_scaled_logits`` in ``devspace_tpu/inference``, over
a batch of rows with per-row parameters. Temperature <= 0 is greedy.

Randomness is counter-based: the draw for a row is Gumbel-max over
uniforms hashed from (seed, position, purpose, token id), so a request's
stream depends only on its seed and on the absolute position it samples
from — never on which other requests share the batch, the decode chunk
size, or where a preemption landed. (The reference keys
``fold_in(PRNGKey(seed), position)`` the same way; its threefry bits
cannot be reproduced here.) ``purpose`` separates the draws one position
can need: the plain decode sample, and the three of a speculative round
(the draft's proposal, the accept test, the corrected token), which a
replayed round draws again unchanged.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# what a draw is for (``purpose``); PLAIN leaves the hash as it was
PLAIN, DRAFT, ACCEPT, CORRECT = 0, 1, 2, 3


def filter_scaled_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """logits [B, V]; temperature/top_k/top_p [B]. Temperature-scale each
    row and mask it to its top-k/top-p keep set (-inf outside).
    ``top_k == 0`` and ``top_p >= 1`` disable their filters. Top-k keeps
    logits >= the k-th largest; top-p keeps tokens whose probability mass
    before them (sorted descending) is < top_p — the shifted-cumsum form
    always keeps at least one token."""
    logits = logits.float()
    vocab = logits.shape[-1]
    scaled = logits / torch.clamp(temperature.float(), min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (top_k.long() - 1).clamp(0, vocab - 1)[:, None])
    keep_k = (top_k <= 0)[:, None] | (scaled >= kth)
    probs_desc = torch.softmax(sorted_desc, dim=-1)
    shifted = torch.cumsum(probs_desc, dim=-1) - probs_desc
    count = (shifted < top_p.float()[:, None]).sum(dim=-1)
    p_threshold = sorted_desc.gather(-1, (count - 1).clamp(0, vocab - 1)[:, None])
    keep_p = (top_p >= 1.0)[:, None] | (scaled >= p_threshold)
    return scaled.masked_fill(~(keep_k & keep_p), float("-inf"))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer over int64 tensors holding uint32
    values; every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def _row_hash(seeds: torch.Tensor, positions: torch.Tensor, purpose: int) -> torch.Tensor:
    h = _mix32((seeds.long() & _M32) ^ 0x2545F491)
    h = _mix32(h ^ (positions.long() & _M32))
    return _mix32(h ^ (purpose * 0x9E3779B1 & _M32)) if purpose else h


def _unit(h: torch.Tensor) -> torch.Tensor:
    """23 bits of a hash -> a uniform strictly inside (0, 1), exact in
    float32."""
    return ((h >> 9).float() + 0.5) / float(1 << 23)


def uniform_noise(seeds: torch.Tensor, positions: torch.Tensor, purpose: int = PLAIN) -> torch.Tensor:
    """One uniform in (0, 1) per row: a pure function of (seed, position,
    purpose). ``seeds`` and ``positions`` have one shape, the result's."""
    return _unit(_mix32(_row_hash(seeds, positions, purpose) ^ 0x5BD1E995))


def gumbel_noise(
    seeds: torch.Tensor, positions: torch.Tensor, vocab: int, purpose: int = PLAIN
) -> torch.Tensor:
    """[B, vocab] standard Gumbel noise, a pure function of (seed,
    position, purpose, token id) per element."""
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _mix32(_row_hash(seeds, positions, purpose)[:, None] ^ ids[None, :])
    return -torch.log(-torch.log(_unit(h)))


def sample_tokens(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,
    positions: torch.Tensor,
    sampling: bool = True,
    filters: bool = True,
) -> torch.Tensor:
    """One token per row of logits [B, V] -> int64 [B]. Rows with
    temperature <= 0 take the argmax. ``sampling=False`` (no row samples)
    and ``filters=False`` (no row uses top-k/top-p) skip work whose
    result would be discarded; they never change a row's token."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    if filters:
        scaled = filter_scaled_logits(logits, temperature, top_k, top_p)
    else:
        scaled = logits.float() / torch.clamp(temperature.float(), min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel_noise(seeds, positions, logits.shape[-1]), dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
