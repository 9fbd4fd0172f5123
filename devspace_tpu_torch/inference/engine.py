"""Continuous-batching inference engine (iteration-level scheduling).

Counterpart of ``devspace_tpu/inference/engine.py`` as that engine runs
with ``prefix_cache=False``, ``kv_tier=None``, ``dispatch_depth=1`` and
``metrics=False``:

- **Paged KV cache** (vLLM-style): K/V live in a block pool
  ``[layers, n_blocks, kv_heads, block_size, head_dim]`` with per-slot
  block tables, so device memory is bounded by the pool, not by
  ``max_slots x max_len``. Blocks are allocated as sequences grow; when
  the pool runs dry the youngest request is preempted (recompute-style:
  requeued with its generated prefix) so older requests always finish.
  Block 0 is scratch: unallocated table entries and parked writes land
  there.
- **Chunked prefill, interleaved**: prompts prefill in bounded chunks
  (``prefill_chunk`` tokens, power-of-two final chunks), one chunk per
  scheduler iteration between decode chunks, so co-resident decodes keep
  streaming while a long prompt is admitted.
- **Device-side sampling + chunked decode**: up to ``chunk_max`` decode
  steps run per dispatch, with logit bias, EOS suppression below
  ``min_new_tokens`` and sampling on the device, and ONE readback per
  chunk. A slot that finishes mid-chunk wastes at most chunk_max-1
  tokens (truncated host-side; every position is rewritten in the same
  step that first attends to it).
- **Speculative decoding** (with ``draft_params``): slots that have a
  seeded draft cache ride one speculative dispatch per iteration — the
  draft proposes ``spec_k`` tokens per slot from a dense per-slot cache,
  the target scores them in ONE paged verification block
  (``decode_block_paged``) and 1..``spec_k``+1 tokens commit per slot;
  the other ready slots take the plain decode chunk in the same
  iteration. Greedy streams are those of plain decoding, token for token.

Every decode step's and every verification block's attention runs
through the paged-decode CUDA kernel when the engine lives on the card
(``ops/paged_attention.py``), and the draft's prefill through the
short-sequence attention kernel (``ops/attention.py``).
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer as tfm
from .sampling import sample_tokens
from .speculative import _draft_propose, _draft_propose_sampled, spec_accept_commit

log = logging.getLogger(__name__)


@dataclass
class Request:
    prompt_ids: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # >= 1 = disabled
    # token-id sequences that end generation; the matched suffix is
    # stripped from result() (stream() may have already yielded it)
    stop: Optional[list[list[int]]] = None
    # EOS (and stop sequences) are ignored until this many tokens have
    # been generated; EOS is additionally suppressed on the device so the
    # model keeps producing real tokens instead of repeated EOS
    min_new_tokens: int = 0
    # token id -> additive logit bias, applied before sampling every
    # generated token (use -inf/+inf floats to forbid/force tokens)
    logit_bias: Optional[dict[int, float]] = None
    # set at finish when a stop-sequence match is stripped: result()
    # slices to this length; ``tokens`` itself is never shrunk because a
    # stream() consumer in another thread may be mid-iteration over it
    result_len: Optional[int] = None
    # filled by the engine
    tokens: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    # host clock (time.monotonic) at submit and at the first token
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    # wakes stream() consumers on every emitted token and on completion
    _cond: threading.Condition = field(default_factory=threading.Condition, repr=False)

    def _notify(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def result(self, timeout: Optional[float] = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error:
            raise RuntimeError(self.error)
        if self.result_len is not None:
            return self.tokens[: self.result_len]
        return self.tokens

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated (in bursts of up to
        chunk_max). Raises like ``result`` on error, and TimeoutError
        when no NEW token arrives within ``timeout``."""
        sent = 0
        while True:
            with self._cond:
                while len(self.tokens) <= sent and not self.done.is_set():
                    if not self._cond.wait(timeout):
                        raise TimeoutError("generation stalled")
                n = len(self.tokens)
                finished = self.done.is_set()
            while sent < n:
                yield self.tokens[sent]
                sent += 1
            if finished:
                if self.error:
                    raise RuntimeError(self.error)
                if sent >= len(self.tokens):
                    return


class _Slot:
    __slots__ = ("req", "length", "remaining", "last_token", "ready",
                 "prefill_pos", "prompt", "admitted_at", "draft_ready")

    def __init__(self):
        self.req: Optional[Request] = None
        self.ready = False
        self.draft_ready = False


class InferenceEngine:
    """Continuous-batching engine over ``max_slots`` concurrent sequences.

    ``submit()`` is thread-safe and returns the Request whose ``result()``
    blocks until generation completes. ``start()`` spawns the scheduler
    thread; ``stop()`` joins it and fails whatever is unfinished.

    ``block_size``/``n_blocks`` size the paged KV pool: device memory for
    K/V is ``2 x layers x n_blocks x block_size x kv_heads x head_dim``
    elements. The default pool holds full capacity (every slot at
    max_len); a smaller ``n_blocks`` oversubscribes, and preemption
    bounds the worst case. ``kv_dtype="int8"`` stores the pool quantized
    (per-token per-head scales): half the bytes, at ~0.5% quantization
    noise in attention reads, so greedy near-ties can flip.

    ``draft_params``/``draft_cfg`` turn on speculative decoding: slots
    whose draft cache is seeded, that use no ``logit_bias``, are past
    their ``min_new_tokens`` and are far enough from max_len ride a
    speculative dispatch (``spec_k`` draft tokens + one paged verify
    block, ``spec_depth`` such rounds chained per dispatch with ONE
    readback), committing 1..k+1 tokens per round; everything else takes
    the plain decode chunk in the same iteration. The draft keeps a DENSE
    per-slot cache (paging bounds the target's K/V; a draft is small).
    Greedy requests commit only the target's argmax choices, so the
    stream never depends on the draft, which only changes how many tokens
    commit per round; sampled requests commit through speculative
    sampling, distributed as plain sampling from the target.

    ``device`` is where the engine runs: ``None`` means cuda and raises
    without it; ``"cpu"`` runs the plain PyTorch path. ``params`` (and
    ``draft_params``) must already live there (see
    ``models.transformer.init_params`` and
    ``models.convert.params_from_numpy``)."""

    def __init__(
        self,
        params: dict,
        cfg: tfm.TransformerConfig,
        max_slots: int = 8,
        max_len: Optional[int] = None,
        chunk_max: int = 8,
        block_size: int = 64,
        n_blocks: Optional[int] = None,
        prefill_chunk: int = 512,
        kv_dtype: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        draft_params: Optional[dict] = None,
        draft_cfg: Optional[tfm.TransformerConfig] = None,
        spec_k: int = 4,
        spec_depth: int = 1,
    ):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, engine runs on {self.device}"
            )
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.params = params
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.block_size = int(block_size)
        self.max_blocks = math.ceil(self.max_len / self.block_size)
        # +1: block 0 is reserved scratch
        self.n_blocks = int(n_blocks) if n_blocks else 1 + self.max_slots * self.max_blocks
        if self.n_blocks < 1 + self.max_blocks:
            raise ValueError(
                f"n_blocks {self.n_blocks} cannot hold even one max_len "
                f"sequence ({1 + self.max_blocks} needed)"
            )
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.chunk_max = max(1, int(chunk_max))
        self.kv_dtype = kv_dtype
        self.pool = self._fresh_pool()
        # speculative decoding state (unused when there is no draft model)
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        if draft_params is not None and draft_params["embed"].device != self.device:
            raise ValueError(
                f"draft params live on {draft_params['embed'].device}, engine runs on {self.device}"
            )
        if spec_k < 1 or spec_k > 16:
            raise ValueError("spec_k must be in 1..16")
        if spec_depth < 1 or spec_depth > 16:
            raise ValueError("spec_depth must be in 1..16")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = int(spec_k)
        self.spec_depth = int(spec_depth)
        # the spec counters all measure REPLAYED slot-rounds (rounds whose
        # commits the host consumed), so rounds/proposed/accepted stay
        # mutually consistent when a slot finishes mid-dispatch
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.spec_dispatches = 0
        # host clock over the parts of every spec dispatch: enqueueing the
        # draft scans, enqueueing the verify blocks with their accept
        # rule, and the readback (which waits for the device)
        self.spec_draft_s = 0.0
        self.spec_verify_s = 0.0
        self.spec_readback_s = 0.0
        self.draft_prefills = 0
        self._draft_cache = self._fresh_draft_cache()
        # host-side allocator state
        self._free_blocks: list[int] = list(range(1, self.n_blocks))
        self._tables = np.zeros((self.max_slots, self.max_blocks), np.int32)
        self._nalloc = [0] * self.max_slots
        self.slots = [_Slot() for _ in range(self.max_slots)]
        self.pending: queue.Queue[Request] = queue.Queue()
        self._resume: list[Request] = []  # preempted, re-admit first
        # per-slot sampling state: the seed keys every draw of the slot's
        # request (see inference/sampling.py); the extras live on the
        # device and change only at admission (_sync_sampling_extras)
        self._seeds = np.zeros((self.max_slots,), np.int64)
        B, V = self.max_slots, cfg.vocab_size
        self._eos_ids = torch.full((B,), -1, dtype=torch.int64, device=self.device)
        self._min_until = torch.zeros((B,), dtype=torch.int64, device=self.device)
        self._logit_bias = torch.zeros((B, V), dtype=torch.float32, device=self.device)
        self._vocab_ids = torch.arange(V, device=self.device)
        self._extras_dirty = [False] * B
        # serving counters (read via stats(); mutated by the scheduler
        # thread and — for fail-outs — by stop(); read-atomic under the GIL)
        self._started_at: Optional[float] = None
        self.requests_completed = 0
        self.requests_failed = 0
        self.requests_preempted = 0
        self.tokens_generated = 0
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.readback_wait_s = 0.0
        self._stop = threading.Event()
        # serializes submit's check+put against stop's set+drain
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._prefill_cursor = -1  # rotating prefill pick (see _loop)

    def _fresh_pool(self) -> dict:
        return tfm.init_paged_pool(
            self.cfg, self.n_blocks, self.block_size, self.kv_dtype, self.device
        )

    def _fresh_draft_cache(self) -> Optional[dict]:
        """The draft's dense cache, one row per slot, with a scratch TAIL
        of ``spec_k + 1`` positions past max_len: a parked slot's propose
        loop still writes k+1 K/V entries into its own row, and pointing
        parked rows at position max_len lands those writes in the tail,
        which no live position ever reads (eligibility caps live writes
        at max_len - 1). Without the tail a spec round in the iteration
        that completed a peer's draft prefill would overwrite that row's
        freshly seeded prompt K/V."""
        if self.draft_params is None:
            return None
        return tfm.init_kv_cache(
            self.draft_cfg, self.max_slots, self.max_len + self.spec_k + 1, self.device
        )

    # -- public API --------------------------------------------------------
    def submit(
        self,
        prompt_ids: list[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop: Optional[list[list[int]]] = None,
        min_new_tokens: int = 0,
        logit_bias: Optional[dict[int, float]] = None,
    ) -> Request:
        if not prompt_ids:
            raise ValueError("empty prompt")
        vocab = self.cfg.vocab_size
        prompt_ids = [int(t) for t in prompt_ids]
        if any(not 0 <= t < vocab for t in prompt_ids):
            raise ValueError(f"prompt token ids must be in [0, {vocab})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+generation ({len(prompt_ids)}+{max_new_tokens}) "
                f"exceeds max_len {self.max_len}"
            )
        if top_k < 0 or top_p <= 0.0:
            raise ValueError("need top_k >= 0 and top_p > 0 (>= 1 disables)")
        if stop is not None:
            stop = [list(map(int, s)) for s in stop]
            if not stop or any(not s for s in stop):
                raise ValueError("stop must be non-empty token-id sequences")
        if not 0 <= min_new_tokens <= max_new_tokens:
            raise ValueError("need 0 <= min_new_tokens <= max_new_tokens")
        if eos_id is not None and not 0 <= int(eos_id) < vocab:
            raise ValueError(f"eos_id must be in [0, {vocab})")
        if logit_bias is not None:
            logit_bias = {int(t): float(b) for t, b in logit_bias.items()}
            if any(not 0 <= t < vocab for t in logit_bias):
                raise ValueError(f"logit_bias token ids must be in [0, {vocab})")
        req = Request(
            prompt_ids,
            int(max_new_tokens),
            float(temperature),
            None if eos_id is None else int(eos_id),
            int(seed),
            top_k=int(top_k),
            top_p=float(top_p),
            stop=stop,
            min_new_tokens=int(min_new_tokens),
            logit_bias=logit_bias,
            submitted_at=time.monotonic(),
        )
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            self.pending.put(req)
        return req

    def start(self) -> "InferenceEngine":
        self._started_at = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler and fail out any unfinished requests so no
        caller blocks forever on a dead engine."""
        with self._submit_lock:
            self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
        self._fail_outstanding("engine stopped")

    def stats(self) -> dict:
        """Serving counters: requests, tokens, slots, pool, queue depth,
        uptime, mean tokens/sec, decode dispatch/step counts, and the
        speculative rounds, proposals, acceptances, commits, dispatches,
        the host seconds of a dispatch's parts (draft, verify, readback)
        and draft prefills."""
        uptime = time.monotonic() - self._started_at if self._started_at else 0.0
        return {
            "requests_completed": self.requests_completed,
            "requests_failed": self.requests_failed,
            "requests_preempted": self.requests_preempted,
            "tokens_generated": self.tokens_generated,
            "active_slots": sum(1 for s in self.slots if s.req is not None and s.ready),
            "prefilling_slots": sum(1 for s in self.slots if s.req is not None and not s.ready),
            "max_slots": self.max_slots,
            "free_blocks": len(self._free_blocks),
            "total_blocks": self.n_blocks - 1,
            "queued": self.pending.qsize() + len(self._resume),
            "uptime_s": round(uptime, 1),
            "tokens_per_sec": round(self.tokens_generated / uptime, 2) if uptime > 0 else 0.0,
            "dispatch_depth": 1,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "readback_wait_s": round(self.readback_wait_s, 4),
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_committed": self.spec_committed,
            "spec_acceptance": (
                round(self.spec_accepted / self.spec_proposed, 4) if self.spec_proposed else 0.0
            ),
            "spec_dispatches": self.spec_dispatches,
            "spec_draft_s": round(self.spec_draft_s, 4),
            "spec_verify_s": round(self.spec_verify_s, 4),
            "spec_readback_s": round(self.spec_readback_s, 4),
            "draft_prefills": self.draft_prefills,
        }

    # -- block allocator ---------------------------------------------------
    def _blocks_needed(self, slot_idx: int, upto: int) -> int:
        """Blocks to add so slot covers logical positions [0, upto)."""
        return max(0, math.ceil(upto / self.block_size) - self._nalloc[slot_idx])

    def _alloc(self, slot_idx: int, upto: int) -> bool:
        """Grow slot's table to cover [0, upto). False if the pool is
        exhausted."""
        need = self._blocks_needed(slot_idx, upto)
        if need > len(self._free_blocks):
            return False
        for _ in range(need):
            self._tables[slot_idx, self._nalloc[slot_idx]] = self._free_blocks.pop()
            self._nalloc[slot_idx] += 1
        return True

    def _free_slot_blocks(self, slot_idx: int) -> None:
        n = self._nalloc[slot_idx]
        self._free_blocks.extend(int(b) for b in self._tables[slot_idx, :n])
        self._tables[slot_idx, :] = 0
        self._nalloc[slot_idx] = 0

    def _reset_pool(self) -> None:
        """Fresh pool + allocator state after a failed decode dispatch."""
        self.pool = self._fresh_pool()
        self._reset_draft_cache()
        self._free_blocks = list(range(1, self.n_blocks))
        self._tables[:] = 0
        self._nalloc = [0] * self.max_slots

    # -- scheduler ---------------------------------------------------------
    @staticmethod
    def _finish(req: Request) -> None:
        """Terminal wakeup: set done, then wake stream() waiters."""
        req.done.set()
        req._notify()

    def _fail(self, req: Request, reason: str) -> None:
        req.error = reason
        self.requests_failed += 1
        self._finish(req)

    def _fail_outstanding(self, reason: str, drain_queue: bool = True) -> None:
        """Fail slot-resident requests (their K/V lives in the pool).
        ``drain_queue=False`` spares queued requests that were never
        admitted — a rebuilt pool can still serve them; only stop()
        drains the queue."""
        for i, slot in enumerate(self.slots):
            req = slot.req
            if req is None:
                continue
            slot.req = None
            slot.ready = False
            self._free_slot_blocks(i)
            if not req.done.is_set():
                self._fail(req, reason)
        if not drain_queue:
            return
        for req in self._resume:
            self._fail(req, reason)
        self._resume.clear()
        while True:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            self._fail(req, reason)

    @staticmethod
    def _pow2_buckets(limit: int, include_limit: bool = True) -> list[int]:
        """Power-of-two sizes up to ``limit`` (plus ``limit`` itself when
        ``include_limit`` and it is not one)."""
        if limit < 1:
            raise ValueError(f"_pow2_buckets needs limit >= 1, got {limit}")
        out = [1]
        while out[-1] * 2 <= limit:
            out.append(out[-1] * 2)
        if include_limit and out[-1] != limit:
            out.append(limit)
        return out

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.prefill_chunk)

    def _pick_chunk(self, n: int) -> int:
        """Largest power-of-two chunk size <= min(n, chunk_max)."""
        return self._pow2_buckets(min(n, self.chunk_max), include_limit=False)[-1]

    def _admit(self, slot_idx: int, req: Request) -> bool:
        """Assign a slot and allocate blocks for the prompt (prefill runs
        chunk by chunk in the scheduler loop). False, leaving the request
        queued, when the pool cannot hold the prompt right now."""
        prompt = req.prompt_ids + req.tokens  # tokens: preempted resume
        if not self._alloc(slot_idx, len(prompt)):
            return False
        slot = self.slots[slot_idx]
        slot.req = req
        slot.prompt = prompt
        slot.prefill_pos = 0
        slot.ready = False
        slot.draft_ready = False
        slot.length = len(prompt)
        slot.remaining = req.max_new_tokens - len(req.tokens)
        slot.admitted_at = time.monotonic()
        self._sync_sampling_extras(slot_idx, req)
        return True

    def _sync_sampling_extras(self, slot_idx: int, req: Request) -> None:
        """Refresh this slot's device-side sampling extras (EOS
        suppression bound + logit bias row) — skipped while neither the
        new request nor the slot's previous occupant used them."""
        uses_min = req.eos_id is not None and req.min_new_tokens > 0
        uses = uses_min or bool(req.logit_bias)
        if not uses and not self._extras_dirty[slot_idx]:
            return
        # EOS is suppressed while the WRITE position is below this bound:
        # generated token g is sampled at position len(prompt_ids)-2+g,
        # and tokens 1..min_new must not be EOS (absolute positions, so
        # preemption-resume keeps the bound)
        self._eos_ids[slot_idx] = req.eos_id if uses_min else -1
        self._min_until[slot_idx] = (
            len(req.prompt_ids) + req.min_new_tokens - 1 if uses_min else 0
        )
        self._logit_bias[slot_idx] = torch.from_numpy(self._bias_row(req)).to(self.device)
        self._extras_dirty[slot_idx] = uses

    def _bias_row(self, req: Request) -> np.ndarray:
        """The request's dense [vocab] additive-bias row — the one place
        logit_bias becomes an array (device rows and the first-token
        sample must agree)."""
        bias = np.zeros(self.cfg.vocab_size, np.float32)
        if req.logit_bias:
            for t, b in req.logit_bias.items():
                bias[t] = b
        return bias

    def _prefill_one_chunk(self, slot_idx: int) -> None:
        """Advance one slot's prefill by at most ``prefill_chunk`` tokens.
        On the final chunk, sample the first generated token."""
        slot = self.slots[slot_idx]
        req = slot.req
        t = len(slot.prompt)
        offset = slot.prefill_pos
        remaining = t - offset
        c = self.prefill_chunk if remaining >= self.prefill_chunk else self._bucket(remaining)
        # the chunk's positions must stay inside the slot's table span —
        # an overshooting pad tail would clamp into the prompt's last
        # block. Shrink by whole buckets, keeping the shape set small.
        t_alloc = self.max_blocks * self.block_size
        if c > t_alloc - offset:
            c = self._pow2_buckets(t_alloc - offset, include_limit=False)[-1]
        real = min(remaining, c)
        chunk = slot.prompt[offset: offset + real] + [0] * (c - real)
        dev = self.device
        logits, _ = tfm.prefill_chunk_paged(
            self.params,
            self.pool,
            torch.from_numpy(self._tables[slot_idx].copy()).to(dev),
            torch.tensor(chunk, dtype=torch.int64, device=dev),
            offset,
            self.cfg,
        )
        slot.prefill_pos = offset + real
        if slot.prefill_pos < t:
            return
        # prefill complete: the first token samples from the last REAL
        # position, keyed by that position (t-1) — on preemption resume
        # (prompt = prompt_ids + generated) the same key the uninterrupted
        # run used for that token
        self._seeds[slot_idx] = req.seed
        lg = logits[real - 1: real]
        if req.logit_bias:
            lg = lg + torch.from_numpy(self._bias_row(req)).to(dev)
        if req.eos_id is not None and len(req.tokens) < req.min_new_tokens:
            lg = lg.clone()
            lg[0, req.eos_id] = float("-inf")
        first = sample_tokens(
            lg,
            torch.tensor([req.temperature], device=dev),
            torch.tensor([req.top_k], device=dev),
            torch.tensor([req.top_p], device=dev),
            torch.tensor([req.seed], device=dev),
            torch.tensor([t - 1], device=dev),
            sampling=req.temperature > 0,
            filters=req.top_k > 0 or req.top_p < 1.0,
        )
        if self.draft_params is not None and not req.logit_bias:
            # logit_bias slots never ride a spec round, so their draft
            # prefill would be dead work; min_new_tokens slots become
            # eligible later, so theirs pays off
            self._draft_prefill(slot_idx)
        slot.ready = True
        self._emit(slot_idx, int(first[0]))

    def _draft_prefill(self, slot_idx: int) -> None:
        """Seed the slot's dense draft-cache row with ONE full-sequence
        draft forward over the prompt padded with token 0 to a power of
        two (clamped at max_len), which bounds the set of shapes. Causal
        masking keeps the real rows clean, and the pad tail's K/V is
        rewritten by the propose loop before anything attends it."""
        slot = self.slots[slot_idx]
        t = len(slot.prompt)
        c = 1
        while c < t:
            c *= 2
        c = min(c, self.max_len)
        toks = torch.tensor(slot.prompt + [0] * (c - t), dtype=torch.int64, device=self.device)
        _, (dk, dv) = tfm.forward(self.draft_params, toks[None], self.draft_cfg, return_kv=True)
        self._draft_cache["k"][:, slot_idx, :c] = dk[:, 0]
        self._draft_cache["v"][:, slot_idx, :c] = dv[:, 0]
        self.draft_prefills += 1
        slot.draft_ready = True

    def _reset_draft_cache(self) -> None:
        """After a failed dispatch that may have left partial writes:
        rebuild the draft cache empty and stop speccing resident slots
        (they go on with plain decode; no stream depends on draft state)."""
        if self.draft_params is None:
            return
        self._draft_cache = self._fresh_draft_cache()
        for s in self.slots:
            s.draft_ready = False

    def _spec_eligible(self, ready: list[int]) -> list[int]:
        """Slots riding this iteration's speculative dispatch: draft cache
        seeded, far enough from max_len that a depth-R verification
        window fits, and using no per-slot sampling extras (the spec
        round samples without them: biased slots would commit unbiased
        tokens, and min-length slots could commit a suppressed EOS; both
        take the plain path, which applies them)."""
        if self.draft_params is None:
            return []
        # a depth-R dispatch can advance R*(k+1) tokens; its last verify
        # write lands at length-2 + R*(k+1), which must stay inside
        # max_len (R=1 reduces to length+k <= max_len)
        spec_span = self.spec_depth * (self.spec_k + 1)
        return [
            i
            for i in ready
            if self.slots[i].draft_ready
            and self.slots[i].length + spec_span - 1 <= self.max_len
            and not self.slots[i].req.logit_bias
            and len(self.slots[i].req.tokens) >= self.slots[i].req.min_new_tokens
        ]

    def _run_spec_round(self, spec_idx: list[int]) -> None:
        """One speculative dispatch for the ``spec_idx`` slots:
        ``spec_depth`` chained rounds, each the draft's ``spec_k``
        proposals per slot (sampled for temperature > 0 rows), ONE paged
        verification block on the target and the accept/correct rule on
        the device, which also advances each active slot's current token
        and positions between rounds; then ONE readback and the host-side
        emits. Every other row is parked: zeroed table and verify
        positions from 0 (writes land in scratch block 0), draft
        positions from max_len (the cache's scratch tail); its outputs
        are discarded and its positions never move. A rejected position's
        K/V is overwritten by the next round's writes before anything
        attends it."""
        B, dev, k = self.max_slots, self.device, self.spec_k
        active = np.zeros((B,), bool)
        active[spec_idx] = True
        # token, draft position, verify position, top_k, seed
        ints = np.zeros((B, 5), np.int64)
        ints[:, 1] = self.max_len
        floats = np.zeros((B, 2), np.float32)  # temperature, top_p
        floats[:, 1] = 1.0
        for i in spec_idx:
            s = self.slots[i]
            ints[i] = (s.last_token, s.length - 1, s.length - 1, s.req.top_k, self._seeds[i])
            floats[i] = (s.req.temperature, s.req.top_p)
        tables = torch.from_numpy(np.where(active[:, None], self._tables, 0)).to(dev)
        cur, pos_d, pos_v, top_ks, seeds = torch.from_numpy(ints).to(dev).unbind(1)
        temps, top_ps = torch.from_numpy(floats).to(dev).unbind(1)
        live = torch.from_numpy(active).to(dev)
        reqs = [self.slots[i].req for i in spec_idx]
        sampling = any(r.temperature > 0 for r in reqs)
        filters = any(r.temperature > 0 and (r.top_k > 0 or r.top_p < 1.0) for r in reqs)
        steps = torch.arange(k + 1, device=dev)
        rounds = []
        for _ in range(self.spec_depth):
            t0 = time.monotonic()
            if sampling:
                props, d_probs, _ = _draft_propose_sampled(
                    self.draft_params, self._draft_cache, cur, pos_d, self.draft_cfg, k,
                    seeds, temps)
            else:
                d_probs = None
                props, _ = _draft_propose(
                    self.draft_params, self._draft_cache, cur, pos_d, self.draft_cfg, k)
            t1 = time.monotonic()
            self.spec_draft_s += t1 - t0
            block = torch.cat([cur[:, None], props], dim=1)
            logits, _ = tfm.decode_block_paged(
                self.params, self.pool, tables, block, pos_v[:, None] + steps[None], self.cfg)
            commit, n_commit = spec_accept_commit(
                props, d_probs, logits, temps, seeds, pos_v, top_ks, top_ps, use_filters=filters)
            rounds.append(torch.cat([commit, n_commit[:, None]], dim=1))
            # the corrected/bonus token (the last committed) seeds the
            # next round
            new_cur = commit.gather(1, (n_commit - 1)[:, None])[:, 0]
            cur = torch.where(live, new_cur, cur)
            pos_d = torch.where(live, pos_d + n_commit, pos_d)
            pos_v = torch.where(live, pos_v + n_commit, pos_v)
            self.spec_verify_s += time.monotonic() - t1
        t0 = time.monotonic()
        out = torch.stack(rounds).cpu().numpy()  # [R, B, k+2]: the one readback
        waited = time.monotonic() - t0
        self.readback_wait_s += waited
        self.spec_readback_s += waited
        self.spec_dispatches += 1
        for i in spec_idx:
            for r in range(self.spec_depth):
                if self.slots[i].req is None:
                    break  # finished mid-dispatch; later rounds are discarded
                n = int(out[r, i, k + 1])
                # accepted/proposed measure the draft-match rate: raw
                # n - 1, not capped by how many tokens the request had
                # room to commit; spec_committed counts actual emits
                self.spec_rounds += 1
                self.spec_proposed += k
                self.spec_accepted += n - 1
                for j in range(n):
                    if self.slots[i].req is None:
                        break  # hit EOS / max_new mid-commit
                    self._emit(i, int(out[r, i, j]))
                    self.spec_committed += 1

    def _decode_chunk(self, plain: list[int], k_steps: int) -> None:
        """``k_steps`` decode steps for the ``plain`` slots (every other
        row is parked: all-zero table, so its writes land in scratch
        block 0), sampling on the device, then ONE readback and the
        host-side emits."""
        B, dev = self.max_slots, self.device
        active = np.zeros((B,), bool)
        active[plain] = True
        ints = np.zeros((B, 4), np.int64)  # token, position, top_k, seed
        floats = np.zeros((B, 2), np.float32)  # temperature, top_p
        floats[:, 1] = 1.0
        for i in plain:
            s = self.slots[i]
            ints[i] = (s.last_token, s.length - 1, s.req.top_k, self._seeds[i])
            floats[i] = (s.req.temperature, s.req.top_p)
        tables = torch.from_numpy(np.where(active[:, None], self._tables, 0)).to(dev)
        tok, pos, top_ks, seeds = torch.from_numpy(ints).to(dev).unbind(1)
        temps, top_ps = torch.from_numpy(floats).to(dev).unbind(1)
        reqs = [self.slots[i].req for i in plain]
        sampling = any(r.temperature > 0 for r in reqs)
        filters = any(r.top_k > 0 or r.top_p < 1.0 for r in reqs)
        steps = []
        for _ in range(k_steps):
            logits, _ = tfm.decode_tokens_paged(self.params, self.pool, tables, tok, pos, self.cfg)
            # extras: additive bias, then EOS suppression for slots below
            # min_new_tokens (pos is the position being written)
            logits = logits + self._logit_bias
            suppress = (pos < self._min_until)[:, None] & (
                self._vocab_ids[None, :] == self._eos_ids[:, None]
            )
            logits = logits.masked_fill(suppress, float("-inf"))
            tok = sample_tokens(logits, temps, top_ks, top_ps, seeds, pos, sampling, filters)
            steps.append(tok)
            # the clamp keeps a parked row from indexing past its table
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
        t0 = time.monotonic()
        toks = torch.stack(steps).cpu().numpy()  # [k_steps, B]: the one readback
        self.readback_wait_s += time.monotonic() - t0
        self.decode_dispatches += 1
        self.decode_steps += k_steps
        for i in plain:
            for j in range(k_steps):
                if self.slots[i].req is None:
                    break  # finished mid-chunk; the rest is overshoot
                self._emit(i, int(toks[j, i]))

    def _preempt_youngest(self, keep: int) -> bool:
        """Free the most recently admitted slot other than ``keep``
        (ready OR mid-prefill), requeueing its request with its generated
        prefix. False with nothing to preempt."""
        candidates = [
            (i, s) for i, s in enumerate(self.slots) if s.req is not None and i != keep
        ]
        if not candidates:
            return False
        i, _ = max(candidates, key=lambda c: c[1].admitted_at)
        self._preempt(i)
        return True

    def _preempt(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        if req is None:
            return
        slot.req = None
        slot.ready = False
        self._free_slot_blocks(i)
        self._resume.append(req)
        self.requests_preempted += 1

    def _emit(self, slot_idx: int, token: int) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        req.tokens.append(token)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req._notify()
        self.tokens_generated += 1
        slot.last_token = token
        slot.length += 1
        slot.remaining -= 1
        gen = len(req.tokens)
        finish = slot.remaining <= 0
        # EOS/stop never end generation inside the first min_new_tokens
        if req.eos_id is not None and token == req.eos_id and gen > req.min_new_tokens:
            finish = True
        # a stop match counts only when the WHOLE matched sequence lies
        # past min_new_tokens (stripping must not cut below the minimum);
        # checked even when max_new_tokens finishes on this same token
        if req.stop:
            for s in req.stop:
                if (
                    gen >= len(s)
                    and gen - len(s) >= req.min_new_tokens
                    and req.tokens[-len(s):] == s
                ):
                    req.result_len = gen - len(s)
                    finish = True
                    break
        if finish:
            slot.req = None
            slot.ready = False
            self._free_slot_blocks(slot_idx)
            self.requests_completed += 1
            self._finish(req)  # done LAST: waiters see settled counters

    def _next_pending(self) -> Optional[Request]:
        if self._resume:
            return self._resume.pop(0)
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _admit_pending(self) -> None:
        """Admit as many pending requests as there are free slots."""
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                continue
            req = self._next_pending()
            if req is None:
                break
            try:
                if not self._admit(i, req):
                    self._resume.insert(0, req)  # pool full: keep it first
                    break
            except Exception as e:  # noqa: BLE001 — fail this request only
                log.exception("admission failed")
                self._free_slot_blocks(i)
                self.slots[i].req = None
                self._fail(req, str(e))

    def _still_ready(self, group: list[int]) -> list[int]:
        return [i for i in group if self.slots[i].req is not None and self.slots[i].ready]

    def _next_prefill_slot(self, prefilling: list[int]) -> int:
        """Rotating pick over prefilling slots: lowest index strictly above
        the previous pick, wrapping to the lowest, so high-index
        admissions make prefill progress under load."""
        after = [i for i in prefilling if i > self._prefill_cursor]
        i = after[0] if after else prefilling[0]
        self._prefill_cursor = i
        return i

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            self._loop()

    def _loop(self) -> None:
        """Scheduler iterations: admission, ONE bounded prefill chunk, then
        chunk sizing + block coverage (with the preemption ladder) and a
        decode chunk whose tokens are emitted before the next iteration."""
        while not self._stop.is_set():
            self._admit_pending()
            prefilling = [i for i, s in enumerate(self.slots) if s.req is not None and not s.ready]
            ready = [i for i, s in enumerate(self.slots) if s.req is not None and s.ready]
            if not prefilling and not ready:
                try:
                    req = self.pending.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._resume.insert(0, req)
                continue
            if prefilling:
                i = self._next_prefill_slot(prefilling)
                try:
                    self._prefill_one_chunk(i)
                except Exception as e:  # noqa: BLE001 — fail this request only
                    log.exception("prefill failed")
                    req = self.slots[i].req
                    self.slots[i].req = None
                    self.slots[i].ready = False
                    self._free_slot_blocks(i)
                    if req is not None and not req.done.is_set():
                        self._fail(req, str(e))
                    self._reset_draft_cache()  # the draft prefill may have died
            if not ready:
                continue
            # split the ready slots into the SPECULATIVE group and the
            # PLAIN decode group; both dispatch in this iteration, so
            # neither starves, and a slot that outgrows spec eligibility
            # (near max_len) finishes on the plain path
            spec_idx = self._spec_eligible(ready)
            plain = [i for i in ready if i not in spec_idx]
            # plain chunk size: the LONGEST remaining want, rounded down to
            # a power of two (clamping to the shortest would put the batch
            # back into one round trip per token whenever a short request
            # is co-resident); slots finishing mid-chunk truncate host-side
            k_steps = 1
            if plain:
                want = max(self.slots[i].remaining for i in plain)
                room = min(self.max_len - self.slots[i].length for i in plain)
                k_steps = self._pick_chunk(max(1, min(want, room + 1)))
            # grow every slot's table to cover this iteration's writes;
            # preempt youngest-first when the pool runs dry
            for i in list(ready):
                s = self.slots[i]
                if s.req is None or not s.ready:
                    ready.remove(i)  # preempted as a victim earlier in this pass
                    continue
                if i in spec_idx:
                    # verification writes reach position
                    # length-2 + depth*(k+1), which eligibility keeps
                    # inside max_len
                    need_upto = s.length - 1 + self.spec_depth * (self.spec_k + 1)
                else:
                    need_upto = min(s.length + k_steps, self.max_len)
                while not self._alloc(i, need_upto):
                    if not self._preempt_youngest(keep=i):
                        self._preempt(i)
                        break
                if s.req is None:
                    ready.remove(i)
            # liveness re-filter for BOTH groups: a preemption victim is
            # picked by admission time, not index order, so one whose own
            # turn already passed is still listed
            spec_idx = self._still_ready(spec_idx)
            plain = self._still_ready(plain)
            try:
                if spec_idx:
                    self._run_spec_round(spec_idx)
                if plain:
                    self._decode_chunk(plain, k_steps)
            except Exception as e:  # noqa: BLE001 — device errors (OOM, …)
                log.exception("decode dispatch failed")
                # the pool and the draft cache may hold partial writes:
                # fail the residents and rebuild both; queued requests are
                # served from the new pool
                self._fail_outstanding(f"decode failed: {e}", drain_queue=False)
                self._reset_pool()
