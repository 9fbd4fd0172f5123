"""Continuous-batching inference engine (iteration-level scheduling).

Counterpart of ``devspace_tpu/inference/engine.py`` at that engine's
serving defaults: the radix prefix cache on, the overlapped dispatch
window at depth 2, every decode chunk and speculative round one program
built ahead of traffic by ``prewarm()``; and with its host KV tier
(``kv_tier``, off by default), KV chain migration between replicas;
and with the reference's telemetry (``metrics``, on by default): request
traces and latency histograms (``obs/request_trace.py``), the serving
counters as the ``engine_*`` metric families, flight-recorder events
and the timeline profiler (``start_timeline``); and tensor-parallel over
a ``mesh`` (below).

- **Paged KV cache** (vLLM-style): K/V live in a block pool
  ``[layers, n_blocks, kv_heads, block_size, head_dim]`` with per-slot
  block tables, so device memory is bounded by the pool, not by
  ``max_slots x max_len``. Blocks are allocated as sequences grow; when
  the pool runs dry the youngest request is preempted (recompute-style:
  requeued with its generated prefix) so older requests always finish.
  Block 0 is scratch: unallocated table entries and parked writes land
  there.
- **Prefix cache** (``prefix_cache``, on by default): full prompt blocks,
  once written, are published in a radix tree (``inference/
  prefix_cache.py``); an admission sharing the prefix points its table at
  the same blocks (refcounted) and its prefill starts at the first
  uncached position. Freed published blocks stay as an LRU cache until
  the allocator needs them. A hit changes table entries only.
- **Host KV tier** (``kv_tier="host"`` or ``"host+disk"``, or
  ``DEVSPACE_KV_TIER``; ``inference/kv_tier.py``): an evicted chain
  spills device->host as int8 payloads (quantized on the device for a
  float pool) instead of vanishing, and a radix match on a spilled chain
  restores it host->device (dequantized on the device for a float pool,
  verbatim into an int8 pool) instead of recomputing its prefill. A miss
  or a corrupt payload falls back to recompute. Gathers and scatters run
  in groups of ``_RESTORE_BATCH`` blocks over a padded index tensor, in
  place in the pool and on the stream the graphs replay on, so they
  queue behind the in-flight window; uploads go through pinned memory
  and spill readbacks land in pinned buffers waited on by event.
- **KV migration** (with a tier): ``submit(kv_source=url)`` marks the
  prompt's uncovered blocks remote, and the restore path pulls their
  KVM1 envelope from that replica's ``GET /kv/chain/<digest>``
  (``export_kv_chain``) before restoring them; any failure falls back to
  recompute. A preempted slot's written blocks are published, so its
  resume can restore them.
- **Chunked prefill, interleaved**: prompts prefill in bounded chunks
  (``prefill_chunk`` tokens, power-of-two final chunks), one chunk per
  scheduler iteration between decode chunks, so co-resident decodes keep
  streaming while a long prompt is admitted. Prefill runs eagerly: its
  offset is a Python int that a graph would bake in.
- **Decode chunks and speculative rounds as programs**
  (``inference/graphs.py``): up to ``chunk_max`` decode steps, with
  logit bias, EOS suppression below ``min_new_tokens`` and sampling on
  the device, are one program per ``(k_steps, mode)``, and a speculative
  dispatch one per ``mode``; on the card each is a CUDA graph captured
  once and replayed. They read the device-resident carry of
  ``inference/dispatch.py`` and write the advanced tokens and positions
  back into it.
- **Overlapped dispatch** (``dispatch_depth``, default 2): chunk N+1 is
  dispatched before chunk N's tokens are read, so the host's emit and
  scheduling work overlaps the card. A slot that finishes mid-chunk
  wastes at most the rest of the window (truncated host-side; every
  position is rewritten in the same step that first attends to it).
- **Speculative decoding** (with ``draft_params``): slots that have a
  seeded draft cache ride one speculative dispatch per iteration — the
  draft proposes ``spec_k`` tokens per slot from a dense per-slot cache,
  the target scores them in ONE paged verification block
  (``decode_block_paged``) and 1..``spec_k``+1 tokens commit per slot;
  the other ready slots take the plain decode chunk in the same
  iteration. Greedy streams are those of plain decoding, token for token.
- **Checkpoints and int8 weights**: ``from_checkpoint`` restores the
  params from a training checkpoint (``inference/checkpoint.py``),
  optionally as weight-only int8 (``inference/quantization.py``:
  ``QuantizedLinear`` leaves, served wherever dense ones are, since
  every weight use is ``x @ w``).

- **Tensor-parallel serving** (``mesh``, ``model_axis``): one process
  per rank of the model axis, each with its shards of the params
  (``quantization.shard_serving_params``), its KV heads of the pool and
  of the draft's dense cache, and the model functions' ``tp=`` (one
  all-reduce per block, the logits gathered before sampling, the
  paged-decode kernel on local heads). The reference's engine is one
  controller over every device; here each rank runs its own scheduler,
  so every decision must be the same on every rank or the step's
  collectives deadlock. The scheduler is a deterministic function of
  the requests and of the tokens, which every rank samples alike from
  the same gathered logits; the two inputs that are not, the arrival of
  requests and the moment a readback happens to be ready, are pinned:
  requests enter at rank 0 of the model axis, which at the top of every
  scheduler iteration broadcasts the new ones, the KV chain exports
  asked of it and its stop flag over a gloo group beside the
  collectives' (the other ranks submit nothing and follow), and the
  window drains only when it is full, never on a readback found ready.
  The decode chunk and spec round graphs hold the NCCL all-reduces; the
  constructor runs one over the axis, so its communicator exists before
  the first capture. The host KV tier lives on rank 0 of the axis: a
  KVT1 payload carries every KV head, so a spill or an export gathers
  the ranks' heads of each block to rank 0 over the gloo group, and a
  restore scatters each rank its heads; every decision that rests on
  rank 0's tier alone (a payload missing or corrupt, an eviction from
  its byte budget, a KVM1 pull's result) reaches the other ranks in a
  broadcast at the step that takes it (``_tier_follow``).

Every decode step's and every verification block's attention runs
through the paged-decode CUDA kernel when the engine lives on the card
(``ops/paged_attention.py``), and the draft's prefill through the
short-sequence attention kernel (``ops/attention.py``).
"""

from __future__ import annotations

import logging
import math
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import transformer as tfm
from ..obs import events as _events
from ..obs.metrics import Registry, WindowedRate, metrics_enabled
from ..obs.request_trace import ServingTelemetry
from ..obs.tracing import (
    TRACK_HOST_SCHED,
    TRACK_PREFILL,
    TRACK_SPEC,
    TRACK_TIER_RESTORE,
    TimelineRecorder,
)
from ..ops.paged_attention import dequantize_kv, quantize_kv
from .dispatch import DecodeDispatcher, resolve_dispatch_depth, upload
from .graphs import ProgramTable
from .kv_tier import (
    HostKVTier,
    KVMigrationClient,
    import_chain,
    pack_chain_envelope,
    pack_kv_payload,
    resolve_kv_tier,
    unpack_kv_payload,
)
from .prefix_cache import RadixPrefixCache
from .quantization import shard_serving_params
from .sampling import sample_tokens
from .speculative import _draft_propose, _draft_propose_sampled, spec_accept_commit

log = logging.getLogger(__name__)

# a program's sampling mode: every active row greedy; some row sampled
# with temperature only; some row also with top-k/top-p
MODES = ("greedy", "sampled", "filters")


# blocks per host-tier gather/scatter: a fixed group over an index tensor
# padded with scratch block 0
_RESTORE_BATCH = 16


def sampling_mode(sampling: bool, filters: bool) -> str:
    return "greedy" if not sampling else "filters" if filters else "sampled"


# Metric families the engine registers over its serving counters
# (pull-style: each callback reads the same value stats() reports — ONE
# mutation site, two views), the reference engine's families exactly, so
# a fleet routes and merges JAX and torch replicas alike. Format: (name,
# kind, help, stats_key, fleet aggregation hint). Counters of the port
# alone (graph_captures, paged_decode_launches, spec_launch_s, ...) stay
# in stats().
ENGINE_METRIC_FAMILIES = (
    ("engine_requests_completed_total", "counter",
     "Requests that finished successfully", "requests_completed", "sum"),
    ("engine_requests_failed_total", "counter",
     "Requests that failed (dispatch faults, bad admissions, stop())",
     "requests_failed", "sum"),
    ("engine_requests_preempted_total", "counter",
     "Preemption events (a request may be preempted more than once)",
     "requests_preempted", "sum"),
    ("engine_tokens_generated_total", "counter",
     "Generated tokens emitted across all requests", "tokens_generated", "sum"),
    ("engine_prefix_hit_blocks_total", "counter",
     "Prompt blocks served from the radix prefix cache at admission",
     "prefix_hit_blocks", "sum"),
    ("engine_prefix_hit_tokens_total", "counter",
     "Prompt tokens whose prefill was skipped at admission (resident "
     "radix hits plus host-tier restores)", "prefix_hit_tokens", "sum"),
    ("engine_recompute_tokens_saved_total", "counter",
     "Prompt tokens restored from the host KV tier instead of "
     "recompute-prefilled (the tier-attributable subset of prefix hits)",
     "recompute_tokens_saved", "sum"),
    ("engine_kv_spill_bytes_total", "counter",
     "Bytes of evicted KV copied device->host into the tier (packed, "
     "int8-quantized)", "kv_spill_bytes", "sum"),
    ("engine_kv_spill_blocks_total", "counter",
     "Evicted KV blocks spilled to the host tier", "kv_spill_blocks", "sum"),
    ("engine_kv_restore_hits_total", "counter",
     "Spilled blocks restored host->device on a radix match",
     "kv_restore_hits", "sum"),
    ("engine_kv_restore_fallbacks_total", "counter",
     "Restore attempts that fell back to recompute-prefill (tier miss, "
     "corrupt payload, or restore error)", "kv_restore_fallbacks", "sum"),
    ("engine_kv_tier_resident_bytes", "gauge",
     "Host RAM currently held by the KV tier", "kv_tier_resident_bytes", "sum"),
    # histogram families carry no stats_key: _register_metric_families
    # creates a real instrument (observed per restore event) instead of
    # a pull callback
    ("engine_kv_restore_seconds", "histogram",
     "Latency of one spilled-chain restore (tier reads + scatter "
     "dispatches; async device work excluded)", None, "sum"),
    # KV migration (disaggregated prefill/decode): chains
    # pulled from a peer replica's /kv/chain endpoint into the local
    # tier, and chain envelopes this replica served to peers
    ("engine_kv_migrate_chains_total", "counter",
     "KV chains fetched from a peer replica and imported into the "
     "local tier", "kv_migrate_chains", "sum"),
    ("engine_kv_migrate_blocks_total", "counter",
     "KV blocks promoted remote->spilled from imported migration "
     "envelopes", "kv_migrate_blocks", "sum"),
    ("engine_kv_migrate_bytes_total", "counter",
     "Envelope bytes fetched in successful KV migrations",
     "kv_migrate_bytes", "sum"),
    ("engine_kv_migrate_failures_total", "counter",
     "KV migration attempts that failed (fetch error or wire-format "
     "rejection) and degraded to recompute-prefill",
     "kv_migrate_failures", "sum"),
    ("engine_kv_export_chains_total", "counter",
     "KV chain envelopes served to peer replicas via /kv/chain",
     "kv_export_chains", "sum"),
    ("engine_kv_migrate_seconds", "histogram",
     "Latency of one KV chain migration (fetch + import + promote; "
     "the host->device scatter is counted by the restore path)",
     None, "sum"),
    ("engine_decode_dispatches_total", "counter",
     "Decode chunks dispatched by the overlapped serving loop",
     "decode_dispatches", "sum"),
    ("engine_readback_wait_seconds_total", "counter",
     "Host time blocked on decode token readback", "readback_wait_s", "sum"),
    ("engine_spec_rounds_total", "counter",
     "Speculative draft/verify rounds replayed by the host commit loop",
     "spec_rounds", "sum"),
    ("engine_spec_proposed_total", "counter",
     "Draft tokens proposed in replayed speculative rounds",
     "spec_proposed", "sum"),
    ("engine_spec_accepted_total", "counter",
     "Draft tokens accepted by target verification", "spec_accepted", "sum"),
    ("engine_spec_committed_total", "counter",
     "Tokens committed from speculative rounds", "spec_committed", "sum"),
    ("engine_active_slots", "gauge",
     "Slots currently decoding (prefill complete)", "active_slots", "sum"),
    ("engine_prefilling_slots", "gauge",
     "Slots currently in chunked prefill", "prefilling_slots", "sum"),
    ("engine_max_slots", "gauge",
     "Configured concurrent-sequence capacity", "max_slots", "sum"),
    ("engine_queued_requests", "gauge",
     "Requests waiting for a slot (pending queue + preempted resume list)",
     "queued", "sum"),
    ("engine_free_kv_blocks", "gauge",
     "Unallocated KV pool blocks", "free_blocks", "sum"),
    ("engine_kv_blocks", "gauge",
     "Allocatable KV pool blocks (excludes the scratch block)",
     "total_blocks", "sum"),
    ("engine_prefix_cached_blocks", "gauge",
     "Blocks currently published in the radix prefix cache",
     "prefix_cached_blocks", "sum"),
    ("engine_dispatch_depth", "gauge",
     "Configured dispatch-ahead window depth", "dispatch_depth", "max"),
    ("engine_dispatch_depth_occupancy", "gauge",
     "Mean in-flight window depth observed at dispatch",
     "dispatch_depth_occupancy", "avg"),
    ("engine_uptime_seconds", "gauge",
     "Seconds since the scheduler thread started", "uptime_s", "max"),
    ("engine_tokens_per_sec_10s", "gauge",
     "Generated tokens per second over the last ~10s window",
     "tokens_per_sec_10s", "sum"),
)


# what a plan carries of each request: everything submit() takes
_PLAN_FIELDS = ("prompt_ids", "max_new_tokens", "temperature", "eos_id", "seed", "top_k",
                "top_p", "stop", "min_new_tokens", "logit_bias", "kv_source", "traceparent")


def _control_group(mesh, axis: str):
    """This rank's gloo group over ``axis``: one group per line of the mesh
    along the axis, created in the same order on every rank of the
    default group (``new_group`` is collective over it)."""
    grid = mesh.device_mesh.mesh
    dim = mesh.axis_names.index(axis)
    lines = grid.movedim(dim, -1).reshape(-1, grid.shape[dim]).tolist()
    me = dist.get_rank()
    mine = None
    for ranks in lines:
        group = dist.new_group(ranks, backend="gloo")
        if me in ranks:
            mine = group
    return mine


def _req_trace_id(req) -> Optional[str]:
    """The request's distributed trace id, when telemetry minted one.
    Events stamp it explicitly: the scheduler thread never sees the
    submitting thread's thread-local tracer context."""
    trace = getattr(req, "_obs_trace", None)
    return trace.trace_id if trace is not None else None


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
    # base URL of a replica that holds this prompt's prefilled KV chain:
    # at admission the uncovered prompt blocks are marked remote and the
    # restore path pulls their envelope from there (any failure falls back
    # to recompute-prefill). Ignored without a host KV tier.
    kv_source: Optional[str] = None
    # inbound W3C traceparent header: the request's serving spans join the
    # caller's distributed trace (telemetry mints a fresh trace without it)
    traceparent: Optional[str] = None
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
                 "prefill_pos", "prompt", "admitted_at", "admit_seq", "draft_ready", "gen")

    def __init__(self):
        self.req: Optional[Request] = None
        self.ready = False
        self.draft_ready = False
        # admission generation: in-flight chunks record it at dispatch so
        # a drained chunk never emits into the slot's next occupant
        self.gen = 0


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

    ``prefix_cache`` (default on) shares full prompt blocks between
    requests with a common prefix (lossless up to the rounding of a
    prefill chunked at another offset; a shared block is never written
    again). ``dispatch_depth`` (default 2, or ``DEVSPACE_ENGINE_OVERLAP``)
    sizes the in-flight decode window; depth 1 is the serial loop, and
    streams are the same at every depth. ``prewarm=True`` runs
    :meth:`prewarm` in ``start()``.

    ``kv_tier`` (``"off"``, ``"host"`` or ``"host+disk"``; ``None`` reads
    ``DEVSPACE_KV_TIER``, default off) keeps evicted prefix chains in a
    host tier of ``kv_tier_bytes`` (overflowing to files under
    ``kv_tier_dir`` with the disk level) and restores them on a match; it
    needs the prefix cache and is off without it. Restores are exact on
    an int8 pool and carry int8 noise on a float pool.

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
    without it; ``"cpu"`` runs the plain PyTorch path, calling each
    program eagerly where the card replays its graph. ``params`` (and
    ``draft_params``) must already live there (see
    ``models.transformer.init_params``,
    ``models.convert.params_from_numpy`` and :meth:`from_checkpoint`);
    their matmul weights may be int8 ``QuantizedLinear`` leaves.

    ``mesh`` (``parallel.mesh.create_mesh`` over the default process
    group, e.g. ``{"model": 2}``) serves tensor-parallel over its
    ``model_axis`` (module docstring): ``params`` and ``draft_params``
    may arrive whole (on the CPU or the device) or as this rank's shards;
    ``n_kv_heads`` (the draft's too) must divide by the axis
    (``ValueError``); the engine runs on ``mesh.device`` (NCCL on the
    card, gloo on the CPU). Every rank builds the engine and calls
    ``prewarm``/``start``/``stop`` alike; ``submit`` belongs to rank 0 of
    the axis (``RuntimeError`` elsewhere), whose requests every other
    rank mirrors (``self.mirrored``). With a host KV tier, rank 0 of the
    axis holds it (its counters are a one-process engine's); the other
    ranks' tier stays empty, and ``export_kv_chain`` is rank 0's.

    ``metrics`` turns the telemetry (``obs/``) on or off: on by default,
    ``DEVSPACE_ENGINE_METRICS=off`` turns it off. When on,
    ``self.telemetry`` records per-request lifecycle traces and latency
    histograms (TTFT, TPOT, queue wait, prefill, e2e) and the serving
    counters are registered as ``ENGINE_METRIC_FAMILIES`` in
    ``self.metrics_registry`` (a private registry unless
    ``metrics_registry`` shares one). ``stats()`` is the same either way:
    the registry and ``stats()`` are two views over the same counters.
    Every hook is host code between dispatches, outside the captured
    graphs, and reads nothing back from the card."""

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
        prefix_cache: bool = True,
        prewarm: bool = False,
        dispatch_depth: Optional[int] = None,
        kv_tier: Optional[str] = None,
        kv_tier_bytes: int = 256 << 20,
        kv_tier_dir: Optional[str] = None,
        metrics: Optional[bool] = None,
        metrics_registry: Optional[Registry] = None,
        mesh=None,
        model_axis: str = "model",
    ):
        self.device = resolve_device(device if mesh is None else mesh.device)
        if device is not None and mesh is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self._tp = None  # (mesh, model_axis) under tensor parallelism
        # the model functions' ``tp=`` and the draft prefill's block hook,
        # passed only under a mesh (without one the calls are unchanged)
        self._tp_kw: dict = {}
        self._draft_hooks: dict = {}
        self._leader = True  # rank 0 of the model axis, or no mesh
        self._control = None  # the gloo group rank 0 of the axis broadcasts plans over
        self._local_cfg, self._draft_local_cfg = cfg, draft_cfg
        if mesh is not None:
            params, draft_params = self._shard_for_mesh(params, cfg, draft_params, draft_cfg,
                                                        mesh, model_axis)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, engine runs on {self.device}"
            )
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
        # the pool and every buffer a program reads are allocated here,
        # once: a captured graph holds their addresses
        self.pool = tfm.init_paged_pool(self._local_cfg, self.n_blocks, self.block_size, kv_dtype,
                                        self.device)
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
        # host clock over a spec dispatch: syncing the carry and queueing
        # the program, then the readback (which waits for the card)
        self.spec_launch_s = 0.0
        self.spec_readback_s = 0.0
        self.draft_prefills = 0
        # the draft's dense cache, one row per slot, with a scratch TAIL of
        # spec_k + 1 positions past max_len: a parked slot's propose loop
        # still writes k+1 K/V entries into its own row, and parking it at
        # position max_len lands those writes in the tail, which no live
        # position ever reads (eligibility caps live writes at max_len - 1)
        self._draft_cache = None
        if draft_params is not None:
            self._draft_cache = tfm.init_kv_cache(
                self._draft_local_cfg, self.max_slots, self.max_len + self.spec_k + 1, self.device)
        # host-side allocator state
        self._free_blocks: list[int] = list(range(1, self.n_blocks))
        self._tables = np.zeros((self.max_slots, self.max_blocks), np.int32)
        self._nalloc = [0] * self.max_slots
        self.prefix_cache_enabled = bool(prefix_cache)
        # the host KV tier (inference/kv_tier.py): None when off, and every
        # tier path below is gated on it
        self.kv_tier_mode = resolve_kv_tier(kv_tier)
        self._kv_tier: Optional[HostKVTier] = None
        # under a multi-rank mesh: the digests rank 0's tier dropped since
        # its last decision reached the other ranks (``_tier_follow``)
        self._tier_evicted: list[str] = []
        # the tier's pinned staging (``_staging``) and the event of the last
        # restore's upload from it
        self._stage: Optional[list[torch.Tensor]] = None
        self._stage_uploaded: Optional[torch.cuda.Event] = None
        if self.kv_tier_mode != "off" and self.prefix_cache_enabled:
            disk_dir = None
            # under a multi-rank mesh only rank 0 of the axis stores
            # payloads; the other ranks' tier stays empty
            if self.kv_tier_mode == "host+disk" and self._leader:
                disk_dir = kv_tier_dir or os.path.join(
                    tempfile.gettempdir(), f"devspace-kv-tier-{os.getpid()}")
            self._kv_tier = HostKVTier(max_bytes=kv_tier_bytes, disk_dir=disk_dir)
            self._kv_tier.on_evict = self._on_tier_evict
        else:
            # a tier without the prefix cache has nothing to spill
            self.kv_tier_mode = "off"
        self._prefix_cache = RadixPrefixCache(track_digests=self._kv_tier is not None)
        self._block_refs: dict[int, int] = {}  # blk -> table references
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.recompute_tokens_saved = 0
        self.kv_spill_blocks = 0
        self.kv_spill_bytes = 0
        self.kv_restore_hits = 0
        self.kv_restore_fallbacks = 0
        # host clock inside spills, restores and migration pulls (a
        # restore's includes its pull)
        self.kv_spill_s = 0.0
        self.kv_restore_s = 0.0
        self.kv_migrate_s = 0.0
        self.kv_migrate_chains = 0
        self.kv_migrate_blocks = 0
        self.kv_migrate_bytes = 0
        self.kv_migrate_failures = 0
        self.kv_export_chains = 0
        self._kv_client: Optional[KVMigrationClient] = None  # lazy; tests inject one
        # /kv/chain handler threads post (digest, box) here; the scheduler
        # thread, the only one that may read the pool, cache and tier,
        # serves them between iterations
        self._kv_export_requests: queue.Queue = queue.Queue()
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
        self.decode_steps = 0
        # tokens/s over a 10 s window (tokens_per_sec is a lifetime mean
        # that goes stale after idle periods): one clock read per token
        self._tok_rate = WindowedRate(10.0)
        # the kv restore/migration latency histograms, set by
        # _register_metric_families
        self._kv_restore_hist = None
        self._kv_migrate_hist = None
        # telemetry: None when off, and every hook site is one None check
        self.telemetry: Optional[ServingTelemetry] = None
        if metrics_enabled(metrics):
            self.telemetry = ServingTelemetry(metrics_registry)
            self._register_metric_families()
        # the timeline profiler: None except inside a capture window
        # (start_timeline / /debug/trace)
        self._timeline: Optional[TimelineRecorder] = None
        self._stop = threading.Event()
        # serializes submit's check+put against stop's set+drain
        self._submit_lock = threading.Lock()
        self._admissions = 0
        # under a multi-rank mesh, rank 0's submissions wait in the inbox
        # for the next plan; the other ranks keep the requests they mirror
        self._inbox: queue.Queue[Request] = queue.Queue()
        self._inbox_head: list[Request] = []
        self.mirrored: list[Request] = []
        self._thread: Optional[threading.Thread] = None
        self._prefill_cursor = -1  # rotating prefill pick (see _loop)
        self._prewarm_on_start = bool(prewarm)
        # the overlapped loop's carry and window, then the programs over it
        self._dispatcher = DecodeDispatcher(self, resolve_dispatch_depth(dispatch_depth))
        self.dispatch_depth = self._dispatcher.depth
        self._programs = ProgramTable(self.device, self._dispatcher.active)
        for k in self._chunk_sizes():
            for mode in MODES:
                self._programs.define(("decode", k, mode), partial(self._decode_program, k, mode))
        if draft_params is not None:
            # [rounds, B, k+2]: each round's k+1 commit tokens, then its count
            self._spec_out = torch.zeros((self.spec_depth, B, self.spec_k + 2),
                                         dtype=torch.int64, device=self.device)
            self._spec_host = torch.zeros(self._spec_out.shape, dtype=torch.int64,
                                          pin_memory=self.device.type == "cuda")
            for mode in MODES:
                self._programs.define(("spec", mode), partial(self._spec_program, mode))

    # -- public API --------------------------------------------------------
    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        cfg: tfm.TransformerConfig,
        *,
        step: Optional[int] = None,
        quantize: Optional[str] = None,
        draft_checkpoint: Optional[str] = None,
        draft_cfg: Optional[tfm.TransformerConfig] = None,
        draft_step: Optional[int] = None,
        mesh=None,
        model_axis: str = "model",
        **engine_kwargs,
    ) -> "InferenceEngine":
        """The train -> serve seam in one call: restore params from a
        checkpoint (``inference/checkpoint.py``: the params alone, on the
        engine's ``device``, int8 weight-quantized with
        ``quantize="int8"``) and build the engine; every weight is placed
        before the engine exists, so the graphs ``prewarm`` captures hold
        their final addresses. ``draft_checkpoint``/``draft_cfg`` restore
        a trained draft for speculative decoding the same way, dense.
        Other kwargs go to the constructor (call ``.start()`` as usual).
        ``mesh``/``model_axis``: each rank restores only its shards of the
        weights (``load_serving_params(mesh=)``) and serves
        tensor-parallel."""
        from .checkpoint import load_serving_params

        device = engine_kwargs.get("device")
        params, _ = load_serving_params(path, cfg, step=step, device=device, quantize=quantize,
                                        mesh=mesh, model_axis=model_axis)
        draft_params = None
        if draft_checkpoint is None and draft_cfg is not None:
            raise ValueError(
                "draft_cfg without draft_checkpoint — from_checkpoint restores draft "
                "weights, it cannot invent them"
            )
        if draft_checkpoint is not None:
            if draft_cfg is None:
                raise ValueError("draft_checkpoint requires draft_cfg")
            draft_params, _ = load_serving_params(draft_checkpoint, draft_cfg, step=draft_step,
                                                  device=device, mesh=mesh,
                                                  model_axis=model_axis)
        return cls(params, cfg, draft_params=draft_params,
                   draft_cfg=draft_cfg if draft_params is not None else None, mesh=mesh,
                   model_axis=model_axis, **engine_kwargs)

    def _shard_for_mesh(self, params, cfg, draft_params, draft_cfg, mesh, model_axis):
        """Tensor-parallel set-up: check that the KV heads divide by the
        axis, place this rank's shards, open the axis's collectives (its
        NCCL communicator must exist before a graph captures them) and,
        for more than one rank, the gloo group plans go over."""
        n = mesh.size(model_axis)
        for name, c in (("n_kv_heads", cfg), ("draft n_kv_heads", draft_cfg)):
            if c is not None and c.n_kv_heads % n:
                raise ValueError(f"{name} {c.n_kv_heads} not divisible by mesh axis "
                                 f"'{model_axis}' ({n})")
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        self._tp = (mesh, model_axis)
        self._tp_kw = {"tp": self._tp}
        self._draft_hooks = {"post_block": tfm.tp_parts(cfg, self._tp)[1]}
        self._local_cfg = tfm.shard_config(cfg, n)
        params = shard_serving_params(params, cfg, mesh, model_axis)
        if draft_params is not None:
            self._draft_local_cfg = tfm.shard_config(draft_cfg, n)
            draft_params = shard_serving_params(draft_params, draft_cfg, mesh, model_axis)
        group = mesh.group(model_axis)
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
        self._leader = mesh.index(model_axis) == 0
        self._leader_rank = dist.get_global_rank(group, 0)
        if n > 1:
            self._control = _control_group(mesh, model_axis)
        return params, draft_params

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
        kv_source: Optional[str] = None,
        traceparent: Optional[str] = None,
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
        if self._tp is not None and not self._leader:
            raise RuntimeError("under a mesh, requests enter at rank 0 of the model axis; "
                               "this rank mirrors them")
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
            kv_source=kv_source,
            traceparent=traceparent,
            submitted_at=time.monotonic(),
        )
        # trace BEFORE the queue put: the scheduler may admit the request
        # the instant it lands, and on_admit is a no-op without the trace
        if self.telemetry is not None:
            self.telemetry.on_submit(req)
        try:
            with self._submit_lock:
                if self._stop.is_set():
                    raise RuntimeError("engine is stopped")
                (self._inbox if self._control is not None else self.pending).put(req)
        except BaseException:
            if self.telemetry is not None:
                self.telemetry.on_finish(req, "failed")
            raise
        return req

    def start(self) -> "InferenceEngine":
        if self._prewarm_on_start:
            self.prewarm()
        self._started_at = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine")
        self._thread.start()
        return self

    def prewarm(self) -> dict:
        """Build every program serving can reach before traffic does:
        capture every decode chunk and spec round (on the CPU: run each
        once) with all rows parked, so their writes land in scratch block
        0 and the draft cache's scratch tail, and run each prefill bucket
        and each draft-prefill bucket once eagerly over scratch (block 0,
        draft row 0); with a host KV tier, one restore group of zeros into
        scratch block 0 and one spill gather of it, which also allocate
        the tier's pinned staging set. Afterwards ``stats()["graph_captures"]``
        stays flat whatever the traffic. Returns ``{program_name:
        seconds}``; raises on a running engine (the scheduler thread owns
        the buffers)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("prewarm() must run before start()")
        timings: dict[str, float] = {}
        dev = self.device

        def timed(name, fn):
            t0 = time.monotonic()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = round(time.monotonic() - t0, 4)

        zero_table = torch.zeros(self.max_blocks, dtype=torch.int64, device=dev)
        t_alloc = self.max_blocks * self.block_size
        with torch.no_grad():
            # the chunk shapes _prefill_one_chunk can emit: power-of-two
            # buckets and the full prefill_chunk, inside the table's span
            for c in self._pow2_buckets(self.prefill_chunk):
                if c <= t_alloc:
                    zeros = torch.zeros(c, dtype=torch.int64, device=dev)
                    timed(f"prefill_{c}", partial(
                        tfm.prefill_chunk_paged, self.params, self.pool, zero_table, zeros, 0,
                        self.cfg, **self._tp_kw))
            if self.draft_params is not None:
                for c in self._pow2_buckets(self.max_len):
                    timed(f"draft_prefill_{c}", partial(self._draft_forward, 0, [0] * c))
            self._dispatcher.active.zero_()
            for key in self._programs.keys():
                timed("_".join(map(str, key)), partial(self._programs.build, key))
            if self._kv_tier is not None:
                R = _RESTORE_BATCH
                cfg = self._local_cfg
                L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
                zq = np.zeros((L, Hkv, self.block_size, D), np.int8)
                zs = np.zeros((L, Hkv, self.block_size), np.float32)
                timed("kv_restore_scatter", partial(
                    self._restore_group, [0] * R, [(zq, zs, zq, zs)] * R))
                timed("kv_spill_gather", partial(self._gather_blocks, [0] * R))
        return timings

    def stop(self) -> None:
        """Stop the scheduler and fail out any unfinished requests so no
        caller blocks forever on a dead engine."""
        with self._submit_lock:
            self._stop.set()
        if self._thread:
            # a rank that follows rank 0's plans stops when rank 0 does
            follower = self._control is not None and not self._leader
            self._thread.join(timeout=None if follower else 30)
        self._fail_outstanding("engine stopped")

    def stats(self) -> dict:
        """Serving counters: requests, tokens, slots, pool, prefix cache,
        the host KV tier and KV migration (all zero with the tier off),
        queue depth, uptime, mean tokens/sec, the dispatch window's
        (``inference/dispatch.py``), decode steps, programs built and
        paged-decode launches made by replays, and the speculative rounds,
        proposals, acceptances, commits, dispatches, the host seconds of
        a dispatch's launch and readback, and draft prefills."""
        uptime = time.monotonic() - self._started_at if self._started_at else 0.0
        d = self._dispatcher
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
            "prefix_cached_blocks": len(self._prefix_cache),
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "recompute_tokens_saved": self.recompute_tokens_saved,
            "kv_tier": self.kv_tier_mode,
            "kv_spill_blocks": self.kv_spill_blocks,
            "kv_spill_bytes": self.kv_spill_bytes,
            "kv_spill_s": round(self.kv_spill_s, 4),
            "kv_restore_hits": self.kv_restore_hits,
            "kv_restore_fallbacks": self.kv_restore_fallbacks,
            "kv_restore_hit_rate": (
                round(self.kv_restore_hits / (self.kv_restore_hits + self.kv_restore_fallbacks), 4)
                if self.kv_restore_hits + self.kv_restore_fallbacks else 0.0
            ),
            "kv_restore_s": round(self.kv_restore_s, 4),
            "kv_tier_resident_bytes": self._kv_tier.resident_bytes if self._kv_tier else 0,
            "kv_tier_entries": len(self._kv_tier) if self._kv_tier else 0,
            "kv_tier_spilled_nodes": self._prefix_cache.spilled_count(),
            "kv_tier_remote_nodes": self._prefix_cache.remote_count(),
            "kv_migrate_chains": self.kv_migrate_chains,
            "kv_migrate_blocks": self.kv_migrate_blocks,
            "kv_migrate_bytes": self.kv_migrate_bytes,
            "kv_migrate_failures": self.kv_migrate_failures,
            "kv_migrate_s": round(self.kv_migrate_s, 4),
            "kv_export_chains": self.kv_export_chains,
            "queued": (self.pending.qsize() + self._inbox.qsize() + len(self._inbox_head)
                       + len(self._resume)),
            "uptime_s": round(uptime, 1),
            "tokens_per_sec": round(self.tokens_generated / uptime, 2) if uptime > 0 else 0.0,
            "tokens_per_sec_10s": round(self._tok_rate.rate(), 2),
            **d.stats(),
            "decode_steps": self.decode_steps,
            "graph_captures": self._programs.captures,
            "paged_decode_launches": self._programs.paged_decode_launches,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_committed": self.spec_committed,
            "spec_acceptance": (
                round(self.spec_accepted / self.spec_proposed, 4) if self.spec_proposed else 0.0
            ),
            "spec_dispatches": self.spec_dispatches,
            "spec_launch_s": round(self.spec_launch_s, 4),
            "spec_readback_s": round(self.spec_readback_s, 4),
            "draft_prefills": self.draft_prefills,
        }

    # -- metrics (obs/) ----------------------------------------------------
    @property
    def metrics_registry(self) -> Optional[Registry]:
        """The engine's metric registry (None with metrics off)."""
        return self.telemetry.registry if self.telemetry is not None else None

    def metrics_text(self) -> str:
        """Prometheus text exposition of this engine's registry (serving
        counters and request-latency histograms); "" with metrics off."""
        reg = self.metrics_registry
        return reg.render() if reg is not None else ""

    def _register_metric_families(self) -> None:
        """Register ENGINE_METRIC_FAMILIES as pull callbacks over
        ``stats()``: the counters keep their one mutation site and the
        registry reads them at scrape time. Weakly referenced, so a
        registry that outlives the engine reports 0 instead of keeping
        the engine (and its device buffers) alive."""
        import weakref

        reg = self.telemetry.registry
        ref = weakref.ref(self)

        def reader(key):
            def fn():
                eng = ref()
                if eng is None:
                    return 0.0
                return float(eng.stats().get(key, 0) or 0)

            return fn

        for name, kind, help_, key, _agg in ENGINE_METRIC_FAMILIES:
            if kind == "histogram":
                # observed per event, not pulled from stats()
                if name == "engine_kv_restore_seconds":
                    self._kv_restore_hist = reg.histogram(name, help_)
                elif name == "engine_kv_migrate_seconds":
                    self._kv_migrate_hist = reg.histogram(name, help_)
                continue
            reg.register_callback(name, kind, help_, reader(key))

    # -- timeline profiler (obs/tracing.py) --------------------------------
    def start_timeline(self, max_events: int = 100_000) -> TimelineRecorder:
        """Attach a timeline recorder: the scheduler loop, the decode
        dispatcher, speculative rounds and the KV tier's restores stream
        events onto named Chrome-trace lanes until :meth:`stop_timeline`.
        Starting over an active capture replaces it."""
        tl = TimelineRecorder(max_events=max_events)
        self._timeline = tl
        return tl

    def stop_timeline(self) -> Optional[TimelineRecorder]:
        """Detach and return the active recorder (None if none)."""
        tl = self._timeline
        self._timeline = None
        return tl

    def capture_timeline(self, seconds: float, max_events: int = 100_000) -> dict:
        """``/debug/trace?seconds=N``: record for ``seconds`` of wall time,
        then render Chrome-trace JSON. Runs on the caller's thread."""
        self.start_timeline(max_events=max_events)
        time.sleep(max(0.0, float(seconds)))
        tl = self.stop_timeline()
        return tl.chrome() if tl is not None else {"traceEvents": []}

    # -- block allocator ---------------------------------------------------
    def _blocks_needed(self, slot_idx: int, upto: int) -> int:
        """Blocks to add so slot covers logical positions [0, upto)."""
        return max(0, math.ceil(upto / self.block_size) - self._nalloc[slot_idx])

    def _pop_block(self) -> int:
        """Take a block for private use: the free list first, then evict
        the least-recently-matched unreferenced cache entry (the cache
        unpublishes the victim's subtree: unreferenced descendants return
        to the free list now, referenced ones are freed on release).
        Callers check availability (free + evictable) first. With a host
        KV tier the evicted chain is spilled first (``_spill_blocks``)."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if self._kv_tier is not None:
            # tiered eviction: the victim chain spills to the host tier and
            # its nodes stay matchable; spilled nodes orphaned by a broken
            # ancestor chain drop their payloads
            spill: list = []
            dropped: list = []
            blk, freed = self._prefix_cache.pop_victim(collect_spill=spill, dropped=dropped)
            self._spill_blocks(spill)
            for d in dropped:
                self._kv_tier.discard(d)
        else:
            blk, freed = self._prefix_cache.pop_victim()
        # an evicted chain's blocks carry no table reference: the cache
        # mirrors _block_refs and frees only ref-0 nodes
        for b in (*freed, blk):
            stale = self._block_refs.pop(b, 0)
            assert stale == 0, f"evicted block {b} still has {stale} table reference(s)"
        self._free_blocks.extend(freed)
        return blk

    def _alloc(self, slot_idx: int, upto: int) -> bool:
        """Grow slot's table to cover [0, upto). False if the pool is
        exhausted (after reclaiming unreferenced prefix-cache blocks)."""
        need = self._blocks_needed(slot_idx, upto)
        if need > len(self._free_blocks) + self._prefix_cache.evictable():
            return False
        for _ in range(need):
            blk = self._pop_block()
            self._block_refs[blk] = 1
            self._tables[slot_idx, self._nalloc[slot_idx]] = blk
            self._nalloc[slot_idx] += 1
        if need:
            self._dispatcher.invalidate_table(slot_idx)
        return True

    def _free_slot_blocks(self, slot_idx: int) -> None:
        """Drop the slot's table references: a published block stays
        cached (the cache mirrors its refcount), any other returns to the
        free list once nothing references it."""
        for b in (int(b) for b in self._tables[slot_idx, : self._nalloc[slot_idx]]):
            refs = self._block_refs.get(b, 1) - 1
            self._block_refs[b] = refs
            if self._prefix_cache.is_published(b):
                self._prefix_cache.release(b)
            elif refs <= 0:
                self._free_blocks.append(b)
        self._tables[slot_idx, :] = 0
        self._nalloc[slot_idx] = 0
        self._dispatcher.invalidate_table(slot_idx)

    def _publish_prefix_blocks(self, slot_idx: int) -> None:
        """Make the slot's fully written full prompt blocks matchable
        (after each prefill chunk: a block's K/V is final once prefill has
        passed its end). First writer wins: a duplicate stays private."""
        if not self.prefix_cache_enabled:
            return
        slot = self.slots[slot_idx]
        bs = self.block_size
        cur = self._prefix_cache.cursor()
        for i in range(min(slot.prefill_pos, len(slot.prompt)) // bs):
            blk = int(self._tables[slot_idx, i])
            cur.publish(tuple(slot.prompt[i * bs: (i + 1) * bs]), blk, self._block_refs.get(blk, 0))

    # -- host KV tier (inference/kv_tier.py) ------------------------------
    @torch.no_grad()
    def _gather_chain(self, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The spill's device program: the blocks named by ``idx`` [R]
        (an index tensor, padded with scratch block 0) gathered from the
        pool as int8 K/V ``[L, R, Hkv, bs, D]`` and f32 scales ``[L, R,
        Hkv, bs]``. A float pool is quantized here, on the device, with
        ``quantize_kv``'s amax/127 round-half-even convention (that of
        ``quantization.quantize_kv_block``); an int8 pool's blocks and
        scales are taken verbatim."""
        k = self.pool["k"].index_select(1, idx)
        v = self.pool["v"].index_select(1, idx)
        if "k_scale" in self.pool:
            return (k, self.pool["k_scale"].index_select(1, idx),
                    v, self.pool["v_scale"].index_select(1, idx))
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return kq, ks, vq, vs

    @torch.no_grad()
    def _restore_chain(self, idx: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor) -> None:
        """The restore's device program: payloads ``[L, R, ...]`` written
        into the pool blocks named by ``idx`` [R], IN PLACE (the captured
        graphs hold the pool's addresses, so the pool is never rebound).
        A float pool dequantizes here, on the device; an int8 pool takes
        q and the scales verbatim, so its restores are exact."""
        if "k_scale" in self.pool:
            self.pool["k"].index_copy_(1, idx, kq)
            self.pool["v"].index_copy_(1, idx, vq)
            self.pool["k_scale"].index_copy_(1, idx, ks)
            self.pool["v_scale"].index_copy_(1, idx, vs)
            return
        dtype = self.pool["k"].dtype
        self.pool["k"].index_copy_(1, idx, dequantize_kv(kq, ks, dtype))
        self.pool["v"].index_copy_(1, idx, dequantize_kv(vq, vs, dtype))

    def _block_index(self, blks: list[int]) -> torch.Tensor:
        """``blks`` padded to ``_RESTORE_BATCH`` with scratch block 0, as a
        device index tensor (never a Python int in a program)."""
        return upload(np.array(blks + [0] * (_RESTORE_BATCH - len(blks)), np.int64), self.device)

    def _staging(self) -> list[torch.Tensor]:
        """The engine's one host staging set for a ``_RESTORE_BATCH`` group,
        block-major (``[R, L, Hkv, bs, D]`` int8 K and V, ``[R, L, Hkv,
        bs]`` f32 scales, in the order kq, ks, vq, vs) so each block's
        payload is one contiguous run; pinned on the card. Allocated once
        (``prewarm`` does it), so no spill or restore pays a pinned
        allocation. Waits for the last restore's upload from it first:
        the host may rewrite it only once that copy has run."""
        if self._stage is None:
            cfg = self._local_cfg
            L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
            q = (_RESTORE_BATCH, L, Hkv, self.block_size, D)
            self._stage = [torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")
                           for shape, dtype in ((q, torch.int8), (q[:-1], torch.float32)) * 2]
        if self._stage_uploaded is not None:
            self._stage_uploaded.synchronize()
            self._stage_uploaded = None
        return self._stage

    @torch.no_grad()
    def _gather_blocks(self, blks: list[int]) -> list[np.ndarray]:
        """Up to ``_RESTORE_BATCH`` pool blocks -> host int8 K/V and f32
        scales, block-major, as views of the staging set (valid until the
        next spill or restore). The gather (and for a float pool the
        quantization) and the copy into pinned memory queue on the current
        stream, behind every in-flight decode chunk; the readback is
        waited on by event."""
        n = len(blks)
        stage = self._staging()
        for h, t in zip(stage, self._gather_chain(self._block_index(blks))):
            h[:n].copy_(t.narrow(1, 0, n).movedim(1, 0), non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return [h[:n].numpy() for h in stage]

    @torch.no_grad()
    def _restore_group(self, blks: list[int], group: list[tuple]) -> None:
        """Scatter up to ``_RESTORE_BATCH`` unpacked payloads ``(kq, ks,
        vq, vs)`` into pool blocks ``blks`` in place: staged block-major in
        the pinned set, uploaded without blocking, laid out as
        ``_restore_chain``'s ``[L, R, ...]`` operands with zero lanes aimed
        at scratch block 0, all on the current stream, so the restore
        queues behind the in-flight window."""
        n = len(blks)
        parts = []
        for j, h in enumerate(self._staging()):
            view = h.numpy()  # lint: allow(JIT502) — a view of pinned host memory, no copy
            for b, payload in enumerate(group):
                view[b] = payload[j]
            t = torch.zeros((h.shape[1], _RESTORE_BATCH) + tuple(h.shape[2:]), dtype=h.dtype,
                            device=self.device)
            t.narrow(1, 0, n).copy_(h[:n].to(self.device, non_blocking=True).movedim(0, 1))
            parts.append(t)
        if self.device.type == "cuda":
            self._stage_uploaded = torch.cuda.Event()
            self._stage_uploaded.record()
        self._restore_chain(self._block_index(blks), *parts)

    def _spill_blocks(self, items: list) -> None:
        """Copy evicted ``(digest, blk)`` blocks device->host into the tier
        before the caller recycles them, ``_RESTORE_BATCH`` blocks a group.
        The gather queues behind every in-flight chunk (published ref-0
        blocks are never their target anyway), so the copy never sees a
        half-written block. A device error raises."""
        if not items:
            return
        t0 = time.monotonic()
        sizes = []
        R = _RESTORE_BATCH
        for lo in range(0, len(items), R):
            group = items[lo: lo + R]
            parts = self._heads_to_leader(self._gather_blocks([blk for _, blk in group]))
            if parts is None:
                continue  # a follower: rank 0 of the axis stores the payloads
            kq, ks, vq, vs = parts
            for n, (digest, _) in enumerate(group):
                payload = pack_kv_payload(kq[n], ks[n], vq[n], vs[n])
                self._kv_tier.put(digest, payload)
                sizes.append(len(payload))
        sizes = self._tier_follow({"sizes": sizes})["sizes"]
        spilled = sum(sizes)
        self.kv_spill_blocks += len(sizes)
        self.kv_spill_bytes += spilled
        self.kv_spill_s += time.monotonic() - t0
        log.debug("kv tier: spilled %d blocks, %d bytes", len(items), spilled)
        _events.emit("kv_tier", "spill", blocks=len(items), bytes=spilled)

    def _on_tier_evict(self, digest: str) -> None:
        """The tier aged out or lost a payload: prune the matching spilled
        radix node (and its subtree's payloads) so no match promises a
        restore the tier cannot honour. Under a multi-rank mesh rank 0
        records the digest for its next ``_tier_follow``, whose followers
        prune the same node."""
        if self._control is not None and self._leader:
            self._tier_evicted.append(digest)
        dropped, freed = self._prefix_cache.drop_spilled(digest)
        self._free_blocks.extend(freed)
        for d in dropped:
            self._kv_tier.discard(d)

    def _tier_follow(self, info: dict) -> dict:
        """A decision of the tier, which under a multi-rank mesh lives on
        rank 0 of the model axis alone: rank 0's ``info``, with the
        digests its tier dropped meanwhile, goes to every rank of the axis
        (the other ranks pass anything), and each other rank prunes what
        rank 0's tier dropped, so every rank's radix tree and free list
        stay the same. ``info`` as it is without a mesh."""
        if self._control is None:
            return info
        plan = [{**info, "evicted": self._tier_evicted} if self._leader else None]
        self._tier_evicted = []
        dist.broadcast_object_list(plan, src=self._leader_rank, group=self._control)
        if not self._leader:
            for digest in plan[0]["evicted"]:
                self._on_tier_evict(digest)
        return plan[0]

    def _heads_to_leader(self, parts: list[np.ndarray]) -> Optional[list[np.ndarray]]:
        """A group's block-major arrays of this rank's KV heads (``[n, L,
        Hkv_local, ...]``) joined along the heads on rank 0 of the model
        axis: a KVT1 payload carries every head. None on the other ranks;
        ``parts`` as they are without a mesh."""
        if self._control is None:
            return parts
        out = []
        for a in parts:
            t = torch.from_numpy(np.ascontiguousarray(a))
            bufs = ([torch.empty_like(t) for _ in range(dist.get_world_size(self._control))]
                    if self._leader else None)
            dist.gather(t, bufs, dst=self._leader_rank, group=self._control)
            out.append(torch.cat(bufs, dim=2).numpy() if self._leader else None)  # lint: allow(JIT502) — host tensors of the gloo group, no readback
        return out if self._leader else None

    def _heads_from_leader(self, group: list[tuple], n: int) -> list[tuple]:
        """``n`` unpacked payloads ``(kq, ks, vq, vs)`` of every head, which
        rank 0 of the model axis holds, cut to each rank's KV heads: this
        rank's part of each, as ``_restore_group`` takes them. ``group``
        as it is without a mesh."""
        if self._control is None:
            return group
        cfg = self._local_cfg
        q = (n, cfg.n_layers, cfg.n_kv_heads, self.block_size, cfg.head_dim)
        mine = []
        for j, (shape, dtype) in enumerate(((q, torch.int8), (q[:-1], torch.float32)) * 2):
            recv = torch.empty(shape, dtype=dtype)
            chunks = None
            if self._leader:
                whole = torch.from_numpy(np.stack([payload[j] for payload in group]))
                chunks = [c.contiguous()
                          for c in whole.chunk(dist.get_world_size(self._control), dim=2)]
            dist.scatter(recv, chunks, src=self._leader_rank, group=self._control)
            mine.append(recv.numpy())  # lint: allow(JIT502) — a host tensor of the gloo group, no readback
        return list(zip(*mine))

    def _match_prefix(self, prompt: list[int]) -> tuple[list[int], list[str]]:
        """The longest run of cached full prompt blocks, capped so that at
        least one prompt token is left to prefill (its logits sample the
        first generated token), walking THROUGH spilled nodes: the
        resident block ids, then the digests of the spilled (or remote)
        chain that extends them. With the tier off the tree holds no
        spilled node, so the second list is empty. A resident node never
        sits below a spilled one (restores revive top-down), and the walk
        stops at the first gap."""
        matched: list[int] = []
        spilled: list[str] = []
        if not self.prefix_cache_enabled:
            return matched, spilled
        bs = self.block_size
        cur = self._prefix_cache.cursor()
        for i in range((len(prompt) - 1) // bs):
            step = cur.step_tiered(tuple(prompt[i * bs: (i + 1) * bs]))
            if step is None:
                break
            kind, val = step
            if kind == "res":
                if spilled:  # defensive: see the docstring
                    break
                matched.append(val)
            else:
                spilled.append(val)
        return matched, spilled

    def _restore_spilled(self, slot_idx: int, prompt: list[int], base: int,
                         spilled: list[str]) -> int:
        """Restore the spilled chain ``spilled`` that extends the slot's
        ``base`` resident matched blocks; returns the blocks restored.

        0. A remote run is pulled from its source replica and imported
           into the tier first (``_migrate_remote``); a failed pull leaves
           its nodes remote, so their reads below miss.
        1. Every payload is read and validated BEFORE any block is popped
           (our own pops could otherwise evict a payload still needed).
           The first miss or corrupt payload prunes its node and subtree,
           and the rest of the prompt is recomputed.
        2. Fresh blocks are popped and the payloads scattered into them,
           ``_RESTORE_BATCH`` a group.
        3. The radix nodes are revived with the new blocks and the slot's
           table is wired.
        ``_admit`` checked the block budget: each restore pops one block
        of the ``need`` it counted."""
        bs = self.block_size
        t0 = time.monotonic()
        overlapped = self._dispatcher.in_flight > 0
        remote = [d for d in spilled if self._prefix_cache.remote_source(d) is not None]
        if remote:
            self._migrate_remote(slot_idx, remote)
        chain, fail = [], None
        if self._leader:  # under a multi-rank mesh only rank 0 holds payloads
            for digest in spilled:
                try:
                    payload = self._kv_tier.get(digest)
                    parsed = unpack_kv_payload(payload) if payload is not None else None
                except Exception:  # noqa: BLE001 — any host-tier fault => recompute
                    parsed = None
                if parsed is None:
                    fail = digest
                    break
                chain.append(parsed)
        found = self._tier_follow({"blocks": len(chain), "fail": fail})
        if found["fail"] is not None:
            self._restore_fallback(slot_idx, found["fail"])
        n = found["blocks"]
        if not n:
            self.kv_restore_s += time.monotonic() - t0
            return 0
        blks = [self._pop_block() for _ in range(n)]
        try:
            for lo in range(0, n, _RESTORE_BATCH):
                hi = min(n, lo + _RESTORE_BATCH)
                self._restore_group(blks[lo: hi], self._heads_from_leader(chain[lo: hi], hi - lo))
        except Exception:
            self._free_blocks.extend(blks)  # their nodes stay spilled
            raise
        cur = self._prefix_cache.cursor()
        for i in range(base):
            # descend the resident prefix; publish on an existing node does
            # not touch its LRU stamp again
            cur.publish(tuple(prompt[i * bs: (i + 1) * bs]), int(self._tables[slot_idx, i]), 0)
        for n, blk in enumerate(blks):
            i = base + n
            self._block_refs[blk] = 1
            self._tables[slot_idx, i] = blk
            self._nalloc[slot_idx] += 1
            got = cur.publish(tuple(prompt[i * bs: (i + 1) * bs]), blk, 1)
            assert got == blk, "restore revived a node another block holds"
            self.kv_restore_hits += 1
        restored = len(blks)
        self._dispatcher.note_restores(restored, overlapped)
        self._dispatcher.invalidate_table(slot_idx)
        now = time.monotonic()
        self.kv_restore_s += now - t0
        if self._kv_restore_hist is not None:
            self._kv_restore_hist.observe(now - t0)
        # the restore belongs to the slot's request
        req = self.slots[slot_idx].req
        trace = getattr(req, "_obs_trace", None) if req is not None else None
        if trace is not None:
            trace.event(f"kv_restore:{restored}", now)
        tl = self._timeline
        if tl is not None:
            tl.add(TRACK_TIER_RESTORE, f"restore x{restored}", t0, now, slot=slot_idx,
                   blocks=restored, overlapped=overlapped,
                   trace_id=trace.trace_id if trace is not None else None)
        _events.emit(
            "kv_tier", "restore", trace_id=trace.trace_id if trace is not None else None,
            slot=slot_idx, blocks=restored, overlapped=overlapped, seconds=round(now - t0, 6),
        )
        return restored

    def _restore_fallback(self, slot_idx: int, digest: str) -> None:
        """The payload of ``digest`` was missing or corrupt: prune its node
        and subtree, so the rest of the prompt is recomputed."""
        self.kv_restore_fallbacks += 1
        dropped, freed = self._prefix_cache.drop_spilled(digest)
        self._free_blocks.extend(freed)
        self._kv_tier.discard(digest)
        for d in dropped:
            self._kv_tier.discard(d)
        log.warning("kv tier: restore fell back to recompute at digest %s "
                    "(slot %d, %d nodes pruned)", digest[:16], slot_idx, len(dropped))
        slot_req = self.slots[slot_idx].req
        _events.emit(
            "kv_tier", "restore_fallback", level="warn",
            trace_id=_req_trace_id(slot_req) if slot_req is not None else None,
            slot=slot_idx, digest=digest[:16], pruned=len(dropped),
        )

    # -- KV migration -------------------------------------------------------
    def _mark_remote_chain(self, prompt: list[int], source: str) -> None:
        """Record that every full prompt block the radix tree does not
        cover is fetchable from ``source`` (remote nodes past the
        frontier; resident and spilled nodes are descended untouched)."""
        bs = self.block_size
        cur = self._prefix_cache.cursor()
        for i in range((len(prompt) - 1) // bs):
            cur.publish_remote(tuple(prompt[i * bs: (i + 1) * bs]), source)

    def _migrate_client(self) -> KVMigrationClient:
        if self._kv_client is None:
            self._kv_client = KVMigrationClient()
        return self._kv_client

    def _migrate_remote(self, slot_idx: int, remote: list[str]) -> None:
        """Pull the envelope of a remote run (one pull, addressed by its
        leaf) into the tier, promoting the covered gap-free prefix of its
        nodes remote -> spilled. A failure leaves them remote, so the
        caller's reads miss and recompute. Never raises."""
        source = self._prefix_cache.remote_source(remote[0])
        req = self.slots[slot_idx].req
        trace = getattr(req, "_obs_trace", None) if req is not None else None
        trace_id = trace.trace_id if trace is not None else None
        t0 = time.monotonic()
        pulled: dict = {}
        if self._leader:  # under a multi-rank mesh rank 0 pulls, and tells the others
            try:
                envelope = self._migrate_client().fetch(source, remote[-1])
                pulled = {"imported": import_chain(self._kv_tier, envelope),
                          "bytes": len(envelope)}
            except Exception as e:  # noqa: BLE001 — any fault => recompute
                pulled = {"reason": type(e).__name__}
        pulled = self._tier_follow(pulled)
        if "reason" in pulled:
            self.kv_migrate_s += time.monotonic() - t0
            self.kv_migrate_failures += 1
            log.warning("kv migration from %s failed (slot %d, %d blocks): %s",
                        source, slot_idx, len(remote), pulled["reason"])
            _events.emit(
                "kv_tier", "migrate_failed", level="warn", trace_id=trace_id, slot=slot_idx,
                source=source, digest=remote[-1][:16], blocks=len(remote),
                reason=pulled["reason"],
            )
            return
        imported = set(pulled["imported"])
        promoted = 0
        for d in remote:
            # past a gap a node is unrestorable (its ancestors miss first)
            if d in imported and self._prefix_cache.promote_remote(d):
                promoted += 1
            else:
                break
        now = time.monotonic()
        self.kv_migrate_s += now - t0
        self.kv_migrate_chains += 1
        self.kv_migrate_blocks += promoted
        self.kv_migrate_bytes += pulled["bytes"]
        if self._kv_migrate_hist is not None:
            self._kv_migrate_hist.observe(now - t0)
        if trace is not None:
            trace.event(f"kv_migrate:{promoted}", now)
        tl = self._timeline
        if tl is not None:
            tl.add(TRACK_TIER_RESTORE, f"migrate x{promoted}", t0, now, slot=slot_idx,
                   source=source, blocks=promoted, trace_id=trace_id)
        _events.emit(
            "kv_tier", "migrate", trace_id=trace_id, slot=slot_idx, source=source,
            blocks=promoted, requested=len(remote), bytes=pulled["bytes"],
            seconds=round(now - t0, 6),
        )

    def export_kv_chain(self, digest: str, timeout: float = 5.0) -> Optional[bytes]:
        """The KVM1 envelope of the root->leaf chain ``digest`` names, for a
        peer's migration pull (the server's ``GET /kv/chain/<digest>``).
        Thread-safe: the request goes through a mailbox to the scheduler
        thread, the only one that may read the pool, cache and tier; with
        no scheduler running it is served inline. Under a multi-rank mesh
        it belongs to rank 0 of the axis, whose next plan carries it to
        every rank (each gathers its heads of the resident blocks), and it
        needs the schedulers running. None for an unknown digest, with the
        tier off, on timeout, or under a mesh elsewhere or stopped."""
        if self._kv_tier is None or not self._leader:
            return None
        if self._thread is not None and self._thread.is_alive():
            box: dict = {"done": threading.Event(), "envelope": None}
            self._kv_export_requests.put((digest, box))
            if not box["done"].wait(timeout):
                return None
            return box["envelope"]
        if self._control is not None:
            return None
        return self._serve_kv_export(digest)

    def _export_requests(self) -> list:
        """The mailbox's ``(digest, box)`` requests, drained."""
        requests = []
        while True:
            try:
                requests.append(self._kv_export_requests.get_nowait())
            except queue.Empty:
                return requests

    def _service_kv_exports(self, requests: list) -> None:
        """Serve export requests (scheduler thread, between iterations);
        under a multi-rank mesh every rank serves the plan's, the other
        ranks with no box to answer."""
        for digest, box in requests:
            envelope = None
            try:
                envelope = self._serve_kv_export(digest)
            except Exception:  # noqa: BLE001 — a failed export is a 404
                log.exception("kv chain export failed")
            finally:
                if box is not None:
                    box["envelope"] = envelope
                    box["done"].set()

    def _serve_kv_export(self, digest: str) -> Optional[bytes]:
        """Build the envelope: resident blocks gathered device->host as a
        spill gathers them, spilled ones read from the tier; the longest
        gap-free prefix of the chain is served."""
        chain = self._prefix_cache.chain_to(digest)
        if not chain:
            return None
        resident = [(d, blk) for d, blk in chain if blk >= 0]
        payloads: dict[str, bytes] = {}
        for lo in range(0, len(resident), _RESTORE_BATCH):
            group = resident[lo: lo + _RESTORE_BATCH]
            parts = self._heads_to_leader(self._gather_blocks([blk for _, blk in group]))
            if parts is None:
                continue  # a follower: rank 0 of the axis packs the envelope
            kq, ks, vq, vs = parts
            for n, (d, _) in enumerate(group):
                payloads[d] = pack_kv_payload(kq[n], ks[n], vq[n], vs[n])
        blocks = []
        if self._leader:
            for d, blk in chain:
                payload = payloads.get(d) if blk >= 0 else self._kv_tier.get(d)
                if payload is None:
                    break  # a gap: nothing below it is restorable
                blocks.append((d, payload))
        n = self._tier_follow({"blocks": len(blocks)})["blocks"]
        if not n:
            return None
        self.kv_export_chains += 1
        _events.emit("kv_tier", "migrate_export", digest=digest[:16], blocks=n)
        return pack_chain_envelope(blocks) if self._leader else None

    def _reset_pool(self) -> None:
        """Zeroed pool and fresh allocator state after a failed dispatch.
        In place: the graphs hold the pool's addresses. The prefix cache
        indexed the lost contents, so it resets with them."""
        for t in self.pool.values():
            t.zero_()
        self._reset_draft_cache()
        self._free_blocks = list(range(1, self.n_blocks))
        self._tables[:] = 0
        self._nalloc = [0] * self.max_slots
        self._prefix_cache.reset()
        if self._kv_tier is not None:
            # payloads are content-addressed, but the radix nodes that map
            # digests to matches died with the cache
            self._kv_tier.clear()
        self._block_refs.clear()

    # -- scheduler ---------------------------------------------------------
    @staticmethod
    def _finish(req: Request) -> None:
        """Terminal wakeup: set done, then wake stream() waiters."""
        req.done.set()
        req._notify()

    def _fail(self, req: Request, reason: str, stage: str, slot: Optional[int] = None) -> None:
        """Fail ``req`` at ``stage`` (admit, prefill, decode, resume,
        queued): count it, close its trace, emit the event, then wake its
        waiters."""
        req.error = reason
        self.requests_failed += 1
        if self.telemetry is not None:
            self.telemetry.on_finish(req, "failed")
        fields = {"slot": slot} if slot is not None else {}
        _events.emit("engine", "request_failed", level="error", trace_id=_req_trace_id(req),
                     reason=reason, stage=stage, **fields)
        self._finish(req)  # done LAST: waiters see settled counters

    def _fail_outstanding(self, reason: str, drain_queue: bool = True) -> None:
        """Fail slot-resident requests (their K/V lives in the pool),
        after abandoning the in-flight window (nothing may emit out of it
        after this). ``drain_queue=False`` spares queued requests that
        were never admitted — a rebuilt pool can still serve them; only
        stop() drains the queue."""
        _events.emit("engine", "fail_outstanding", level="error", reason=reason,
                     drain_queue=drain_queue)
        self._dispatcher.abandon()
        for i, slot in enumerate(self.slots):
            req = slot.req
            if req is None:
                continue
            slot.req = None
            slot.ready = False
            self._free_slot_blocks(i)
            if not req.done.is_set():
                self._fail(req, reason, "decode", slot=i)
        if not drain_queue:
            return
        for req in self._resume:
            self._fail(req, reason, "resume")
        self._resume.clear()
        for req in self._inbox_head:
            self._fail(req, reason, "queued")
        self._inbox_head.clear()
        for q in (self.pending, self._inbox):
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                self._fail(req, reason, "queued")

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

    def _chunk_sizes(self) -> list[int]:
        """The decode programs' chunk sizes: powers of two up to chunk_max."""
        return self._pow2_buckets(self.chunk_max, include_limit=False)

    def _pick_chunk(self, n: int) -> int:
        """Largest chunk size <= min(n, chunk_max)."""
        return self._pow2_buckets(min(n, self.chunk_max), include_limit=False)[-1]

    def _admit(self, slot_idx: int, req: Request) -> bool:
        """Assign a slot, reference the cached prefix and allocate blocks
        for the rest of the prompt (prefill runs chunk by chunk in the
        scheduler loop, from the first uncached position). With a host KV
        tier the spilled (or, with ``kv_source``, remote) extension of the
        match is restored first. False, leaving the request queued, when
        the pool cannot hold the prompt now."""
        prompt = req.prompt_ids + req.tokens  # tokens: preempted resume
        matched, spilled = self._match_prefix(prompt)
        # a kv_source promises the uncovered prompt blocks at a peer: mark
        # them remote so the restore path pulls their envelope
        if self._kv_tier is not None and req.kv_source and (
            len(matched) + len(spilled) < (len(prompt) - 1) // self.block_size
        ):
            self._mark_remote_chain(prompt, req.kv_source)
            matched, spilled = self._match_prefix(prompt)
        # spilled blocks are not subtracted: each restore pops a fresh
        # block of this budget
        need = math.ceil(len(prompt) / self.block_size) - len(matched)
        # the matched blocks themselves are not evictable for the pops below
        if need > len(self._free_blocks) + self._prefix_cache.evictable_excluding(matched):
            return False
        # reference the matched blocks FIRST so the pops cannot evict them
        for i, blk in enumerate(matched):
            self._block_refs[blk] = self._block_refs.get(blk, 0) + 1
            self._prefix_cache.ref(blk)
            self._tables[slot_idx, i] = blk
        self._nalloc[slot_idx] = len(matched)
        # then the restored blocks (referenced, so the private pops below
        # cannot evict them either)
        restored = self._restore_spilled(slot_idx, prompt, len(matched), spilled) if spilled else 0
        ok = self._alloc(slot_idx, len(prompt))  # >= 1 block: invalidates the table row
        assert ok, "availability was checked above"
        hit = len(matched) + restored
        self.prefix_hit_blocks += hit
        self.prefix_hit_tokens += hit * self.block_size
        self.recompute_tokens_saved += restored * self.block_size
        slot = self.slots[slot_idx]
        slot.gen += 1  # a new occupant: stale in-flight chunks must not emit
        slot.req = req
        slot.prompt = prompt
        slot.prefill_pos = hit * self.block_size
        slot.ready = False
        slot.draft_ready = False
        slot.length = len(prompt)
        slot.remaining = req.max_new_tokens - len(req.tokens)
        slot.admitted_at = time.monotonic()
        self._admissions += 1
        slot.admit_seq = self._admissions  # the preemption order, the same on every rank
        self._sync_sampling_extras(slot_idx, req)
        if self.telemetry is not None:
            self.telemetry.on_admit(req)
        _events.emit("engine", "admit", trace_id=_req_trace_id(req), slot=slot_idx,
                     prompt_tokens=len(prompt), cached_blocks=hit)
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
        self._logit_bias[slot_idx].copy_(upload(self._bias_row(req), self.device))
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
        # one upload: the slot's table, then the chunk padded with token 0
        packed = np.zeros(self.max_blocks + c, np.int64)
        packed[: self.max_blocks] = self._tables[slot_idx]
        packed[self.max_blocks: self.max_blocks + real] = slot.prompt[offset: offset + real]
        packed = upload(packed, self.device)
        tl = self._timeline
        t_pf = time.monotonic() if tl is not None else 0.0
        logits, _ = tfm.prefill_chunk_paged(
            self.params, self.pool, packed[: self.max_blocks], packed[self.max_blocks:], offset,
            self.cfg, **self._tp_kw,
        )
        if tl is not None:
            # host time to queue the chunk (the card runs it asynchronously)
            tl.add(TRACK_PREFILL, f"prefill slot {slot_idx} @{offset}+{real}", t_pf,
                   time.monotonic(), slot=slot_idx, offset=offset, tokens=real,
                   trace_id=_req_trace_id(req))
        slot.prefill_pos = offset + real
        self._publish_prefix_blocks(slot_idx)
        if self.telemetry is not None:
            self.telemetry.on_prefill_chunk(req, slot.prefill_pos)
        if slot.prefill_pos < t:
            return
        # prefill complete: the first token samples from the last REAL
        # position, keyed by that position (t-1) — on preemption resume
        # (prompt = prompt_ids + generated) the same key the uninterrupted
        # run used for that token
        self._seeds[slot_idx] = req.seed
        dev = self.device
        lg = logits[real - 1: real]
        if req.logit_bias:
            lg = lg + upload(self._bias_row(req), dev)
        if req.eos_id is not None and len(req.tokens) < req.min_new_tokens:
            lg = lg.clone()
            lg[0, req.eos_id] = float("-inf")
        ints = upload(np.array([[req.top_k, req.seed, t - 1]], np.int64), dev)
        floats = upload(np.array([[req.temperature, req.top_p]], np.float32), dev)
        first = sample_tokens(
            lg, floats[:, 0], ints[:, 0], floats[:, 1], ints[:, 1], ints[:, 2],
            sampling=req.temperature > 0,
            filters=req.top_k > 0 or req.top_p < 1.0,
        )
        if self.draft_params is not None and not req.logit_bias:
            # logit_bias slots never ride a spec round, so their draft
            # prefill would be dead work; min_new_tokens slots become
            # eligible later, so theirs pays off
            self._draft_forward(slot_idx, slot.prompt)
            self.draft_prefills += 1
            slot.draft_ready = True
        slot.ready = True
        if self.telemetry is not None:
            self.telemetry.on_prefill_done(req)
        self._emit(slot_idx, int(first[0]))
        # the host is authoritative for this slot's carry row until its
        # first dispatch uploads it
        self._dispatcher.invalidate_state(slot_idx)

    def _draft_forward(self, slot_idx: int, tokens: list[int]) -> None:
        """Seed draft-cache row ``slot_idx`` with ONE full-sequence draft
        forward over ``tokens`` padded with token 0 to a power of two
        (clamped at max_len), which bounds the set of shapes. Causal
        masking keeps the real rows clean, and the pad tail's K/V is
        rewritten by the propose loop before anything attends it."""
        t = len(tokens)
        c = 1
        while c < t:
            c *= 2
        c = min(c, self.max_len)
        toks = upload(np.array(tokens + [0] * (c - t), np.int64), self.device)
        # under a mesh: this rank's KV heads, each block summed over the
        # axis (the logits, vocab-sharded, are not used)
        _, (dk, dv) = tfm.forward(self.draft_params, toks[None], self._draft_local_cfg,
                                  return_kv=True, **self._draft_hooks)
        self._draft_cache["k"][:, slot_idx, :c] = dk[:, 0]
        self._draft_cache["v"][:, slot_idx, :c] = dv[:, 0]

    def _reset_draft_cache(self) -> None:
        """After a failed dispatch that may have left partial writes: zero
        the draft cache in place and stop speccing resident slots (they go
        on with plain decode; no stream depends on draft state)."""
        if self.draft_params is None:
            return
        self._draft_cache["k"].zero_()
        self._draft_cache["v"].zero_()
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

    # -- programs (inference/graphs.py) --------------------------------------
    @torch.no_grad()
    def _decode_program(self, k_steps: int, mode: str) -> None:
        """``k_steps`` decode steps for the active rows of the carry, with
        the sampling extras and sampling on the device; the tokens go to
        ``toks_out`` [k_steps, B] and the advanced tokens and positions
        back into the carry. Parked rows read an all-zero table from
        position 0, so their writes land in scratch block 0; their
        outputs are discarded and their carry rows left as they were."""
        d = self._dispatcher
        c, act = d.carry, d.active
        sampling, filters = mode != "greedy", mode == "filters"
        tables = torch.where(act[:, None], c["tables"], 0)
        tok = c["tokens"]
        pos = torch.where(act, c["positions"], 0)
        for j in range(k_steps):
            logits, _ = tfm.decode_tokens_paged(self.params, self.pool, tables, tok, pos, self.cfg,
                                                **self._tp_kw)
            # extras: additive bias, then EOS suppression for slots below
            # min_new_tokens (pos is the position being written)
            logits = logits + self._logit_bias
            suppress = (pos < self._min_until)[:, None] & (
                self._vocab_ids[None, :] == self._eos_ids[:, None]
            )
            logits = logits.masked_fill(suppress, float("-inf"))
            tok = sample_tokens(logits, c["temps"], c["top_ks"], c["top_ps"], c["seeds"], pos,
                                sampling, filters)
            d.toks_out[j].copy_(tok)
            # the clamp keeps a position from indexing past its table
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
        c["tokens"].copy_(torch.where(act, tok, c["tokens"]))
        c["positions"].copy_(torch.where(act, pos, c["positions"]))

    @torch.no_grad()
    def _spec_program(self, mode: str) -> None:
        """One speculative dispatch for the active rows: ``spec_depth``
        chained rounds, each the draft's ``spec_k`` proposals per row
        (sampled for temperature > 0 rows), ONE paged verification block
        on the target and the accept/correct rule, which also advances
        each active row's token and positions between rounds. Round r's
        commit tokens and count go to ``_spec_out[r]``; the advanced
        tokens and positions go back into the carry. Parked rows read a
        zeroed table with verify positions from 0 (scratch block 0) and
        draft positions from max_len (the cache's scratch tail); their
        positions never move. A rejected position's K/V is overwritten by
        the next round's writes before anything attends it."""
        d = self._dispatcher
        c, act = d.carry, d.active
        sampling, filters = mode != "greedy", mode == "filters"
        k = self.spec_k
        tables = torch.where(act[:, None], c["tables"], 0)
        cur = c["tokens"]
        pos_d = torch.where(act, c["positions"], self.max_len)
        pos_v = torch.where(act, c["positions"], 0)
        steps = torch.arange(k + 1, device=self.device)
        for r in range(self.spec_depth):
            if sampling:
                props, d_probs, _ = _draft_propose_sampled(
                    self.draft_params, self._draft_cache, cur, pos_d, self.draft_cfg, k,
                    c["seeds"], c["temps"], **self._tp_kw)
            else:
                d_probs = None
                props, _ = _draft_propose(
                    self.draft_params, self._draft_cache, cur, pos_d, self.draft_cfg, k,
                    **self._tp_kw)
            block = torch.cat([cur[:, None], props], dim=1)
            logits, _ = tfm.decode_block_paged(
                self.params, self.pool, tables, block, pos_v[:, None] + steps[None], self.cfg,
                **self._tp_kw)
            commit, n_commit = spec_accept_commit(
                props, d_probs, logits, c["temps"], c["seeds"], pos_v, c["top_ks"], c["top_ps"],
                use_filters=filters)
            self._spec_out[r, :, : k + 1].copy_(commit)
            self._spec_out[r, :, k + 1].copy_(n_commit)
            # the corrected/bonus token (the last committed) seeds the
            # next round
            new_cur = commit.gather(1, (n_commit - 1)[:, None])[:, 0]
            cur = torch.where(act, new_cur, cur)
            pos_d = torch.where(act, pos_d + n_commit, pos_d)
            pos_v = torch.where(act, pos_v + n_commit, pos_v)
        c["tokens"].copy_(cur)
        c["positions"].copy_(torch.where(act, pos_v, c["positions"]))

    def _run_spec_round(self, spec_idx: list[int]) -> None:
        """One speculative dispatch for the ``spec_idx`` slots (the window
        is drained): sync their carry rows, run the program, ONE readback,
        then the host-side emits. A failure fails the residents and
        zeroes the pool and the draft cache."""
        reqs = [self.slots[i].req for i in spec_idx]
        sampling = any(r.temperature > 0 for r in reqs)
        filters = any(r.temperature > 0 and (r.top_k > 0 or r.top_p < 1.0) for r in reqs)
        d = self._dispatcher
        tl = self._timeline
        try:
            t0 = time.monotonic()
            d.sync_carry(spec_idx)
            self._programs.run(("spec", sampling_mode(sampling, filters)))
            self._spec_host.copy_(self._spec_out, non_blocking=True)
            t1 = time.monotonic()
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            out = self._spec_host.tolist()  # [R, B, k+2]: the one readback
        except Exception as e:  # noqa: BLE001 — device errors (OOM, …)
            log.exception("speculative round failed")
            self._fail_outstanding(f"speculative round failed: {e}", drain_queue=False)
            self._reset_pool()
            return
        t2 = time.monotonic()
        waited = t2 - t1
        if tl is not None:
            # one bar per draft/verify dispatch: with speculation on, this
            # is the decode work of these slots
            tl.add(TRACK_SPEC, f"spec round x{len(spec_idx)}", t0, t2, slots=list(spec_idx),
                   spec_k=self.spec_k, spec_depth=self.spec_depth,
                   trace_ids=[t for t in map(_req_trace_id, reqs) if t is not None])
        self.spec_launch_s += t1 - t0
        self.spec_readback_s += waited
        d.readback_wait_s += waited
        self.spec_dispatches += 1
        k = self.spec_k
        for i in spec_idx:
            for r in range(self.spec_depth):
                if self.slots[i].req is None:
                    break  # finished mid-dispatch; later rounds are discarded
                n = out[r][i][k + 1]
                # accepted/proposed measure the draft-match rate: raw
                # n - 1, not capped by how many tokens the request had
                # room to commit; spec_committed counts actual emits
                self.spec_rounds += 1
                self.spec_proposed += k
                self.spec_accepted += n - 1
                for j in range(n):
                    if self.slots[i].req is None:
                        break  # hit EOS / max_new mid-commit
                    self._emit(i, out[r][i][j])
                    self.spec_committed += 1

    def _preempt_youngest(self, keep: int) -> bool:
        """Free the most recently admitted slot other than ``keep``
        (ready OR mid-prefill), requeueing its request with its generated
        prefix. False with nothing to preempt."""
        candidates = [
            (i, s) for i, s in enumerate(self.slots) if s.req is not None and i != keep
        ]
        if not candidates:
            return False
        i, _ = max(candidates, key=lambda c: c[1].admit_seq)
        self._preempt(i)
        return True

    def _preempt(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        if req is None:
            return
        if self._kv_tier is not None:
            self._publish_preempt_chain(i)
        slot.req = None
        slot.ready = False
        self._free_slot_blocks(i)
        self._resume.append(req)
        self.requests_preempted += 1
        if self.telemetry is not None:
            self.telemetry.on_preempt(req)
        _events.emit("engine", "preempt", level="warn", trace_id=_req_trace_id(req), slot=i,
                     generated=len(req.tokens))

    def _publish_preempt_chain(self, i: int) -> None:
        """With a tier: publish the preempted slot's fully written blocks
        over prompt + generated tokens before they are freed, so under
        pressure they spill and the resume restores them instead of
        prefilling again. K/V is final for positions [0, length-1) (the
        last token's K/V is written by the step that generates its
        successor), and every call site reaches here with the window
        drained. A slot mid-prefill published its prompt blocks already."""
        slot = self.slots[i]
        if not slot.ready or slot.req is None:
            return
        seq = slot.req.prompt_ids + slot.req.tokens
        bs = self.block_size
        cur = self._prefix_cache.cursor()
        for b in range((slot.length - 1) // bs):
            blk = int(self._tables[i, b])
            cur.publish(tuple(seq[b * bs: (b + 1) * bs]), blk, self._block_refs.get(blk, 0))

    def _emit(self, slot_idx: int, token: int) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        req.tokens.append(token)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req._notify()
        self.tokens_generated += 1
        self._tok_rate.add(1)
        if self.telemetry is not None:
            self.telemetry.on_emit(req)
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
            self._retire_slot(slot_idx)
            self.requests_completed += 1
            if self.telemetry is not None:
                self.telemetry.on_finish(req, "completed")
            self._finish(req)  # done LAST: waiters see settled counters

    def _retire_slot(self, slot_idx: int) -> None:
        """Release a finished slot's blocks: now when no decode chunk
        references it, else when the last in-flight chunk drains (its
        overshoot writes target these blocks; the slot stays
        un-admittable meanwhile, see ``slot_busy``)."""
        if self._dispatcher.slot_busy(slot_idx):
            self._dispatcher.pending_free.add(slot_idx)
        else:
            self._free_slot_blocks(slot_idx)

    def _next_pending(self) -> Optional[Request]:
        if self._resume:
            return self._resume.pop(0)
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _admit_pending(self) -> None:
        """Admit as many pending requests as there are free slots; a
        zombie slot (finished, still referenced by in-flight chunks) is
        skipped until the window releases it."""
        for i, slot in enumerate(self.slots):
            if slot.req is not None or self._dispatcher.slot_busy(i):
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
                self._fail(req, str(e), "admit", slot=i)

    def _live(self, group: list[int]) -> list[int]:
        return [i for i in group if self.slots[i].req is not None and self.slots[i].ready]

    def _next_prefill_slot(self, prefilling: list[int]) -> int:
        """Rotating pick over prefilling slots: lowest index strictly above
        the previous pick, wrapping to the lowest, so high-index
        admissions make prefill progress under load."""
        after = [i for i in prefilling if i > self._prefill_cursor]
        i = after[0] if after else prefilling[0]
        self._prefill_cursor = i
        return i

    def _dispatch_failed(self, e: Exception) -> None:
        """A decode dispatch or its readback died: fail the WHOLE window
        (every chunk chains off the pool) and every resident request, zero
        the pool and keep serving queued requests."""
        log.error("decode dispatch failed: %s", e, exc_info=e)
        _events.emit("engine", "poisoned_window", level="error", error=str(e),
                     in_flight=self._dispatcher.in_flight)
        self._fail_outstanding(f"decode failed: {e}", drain_queue=False)
        self._reset_pool()

    def _cover(self, ready: list[int], spec_idx: list[int], plain_set: set,
               k_steps: int) -> bool:
        """Grow every participating slot's table to cover this iteration's
        writes (evicting, and with a tier spilling, cached blocks),
        preempting youngest-first when the pool runs dry once the window
        has settled. Drops slots that stop participating from ``ready``.
        True when the window was drained and the schedule must be rebuilt
        from settled state."""
        d = self._dispatcher
        for i in list(ready):
            s = self.slots[i]
            if s.req is None or not s.ready:
                ready.remove(i)  # preempted as a victim earlier in this pass
                continue
            if i in spec_idx:
                # verification writes reach position length-2 + depth*(k+1),
                # which eligibility keeps inside max_len
                need_upto = s.length - 1 + self.spec_depth * (self.spec_k + 1)
            elif i in plain_set:
                # in-flight chunks write up to length+inflight first; writes
                # never pass max_len-1 (the decode clamps)
                need_upto = min(s.length + d.inflight_steps[i] + k_steps, self.max_len)
            else:
                continue  # remainder fully covered by the window
            while not self._alloc(i, need_upto):
                if d.in_flight:
                    # in-flight chunks pin their slots' blocks and may finish
                    # slots: settle the window before preempting anyone
                    try:
                        d.drain_all()
                    except Exception as e:  # noqa: BLE001
                        self._dispatch_failed(e)
                    return True
                if not self._preempt_youngest(keep=i):
                    self._preempt(i)
                    break
            if s.req is None:
                ready.remove(i)
        return False

    def _sync_plan(self) -> bool:
        """One scheduler iteration's plan under a multi-rank mesh: rank 0
        of the axis broadcasts the requests submitted since the last plan
        (their arguments), the KV chain exports asked of it meanwhile and
        whether it stops; every rank queues the same requests in the same
        order and serves the same exports. True to stop."""
        if self._leader:
            new = self._inbox_head
            self._inbox_head = []
            while True:
                try:
                    new.append(self._inbox.get_nowait())
                except queue.Empty:
                    break
            exports = self._export_requests()
            plan = [{"stop": self._stop.is_set(),
                     "requests": [{f: getattr(r, f) for f in _PLAN_FIELDS} for r in new],
                     "exports": [digest for digest, _ in exports]}]
        else:
            plan = [None]
        dist.broadcast_object_list(plan, src=self._leader_rank, group=self._control)
        if not self._leader:
            exports = [(digest, None) for digest in plan[0]["exports"]]
        if not self._leader:
            new = []
            for args in plan[0]["requests"]:
                req = Request(**args, submitted_at=time.monotonic())
                if self.telemetry is not None:
                    self.telemetry.on_submit(req)
                new.append(req)
            self.mirrored.extend(new)
        for req in new:
            self.pending.put(req)
        if exports:
            self._service_kv_exports(exports)
        return plan[0]["stop"]

    def _note_iter(self, t_iter: float) -> None:
        """Close one scheduler iteration: account its busy time and, in a
        timeline capture, put it on the host-sched lane."""
        now = time.monotonic()
        self._dispatcher.loop_busy_s += now - t_iter
        tl = self._timeline
        if tl is not None:
            tl.add(TRACK_HOST_SCHED, "iteration", t_iter, now)

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            self._loop()

    def _loop(self) -> None:
        """Scheduler iterations: admission, ONE bounded prefill chunk,
        spec-round interleaving, chunk sizing + block coverage (with the
        preemption ladder), then a decode dispatch into the window, whose
        oldest entry is drained (emitting its tokens) while the newest is
        on the card."""
        d = self._dispatcher
        while True:
            if self._control is not None:
                if self._sync_plan():
                    break
            elif self._stop.is_set():
                break
            t_iter = time.monotonic()
            if self._control is None and not self._kv_export_requests.empty():
                self._service_kv_exports(self._export_requests())
            self._admit_pending()
            prefilling = [i for i, s in enumerate(self.slots) if s.req is not None and not s.ready]
            ready = [i for i, s in enumerate(self.slots) if s.req is not None and s.ready]
            if not prefilling and not ready:
                if d.in_flight:
                    # nothing schedulable, but chunks are in flight: their
                    # readback is the only source of new work
                    try:
                        d.drain(block=True)
                    except Exception as e:  # noqa: BLE001
                        self._dispatch_failed(e)
                    self._note_iter(t_iter)
                    continue
                if self._control is not None:
                    # rank 0 waits for a submission; the next plan carries
                    # it to every rank, which waits for that plan
                    if self._leader:
                        try:
                            self._inbox_head.append(self._inbox.get(timeout=0.05))
                        except queue.Empty:
                            pass
                    continue
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
                        self._fail(req, str(e), "prefill", slot=i)
                    self._reset_draft_cache()  # the draft prefill may have died
                if not ready:
                    # nothing to decode yet, but finished in-flight chunks
                    # can retire while the next prompt prefills
                    try:
                        d.drain(block=False)
                    except Exception as e:  # noqa: BLE001
                        self._dispatch_failed(e)
                    self._note_iter(t_iter)
                    continue
            # split the ready slots into the SPECULATIVE group and the
            # PLAIN decode group; both dispatch in this iteration, so
            # neither starves, and a slot that outgrows spec eligibility
            # (near max_len) finishes on the plain path
            spec_idx = self._spec_eligible(ready)
            if spec_idx and d.in_flight:
                # a spec round reads and rewrites slot K/V and commits on
                # the host: it needs settled state, so the window drains
                # first, and eligibility is recomputed (the drain advanced
                # lengths and may have finished slots)
                try:
                    d.drain_all()
                except Exception as e:  # noqa: BLE001
                    self._dispatch_failed(e)
                    self._note_iter(t_iter)
                    continue
                ready = self._live(ready)
                spec_idx = self._spec_eligible(ready)
            # the plain group: every ready non-spec slot with tokens to
            # produce BEYOND what in-flight chunks already cover
            plain = [
                i for i in ready
                if i not in spec_idx and self.slots[i].remaining - d.inflight_steps[i] >= 1
            ]
            # plain chunk size: the LONGEST remaining want, rounded down to
            # a power of two (clamping to the shortest would put the batch
            # back into one round trip per token whenever a short request
            # is co-resident); slots finishing mid-chunk truncate
            # host-side. In-flight steps count as already produced.
            k_steps = 1
            if plain:
                want = max(self.slots[i].remaining - d.inflight_steps[i] for i in plain)
                room = min(
                    self.max_len - (self.slots[i].length + d.inflight_steps[i]) for i in plain
                )
                k_steps = self._pick_chunk(max(1, min(want, room + 1)))
            # grow every participating slot's table to cover this
            # iteration's writes; preempt youngest-first when the pool
            # runs dry, once the window has settled
            plain_set = set(plain)
            restart = False
            try:
                restart = self._cover(ready, spec_idx, plain_set, k_steps)
            except Exception as e:  # noqa: BLE001 — a spill's device error
                self._dispatch_failed(e)
                restart = True
            if restart:
                self._note_iter(t_iter)
                continue
            # liveness re-filter for BOTH groups: a preemption victim is
            # picked by admission time, not index order, so one whose own
            # turn already passed is still listed
            spec_idx = self._live(spec_idx)
            plain = self._live(plain)
            if spec_idx:
                self._run_spec_round(spec_idx)
                # spec commits may complete slots and free blocks
                plain = self._live(plain)
            try:
                if plain:
                    reqs = [self.slots[i].req for i in plain]
                    mode = sampling_mode(any(r.temperature > 0 for r in reqs),
                                         any(r.top_k > 0 or r.top_p < 1.0 for r in reqs))
                    d.dispatch(plain, k_steps, mode)
                    self.decode_steps += k_steps
                # window full (or nothing new dispatched): block on the
                # OLDEST entry while the card runs the newest; otherwise
                # consume only entries already read back
                d.drain(block=d.full or not plain)
            except Exception as e:  # noqa: BLE001 — device errors (OOM, …)
                self._dispatch_failed(e)
            self._note_iter(t_iter)
