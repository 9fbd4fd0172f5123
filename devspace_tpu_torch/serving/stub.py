"""Deterministic stub serving replica — the fleet layer's crash-test dummy.

Speaks the llama-inference example's serving protocol (``/generate``
with ndjson streaming, ``/healthz``, ``/readyz``, ``POST /drain``,
``/metrics`` in Prometheus 0.0.4 with the engine family names the
collector/autoscaler read, ``/debug/events``) but replaces the JAX
engine with a deterministic token generator, so a 3-replica fleet boots
in well under a second and every byte of every stream is predictable:

    token_at(prompt_ids, i)  ==  the i-th token any healthy replica emits

That predictability is what lets the chaos gate
(scripts/chaos_serving_check.py) and the loadgen assert **zero
corrupted streams** — a surviving stream must carry exactly the
expected token sequence; anything else is corruption, not bad luck.

Chaos is first-class: ``POST /chaos`` flips failure modes at runtime —

- ``{"hang": true}``        — /readyz and /healthz handlers block
  (simulates a wedged process: alive but unresponsive; the fleet
  manager's probe must time out and restart it)
- ``{"metrics_garbage": true}`` — /metrics returns non-exposition bytes
  (the collector must quarantine, never corrupt the merge)
- ``{"exit": N}``           — process exits with code N

Env knobs: ``PORT``, ``STUB_MAX_SLOTS`` (admission concurrency, default
4), ``STUB_TOKEN_DELAY_S`` (per-token sleep, default 0.02 — requests
may override with a ``token_delay_s`` field), ``STUB_STARTUP_DELAY_S``
(sleep before binding, for ready-timeout tests),
``STUB_PREFILL_DELAY_PER_TOKEN_S`` (simulated prefill cost per
*uncached* prompt token, default 0 — set it to make prefix-cache
locality physically observable in TTFT),
``STUB_PREFILL_INTERFERENCE`` (continuous-batching stall factor,
default 0 — while a prefill bill is running, every OTHER request on
this replica pays its sleeps stretched by ``1 + factor * active
prefills``, the decode interference that disaggregated prefill removes
from decode replicas), ``STUB_PREFIX_BLOCK``
(fingerprint block size, default 8 — must match the router's
``block_size`` for the shadow index to mirror reality).

The stub keeps a real radix-shaped prefix memory (the same blake2b
block-digest chains as :mod:`devspace_tpu_torch.inference.prefix_cache`) and
reports ``engine_prefix_hit_tokens_total`` through its callback
metrics, so routing efficacy — cache-hit tokens per routed request —
is observable end-to-end without a JAX engine.

The port's copy of ``devspace_tpu/serving/stub.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from ..inference.kv_tier import (
    KVMigrationClient,
    pack_chain_envelope,
    pack_kv_payload,
    unpack_chain_envelope,
)
from ..inference.prefix_cache import fingerprint_chain
from ..obs import events as obs_events
from ..obs.metrics import Registry, WindowedRate
from ..resilience.policy import RetryPolicy
from .router import ShadowRadixIndex

VOCAB = 50_000


def synth_kv_payload(digest: str, block_size: int = 8) -> bytes:
    """A tiny but REAL packed KV block derived deterministically from its
    digest — real KVT1 header, real checksums over real int8/f32 buffers,
    so the migration wire format (and its rejection of bit flips) is
    exercised end-to-end without a JAX engine."""
    rng = np.random.default_rng(int(digest[:16], 16))
    shape = (1, 1, block_size, 4)  # L, Hkv, bs, D
    kq = rng.integers(-128, 128, shape, dtype=np.int8)
    vq = rng.integers(-128, 128, shape, dtype=np.int8)
    ks = rng.random(shape[:3], dtype=np.float32)
    vs = rng.random(shape[:3], dtype=np.float32)
    return pack_kv_payload(kq, ks, vq, vs)


def token_at(prompt_ids, i: int) -> int:
    """The i-th output token for ``prompt_ids`` — shared contract between
    stub replicas and stream verifiers (loadgen, the chaos gate). Any
    deviation observed by a client is stream corruption by definition."""
    seed = 0
    for t in prompt_ids:
        seed = (seed * 31 + int(t) + 7) % VOCAB
    return (seed + 13 * (i + 1)) % VOCAB


class StubState:
    """Counters + chaos flags shared across handler threads."""

    def __init__(self, max_slots: int = 4):
        self.max_slots = max(1, int(max_slots))
        self.lock = threading.Lock()
        self.active = 0
        self.queued = 0
        self.completed = 0
        self.failed = 0
        self.draining = os.environ.get("DEVSPACE_DRAIN", "0") == "1"
        self.hang = False
        self.metrics_garbage = False
        self.slots = threading.Semaphore(self.max_slots)

        # radix-shaped prefix memory: same digest chains as the real
        # cache, LRU-bounded, guarded by self.lock
        self.prefix_block = max(
            1, int(os.environ.get("STUB_PREFIX_BLOCK", 8)))
        self.prefix = ShadowRadixIndex(
            max_blocks=int(os.environ.get("STUB_PREFIX_MAX_BLOCKS", 4096)))
        self.prefix_hit_tokens = 0
        # prefill bills currently sleeping on this replica — co-resident
        # requests stall in proportion (continuous-batching interference)
        self.prefill_active = 0

        # disaggregated prefill/decode surface: materialized KV blocks
        # (real wire payloads, synthesized per digest) served over
        # /kv/chain/<digest> and pulled on ``kv_source`` requests
        self.kv_blocks: dict = {}   # digest -> packed payload
        self.kv_chains: dict = {}   # leaf digest -> [digests root->leaf]
        self.kv_garbage = False     # chaos: corrupt served envelopes
        self.kv_migrate_chains = 0
        self.kv_migrate_blocks = 0
        self.kv_migrate_bytes = 0
        self.kv_migrate_failures = 0
        self.kv_restore_fallbacks = 0
        self.kv_export_chains = 0

        self.registry = Registry()
        reg = self.registry
        self.m_completed = reg.counter(
            "engine_requests_completed_total", "Requests finished")
        self.m_failed = reg.counter(
            "engine_requests_failed_total", "Requests failed")
        self.rate = WindowedRate(10.0)
        reg.register_callback(
            "engine_tokens_per_sec_10s", "gauge",
            "Emitted tokens/s over a 10s window", self.rate.rate)
        reg.register_callback(
            "engine_active_slots", "gauge", "In-flight requests",
            lambda: self.active)
        reg.register_callback(
            "engine_max_slots", "gauge", "Admission concurrency",
            lambda: self.max_slots)
        reg.register_callback(
            "engine_queued_requests", "gauge",
            "Requests waiting for a slot", lambda: self.queued)
        reg.register_callback(
            "engine_dispatch_depth_occupancy", "gauge",
            "Slot occupancy fraction",
            lambda: self.active / self.max_slots)
        reg.register_callback(
            "engine_prefix_hit_tokens_total", "counter",
            "Prompt tokens served from the radix prefix cache",
            lambda: self.prefix_hit_tokens)
        reg.register_callback(
            "engine_kv_migrate_chains_total", "counter",
            "KV chains pulled from a peer replica",
            lambda: self.kv_migrate_chains)
        reg.register_callback(
            "engine_kv_migrate_blocks_total", "counter",
            "KV blocks imported through chain migration",
            lambda: self.kv_migrate_blocks)
        reg.register_callback(
            "engine_kv_migrate_bytes_total", "counter",
            "Envelope bytes pulled through chain migration",
            lambda: self.kv_migrate_bytes)
        reg.register_callback(
            "engine_kv_migrate_failures_total", "counter",
            "KV chain pulls that failed (degraded to recompute)",
            lambda: self.kv_migrate_failures)
        reg.register_callback(
            "engine_kv_restore_fallbacks_total", "counter",
            "Requests that recomputed prefill after a failed restore",
            lambda: self.kv_restore_fallbacks)
        reg.register_callback(
            "engine_kv_export_chains_total", "counter",
            "KV chain envelopes served to peer replicas",
            lambda: self.kv_export_chains)
        self.ttft = reg.histogram("ttft_seconds", "Time to first token")
        self.e2e = reg.histogram("request_e2e_seconds", "End-to-end latency")


def main(argv=None) -> int:
    import argparse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("PORT", 8000)))
    args = ap.parse_args(argv)

    startup_delay = float(os.environ.get("STUB_STARTUP_DELAY_S", 0))
    if startup_delay:
        time.sleep(startup_delay)

    state = StubState(max_slots=int(os.environ.get("STUB_MAX_SLOTS", 4)))
    default_delay = float(os.environ.get("STUB_TOKEN_DELAY_S", 0.02))
    prefill_delay = float(
        os.environ.get("STUB_PREFILL_DELAY_PER_TOKEN_S", 0))
    prefill_interference = float(
        os.environ.get("STUB_PREFILL_INTERFERENCE", 0))
    prefill_interference_min_s = float(
        os.environ.get("STUB_PREFILL_INTERFERENCE_MIN_S", 0.05))

    def billed_prefill(seconds):
        """Charge a prefill bill while registered as an ACTIVE prefill.
        Slept in 25ms quanta, each stretched by the OTHER prefills
        running concurrently. Prefill is compute-bound, so N overlapping
        prefills fair-share the chip — the stretch among prefills is
        time-slicing (1 + others), capped there no matter how large the
        interference knob is; the knob's full value only hits decode
        (see ``stalled``), which is memory-bound and loses
        disproportionately when a prefill grabs the compute. Bills
        under STUB_PREFILL_INTERFERENCE_MIN_S (one prefill chunk's
        worth) ride along inside the continuous batch like any short
        prompt under chunked prefill — they neither stall decode nor
        register as active. With STUB_PREFILL_INTERFERENCE=0 (default)
        this is a plain sleep(seconds)."""
        if seconds <= 0:
            return
        if seconds < prefill_interference_min_s:
            time.sleep(seconds)
            return
        share = min(1.0, prefill_interference)
        with state.lock:
            state.prefill_active += 1
        try:
            remaining = seconds
            while remaining > 0:
                q = min(0.025, remaining)
                others = max(0, state.prefill_active - 1)
                time.sleep(q * (1.0 + share * others))
                remaining -= q
        finally:
            with state.lock:
                state.prefill_active -= 1

    def stalled(delay):
        """A decode-side sleep, stretched by active prefill bills."""
        return delay * (1.0 + prefill_interference * state.prefill_active)
    flight = obs_events.add_sink(obs_events.FlightRecorder(per_subsystem=128))
    kv_client = KVMigrationClient(retry=RetryPolicy(
        max_attempts=2, base_delay=0.02, max_delay=0.05, jitter=0.5,
        retry_on=(OSError,), seed=0), timeout_s=5.0)

    def materialize_chain(chain):
        """Synthesize-and-retain KV payloads for every digest of a
        prefilled chain (caller holds state.lock)."""
        for digest in chain:
            if digest not in state.kv_blocks:
                state.kv_blocks[digest] = synth_kv_payload(
                    digest, state.prefix_block)
        if chain:
            state.kv_chains[chain[-1]] = list(chain)

    def chain_for(digest):
        """Root->leaf digest run ending at ``digest``, or None. Leaf
        lookups are O(1); mid-chain digests fall back to a scan (rare:
        a decode replica always asks for the leaf it computed)."""
        chain = state.kv_chains.get(digest)
        if chain is not None:
            return chain
        for run in state.kv_chains.values():
            if digest in run:
                return run[:run.index(digest) + 1]
        return None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: N802 — quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            path = self.path.partition("?")[0]
            if path in ("/healthz", "/readyz") and state.hang:
                # wedged-process simulation: the handler blocks until the
                # probe side gives up (daemon_threads, so exit still works)
                time.sleep(3600)
                return
            if path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "model": "stub",
                    "draining": state.draining,
                    "active_requests": state.active,
                    "queued_requests": state.queued,
                    "requests_completed": state.completed,
                    "requests_failed": state.failed,
                    "max_slots": state.max_slots,
                })
            elif path == "/readyz":
                ready = not state.draining
                self._json(200 if ready else 503,
                           {"ready": ready, "draining": state.draining})
            elif path == "/metrics":
                if state.metrics_garbage:
                    body = b"!! this is not a prometheus exposition !!\n\x00"
                else:
                    body = state.registry.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/debug/events":
                self._json(200, {
                    "events_enabled": True,
                    "subsystems": flight.subsystems(),
                    "events": flight.dump_dicts(None, 200),
                })
            elif path.startswith("/kv/chain/"):
                digest = path[len("/kv/chain/"):]
                with state.lock:
                    chain = chain_for(digest)
                    blocks = [(d, state.kv_blocks[d]) for d in chain] \
                        if chain and all(
                            d in state.kv_blocks for d in chain) else None
                if not blocks:
                    self._json(404, {"error": "unknown chain digest"})
                    return
                envelope = pack_chain_envelope(blocks)
                if state.kv_garbage:
                    # chaos: flip one payload byte; the puller's
                    # checksum must reject and degrade to recompute
                    mid = len(envelope) // 2
                    envelope = (envelope[:mid]
                                + bytes([envelope[mid] ^ 0xFF])
                                + envelope[mid + 1:])
                with state.lock:
                    state.kv_export_chains += 1
                self.send_response(200)
                self.send_header(
                    "Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(envelope)))
                self.end_headers()
                self.wfile.write(envelope)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length)) if length else {}
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "body must be JSON"})
                return
            if self.path == "/drain":
                off = bool(req.get("off"))
                changed = state.draining == off
                state.draining = not off
                if changed:
                    obs_events.emit(
                        "serving",
                        "drain_cleared" if off else "drain_started",
                        level="info" if off else "warn", pid=os.getpid(),
                    )
                self._json(200, {"draining": state.draining})
            elif self.path == "/chaos":
                if "hang" in req:
                    state.hang = bool(req["hang"])
                if "metrics_garbage" in req:
                    state.metrics_garbage = bool(req["metrics_garbage"])
                if "kv_garbage" in req:
                    state.kv_garbage = bool(req["kv_garbage"])
                self._json(200, {
                    "hang": state.hang,
                    "metrics_garbage": state.metrics_garbage,
                    "kv_garbage": state.kv_garbage,
                })
                if "exit" in req:
                    os._exit(int(req["exit"]))
            elif self.path == "/prefill":
                self._prefill(req)
            elif self.path == "/generate":
                self._generate(req)
            else:
                self._json(404, {"error": "not found"})

        def _prefill(self, req):
            """Phase 1 of two-phase placement: run (simulate) the
            prompt's prefill, publish the chain locally, and materialize
            its KV blocks so a decode replica can pull them."""
            try:
                prompt = [int(t) for t in req["prompt_ids"]]
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            state.slots.acquire()
            with state.lock:
                state.active += 1
            try:
                chain = fingerprint_chain(prompt, state.prefix_block)
                with state.lock:
                    hit = min(
                        state.prefix.overlap("self", chain)
                        * state.prefix_block,
                        len(prompt))
                    state.prefix_hit_tokens += hit
                    state.prefix.observe("self", chain)
                    materialize_chain(chain)
                if prefill_delay:
                    billed_prefill(prefill_delay * (len(prompt) - hit))
                self._json(200, {
                    "prefilled_tokens": len(prompt),
                    "cached_tokens": hit,
                    "chain": chain[-1] if chain else None,
                    "blocks": len(chain),
                })
            finally:
                with state.lock:
                    state.active -= 1
                state.slots.release()

        def _generate(self, req):
            try:
                prompt = [int(t) for t in req["prompt_ids"]]
                n = int(req.get("max_new_tokens", 16))
                delay = float(req.get("token_delay_s", default_delay))
                if n < 1:
                    raise ValueError("max_new_tokens must be >= 1")
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            t0 = time.monotonic()
            with state.lock:
                state.queued += 1
            state.slots.acquire()
            with state.lock:
                state.queued -= 1
                state.active += 1
            try:
                tokens = [token_at(prompt, i) for i in range(n)]
                # prefix-cache accounting: hit = leading digest run of
                # the prompt chain already cached here; only uncached
                # prompt tokens pay the simulated prefill cost. The full
                # prompt+reply chain is published afterwards, exactly
                # like the real radix cache after decode.
                chain = fingerprint_chain(prompt, state.prefix_block)
                with state.lock:
                    hit = min(
                        state.prefix.overlap("self", chain)
                        * state.prefix_block,
                        len(prompt))
                    state.prefix_hit_tokens += hit
                # two-phase placement: the router prefilled this prompt
                # elsewhere; pull the KV chain instead of recomputing.
                # ANY failure (miss, I/O, checksum) degrades to local
                # recompute-prefill and counts a restore fallback.
                kv_source = req.get("kv_source")
                migrated = 0
                if (kv_source and chain
                        and len(prompt) - hit >= state.prefix_block):
                    try:
                        envelope = kv_client.fetch(
                            str(kv_source), chain[-1])
                        blocks = unpack_chain_envelope(envelope)
                        got = {d for d, _ in blocks}
                        run = 0
                        for d in chain:
                            if d not in got:
                                break
                            run += 1
                        migrated = max(
                            0, min(run * state.prefix_block,
                                   len(prompt)) - hit)
                        with state.lock:
                            state.kv_migrate_chains += 1
                            state.kv_migrate_blocks += len(blocks)
                            state.kv_migrate_bytes += len(envelope)
                            for d, payload in blocks:
                                state.kv_blocks.setdefault(d, payload)
                            state.kv_chains[blocks[-1][0]] = [
                                d for d, _ in blocks]
                    except Exception as e:  # noqa: BLE001 — degrade, never corrupt
                        with state.lock:
                            state.kv_migrate_failures += 1
                            state.kv_restore_fallbacks += 1
                        obs_events.emit(
                            "kv_tier", "migrate_failed", level="warn",
                            source=str(kv_source),
                            reason=type(e).__name__)
                with state.lock:
                    state.prefix.observe("self", chain)
                if prefill_delay:
                    billed_prefill(
                        prefill_delay * (len(prompt) - hit - migrated))
                if req.get("stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/x-ndjson")
                    self.end_headers()
                    first = True
                    for tok in tokens:
                        time.sleep(stalled(delay))
                        if first:
                            state.ttft.observe(time.monotonic() - t0)
                            first = False
                        self.wfile.write(
                            json.dumps({"token": tok}).encode() + b"\n")
                        self.wfile.flush()
                        state.rate.add(1)
                    self.wfile.write(
                        json.dumps({"done": True}).encode() + b"\n")
                else:
                    time.sleep(stalled(delay) * n)
                    state.ttft.observe(time.monotonic() - t0)
                    state.rate.add(n)
                    self._json(200, {"tokens": tokens})
                with state.lock:
                    state.completed += 1
                    state.prefix.observe("self", fingerprint_chain(
                        prompt + tokens, state.prefix_block))
                state.m_completed.inc()
                state.e2e.observe(time.monotonic() - t0)
            except (ConnectionError, BrokenPipeError):
                with state.lock:
                    state.failed += 1
                state.m_failed.inc()
            finally:
                with state.lock:
                    state.active -= 1
                state.slots.release()

    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    httpd.daemon_threads = True  # hung/chaos handlers never block exit
    print(f"stub replica serving on :{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
