"""HTTP server for the port's continuous-batching engine.

    python -m devspace_tpu_torch.serve --port N [--device cpu] [--kv-tier off|host|host+disk]

Speaks the contract of the reference server
(``examples/llama-inference/serve.py``) for plain and speculative serving:

- ``POST /generate`` — JSON ``{"prompt_ids": [...], "max_new_tokens": N}``
  plus optional ``temperature``, ``eos_id``, ``seed``, ``top_k``,
  ``top_p``, ``stop``, ``min_new_tokens``, ``logit_bias``, ``stream`` and
  ``kv_source`` (the base URL of a replica that prefilled this prompt:
  its KV chain is pulled from there instead of recomputed, and any
  failure falls back to recomputing). Replies ``{"tokens": [...]}``; with
  ``"stream": true`` newline-delimited JSON, one ``{"token": t}`` per
  token then ``{"done": true}``.
- ``POST /prefill`` — ``{"prompt_ids": [...]}``: runs the prompt for one
  token so its KV chain lands in the prefix cache, ready to export.
  Replies ``{"prefilled_tokens": n}``; 400 on bad input, 500 on an
  engine failure.
- ``GET /kv/chain/<digest>`` — the KVM1 envelope of the chain the digest
  names (``application/octet-stream``), for a peer's ``kv_source`` pull;
  404 for an unknown digest or with the tier off.
- ``GET /healthz`` — liveness plus the engine's ``stats()`` (its
  ``kv_tier`` is the tier's mode) and an ``slo`` block: each objective's
  multi-window burn-rate status.
- ``GET /readyz`` — 200, or 503 while any SLO is in breach or while
  draining (the load-shed signal; liveness stays ``/healthz``).
- ``POST /drain`` — enter drain mode (``{"off": true}`` leaves it):
  ``/readyz`` answers 503 while ``/healthz`` stays 200.
- ``GET /metrics`` — Prometheus text: the engine's registry (the
  ``engine_*`` families and the request-latency histograms) plus the
  process-wide one; OpenMetrics, with trace-id exemplars on the TTFT and
  e2e buckets, when the client accepts ``application/openmetrics-text``.
- ``GET /debug/events`` — the flight recorder's recent events
  (``?subsystem=engine``, ``?limit=N``); ``GET /debug/config`` — the
  effective serving configuration; ``GET /debug/requests`` — recent
  request traces (``?limit=N``, ``?outcome=completed|failed|in-flight``);
  ``GET /debug/spans`` — this process's request-phase and tracer spans
  (``?trace_id=``, ``?limit=``), the fleet collector's feed;
  ``GET /debug/trace?seconds=N`` — the engine's timeline for N seconds
  (0 < N <= 60) as Chrome-trace JSON.
- ``POST /generate_speculative`` — greedy only, through the engine's
  speculative path: ``{"prompt_ids": [...], "max_new_tokens": N}`` plus
  an optional ``k`` that must equal the engine's. Replies ``{"tokens":
  [...], "speculative": {rounds, acceptance_rate, tokens_per_round}}``
  (engine-cumulative); the tokens are those of ``/generate`` at
  temperature 0. A sampling, EOS or stream field is a 400 whatever its
  value; 501 when the engine has no draft model.
- anything else — 404.

An inbound W3C ``traceparent`` header on ``/generate``,
``/generate_speculative`` or ``/prefill`` joins the request's serving
spans to the caller's distributed trace.

Weights: ``CHECKPOINT=<dir>`` restores trained ones (a training root of
``step_NNNNNNNN`` dirs, whose latest step is served, or one checkpoint
dir: the train -> serve seam, ``inference.load_serving_params``; an
Orbax checkpoint of the JAX package converts with
``scripts/convert_checkpoint.py``); without it they are random, drawn
from a seeded ``torch.Generator`` on the device. ``QUANTIZE=int8``
serves weight-only int8 (any other value is refused). Environment:
``MODEL`` (tiny | llama2-7b | llama2-13b, default tiny: the config the
checkpoint must match), ``KV_DTYPE`` (int8 for a quantized pool),
``MAX_SLOTS``, ``CHUNK_MAX``, ``PORT`` (``--port`` wins); ``SPEC`` (0
turns the draft model off), ``SPEC_K``, ``SPEC_DEPTH``, ``DRAFT_MODEL``
(a config name; default: tiny drafts for itself, any other model has no
draft) and ``DRAFT_CHECKPOINT`` (the draft's trained weights, dense;
random without it). ``ENGINE_OVERLAP=off`` runs the serial decode
loop (dispatch depth 1; default: the depth-2 window), and ``PREWARM=1``
builds every program (``InferenceEngine.prewarm``) before the port
opens. ``--kv-tier`` turns on the host KV tier (``DEVSPACE_KV_TIER`` when
the flag is omitted; default off), which the KV chain endpoints need.
``--device`` defaults to cuda, and no CUDA is an error.

Telemetry, as the reference server's: ``DEVSPACE_ENGINE_METRICS=off``
turns the engine's metrics off, ``DEVSPACE_ENGINE_EVENTS=off`` the
flight recorder (``DEVSPACE_EVENT_RING`` events per subsystem, default
256). The SLOs behind ``/readyz`` read ``DEVSPACE_SLO_TTFT_P99_S``
(default 1.0), ``DEVSPACE_SLO_TOK_S_FLOOR`` (0.5),
``DEVSPACE_SLO_SHORT_WINDOW_S`` (300), ``DEVSPACE_SLO_LONG_WINDOW_S``
(3600) and are evaluated every ``DEVSPACE_SLO_INTERVAL_S`` (5) seconds;
``DEVSPACE_DRAIN=1`` starts the server draining.
"""

from __future__ import annotations

import argparse
import http.server
import json
import logging
import math
import os
import threading
import time
import weakref
from typing import Optional
from urllib.parse import parse_qs

import torch

from .device import resolve_device
from .inference import InferenceEngine, load_serving_params
from .inference.kv_tier import kv_payload_bytes
from .inference.quantization import quantize_params
from .models import transformer as tfm
from .obs import events as obs_events
from .obs import slo as obs_slo
from .obs.metrics import get_registry
from .obs.tracing import get_tracer
from .serving.gateway import LISTEN_BACKLOG

CONFIGS = {"tiny": tfm.TINY, "llama2-7b": tfm.LLAMA2_7B, "llama2-13b": tfm.LLAMA2_13B}
BLOCK_SIZE = 64  # the engine's paged-KV block, in tokens

log = logging.getLogger(__name__)


# fields /generate_speculative cannot honour: their PRESENCE is refused (a
# value-based allowlist would misread temperature 1.0 or eos_id 0)
SPEC_UNSUPPORTED = ("temperature", "eos_id", "top_k", "top_p", "stream", "stop",
                    "min_new_tokens", "logit_bias")


class SpecDisabled(RuntimeError):
    """The engine has no draft model (SPEC=0, or no DRAFT_MODEL)."""


def _slo_loop(ref, interval: float, stopped: threading.Event) -> None:
    """Evaluate the server's SLOs every ``interval`` seconds while it
    lives (a weak reference: the thread does not keep it, or its engine,
    alive) and until :meth:`Server.close`."""
    while not stopped.wait(interval):
        server = ref()
        if server is None:
            return
        try:
            server.slo.evaluate()
        except Exception:  # noqa: BLE001 — evaluation must not die
            log.exception("slo evaluation failed")
        del server


class Server:
    """The engine plus the server's own state: drain mode, the flight
    recorder of recent events, and the SLO evaluator that gates
    ``/readyz``, evaluated on a background thread every
    ``DEVSPACE_SLO_INTERVAL_S`` seconds. ``close()`` stops the thread and
    detaches the recorder."""

    def __init__(self, engine: InferenceEngine, model: str):
        self.engine = engine
        self.model = model
        # DEVSPACE_DRAIN=1 starts the server draining (spawn, then admit)
        self.draining = os.environ.get("DEVSPACE_DRAIN", "0") == "1"
        self.flight = None
        if obs_events.events_enabled():
            self.flight = obs_events.add_sink(obs_events.FlightRecorder(
                per_subsystem=int(os.environ.get("DEVSPACE_EVENT_RING", 256))))
        specs = obs_slo.default_serving_slos(
            ttft_threshold_s=float(os.environ.get("DEVSPACE_SLO_TTFT_P99_S", 1.0)),
            tok_s_floor=float(os.environ.get("DEVSPACE_SLO_TOK_S_FLOOR", 0.5)),
            short_window_s=float(os.environ.get("DEVSPACE_SLO_SHORT_WINDOW_S", 300.0)),
            long_window_s=float(os.environ.get("DEVSPACE_SLO_LONG_WINDOW_S", 3600.0)),
        )
        sources = []
        if engine.metrics_registry is not None:
            sources.append(engine.metrics_registry.snapshot)
        sources.append(get_registry().snapshot)
        self.slo = obs_slo.SLOEvaluator(specs, sources)
        self.slo.register_metrics(get_registry())
        self.slo_interval = float(os.environ.get("DEVSPACE_SLO_INTERVAL_S", 5.0))
        self._stopped = threading.Event()
        threading.Thread(target=_slo_loop, args=(weakref.ref(self), self.slo_interval,
                                                 self._stopped),
                         daemon=True, name="slo-eval").start()

    def close(self) -> None:
        """Stop the SLO thread and detach the flight recorder."""
        self._stopped.set()
        if self.flight is not None:
            obs_events.remove_sink(self.flight)
            self.flight = None

    def config(self) -> dict:
        """The effective serving configuration (``/debug/config``)."""
        cfg = self.engine.cfg
        return {
            "model": self.model,
            "layers": cfg.n_layers,
            "max_seq_len": cfg.max_seq_len,
            "vocab_size": cfg.vocab_size,
            "max_slots": self.engine.max_slots,
            "chunk_max": self.engine.chunk_max,
            "spec_k": self.engine.spec_k,
            "speculative": self.engine.draft_params is not None,
            "kv_tier": self.engine.kv_tier_mode,
            "checkpoint": os.environ.get("CHECKPOINT"),
            "quantize": os.environ.get("QUANTIZE"),
            "device": str(self.engine.device),
            "events_enabled": self.flight is not None,
            "draining": self.draining,
            "slo_interval_s": self.slo_interval,
            "slos": [s.to_dict() for s in self.slo.specs],
        }

    def generate_speculative(self, prompt_ids, max_new_tokens: int, k: Optional[int] = None,
                             traceparent: Optional[str] = None):
        """Greedy generation through the engine's speculative path ->
        (tokens, engine-cumulative speculation stats)."""
        if self.engine.draft_params is None:
            raise SpecDisabled(
                "speculative decoding disabled (SPEC=0, or no DRAFT_MODEL "
                "configured for a non-tiny MODEL)"
            )
        spec_k = self.engine.spec_k
        if k is not None:
            if not 1 <= k <= 16:
                raise ValueError(f"k must be in [1, 16], got {k}")
            if k != spec_k:
                raise ValueError(
                    f"k is engine-level: this server runs SPEC_K={spec_k}; omit k or pass {spec_k}"
                )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        tokens = self.engine.submit(prompt_ids, max_new_tokens,
                                    traceparent=traceparent).result(timeout=600)
        st = self.engine.stats()
        return tokens, {
            # engine-cumulative: slots interleave, so per-request numbers
            # would need per-slot counters
            "rounds": st["spec_rounds"],
            "acceptance_rate": st["spec_acceptance"],
            "tokens_per_round": (
                round(st["spec_committed"] / st["spec_rounds"], 2) if st["spec_rounds"] else 0.0
            ),
        }


def _generate_kwargs(body: dict) -> dict:
    return dict(
        temperature=float(body.get("temperature", 0.0)),
        eos_id=int(body["eos_id"]) if body.get("eos_id") is not None else None,
        seed=int(body.get("seed", 0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        stop=body.get("stop"),
        min_new_tokens=int(body.get("min_new_tokens", 0)),
        logit_bias=(
            {int(t): float(b) for t, b in body["logit_bias"].items()}
            if body.get("logit_bias")
            else None
        ),
        kv_source=str(body["kv_source"]) if body.get("kv_source") else None,
    )


def make_handler(server: Server):
    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length)) if length else {}
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        def _int_arg(self, qs: dict, name: str, default: int) -> Optional[int]:
            try:
                return int(qs.get(name, [str(default)])[0])
            except ValueError:
                self._json(400, {"error": f"{name} must be an integer"})
                return None

        def do_GET(self):
            path, _, query = self.path.partition("?")
            qs = parse_qs(query)
            if path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "model": server.model,
                    "device": str(server.engine.device),
                    "draining": server.draining,
                    "slo": server.slo.to_dict(),
                    **server.engine.stats(),
                })
            elif path == "/readyz":
                slo = server.slo.to_dict()
                ready = slo["ready"] and not server.draining
                self._json(200 if ready else 503,
                           {"ready": ready, "draining": server.draining, "slo": slo})
            elif path == "/metrics":
                # the engine's registry and the process-wide one: their
                # name prefixes are disjoint, so the concatenation is one
                # document (OpenMetrics: the engine part's "# EOF" dropped)
                eng = server.engine
                if "application/openmetrics-text" in (self.headers.get("Accept") or ""):
                    reg = eng.metrics_registry
                    part = reg.render_openmetrics().rsplit("# EOF", 1)[0] if reg else ""
                    body = part + get_registry().render_openmetrics()
                    ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
                else:
                    body = eng.metrics_text() + get_registry().render()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/debug/events":
                limit = self._int_arg(qs, "limit", 200)
                if limit is None:
                    return
                fr = server.flight
                self._json(200, {
                    "events_enabled": fr is not None,
                    "subsystems": fr.subsystems() if fr is not None else [],
                    "events": (fr.dump_dicts(qs.get("subsystem", [None])[0], limit)
                               if fr is not None else []),
                })
            elif path == "/debug/config":
                self._json(200, server.config())
            elif path == "/debug/spans":
                limit = self._int_arg(qs, "limit", 512)
                if limit is None:
                    return
                trace_id = qs.get("trace_id", [None])[0]
                tracer = get_tracer()
                found = tracer.find(trace_id) if trace_id else tracer.recent(max(0, limit))
                spans = [sp.to_dict() for sp in found]
                tel = server.engine.telemetry
                if tel is not None:
                    spans.extend(tel.recent_spans(limit=max(0, limit), trace_id=trace_id))
                self._json(200, {"process": f"serve:{os.getpid()}",
                                 "spans": spans[-max(0, limit):]})
            elif path == "/debug/requests":
                limit = self._int_arg(qs, "limit", 50)
                if limit is None:
                    return
                tel = server.engine.telemetry
                outcome = qs.get("outcome", [None])[0]
                # filter the whole ring, then keep the newest ``limit``
                rows = tel.recent(4096) if tel is not None else []
                if outcome is not None:
                    rows = [r for r in rows if (r.get("outcome") or "in-flight") == outcome]
                self._json(200, {"metrics_enabled": tel is not None,
                                 "requests": rows[-max(0, limit):] if limit else []})
            elif path == "/debug/trace":
                try:
                    seconds = float(qs.get("seconds", ["2"])[0])
                except ValueError:
                    self._json(400, {"error": "seconds must be a number"})
                    return
                if not 0 < seconds <= 60:
                    self._json(400, {"error": "seconds must be in (0, 60]"})
                    return
                self._json(200, server.engine.capture_timeline(seconds))
            elif path.startswith("/kv/chain/"):
                try:
                    envelope = server.engine.export_kv_chain(path[len("/kv/chain/"):])
                except Exception:  # noqa: BLE001 — a failed export is a miss
                    log.exception("kv chain export failed")
                    envelope = None
                if envelope is None:
                    self._json(404, {"error": "unknown chain digest"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(envelope)))
                self.end_headers()
                self.wfile.write(envelope)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/drain":
                try:
                    body = self._body()
                except ValueError:  # json.JSONDecodeError is a ValueError
                    self._json(400, {"error": "body must be JSON"})
                    return
                off = bool(body.get("off"))
                changed = server.draining == off
                server.draining = not off
                if changed:
                    obs_events.emit("serving", "drain_cleared" if off else "drain_started",
                                    level="info" if off else "warn", pid=os.getpid())
                self._json(200, {"draining": server.draining})
                return
            traceparent = self.headers.get("traceparent")
            if self.path == "/generate_speculative":
                try:
                    body = self._body()
                    unsupported = [f for f in SPEC_UNSUPPORTED if f in body]
                    if unsupported:
                        self._json(400, {
                            "error": "greedy-only endpoint; unsupported field(s): "
                            f"{', '.join(unsupported)} — use /generate for sampling/eos"
                        })
                        return
                    tokens, stats = server.generate_speculative(
                        body["prompt_ids"], int(body.get("max_new_tokens", 16)),
                        k=int(body["k"]) if "k" in body else None, traceparent=traceparent,
                    )
                    self._json(200, {"tokens": tokens, "speculative": stats})
                except SpecDisabled as e:
                    self._json(501, {"error": str(e)})
                except (ValueError, KeyError, TypeError) as e:  # client input
                    self._json(400, {"error": str(e)})
                except Exception:  # noqa: BLE001 — no internals in the reply
                    log.exception("speculative request failed")
                    self._json(500, {"error": "internal server error"})
                return
            if self.path == "/prefill":
                # the first phase of a two-phase placement: the chain lands
                # in the prefix cache, for a decode replica to pull
                try:
                    prompt = [int(t) for t in self._body()["prompt_ids"]]
                    server.engine.submit(prompt, 1, traceparent=traceparent).result(timeout=600)
                    self._json(200, {"prefilled_tokens": len(prompt)})
                except (ValueError, KeyError, TypeError) as e:  # client input
                    self._json(400, {"error": str(e)})
                except Exception:  # noqa: BLE001 — no internals in the reply
                    log.exception("prefill failed")
                    self._json(500, {"error": "internal server error"})
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                body = self._body()
                prompt = body["prompt_ids"]
                n = int(body.get("max_new_tokens", 16))
                handle = server.engine.submit(prompt, n, traceparent=traceparent,
                                              **_generate_kwargs(body))
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self._json(400, {"error": str(e)})
                return
            except RuntimeError as e:  # engine stopped
                self._json(503, {"error": str(e)})
                return
            if body.get("stream"):
                # once the 200 headers are out, errors are delivered
                # in-stream: a second response would corrupt the body
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                try:
                    for tok in handle.stream(timeout=600):
                        self.wfile.write(json.dumps({"token": tok}).encode() + b"\n")
                        self.wfile.flush()
                    self.wfile.write(json.dumps({"done": True}).encode() + b"\n")
                except ConnectionError:
                    pass  # client went away; the engine finishes the slot
                except (RuntimeError, TimeoutError) as e:
                    self.wfile.write(json.dumps({"error": str(e)}).encode() + b"\n")
                return
            try:
                tokens = handle.result(timeout=600)
            except (RuntimeError, TimeoutError) as e:
                log.error("request failed: %s", e)
                self._json(500, {"error": "internal server error"})
                return
            self._json(200, {"tokens": tokens})

    return Handler


class _HTTPServer(http.server.ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


def make_http_server(server: Server, host: str = "0.0.0.0", port: int = 8000):
    """A ThreadingHTTPServer for ``server`` (port 0 picks a free one) whose
    accept queue holds the gateway's ``LISTEN_BACKLOG`` connections; the
    caller runs ``serve_forever`` and ``shutdown``."""
    return _HTTPServer((host, port), make_handler(server))


def kv_tier_budget(cfg: tfm.TransformerConfig, max_slots: int) -> int:
    """The host KV tier's bytes for a server's engine: one KVT1 payload
    for every block of its pool, and never less than the engine's own
    256 MiB default. The tier must hold whole chains: a chain or KVM1
    envelope longer than the tier evicts its own root while it is put,
    and then none of it restores (at Llama-2-7B, 256 MiB holds 15 of the
    17.3 MB payloads, less than one 1024-token prompt)."""
    blocks = max_slots * math.ceil(cfg.max_seq_len / BLOCK_SIZE)
    payload = kv_payload_bytes(cfg.n_layers, cfg.n_kv_heads, BLOCK_SIZE, cfg.head_dim)
    return max(256 << 20, blocks * payload)


def build_engine(
    model: str = "tiny",
    device: Optional[str] = None,
    kv_dtype: Optional[str] = None,
    max_slots: int = 8,
    chunk_max: int = 8,
    draft_model: Optional[str] = None,
    spec_k: int = 4,
    spec_depth: int = 1,
    dispatch_depth: Optional[int] = None,
    kv_tier: Optional[str] = None,
    checkpoint: Optional[str] = None,
    quantize: Optional[str] = None,
    draft_checkpoint: Optional[str] = None,
) -> InferenceEngine:
    """An engine for ``model`` on ``device``: its weights restored from
    ``checkpoint`` (``inference.load_serving_params``), else random (seed
    0); ``quantize="int8"`` serves them weight-only int8. With
    ``draft_model`` (a config name sharing the vocabulary), also a draft
    for speculative decoding, restored dense from ``draft_checkpoint``,
    else random (seed 1). ``kv_tier`` is the engine's (``None`` reads
    ``DEVSPACE_KV_TIER``), its budget :func:`kv_tier_budget`."""
    if model not in CONFIGS:
        raise ValueError(f"MODEL={model!r} unknown (choices: {', '.join(CONFIGS)})")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if draft_checkpoint is not None and draft_model is None:
        raise ValueError("a draft checkpoint needs its config: name it with DRAFT_MODEL")
    cfg = CONFIGS[model]
    dev = resolve_device(device)
    if checkpoint:
        params, step = load_serving_params(checkpoint, cfg, device=dev, quantize=quantize)
        print(f"restored {model} params from {checkpoint}"
              + (f" (step {step})" if step is not None else "")
              + (f", {quantize} weights" if quantize else ""), flush=True)
    else:
        params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        if quantize:
            params = quantize_params(params)
    draft_params = draft_cfg = None
    if draft_model is not None:
        if draft_model not in CONFIGS:
            raise ValueError(
                f"DRAFT_MODEL={draft_model!r} unknown (choices: {', '.join(CONFIGS)})"
            )
        draft_cfg = CONFIGS[draft_model]
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model '{draft_model}' has vocab_size {draft_cfg.vocab_size} != "
                f"target {cfg.vocab_size}: a draft must share the target's vocabulary"
            )
        if draft_checkpoint:
            draft_params, dstep = load_serving_params(draft_checkpoint, draft_cfg, device=dev)
            print(f"restored draft '{draft_model}' params from {draft_checkpoint}"
                  + (f" (step {dstep})" if dstep is not None else ""), flush=True)
        else:
            draft_params = tfm.init_params(draft_cfg,
                                           torch.Generator(device=dev).manual_seed(1))
    return InferenceEngine(
        params, cfg, max_slots=max_slots, chunk_max=chunk_max, block_size=BLOCK_SIZE,
        kv_dtype=kv_dtype, device=dev,
        draft_params=draft_params, draft_cfg=draft_cfg, spec_k=spec_k, spec_depth=spec_depth,
        dispatch_depth=dispatch_depth, kv_tier=kv_tier,
        kv_tier_bytes=kv_tier_budget(cfg, max_slots),
    )


def draft_model_from_env(model: str) -> Optional[str]:
    """The reference server's draft policy: ``SPEC=0`` turns speculation
    off; otherwise ``DRAFT_MODEL`` names the draft's config, and by
    default only tiny drafts for itself (for a real model a self-draft
    would double the weights and speed nothing up). ``DRAFT_CHECKPOINT``
    (read by :func:`main`) restores the draft's weights."""
    if os.environ.get("SPEC", "1") == "0":
        return None
    return os.environ.get("DRAFT_MODEL", "tiny" if model == "tiny" else None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 8000)))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default=None)
    ap.add_argument("--kv-tier", choices=["off", "host", "host+disk"], default=None,
                    help="spill evicted KV prefix chains to host RAM (optionally disk-backed) "
                         "and restore them on a match; defaults to $DEVSPACE_KV_TIER, else off")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = os.environ.get("MODEL", "tiny")
    quantize = os.environ.get("QUANTIZE") or None
    if quantize and quantize != "int8":
        raise SystemExit(f"QUANTIZE={quantize!r} (only int8 exists)")
    draft_model = draft_model_from_env(model)
    t0 = time.monotonic()
    engine = build_engine(
        model,
        device=args.device,
        kv_dtype=os.environ.get("KV_DTYPE") or None,
        max_slots=int(os.environ.get("MAX_SLOTS", 8)),
        chunk_max=int(os.environ.get("CHUNK_MAX", 8)),
        draft_model=draft_model,
        spec_k=int(os.environ.get("SPEC_K", 4)),
        spec_depth=int(os.environ.get("SPEC_DEPTH", 1)),
        dispatch_depth=1 if os.environ.get("ENGINE_OVERLAP") == "off" else None,
        kv_tier=args.kv_tier,
        checkpoint=os.environ.get("CHECKPOINT") or None,
        quantize=quantize,
        # the draft's checkpoint counts only when there is a draft, as in
        # the reference server
        draft_checkpoint=(os.environ.get("DRAFT_CHECKPOINT") or None) if draft_model else None,
    )
    print(f"engine built in {time.monotonic() - t0:.2f}s", flush=True)
    if os.environ.get("PREWARM", "0") == "1":
        t0 = time.monotonic()
        timings = engine.prewarm()
        print(f"prewarmed {len(timings)} programs in {time.monotonic() - t0:.2f}s", flush=True)
    engine.start()
    server = Server(engine, model)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving {model} on {engine.device} at :{httpd.server_address[1]} "
          f"(kv tier {engine.kv_tier_mode})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
        engine.stop()


if __name__ == "__main__":
    main()
