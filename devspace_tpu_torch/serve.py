"""HTTP server for the port's continuous-batching engine.

    python -m devspace_tpu_torch.serve --port N [--device cpu]

Speaks the contract of the reference server
(``examples/llama-inference/serve.py``) for plain serving:

- ``POST /generate`` — JSON ``{"prompt_ids": [...], "max_new_tokens": N}``
  plus optional ``temperature``, ``eos_id``, ``seed``, ``top_k``,
  ``top_p``, ``stop``, ``min_new_tokens``, ``logit_bias`` and ``stream``.
  Replies ``{"tokens": [...]}``; with ``"stream": true`` newline-
  delimited JSON, one ``{"token": t}`` per token then ``{"done": true}``.
- ``GET /healthz`` — liveness plus the engine's ``stats()``.
- ``GET /readyz`` — 200, or 503 while draining.
- ``POST /drain`` — enter drain mode (``{"off": true}`` leaves it):
  ``/readyz`` answers 503 while ``/healthz`` stays 200.
- ``POST /generate_speculative`` — 501: speculative decoding is not in
  this port yet, as the reference answers with ``SPEC=0``.
- anything else — 404.

Weights are random, drawn from a seeded ``torch.Generator`` on the
device. Environment: ``MODEL`` (tiny | llama2-7b | llama2-13b, default
tiny), ``KV_DTYPE`` (int8 for a quantized pool), ``MAX_SLOTS``,
``CHUNK_MAX``, ``PORT`` (``--port`` wins). ``--device`` defaults to
cuda, and no CUDA is an error.
"""

from __future__ import annotations

import argparse
import http.server
import json
import logging
import os
from typing import Optional

import torch

from .device import resolve_device
from .inference import InferenceEngine
from .models import transformer as tfm

CONFIGS = {"tiny": tfm.TINY, "llama2-7b": tfm.LLAMA2_7B, "llama2-13b": tfm.LLAMA2_13B}

log = logging.getLogger(__name__)


class Server:
    """The engine plus the server's own state (drain mode)."""

    def __init__(self, engine: InferenceEngine, model: str):
        self.engine = engine
        self.model = model
        self.draining = False


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

        def do_GET(self):
            path = self.path.partition("?")[0]
            if path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "model": server.model,
                    "device": str(server.engine.device),
                    "draining": server.draining,
                    **server.engine.stats(),
                })
            elif path == "/readyz":
                ready = not server.draining
                self._json(200 if ready else 503, {"ready": ready, "draining": server.draining})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/drain":
                try:
                    body = self._body()
                except ValueError:  # json.JSONDecodeError is a ValueError
                    self._json(400, {"error": "body must be JSON"})
                    return
                server.draining = not bool(body.get("off"))
                self._json(200, {"draining": server.draining})
                return
            if self.path == "/generate_speculative":
                self._json(501, {"error": "speculative decoding is not available in this server"})
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                body = self._body()
                prompt = body["prompt_ids"]
                n = int(body.get("max_new_tokens", 16))
                handle = server.engine.submit(prompt, n, **_generate_kwargs(body))
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


def make_http_server(server: Server, host: str = "0.0.0.0", port: int = 8000):
    """A ThreadingHTTPServer for ``server`` (port 0 picks a free one);
    the caller runs ``serve_forever`` and ``shutdown``."""
    return http.server.ThreadingHTTPServer((host, port), make_handler(server))


def build_engine(
    model: str = "tiny",
    device: Optional[str] = None,
    kv_dtype: Optional[str] = None,
    max_slots: int = 8,
    chunk_max: int = 8,
) -> InferenceEngine:
    """An engine for ``model`` with random weights (seed 0) on ``device``."""
    if model not in CONFIGS:
        raise ValueError(f"MODEL={model!r} unknown (choices: {', '.join(CONFIGS)})")
    cfg = CONFIGS[model]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(cfg, gen)
    return InferenceEngine(
        params, cfg, max_slots=max_slots, chunk_max=chunk_max,
        kv_dtype=kv_dtype, device=dev,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 8000)))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = os.environ.get("MODEL", "tiny")
    engine = build_engine(
        model,
        device=args.device,
        kv_dtype=os.environ.get("KV_DTYPE") or None,
        max_slots=int(os.environ.get("MAX_SLOTS", 8)),
        chunk_max=int(os.environ.get("CHUNK_MAX", 8)),
    ).start()
    httpd = make_http_server(Server(engine, model), args.host, args.port)
    print(f"serving {model} on {engine.device} at :{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
