"""Routing gateway: the HTTP frontend over the replica fleet.

One process, one port, N replicas behind it. The gateway parses just
enough of each ``/generate`` body to fingerprint the token prefix and
read the tenant tag, asks :class:`~.router.PrefixRouter` for a
decision, and proxies the stream byte-for-byte — it never interprets
tokens, so any replica speaking the serving protocol (the real engine
server or the stub) works unchanged.

Failure discipline (what keeps chaos runs at zero corrupted streams):

- connect/first-byte failure → the replica is dead or saturating; the
  gateway **reroutes** the request (avoiding every replica already
  tried this attempt), counting ``serving_router_retries_total`` and
  emitting ``router.retry_rerouted``. The client never notices. A
  replica can also take the connection and stay silent: one killed
  while its process still tears down keeps its listening socket until
  the teardown ends, and the kernel accepts the connection into its
  backlog with nothing behind it, so the gateway waits for as long as
  its timeout lets it. ``header_timeout_s`` bounds how long
  a streamed request waits for a replica's response headers before it
  counts as such a failure; set it where the replicas answer at once
  (the engine's server sends a stream's headers when the engine has
  queued the request). By default the request's timeout applies, as in
  the reference, which suits replicas that answer only after a queue or
  a prefill (the stub). ``prefill_timeout_s`` bounds the same way how
  long a two-phase placement waits for its prefill pool's answer: past
  it, phase 1 counts as failed and the request degrades to unified
  placement, as for any other phase-1 failure.
- failure **after** payload bytes were forwarded → the gateway must NOT
  retry (replaying would duplicate tokens into the half-written client
  stream — exactly the corruption the loadgen hunts). It drops the
  connection so the client sees a dead stream and retries itself; the
  retry arrives as a fresh request and reroutes. Counted as
  ``serving_router_upstream_failures_total``.

Admission verdicts map to HTTP: REJECT → 429 with a JSON body carrying
the projection, QUEUE → the handler re-polls the router until the
projection clears the warn band or ``queue_timeout_s`` expires (then
429). ``/drain`` flips ``/readyz`` to 503 exactly like a replica, so a
fleet of gateways is itself drainable.

Endpoints: ``POST /generate`` (routed proxy), ``GET /healthz``,
``/readyz``, ``/metrics`` (the ``serving_router_*`` catalog),
``/debug/router`` (live stats + recent decisions).

The port's copy of ``devspace_tpu/serving/gateway.py``; it imports nothing
of the JAX package. One difference: the proxy forwards whatever the
replica has streamed so far, where the reference's waits for 8 KiB or
the stream's end, which holds a token stream back until it completes
(its first token arrives with its last), and its accept queue holds
``LISTEN_BACKLOG`` connections, not socketserver's 5.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from ..obs import events as obs_events
from ..resilience.policy import IdleBackoff
from .router import ADMIT, QUEUE, REJECT, PrefixRouter

# endpoints proxied verbatim to the routed replica
_HOP_HEADERS = {"host", "content-length", "connection"}
# the accept queue: a burst of clients (a wave of requests, the retries
# after a replica dies) overflows socketserver's default of 5, and a
# dropped connection waits out its SYN's retransmits (1, 3, 7 s)
LISTEN_BACKLOG = 128


class RoutingGateway:
    """Owns a :class:`PrefixRouter` and a ThreadingHTTPServer frontend.

    ``replicas_fn`` is the live routable view ({name: base_url} —
    ``fleet.targets`` for a live fleet); the router re-reads it per
    decision and per reroute, so a replica restarted on a new port is
    picked up without gateway restarts."""

    def __init__(
        self,
        router: PrefixRouter,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        queue_poll_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
        header_timeout_s: Optional[float] = None,
        prefill_timeout_s: Optional[float] = None,
    ):
        self.router = router
        self.host = host
        self.request_timeout_s = request_timeout_s
        self.header_timeout_s = header_timeout_s
        self.prefill_timeout_s = prefill_timeout_s
        self.queue_poll_s = queue_poll_s
        self._clock = clock
        self._sleep = time.sleep  # injectable for the QUEUE re-poll test
        self.draining = False
        self._httpd = self._build_server(host, port)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="routing-gateway")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- proxy core ----------------------------------------------------------
    def _admit(self, prompt_ids, tenant: str,
               exclude: frozenset = frozenset()):
        """Run the admission loop: route, and if queued, re-poll until
        the projection clears or the queue deadline expires. Returns
        (decision, queue_wait_s).

        The re-poll wait is a jittered :class:`IdleBackoff`, not a fixed
        sleep: while the projection is unchanged the wait doubles (no
        point hammering a router whose view hasn't moved), and any
        projection change snaps it back to ``queue_poll_s`` — so many
        queued requests backing off from the same hot replica neither
        re-poll in lockstep nor sleep through the capacity they were
        waiting for."""
        router = self.router
        decision = router.route(prompt_ids, tenant=tenant, exclude=exclude)
        if decision.admission != QUEUE:
            return decision, 0.0
        t0 = self._clock()
        deadline = t0 + router.config.queue_timeout_s
        backoff = IdleBackoff(
            initial=self.queue_poll_s,
            maximum=max(self.queue_poll_s,
                        router.config.queue_timeout_s / 8),
            jitter=0.5, seed=0)
        last_projection = decision.projected_ttft_s
        while self._clock() < deadline:
            self._sleep(backoff.next_wait())
            decision = router.route(
                prompt_ids, tenant=tenant, requeue=True, exclude=exclude)
            if decision.projected_ttft_s != last_projection:
                backoff.reset()  # state moved: poll eagerly again
                last_projection = decision.projected_ttft_s
            if decision.admission != QUEUE:
                wait = self._clock() - t0
                router.h_queue_wait.observe(max(0.0, wait))
                return decision, wait
        wait = self._clock() - t0
        router.h_queue_wait.observe(max(0.0, wait))
        return (
            type(decision)(
                admission=REJECT,
                projected_ttft_s=decision.projected_ttft_s,
                prompt_tokens=decision.prompt_tokens,
                scores=decision.scores,
                reason=f"queued {wait:.2f}s without clearing the warn "
                       "band (queue timeout)",
            ),
            wait,
        )

    def _open_upstream(self, url: str, body: bytes, headers: dict):
        """POST ``body`` to the replica's ``/generate`` -> its response,
        once the headers are in. A streamed request waits at most
        ``header_timeout_s`` for them (then ``TimeoutError``) and reads
        its stream under ``request_timeout_s``; a status outside 2xx
        raises ``HTTPError``, as ``urlopen`` does."""
        streamed = self.header_timeout_s is not None and json.loads(body).get("stream")
        target = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(
            target.hostname, target.port,
            timeout=self.header_timeout_s if streamed else self.request_timeout_s)
        try:
            conn.request("POST", "/generate", body,
                         {"Content-Type": "application/json", **headers})
            sock = conn.sock  # the response reads through it
            upstream = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        sock.settimeout(self.request_timeout_s)
        if not 200 <= upstream.status < 300:
            raise urllib.error.HTTPError(url + "/generate", upstream.status, upstream.reason,
                                         upstream.headers, upstream)
        return upstream

    def _phase1_prefill(self, decision, body: bytes,
                        headers: dict) -> Optional[str]:
        """Two-phase placement, phase 1: run the prompt's prefill on
        ``decision.prefill_replica`` and return that replica's base URL
        (the decode request's ``kv_source``). ANY failure returns None —
        the request degrades to unified placement and the decode replica
        prefills locally; nothing is ever half-migrated. A pool silent
        past ``prefill_timeout_s`` (default: the request's timeout) is
        such a failure."""
        router = self.router
        name = decision.prefill_replica
        tokens = max(0, decision.prompt_tokens - decision.overlap_tokens)
        url = router.replicas_fn().get(name)
        if not url:
            router.prefill_complete(name, tokens, ok=False)
            obs_events.emit(
                "router", "prefill_failed", level="warn",
                prefill_replica=name, error="replica not routable")
            return None
        try:
            req = urllib.request.Request(
                url + "/prefill", data=body,
                headers={"Content-Type": "application/json", **headers})
            with urllib.request.urlopen(
                    req, timeout=self.prefill_timeout_s or self.request_timeout_s) as resp:
                resp.read()
        except (OSError, urllib.error.URLError) as e:
            router.prefill_complete(name, tokens, ok=False)
            obs_events.emit(
                "router", "prefill_failed", level="warn",
                prefill_replica=name, error=str(e)[:120])
            return None
        router.prefill_complete(name, tokens, ok=True)
        return url

    def _build_server(self, host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):  # noqa: N802 — quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.partition("?")[0]
                router = gateway.router
                if path == "/healthz":
                    self._json(200, {
                        "ok": True,
                        "role": "gateway",
                        "policy": router.config.policy,
                        "draining": gateway.draining,
                        "replicas": sorted(router.replicas_fn()),
                    })
                elif path == "/readyz":
                    ready = (not gateway.draining
                             and bool(router.replicas_fn()))
                    self._json(200 if ready else 503, {
                        "ready": ready, "draining": gateway.draining})
                elif path == "/metrics":
                    body = router.registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/debug/router":
                    self._json(200, router.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path == "/drain":
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        req = json.loads(
                            self.rfile.read(length)) if length else {}
                    except (ValueError, json.JSONDecodeError):
                        self._json(400, {"error": "body must be JSON"})
                        return
                    gateway.draining = not bool(req.get("off"))
                    self._json(200, {"draining": gateway.draining})
                elif self.path == "/generate":
                    self._generate()
                else:
                    self._json(404, {"error": "not found"})

            # -- the routed proxy -------------------------------------------
            def _generate(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    req = json.loads(body) if body else {}
                    prompt_ids = [int(t) for t in req["prompt_ids"]]
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request body: {e}"})
                    return
                tenant = str(req.get("tenant", ""))
                router = gateway.router

                decision, _wait = gateway._admit(prompt_ids, tenant)
                if decision.admission != ADMIT:
                    self._json(429, {
                        "error": "rejected by admission control",
                        "reason": decision.reason,
                        "projected_ttft_s": round(
                            decision.projected_ttft_s, 4),
                    })
                    return

                headers = {
                    k: v for k, v in self.headers.items()
                    if k.lower() not in _HOP_HEADERS
                }
                kv_source = None
                if decision.prefill_replica:
                    kv_source = gateway._phase1_prefill(
                        decision, body, headers)
                    if kv_source:
                        req["kv_source"] = kv_source
                        body = json.dumps(req).encode()
                tried = {decision.replica}
                replica = decision.replica
                while True:
                    t0 = time.monotonic()
                    try:
                        upstream = gateway._open_upstream(
                            router.replicas_fn()[replica], body, headers)
                    except (KeyError, OSError,
                            urllib.error.URLError) as e:
                        # nothing forwarded yet: safe to reroute. The
                        # dead replica's radix cache died with it, so
                        # its shadow state goes too, and a fresh
                        # routing episode excludes everything already
                        # tried this request.
                        router.complete(replica, ok=False)
                        router.forget_replica(replica)
                        decision, _w = gateway._admit(
                            prompt_ids, tenant,
                            exclude=frozenset(tried))
                        if decision.admission != ADMIT:
                            self._json(502, {
                                "error": "no replica accepted the "
                                         "request after reroute",
                                "reason": decision.reason,
                                "tried": sorted(tried),
                            })
                            return
                        replica = decision.replica
                        if decision.prefill_replica:
                            if kv_source is None:
                                kv_source = gateway._phase1_prefill(
                                    decision, body, headers)
                                if kv_source:
                                    req["kv_source"] = kv_source
                                    body = json.dumps(req).encode()
                            else:
                                # phase 1 already ran; the chain still
                                # lives at kv_source — just release the
                                # re-stamped prefill tokens
                                router.prefill_complete(
                                    decision.prefill_replica,
                                    max(0, decision.prompt_tokens
                                        - decision.overlap_tokens))
                        tried.add(replica)
                        router.m_retries.inc()
                        obs_events.emit(
                            "router", "retry_rerouted", level="warn",
                            replica=replica, error=str(e)[:120],
                        )
                        continue
                    self._proxy_stream(
                        upstream, replica, req, prompt_ids, t0)
                    return

            def _proxy_stream(self, upstream, replica, req,
                              prompt_ids, t0):
                """Forward the upstream response byte-for-byte. Once any
                payload byte is out, failures abort instead of retrying
                (see module docstring)."""
                router = gateway.router
                forwarded = False
                ok = False
                try:
                    with upstream:
                        self.send_response(upstream.status)
                        ctype = upstream.headers.get(
                            "Content-Type", "application/octet-stream")
                        self.send_header("Content-Type", ctype)
                        clen = upstream.headers.get("Content-Length")
                        if clen is not None:
                            self.send_header("Content-Length", clen)
                        self.end_headers()
                        while True:
                            # read1: what has arrived, up to 8 KiB. read()
                            # would wait for 8 KiB or the end, holding a
                            # token stream back until it completes
                            chunk = upstream.read1(8192)
                            if not chunk:
                                break
                            forwarded = True
                            self.wfile.write(chunk)
                            self.wfile.flush()
                    ok = True
                except (OSError, urllib.error.URLError):
                    if forwarded:
                        # half-written client stream: drop the
                        # connection, the client's retry reroutes
                        router.m_upstream_failures.inc()
                        try:
                            self.connection.close()
                        except OSError:
                            pass
                    else:
                        self._json(502, {"error": "upstream died before "
                                                  "first byte"})
                finally:
                    router.complete(
                        replica,
                        service_s=time.monotonic() - t0 if ok else None,
                        ok=ok)
                if ok:
                    # the replica's radix cache now holds prompt+reply;
                    # teach the shadow index the full chain so the next
                    # chat turn (prompt ⊃ this prompt+reply) maps here
                    n = req.get("max_new_tokens")
                    if isinstance(n, int) and n > 0:
                        try:
                            from .stub import token_at

                            router.observe_chain(
                                replica,
                                list(prompt_ids) + [
                                    token_at(prompt_ids, i)
                                    for i in range(n)],
                            )
                        except Exception:  # noqa: BLE001 — best effort
                            router.observe_chain(replica, prompt_ids)
                    else:
                        router.observe_chain(replica, prompt_ids)

        class Server(ThreadingHTTPServer):
            request_queue_size = LISTEN_BACKLOG

        httpd = Server((host, port), Handler)
        httpd.daemon_threads = True
        return httpd
