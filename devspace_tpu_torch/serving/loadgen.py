"""Open-loop traffic harness: seeded trace specs, honest accounting.

Two halves, deliberately separable:

- :func:`generate_trace` turns a :class:`TraceSpec` into a concrete
  request trace — **deterministically**: the same spec (same seed)
  produces byte-identical JSON via :func:`trace_json`, so a chaos run
  can be replayed exactly and a regression bisected against the same
  traffic. Supported shapes: ``poisson`` (memoryless arrivals — the
  classic open-loop model), ``chat`` (multi-turn sessions whose turns
  share a growing prefix — the prefix-cache-friendly pattern),
  ``bursty`` (on/off square wave — what forces scale-up then drain),
  and ``rag`` (a few very long shared contexts, each queried repeatedly
  with a short question appended, interleaved with short chat — the
  long-prompt/short-chat mix that makes prefix-aware routing or its
  absence most expensive). A ``sampled`` bit marks the greedy/sampled
  mix.

- :class:`LoadGenerator` replays a trace **open-loop**: requests launch
  at their scheduled arrival time whether or not earlier ones finished
  (closed-loop generators hide overload by slowing down with the
  system; open-loop is what reveals queue collapse). Every request ends
  in exactly one terminal outcome:

  ===========  ==========================================================
  completed    stream verified token-for-token on the first attempt
  retried      first stream died with the replica; the retry verified
  failed       no attempt produced a complete verified stream
  corrupted    a stream *completed* with wrong bytes — protocol
               violation, the invariant chaos runs assert is ZERO
  hung         no response within the hang deadline — also must be zero
  ===========  ==========================================================

  The corrupted/failed distinction is the whole point: a replica
  SIGKILL mid-stream must surface as ``retried`` (or at worst
  ``failed``), never as a silently-wrong ``completed``. Verification is
  exact because replicas share :func:`devspace_tpu_torch.serving.stub.token_at`.

The port's copy of ``devspace_tpu/serving/loadgen.py``; it imports
nothing of the JAX package. Two seams let it hold real model replicas,
which stream their model's greedy tokens rather than ``token_at``'s,
and each defaults to the reference's behaviour:

- ``LoadGenerator(..., expected_fn=...)``: ``expected_fn(event)`` is the
  stream a request must produce (default: ``token_at`` over its prompt);
- ``RequestOutcome.received``: the tokens a ``corrupted`` stream
  delivered (empty for every other outcome), so a caller can tell where
  it left the expected stream. :meth:`LoadReport.to_dict` leaves it out.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

from .stub import token_at

OUTCOMES = ("completed", "retried", "failed", "corrupted", "hung")


@dataclass
class TraceSpec:
    """Seeded description of a workload. All randomness flows from
    ``seed`` through one ``random.Random`` — the determinism contract
    :func:`trace_json` pins."""

    kind: str = "poisson"  # poisson | chat | bursty | rag
    seed: int = 0
    duration_s: float = 5.0
    rate_rps: float = 8.0
    prompt_len: tuple = (4, 32)
    max_new_tokens: tuple = (4, 16)
    sampled_fraction: float = 0.5
    # chat: sessions arrive at rate_rps, each runs `turns` turns whose
    # prompts share (and grow) the session prefix, spaced by think time
    turns: tuple = (2, 4)
    think_time_s: tuple = (0.1, 0.5)
    # bursty: square wave between rate_rps and rate_rps*burst_multiplier
    burst_on_s: float = 1.0
    burst_off_s: float = 1.0
    burst_multiplier: float = 4.0
    # rag: rag_contexts shared long documents; a rag_long_fraction of
    # arrivals are a context + short question (session = context id),
    # the rest ordinary short chat prompts (session = -1)
    rag_contexts: int = 3
    rag_context_len: tuple = (192, 384)
    rag_long_fraction: float = 0.3


def _round(x: float) -> float:
    # fixed precision keeps trace_json byte-stable across platforms
    return round(float(x), 6)


def load_recorded_trace(path: str) -> list:
    """Parse a recorded JSONL trace: one request per line carrying
    ``timestamp`` (seconds; absolute or already-relative — arrivals are
    re-based so the earliest is 0), ``prompt`` (token ids; ``prompt_ids``
    also accepted) and optionally ``tenant`` / ``max_new_tokens`` /
    ``sampled`` / ``session``. The result uses the exact
    :func:`generate_trace` event schema, so replay, verification and
    :func:`trace_json` byte-stability work unchanged on recorded
    production traffic."""
    events: list = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                at = float(rec.get("timestamp", rec.get("at", 0.0)))
                ids = [int(t) for t in
                       rec.get("prompt", rec.get("prompt_ids"))]
            except (TypeError, ValueError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"{path}:{lineno}: bad trace record: {e}") from None
            events.append({
                "id": len(events),
                "at": at,
                "prompt_ids": ids,
                "max_new_tokens": int(rec.get("max_new_tokens", 16)),
                "sampled": bool(rec.get("sampled", False)),
                "session": int(rec.get("session", -1)),
                "tenant": str(rec.get("tenant", "")),
            })
    if not events:
        raise ValueError(f"{path}: empty trace file")
    base = min(e["at"] for e in events)
    for e in events:
        e["at"] = _round(e["at"] - base)
    events.sort(key=lambda e: (e["at"], e["id"]))
    return events


def generate_trace(spec: TraceSpec) -> list:
    """[{id, at, prompt_ids, max_new_tokens, sampled, session}] sorted
    by arrival time. Pure function of ``spec`` — including
    ``kind="file:<path>.jsonl"``, which replays a recorded trace (same
    bytes in, same trace out)."""
    if spec.kind.startswith("file:"):
        return load_recorded_trace(spec.kind[len("file:"):])
    rng = random.Random(spec.seed)
    events: list = []

    def prompt(length: int) -> list:
        return [rng.randrange(1, 50_000) for _ in range(length)]

    def one(at: float, prompt_ids: list, session: int) -> dict:
        return {
            "id": len(events),
            "at": _round(at),
            "prompt_ids": prompt_ids,
            "max_new_tokens": rng.randint(*spec.max_new_tokens),
            "sampled": rng.random() < spec.sampled_fraction,
            "session": session,
        }

    if spec.kind == "poisson":
        t = 0.0
        while True:
            t += rng.expovariate(spec.rate_rps)
            if t >= spec.duration_s:
                break
            events.append(one(t, prompt(rng.randint(*spec.prompt_len)), -1))
    elif spec.kind == "bursty":
        t = 0.0
        period = spec.burst_on_s + spec.burst_off_s
        while t < spec.duration_s:
            in_burst = (t % period) < spec.burst_on_s
            rate = spec.rate_rps * (spec.burst_multiplier if in_burst else 1)
            t += rng.expovariate(rate)
            if t >= spec.duration_s:
                break
            events.append(one(t, prompt(rng.randint(*spec.prompt_len)), -1))
    elif spec.kind == "chat":
        t, session = 0.0, 0
        while True:
            t += rng.expovariate(spec.rate_rps)
            if t >= spec.duration_s:
                break
            prefix = prompt(rng.randint(*spec.prompt_len))
            turn_at = t
            for _turn in range(rng.randint(*spec.turns)):
                events.append(one(turn_at, list(prefix), session))
                # next turn's prompt = shared prefix grown by this
                # turn's reply (the prefix-cache-hit shape)
                reply = [token_at(prefix, i)
                         for i in range(events[-1]["max_new_tokens"])]
                prefix = prefix + reply
                turn_at = _round(
                    turn_at + rng.uniform(*spec.think_time_s))
            session += 1
    elif spec.kind == "rag":
        contexts = [prompt(rng.randint(*spec.rag_context_len))
                    for _ in range(max(1, spec.rag_contexts))]
        t = 0.0
        while True:
            t += rng.expovariate(spec.rate_rps)
            if t >= spec.duration_s:
                break
            if rng.random() < spec.rag_long_fraction:
                # long RAG query: shared context + fresh short question
                ctx = rng.randrange(len(contexts))
                ids = contexts[ctx] + prompt(
                    rng.randint(*spec.prompt_len))
                events.append(one(t, ids, ctx))
            else:
                events.append(
                    one(t, prompt(rng.randint(*spec.prompt_len)), -1))
    else:
        raise ValueError(f"unknown trace kind {spec.kind!r}")

    events.sort(key=lambda e: (e["at"], e["id"]))
    return events


def trace_json(spec: TraceSpec) -> bytes:
    """Canonical bytes for a spec's trace — the replay/bisect artifact.
    Byte-equality across calls IS the determinism contract."""
    return json.dumps(
        generate_trace(spec), sort_keys=True, separators=(",", ":")
    ).encode()


@dataclass
class RequestOutcome:
    id: int
    outcome: str          # one of OUTCOMES
    latency_s: float
    attempts: int = 1
    tokens: int = 0
    ttft_s: float = 0.0   # request start -> first verified token
    error: str = ""
    received: list = field(default_factory=list)  # a corrupted stream's tokens


@dataclass
class LoadReport:
    outcomes: list = field(default_factory=list)
    wall_s: float = 0.0

    def counts(self) -> dict:
        c = {k: 0 for k in OUTCOMES}
        for o in self.outcomes:
            c[o.outcome] += 1
        return c

    def latency_quantile(self, q: float) -> float:
        lat = sorted(o.latency_s for o in self.outcomes
                     if o.outcome in ("completed", "retried"))
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def ttft_quantile(self, q: float) -> float:
        """Quantile of time-to-first-verified-token across successful
        requests — the serving-tier SLI the router optimises."""
        lat = sorted(o.ttft_s for o in self.outcomes
                     if o.outcome in ("completed", "retried")
                     and o.ttft_s > 0)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def total_tokens(self) -> int:
        return sum(o.tokens for o in self.outcomes
                   if o.outcome in ("completed", "retried"))

    def to_dict(self) -> dict:
        return {
            "requests": len(self.outcomes),
            "wall_s": round(self.wall_s, 3),
            "counts": self.counts(),
            "p50_latency_s": round(self.latency_quantile(0.50), 4),
            "p95_latency_s": round(self.latency_quantile(0.95), 4),
            "p50_ttft_s": round(self.ttft_quantile(0.50), 4),
            "p99_ttft_s": round(self.ttft_quantile(0.99), 4),
            "tokens": self.total_tokens(),
        }


class _StreamDied(Exception):
    """Connection lost mid-stream (replica death) — retryable."""


class _StreamCorrupt(Exception):
    """Stream completed with wrong content — NOT retryable; a protocol
    violation the caller must surface, never paper over. ``received`` is
    what the stream delivered."""

    def __init__(self, msg: str, received: list):
        super().__init__(msg)
        self.received = list(received)


def stub_stream(event: dict) -> list:
    """The reference's expected stream: the stub replicas' ``token_at``."""
    return [token_at(event["prompt_ids"], i)
            for i in range(event["max_new_tokens"])]


class LoadGenerator:
    """Replay a trace against live targets, open-loop.

    ``targets_fn`` returns the current {name: base_url} routing table
    (pass ``fleet.targets`` for a live fleet, or a lambda over a static
    dict); it is re-read per attempt, so retries after a replica death
    see the post-restart fleet. ``expected_fn(event)`` returns the stream
    a request must produce (default :func:`stub_stream`).
    """

    def __init__(
        self,
        targets_fn: Callable[[], dict],
        request_timeout_s: float = 10.0,
        hang_timeout_s: float = 30.0,
        max_attempts: int = 2,
        seed: int = 0,
        expected_fn: Optional[Callable[[dict], list]] = None,
    ):
        self.targets_fn = targets_fn
        self.request_timeout_s = request_timeout_s
        self.hang_timeout_s = hang_timeout_s
        self.max_attempts = max(1, max_attempts)
        self.seed = seed
        self.expected_fn = expected_fn or stub_stream

    # -- single request ------------------------------------------------------
    def _pick_target(self, request_id: int, attempt: int,
                     avoid: Optional[str] = None) -> Optional[str]:
        urls = sorted(self.targets_fn().values())
        if not urls:
            return None
        if avoid is not None and len(urls) > 1:
            urls = [u for u in urls if u != avoid]
        rng = random.Random(
            self.seed * 1_000_003 + request_id * 1_009 + attempt)
        return rng.choice(urls)

    def _stream_once(self, url: str, event: dict,
                     deadline: float) -> tuple:
        """One streaming attempt, verified token-for-token. Returns
        ``(token_count, ttft_s)``; raises _StreamDied / _StreamCorrupt /
        socket.timeout."""
        prompt = event["prompt_ids"]
        n = event["max_new_tokens"]
        expected = list(self.expected_fn(event))
        body = json.dumps({
            "prompt_ids": prompt,
            "max_new_tokens": n,
            "stream": True,
            "sampled": event.get("sampled", False),
            "tenant": event.get("tenant", ""),
        }).encode()
        req = urllib.request.Request(
            url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        timeout = min(self.request_timeout_s,
                      max(0.1, deadline - time.monotonic()))
        got: list = []
        done = False
        t_start = time.monotonic()
        ttft = 0.0
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                for raw in resp:
                    if time.monotonic() > deadline:
                        raise socket.timeout("hang deadline")
                    try:
                        msg = json.loads(raw)
                    except json.JSONDecodeError as e:
                        # a half-written line is what a mid-stream kill
                        # looks like on a close-delimited response: the
                        # replica died between write and flush. Only a
                        # wrong verified prefix is corruption.
                        if got == expected[: len(got)]:
                            raise _StreamDied(
                                f"truncated line after {len(got)} tokens: "
                                f"{raw[:80]!r}") from e
                        raise _StreamCorrupt(
                            f"undecodable stream line: {raw[:80]!r}",
                            got) from e
                    if msg.get("done"):
                        done = True
                        break
                    if "token" not in msg:
                        raise _StreamCorrupt(
                            f"line without token: {msg}", got)
                    if not got:
                        ttft = time.monotonic() - t_start
                    got.append(msg["token"])
        except (urllib.error.URLError, ConnectionError, socket.timeout,
                http.client.IncompleteRead,
                http.client.HTTPException) as e:
            if isinstance(e, socket.timeout):
                raise
            if isinstance(e, urllib.error.URLError) and isinstance(
                    e.reason, socket.timeout):
                raise socket.timeout(str(e)) from e
            # partial-but-correct stream + dead connection = replica died
            if got == expected[: len(got)]:
                raise _StreamDied(str(e)) from e
            raise _StreamCorrupt(
                f"mismatch before death at token {len(got)}", got) from e
        if got != expected[: len(got)] or (done and got != expected):
            # wrong content, or the server claimed completion over an
            # incomplete stream — both are protocol violations
            raise _StreamCorrupt(
                f"verified {len(got)}/{len(expected)} tokens, done={done}",
                got)
        if not done:
            # clean EOF without the done marker: the replica died with
            # its connection (close-delimited bodies surface a kill as
            # end-of-stream, not as a socket error) — retryable
            raise _StreamDied(
                f"stream truncated at {len(got)}/{len(expected)} tokens")
        return len(got), ttft

    def _run_one(self, event: dict) -> RequestOutcome:
        t0 = time.monotonic()
        deadline = t0 + self.hang_timeout_s
        last_error = ""
        last_url: Optional[str] = None
        for attempt in range(1, self.max_attempts + 1):
            url = self._pick_target(event["id"], attempt, avoid=last_url)
            if url is None:
                last_error = "no targets"
                time.sleep(0.05)
                continue
            last_url = url
            try:
                t_att = time.monotonic()
                tokens, ttft = self._stream_once(url, event, deadline)
                return RequestOutcome(
                    id=event["id"],
                    outcome="completed" if attempt == 1 else "retried",
                    latency_s=time.monotonic() - t0,
                    attempts=attempt, tokens=tokens,
                    # from request start, so retry overhead counts
                    ttft_s=(t_att - t0) + ttft,
                )
            except _StreamCorrupt as e:
                return RequestOutcome(
                    id=event["id"], outcome="corrupted",
                    latency_s=time.monotonic() - t0,
                    attempts=attempt, error=str(e), received=e.received,
                )
            except socket.timeout as e:
                return RequestOutcome(
                    id=event["id"], outcome="hung",
                    latency_s=time.monotonic() - t0,
                    attempts=attempt, error=str(e),
                )
            except _StreamDied as e:
                last_error = str(e)
                continue
        return RequestOutcome(
            id=event["id"], outcome="failed",
            latency_s=time.monotonic() - t0,
            attempts=self.max_attempts, error=last_error,
        )

    # -- replay --------------------------------------------------------------
    def run(self, trace: list, speed: float = 1.0) -> LoadReport:
        """Replay ``trace`` open-loop (``speed`` > 1 compresses time).
        Blocks until every request reaches a terminal outcome — by
        construction no request is left unresolved."""
        t0 = time.monotonic()
        results: list = [None] * len(trace)
        threads = []

        def worker(i, event):
            results[i] = self._run_one(event)

        for i, event in enumerate(trace):
            delay = t0 + event["at"] / speed - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(
                target=worker, args=(i, event), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=self.hang_timeout_s + self.request_timeout_s)
        report = LoadReport(wall_s=time.monotonic() - t0)
        for i, res in enumerate(results):
            if res is None:  # worker never finished: count it, loudly
                res = RequestOutcome(
                    id=trace[i]["id"], outcome="hung",
                    latency_s=time.monotonic() - t0,
                    error="worker did not finish")
            report.outcomes.append(res)
        return report
