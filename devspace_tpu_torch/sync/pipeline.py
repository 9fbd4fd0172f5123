"""Bounded producer/consumer upload pipeline for the slice fan-out.

A serial upstream path does tar(batch1) -> broadcast(batch1) ->
tar(batch2) -> ... with the broadcast itself waiting on the slowest
worker. This stage decouples the two sides:

- the PRODUCER (the caller's thread) builds compressed artifacts through
  the session's TarArtifactCache and feeds every live worker's bounded
  queue — so the gzip of batch N+1 overlaps the network broadcast of
  batch N;
- one CONSUMER per worker drains its own queue, so a slow worker delays
  the producer only once its queue (depth x ~64MB) is full, instead of
  gating every peer on each batch.

Failure semantics intentionally mirror SyncSession._fan_out's graded
ladder: a worker that errors gets one shell revive + retry, then is
quarantined via _mark_worker_failed and its consumer switches to discard
mode (it keeps draining so the producer never wedges — the chaos tests
pin this). After the join, losing worker 0 or delivering a batch to zero
workers raises the same SyncError messages _fan_out would.

Index commits keep the per-batch discipline of the serial path: a
batch's entries are index.set once every live worker has resolved
(delivered or discarded) and at least one delivery succeeded.

The port's copy of ``devspace_tpu/sync/pipeline.py``, with the same
behaviour.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time

from ..obs.tracing import get_tracer
from .shell import SyncError

_SENTINEL = None


class UploadPipeline:
    def __init__(self, session, depth: int = 3):
        self.session = session
        self.depth = depth

    def run(self, batches) -> int:
        """Stream ``batches`` (iterable of FileInformation lists) to every
        live worker. Returns the number of committed (indexed) entries."""
        session = self.session
        live = session._live_indices()
        if not live:
            raise SyncError("sync has no live workers left")
        # trace context captured on the producer thread; consumers
        # re-attach it (pool threads have empty thread-local stacks), so
        # every per-worker upload span — success, retry after revive, or
        # the failed attempt that quarantines the worker — carries the
        # originating operation's trace_id
        tracer = get_tracer()
        ctx = tracer.current_context() or getattr(
            session, "_session_ctx", None
        )

        def upload_once(i: int, bidx: int, tar, retry: bool) -> None:
            with tracer.attach(ctx):
                sp = tracer.start_span(
                    "sync.upload",
                    attrs={"worker": i, "batch": bidx, "retry": retry},
                )
                try:
                    session._upload_raw(
                        session._shells[i], session.workers[i], tar
                    )
                except Exception as e:  # noqa: BLE001 — ladder decides
                    sp.attrs["outcome"] = "failed"
                    tracer.end_span(
                        sp, ok=False, error=f"{type(e).__name__}: {e}"
                    )
                    raise
                else:
                    sp.attrs["outcome"] = "delivered"
                    tracer.end_span(sp, ok=True)
        queues = {i: queue_mod.Queue(maxsize=self.depth) for i in live}
        lock = threading.Lock()
        # batch idx -> [workers still pending, deliveries ok, entries]
        pending: dict[int, list] = {}
        failed_batches: list[int] = []
        committed = 0

        def finish(bidx: int, ok: bool) -> None:
            nonlocal committed
            done = None
            with lock:
                st = pending[bidx]
                st[0] -= 1
                if ok:
                    st[1] += 1
                if st[0] == 0:
                    done = pending.pop(bidx)
            if done is None:
                return
            # Only the worker that resolved the batch's last delivery gets
            # here — commit without the lock (index has its own).
            if done[1] > 0:
                for info in done[2]:
                    session.index.set(info)
                session._bump("uploaded", len(done[2]))
                committed += len(done[2])
            else:
                failed_batches.append(bidx)

        def consume(i: int) -> None:
            discard = False
            while True:
                item = queues[i].get()
                if item is _SENTINEL:
                    return
                bidx, tar = item
                if discard or session._stopped.is_set():
                    finish(bidx, ok=False)
                    continue
                try:
                    upload_once(i, bidx, tar, retry=False)
                    finish(bidx, ok=True)
                except Exception as e:  # noqa: BLE001 — graded ladder below
                    err = e
                    if session._try_revive(i):
                        try:
                            # re-read the shell: revive swapped it; the
                            # retry span re-attaches the SAME context
                            upload_once(i, bidx, tar, retry=True)
                            finish(bidx, ok=True)
                            continue
                        except Exception as e2:  # noqa: BLE001
                            err = e2
                    session._mark_worker_failed(i, err)
                    discard = True
                    finish(bidx, ok=False)

        futures = [session._pool.submit(consume, i) for i in live]
        stall = 0.0
        try:
            for bidx, batch in enumerate(batches):
                if session._stopped.is_set():
                    break
                tar = session.artifacts.get_or_build(
                    session.opts.local_path, batch
                )
                if not tar:
                    continue
                with lock:
                    pending[bidx] = [len(live), 0, list(batch)]
                for i in live:
                    t0 = time.monotonic()
                    queues[i].put((bidx, tar))
                    stall += time.monotonic() - t0
        finally:
            for i in live:
                queues[i].put(_SENTINEL)
            for f in futures:
                f.result()
            session._bump("pipeline_stall_s", stall)

        if session._stopped.is_set():
            return committed
        with session._workers_lock:
            worker0_error = session.worker_errors.get(0)
        if worker0_error is not None:
            raise SyncError(f"authoritative worker 0 lost: {worker0_error}")
        if failed_batches:
            raise SyncError("upload failed on every worker")
        return committed
