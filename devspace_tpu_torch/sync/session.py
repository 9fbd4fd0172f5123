"""Bidirectional sync session with N-worker fan-out across a job's pods.

Reference behavior (pkg/devspace/sync/sync_config.go + upstream.go +
downstream.go + evaluater.go), generalized per SURVEY §2.2's multi-host
note: one local watcher feeds an upstream that broadcasts to every worker
of the job; the downstream polls worker 0 (authoritative). Conflict rules preserved:

- steady-state upload on any local mtime+size change (evaluater.go:37)
- download when the remote side is newer than the index (evaluater.go:91)
- initial sync keeps the newer side, never deletes (sync_config.go:262)
- remote deletions propagate only after two stable polls AND the local
  file still matches the index — the deletion triple-check
  (downstream.go:105-134, evaluater.go:139)
- uploads that race a remote-newer file are skipped (shouldRemoveRemote
  mtime guard, evaluater.go:8)

Latency: defaults beat the reference's constants (~1s upstream debounce,
1.3s downstream poll — BASELINE.md) while keeping the same safety rules.

The port's copy of ``devspace_tpu/sync/session.py``, with the same
behaviour: ``walk_local_tree`` walks through the port's native scanner
(``utils/native.py``) when that is built, and in Python otherwise; both
give the same entries.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

from ..obs import events as _events
from ..resilience.policy import RetryPolicy
from ..utils import log as logutil
from ..utils.ignoreutil import IgnoreMatcher
from .artifacts import TarArtifactCache
from .file_info import DigestCache, FileInformation, local_file_information
from .index import FileIndex
from .pipeline import UploadPipeline
from .shell import RateLimiter, RemoteShell, SyncError, build_tar, extract_tar
from .watcher import Watcher, new_watcher

UPLOAD_BATCH_FILES = 1000  # reference: sync_config.go:20
UPLOAD_BATCH_BYTES = 64 << 20

# Serializes sync-status.json read-modify-write across all sessions/threads
# in this process (see SyncSession._publish_status).
_STATUS_FILE_LOCK = threading.Lock()


def walk_local_tree(
    root: str, exclude: Optional[IgnoreMatcher] = None
) -> dict[str, FileInformation]:
    """Walk a local tree (following symlinks, cycle-guarded) into
    {relpath: FileInformation}, honoring an exclude matcher. Uses the
    native scanner (utils/native.py, C++ readdir+lstat loop) when built;
    both paths produce identical results (tested side by side)."""
    native_out = _walk_local_tree_native(root, exclude)
    if native_out is not None:
        return native_out
    out: dict[str, FileInformation] = {}
    stack = [root]
    seen_dirs: set[tuple[int, int]] = set()
    while stack:
        d = stack.pop()
        try:
            with os.scandir(d) as it:
                entries = list(it)
        except OSError:
            continue
        for e in entries:
            rel = os.path.relpath(e.path, root).replace(os.sep, "/")
            try:
                is_dir = e.is_dir()  # follows symlinks
            except OSError:
                continue
            if exclude is not None and exclude.matches(rel, is_dir):
                continue
            info = local_file_information(root, rel)
            if info is None:
                continue
            out[rel] = info
            if is_dir:
                try:
                    st = os.stat(e.path)
                    key = (st.st_dev, st.st_ino)
                except OSError:
                    continue
                if key in seen_dirs:
                    continue  # symlink cycle guard
                seen_dirs.add(key)
                stack.append(e.path)
    return out


def _walk_local_tree_native(
    root: str, exclude: Optional[IgnoreMatcher]
) -> Optional[dict[str, FileInformation]]:
    """Native-walk variant of walk_local_tree; None when libdevsync is
    unavailable. The C++ side emits every entry in parent-before-child
    order; gitignore filtering stays here so semantics are identical."""
    from ..utils import native

    prune = native.prune_names(exclude.patterns) if exclude is not None else None
    entries = native.walk(root, prune=prune, follow_symlinks=True)
    if entries is None:
        return None
    out: dict[str, FileInformation] = {}
    excluded_dirs: set[str] = set()
    for e in entries:
        parent = os.path.dirname(e.rel)
        if parent and parent in excluded_dirs:
            if e.is_dir:
                excluded_dirs.add(e.rel)
            continue
        if exclude is not None and exclude.matches(e.rel, e.is_dir):
            if e.is_dir:
                excluded_dirs.add(e.rel)
            continue
        out[e.rel] = FileInformation(
            name=e.rel,
            size=0 if e.is_dir else e.size,
            mtime=e.mtime,
            is_directory=e.is_dir,
            is_symlink=e.is_symlink,
        )
    return out


@dataclass
class SyncOptions:
    local_path: str
    container_path: str
    exclude_paths: list[str] = field(default_factory=list)
    download_exclude_paths: list[str] = field(default_factory=list)
    upload_exclude_paths: list[str] = field(default_factory=list)
    upload_limit_kbs: Optional[int] = None
    download_limit_kbs: Optional[int] = None
    # Latency knobs — defaults beat the reference's 1s/600ms/1.3s.
    # quiet=0.15: still coalesces editor save bursts and bulk ops (events
    # arriving <150ms apart keep deferring the flush) at ~180ms median
    # edit->all-workers latency on the 4-worker fake slice.
    upstream_quiet: float = 0.15
    upstream_tick: float = 0.05
    downstream_interval: float = 0.8
    stable_polls: int = 2  # reference: downstream.go:117-128
    container: Optional[str] = None
    fan_out: str = "all"  # "all" | "worker0"
    verbose: bool = False
    # Drift detection for non-authoritative workers: every
    # ``verify_interval`` seconds each mirror worker's tree is checksummed
    # against the index and silently-diverged files are repaired (a worker
    # whose tree diverges without its shell dying — e.g. an in-container
    # rm — is otherwise never detected). 0 disables.
    verify_interval: float = 30.0
    # Path of a JSON status file updated with per-worker health so
    # `status sync` in another process can show live per-worker state
    # (reference reconstructs per-session status from sync.log regexes,
    # cmd/status/sync.go:56-110; we publish structured state instead).
    status_path: Optional[str] = None
    # Content-digest gating: a change whose bytes are unchanged (touch,
    # branch checkout round-trip) becomes a remote metadata-only fix
    # instead of a re-upload. Off switch for pathological trees where
    # hashing on every event costs more than the transfer it avoids.
    digest_gating: bool = True
    # Per-worker send-queue depth for the pipelined upstream (bounds
    # in-flight artifacts per worker at depth x UPLOAD_BATCH_BYTES).
    pipeline_depth: int = 3


# (name, kind, help, stats_key, agg) — lintable catalog
# (lint/rules_obs.py's OBS7xx rules); agg is the fleet aggregation hint.
# Registered once as pull-style callbacks that aggregate over every live
# session: the stats dict stays the single mutation site ("two views, one
# truth") and `status sync` output is untouched.
SYNC_METRIC_FAMILIES = (
    ("sync_uploaded_total", "counter", "Files uploaded to workers", "uploaded", "sum"),
    ("sync_downloaded_total", "counter", "Files mirrored back from workers", "downloaded", "sum"),
    ("sync_removed_local_total", "counter", "Local files removed by downstream mirroring", "removed_local", "sum"),
    ("sync_removed_remote_total", "counter", "Remote files removed by upstream mirroring", "removed_remote", "sum"),
    ("sync_repaired_total", "counter", "Files re-pushed by the verify/repair loop", "repaired", "sum"),
    ("sync_sent_bytes_total", "counter", "Payload bytes broadcast to workers", "bytes_sent", "sum"),
    ("sync_meta_fixes_total", "counter", "Metadata-only fixes (mtime/mode) applied remotely", "meta_fixes", "sum"),
    ("sync_saved_digest_bytes_total", "counter", "Upload bytes avoided by digest gating", "bytes_saved_digest", "sum"),
    ("sync_pipeline_stall_seconds_total", "counter", "Producer time blocked on full per-worker send queues", "pipeline_stall_s", "sum"),
    ("sync_workers_quarantined_total", "counter", "Workers dropped from the fan-out after unrecoverable errors", "workers_quarantined", "sum"),
)

# Live sessions for the aggregate metric callbacks — weak so the registry
# never pins a stopped session.
_LIVE_SESSIONS: "weakref.WeakSet[SyncSession]" = weakref.WeakSet()


def _register_sync_metrics() -> None:
    try:
        from ..obs.metrics import get_registry

        reg = get_registry()
        for name, kind, help_, key, _agg in SYNC_METRIC_FAMILIES:

            def fn(key=key):
                total = 0.0
                for s in list(_LIVE_SESSIONS):
                    with s._stats_lock:
                        total += float(s.stats.get(key, 0) or 0)
                return total

            reg.register_callback(name, kind, help_, fn)
    except Exception:  # noqa: BLE001 — metrics are optional here
        pass


class SyncSession:
    def __init__(
        self,
        backend,
        workers: list,
        options: SyncOptions,
        logger: Optional[logutil.Logger] = None,
    ):
        if not workers:
            raise ValueError("sync session needs at least one worker pod")
        self.backend = backend
        self.workers = workers if options.fan_out == "all" else workers[:1]
        self.opts = options
        self.log = logger or logutil.get_logger()
        self.index = FileIndex()
        self.error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._threads: list[threading.Thread] = []
        self._shells: list[RemoteShell] = []  # upstream shell per worker
        self._down_shell: Optional[RemoteShell] = None
        self._watcher: Optional[Watcher] = None
        self._last_remote: dict[str, FileInformation] = {}
        self._last_remote_lock = threading.Lock()
        self._up_limiter = RateLimiter(options.upload_limit_kbs)
        self._down_limiter = RateLimiter(options.download_limit_kbs)
        # Sized for the pipeline: its consumers occupy one thread per
        # worker for a whole _apply_uploads call, and a concurrent
        # downstream mirror / verify repair must still find fan-out slots.
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.workers) + 1),
            thread_name_prefix="sync-up",
        )
        self.digests = DigestCache()
        self.artifacts = TarArtifactCache()
        combined = list(options.exclude_paths)
        self.exclude = IgnoreMatcher(combined)
        self.upload_exclude = IgnoreMatcher(
            combined + list(options.upload_exclude_paths)
        )
        self.download_exclude = IgnoreMatcher(
            combined + list(options.download_exclude_paths)
        )
        # Stats for `status sync` (reference scrapes sync.log; we keep
        # counters AND log lines).
        self.stats = {
            "uploaded": 0,
            "downloaded": 0,
            "removed_local": 0,
            "removed_remote": 0,
            "repaired": 0,
            # perf surfaces: payload bytes actually broadcast,
            # re-uploads avoided by digest gating (count + bytes that
            # would have gone to each live worker), producer time spent
            # blocked on a full per-worker send queue.
            "bytes_sent": 0,
            "meta_fixes": 0,
            "bytes_saved_digest": 0,
            "pipeline_stall_s": 0.0,
            # workers dropped from the fan-out (observability)
            "workers_quarantined": 0,
        }
        self._stats_lock = threading.Lock()
        self.started_at: Optional[float] = None
        self.initial_sync_done = threading.Event()
        # Partial-failure state (SURVEY §7 hard part #2): workers dropped
        # from the fan-out after an unrecoverable error, index -> reason.
        self.worker_errors: dict[int, str] = {}
        self._workers_lock = threading.Lock()
        # Per-worker drift/repair bookkeeping (verify loop).
        self._worker_repairs: dict[int, int] = {}
        self._worker_verified_at: dict[int, float] = {}
        # Rogue paths seen on a worker last pass — removal needs two
        # consecutive sightings (see _verify_worker).
        self._extra_candidates: dict[int, set[str]] = {}
        # distributed-trace root for this session: opened in
        # start(), closed in stop(). Fan-out ops re-attach this context
        # in their pool threads (thread-locals do not cross the
        # ThreadPoolExecutor boundary), so every per-worker span — and
        # the $TRACEPARENT the shells export remotely — parents here.
        self._session_span = None
        self._session_ctx = None
        _LIVE_SESSIONS.add(self)

    # -- paths -------------------------------------------------------------
    def _remote_dir(self, worker) -> str:
        return self.backend.translate_path(worker, self.opts.container_path)

    # -- stats -------------------------------------------------------------
    def _bump(self, key: str, n) -> None:
        """Thread-safe stats increment (pipeline consumers, fan-out threads
        and the downstream loop all write concurrently)."""
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Open shells, run initial sync, then start the pipes
        (reference: sync_config.go Start/mainLoop)."""
        self.started_at = time.time()
        from ..obs.tracing import get_tracer

        self._session_span = get_tracer().start_span(
            "sync.session", attrs={"workers": len(self.workers)}, push=False
        )
        self._session_ctx = self._session_span.context
        self.log.info(
            "[sync] starting: %s <-> %s on %d worker(s)",
            self.opts.local_path,
            self.opts.container_path,
            len(self.workers),
        )
        for w in self.workers:
            proc = self.backend.exec_stream(
                w, ["sh"], container=self.opts.container, tty=False
            )
            self._shells.append(RemoteShell(proc, label=f"up{getattr(w, 'name', w)}"))
        down_proc = self.backend.exec_stream(
            self.workers[0], ["sh"], container=self.opts.container, tty=False
        )
        self._down_shell = RemoteShell(down_proc, label="down")

        # Watcher starts BEFORE initial sync so changes made during it are
        # not lost (events for files initial-sync touches are deduped by the
        # index check).
        self._watcher = new_watcher(self.opts.local_path, self.upload_exclude)
        self._watcher.start()

        # initial sync (and its fan-out + shell traffic) parents under
        # the session root span
        with get_tracer().attach(self._session_ctx):
            self.initial_sync()
        self.initial_sync_done.set()

        t_up = threading.Thread(target=self._upstream_loop, daemon=True, name="sync-upstream")
        t_down = threading.Thread(target=self._downstream_loop, daemon=True, name="sync-downstream")
        self._threads = [t_up, t_down]
        t_up.start()
        t_down.start()
        if self.opts.verify_interval > 0 and len(self.workers) > 1:
            t_verify = threading.Thread(
                target=self._verify_loop, daemon=True, name="sync-verify"
            )
            self._threads.append(t_verify)
            t_verify.start()
        # Heartbeat: republish status on a timer so a healthy-but-idle
        # session (no sync events for >10 min — common for single-worker
        # sessions that never start the verify loop) is not reported
        # Stopped by `status sync`'s staleness guard.
        t_hb = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="sync-heartbeat"
        )
        self._threads.append(t_hb)
        t_hb.start()
        self._publish_status()

    def _heartbeat_loop(self, interval: float = 120.0) -> None:
        while not self._stopped.wait(interval):
            self._publish_status()

    def stop(self, error: Optional[BaseException] = None) -> None:
        if error is not None and self.error is None:
            self.error = error
            self.log.error("[sync] fatal: %s", error)
        self._stopped.set()
        self._publish_status()
        if self._watcher:
            self._watcher.stop()
        # Close shells under the workers lock: _try_revive stores a revived
        # shell under the same lock after re-checking _stopped, so every
        # shell is either closed here or never stored.
        with self._workers_lock:
            for sh in self._shells:
                sh.close()
        if self._down_shell:
            self._down_shell.close()
        self._pool.shutdown(wait=False)
        if self._session_span is not None:
            from ..obs.tracing import get_tracer

            get_tracer().end_span(
                self._session_span,
                ok=self.error is None,
                error=str(self.error) if self.error else None,
            )
            self._session_span = None

    # -- local walk --------------------------------------------------------
    def _walk_local(self) -> dict[str, FileInformation]:
        return walk_local_tree(self.opts.local_path, self.exclude)

    # -- initial sync ------------------------------------------------------
    def initial_sync(self) -> None:
        """Reconcile both sides, newest wins, no deletions
        (reference: sync_config.go initialSync/diffServerClient)."""
        from ..utils.trace import span

        with span("sync.initial", workers=len(self.workers)) as s:
            self._initial_sync(s)

    def _initial_sync(self, trace_span: dict) -> None:
        assert self._down_shell is not None
        remote = self._down_shell.snapshot(self._remote_dir(self.workers[0]))
        local = self._walk_local()
        trace_span["local_files"] = len(local)
        trace_span["remote_files"] = len(remote)

        uploads: list[FileInformation] = []
        downloads: list[str] = []
        for rel, li in local.items():
            ri = remote.get(rel)
            if li.is_directory:
                if ri is None and not self.upload_exclude.matches(rel, True):
                    uploads.append(li)
                else:
                    self.index.set(li)
                continue
            if ri is None:
                if not self.upload_exclude.matches(rel, False):
                    uploads.append(li)
            elif li.same_as(ri):
                li.remote_mode = ri.remote_mode
                li.remote_uid = ri.remote_uid
                li.remote_gid = ri.remote_gid
                self.index.set(li)
            elif ri.mtime > li.mtime and not self.download_exclude.matches(rel, False):
                downloads.append(rel)
            elif not self.upload_exclude.matches(rel, False):
                li.remote_mode = ri.remote_mode
                li.remote_uid = ri.remote_uid
                li.remote_gid = ri.remote_gid
                uploads.append(li)
        for rel, ri in remote.items():
            if rel not in local and not ri.is_directory:
                if not self.exclude.matches(rel, False) and not self.download_exclude.matches(rel, False):
                    downloads.append(rel)

        if downloads:
            self._apply_downloads(downloads)
        if uploads:
            self._apply_uploads(uploads)

        # Mirror pass for non-authoritative workers: bring each to local
        # state (upload-only — initial sync never deletes). Graded failure
        # semantics via _fan_out: a worker that can't be mirrored is
        # dropped, not fatal (worker 0 is a no-op — it IS the authority).
        if len(self.workers) > 1:
            local_now = self._walk_local()

            def mirror(i: int) -> None:
                if i == 0:
                    return
                shell = self._shells[i]
                w = self.workers[i]
                snap = shell.snapshot(self._remote_dir(w))
                need = [
                    li
                    for rel, li in local_now.items()
                    if not self.upload_exclude.matches(rel, li.is_directory)
                    and (rel not in snap or (not li.is_directory and not li.same_as(snap[rel])))
                ]
                if need:
                    self._upload_to(shell, w, need)

            self._fan_out(mirror, "initial mirror")
        self.log.done(
            "[sync] initial sync complete: %d up, %d down, index=%d",
            len(uploads),
            len(downloads),
            len(self.index),
        )

    # -- upstream ----------------------------------------------------------
    def _upstream_loop(self) -> None:
        try:
            while not self._stopped.is_set():
                changes = self._collect_events()
                if changes is None:
                    continue
                if self._stopped.is_set():
                    return
                self._process_upstream_changes(changes)
        except BaseException as e:  # noqa: BLE001 — any pipe error is fatal
            if not self._stopped.is_set():
                self.stop(e)

    def _collect_events(self) -> Optional[set[str]]:
        """Debounce: gather events until a quiet period passes
        (reference: upstream.go mainLoop 100-153)."""
        import queue as queue_mod

        assert self._watcher is not None
        try:
            first = self._watcher.events.get(timeout=self.opts.upstream_tick)
        except queue_mod.Empty:
            return None
        changes = {first}
        last_event = time.monotonic()
        while not self._stopped.is_set():
            try:
                ev = self._watcher.events.get(timeout=self.opts.upstream_tick)
                changes.add(ev)
                last_event = time.monotonic()
            except queue_mod.Empty:
                if time.monotonic() - last_event >= self.opts.upstream_quiet:
                    break
        if self._watcher.overflowed.is_set():
            self._watcher.overflowed.clear()
            self.log.warn("[sync] event overflow — full rescan")
            local = self._walk_local()
            changes.update(local.keys())
            changes.update(self.index.snapshot().keys())
        return changes

    def _process_upstream_changes(self, changes: set[str]) -> None:
        """Classify by stat (reference: evaluateChange), digest-gate
        touch-only changes, then apply."""
        creates: list[FileInformation] = []
        removes: list[str] = []
        meta_fixes: list[FileInformation] = []
        expanded: set[str] = set()
        for rel in sorted(changes):
            if rel in expanded:
                continue
            li = local_file_information(self.opts.local_path, rel)
            if li is None:
                old = self.index.get(rel)
                if old is not None and not self.upload_exclude.matches(
                    rel, old.is_directory
                ):
                    if self._remote_newer_than_index(rel):
                        continue  # remote changed it meanwhile — downstream wins
                    removes.append(rel)
                continue
            if self.upload_exclude.matches(rel, li.is_directory):
                continue
            if li.is_directory:
                if rel not in self.index:
                    # New dir: upload it and everything beneath.
                    sub = self._walk_subtree(rel)
                    creates.extend(sub)
                    expanded.update(i.name for i in sub)
                continue
            old = self.index.get(rel)
            if old is None or not li.same_as(old):
                if old is not None:
                    li.remote_mode = old.remote_mode
                    li.remote_uid = old.remote_uid
                    li.remote_gid = old.remote_gid
                if self.opts.digest_gating:
                    # Hash the changed file (memoized on stat identity):
                    # recorded on upload either way, and when the bytes
                    # match the indexed digest the change is a touch/
                    # checkout no-op — answer with a metadata fix.
                    li.digest = self.digests.digest(self.opts.local_path, li)
                    if (
                        old is not None
                        and not old.is_directory
                        and old.digest is not None
                        and li.digest is not None
                        and li.digest == old.digest
                    ):
                        meta_fixes.append(li)
                        continue
                creates.append(li)
        if removes:
            self._apply_removes(removes)
        if meta_fixes:
            self._apply_meta_fixes(meta_fixes)
        if creates:
            self._apply_uploads(creates)

    def _walk_subtree(self, rel: str) -> list[FileInformation]:
        root = self.opts.local_path
        out: list[FileInformation] = []
        top = local_file_information(root, rel)
        if top is not None:
            out.append(top)
        full = os.path.join(root, rel.replace("/", os.sep))
        for dirpath, dirnames, filenames in os.walk(full):
            for name in dirnames + filenames:
                sub = os.path.relpath(os.path.join(dirpath, name), root).replace(
                    os.sep, "/"
                )
                is_dir = name in dirnames
                if self.upload_exclude.matches(sub, is_dir):
                    if is_dir:
                        dirnames.remove(name)
                    continue
                info = local_file_information(root, sub)
                if info is not None:
                    out.append(info)
        return out

    def _remote_newer_than_index(self, rel: str) -> bool:
        """Upload/remove safety valve (reference: evaluater.go:8
        shouldRemoveRemote's mtime guard): consult the latest downstream
        snapshot; if the remote copy is newer than our index, don't clobber."""
        idx = self.index.get(rel)
        with self._last_remote_lock:
            remote = self._last_remote.get(rel)
        if idx is None or remote is None:
            return False
        return remote.mtime > idx.mtime

    # -- partial failure (SURVEY §7 hard part #2) ---------------------------
    def _live_indices(self) -> list[int]:
        with self._workers_lock:
            return [
                i for i in range(len(self.workers)) if i not in self.worker_errors
            ]

    def _mark_worker_failed(self, i: int, exc: Exception) -> None:
        with self._workers_lock:
            if i in self.worker_errors:
                return
            self.worker_errors[i] = str(exc)
        self._bump("workers_quarantined", 1)
        try:
            self._shells[i].close()
        except Exception:  # noqa: BLE001 — already broken
            pass
        self.log.error(
            "[sync] worker %s dropped from fan-out: %s",
            getattr(self.workers[i], "name", i),
            exc,
        )
        ctx = getattr(self, "_session_ctx", None)
        _events.emit(
            "sync", "worker_quarantined", level="error",
            trace_id=ctx.trace_id if ctx is not None else None,
            span_id=ctx.span_id if ctx is not None else None,
            worker=str(getattr(self.workers[i], "name", i)), error=str(exc),
        )
        self._publish_status()

    def _try_revive(self, i: int) -> bool:
        """Reopen the worker's shell and catch its tree up to the index —
        handles a container restart (exec dies, pod comes back). Presence
        parity only: files deleted while the worker was dead are cleaned
        up by the next remove that targets them."""
        if self._stopped.is_set():
            # A stopping session must not open fresh exec streams — they
            # would outlive teardown's ConnectionTracker.close_all().
            return False
        worker = self.workers[i]
        try:
            proc = self.backend.exec_stream(
                worker, ["sh"], container=self.opts.container, tty=False
            )
            shell = RemoteShell(proc, label=f"up{getattr(worker, 'name', i)}")
            if self._stopped.is_set():
                # stop() raced the exec: it may already have run its close
                # loop (and the pipeline its close_all), so nothing else
                # would ever close this stream — close it here.
                shell.close()
                return False
            snap = shell.snapshot(self._remote_dir(worker))
            need = [
                info
                for rel, info in self.index.snapshot().items()
                if rel not in snap
                or (not info.is_directory and not info.same_as(snap[rel]))
            ]
            if need:
                for batch in _batch_entries(need):
                    # catch-up reuses the cached artifact when the batch
                    # matches one already built for the live workers
                    tar_bytes = self.artifacts.get_or_build(
                        self.opts.local_path, batch
                    )
                    if tar_bytes:
                        shell.upload_tar(
                            self._remote_dir(worker),
                            tar_bytes,
                            limiter=self._up_limiter,
                        )
                        self._bump("bytes_sent", len(tar_bytes))
            with self._workers_lock:
                if self._stopped.is_set():
                    # stop() already closed every stored shell; storing now
                    # would leak this one past teardown.
                    shell.close()
                    return False
                old = self._shells[i]
                self._shells[i] = shell
            try:
                old.close()
            except Exception:  # noqa: BLE001
                pass
            self.log.warn(
                "[sync] worker %s shell revived (%d file(s) caught up)",
                getattr(worker, "name", i),
                len(need),
            )
            ctx = getattr(self, "_session_ctx", None)
            _events.emit(
                "sync", "worker_revived",
                trace_id=ctx.trace_id if ctx is not None else None,
                span_id=ctx.span_id if ctx is not None else None,
                worker=str(getattr(worker, "name", i)),
                caught_up_files=len(need),
            )
            return True
        except Exception:  # noqa: BLE001 — revive is best-effort
            return False

    def _fan_out(self, op, what: str) -> list[int]:
        """Run ``op(i)`` on every live worker concurrently. A worker that
        fails gets one shell-revive attempt + retry; failing that it is
        dropped from the fan-out and the session continues — fatal only
        when worker 0 (the downstream authority) or ALL workers are lost
        (reference keeps single-pod all-or-nothing semantics,
        sync_config.go:439; fan-out needs the graded version)."""
        live = self._live_indices()
        if not live:
            raise SyncError("sync has no live workers left")
        # capture the caller's trace context HERE: the pool threads have
        # their own (empty) thread-local stacks, so each per-worker op
        # re-attaches it explicitly — its span (and the $TRACEPARENT the
        # shell exports remotely) then parents under the operation that
        # fanned out, not under nothing
        from ..obs.tracing import get_tracer

        tracer = get_tracer()
        ctx = tracer.current_context() or self._session_ctx

        def traced(i: int, retry: bool = False) -> None:
            with tracer.attach(ctx):
                with tracer.span(
                    f"sync.{what}", worker=i, retry=retry
                ):
                    op(i)

        futures = {i: self._pool.submit(traced, i) for i in live}
        ok: list[int] = []
        for i, f in futures.items():
            try:
                f.result()
                ok.append(i)
            except Exception as e:  # noqa: BLE001
                err = e
                if self._try_revive(i):
                    try:
                        # retry inline, SAME context re-attached — the
                        # retried attempt stays in the original trace
                        traced(i, retry=True)
                        ok.append(i)
                        continue
                    except Exception as e2:  # noqa: BLE001
                        err = e2
                self._mark_worker_failed(i, err)
        with self._workers_lock:
            worker0_error = self.worker_errors.get(0)
        if worker0_error is not None:
            raise SyncError(f"authoritative worker 0 lost: {worker0_error}")
        if not ok:
            raise SyncError(f"{what} failed on every worker")
        return ok

    def _apply_uploads(self, entries: list[FileInformation]) -> None:
        """Tar once per batch (artifact cache), broadcast through the
        bounded producer/consumer pipeline — gzip of batch N+1 overlaps
        the network send of batch N, and each worker drains its own queue
        (reference: applyCreates/uploadArchive; fan-out per SURVEY §2.2)."""
        pipe = UploadPipeline(self, depth=self.opts.pipeline_depth)
        uploaded = pipe.run(_batch_entries(entries))
        if self.opts.verbose:
            for info in entries:
                self.log.debug("[sync] upload %s", info.name)
        self.log.info(
            "[sync] Uploaded %d change(s) to %d worker(s)",
            uploaded,
            len(self._live_indices()),
        )
        self._publish_status()

    def _apply_meta_fixes(self, entries: list[FileInformation]) -> None:
        """Digest-gated path: bytes unchanged, only metadata moved — fix
        the remote mtimes in place (zero payload) and re-index. Keeping
        remote mtime == index mtime is what stops the downstream poll and
        the verify loop from seeing these files as forever-stale."""
        pairs = [(info.name, info.mtime) for info in entries]

        def send(i: int) -> None:
            self._shells[i].touch_paths(self._remote_dir(self.workers[i]), pairs)

        self._fan_out(send, "metadata fix")
        saved = 0
        for info in entries:
            self.index.set(info)
            saved += info.size
        self._bump("meta_fixes", len(entries))
        self._bump("bytes_saved_digest", saved * len(self._live_indices()))
        self.log.info(
            "[sync] Metadata-only fix for %d file(s) (content digest unchanged)",
            len(entries),
        )
        self._publish_status()

    def _upload_to(self, shell: RemoteShell, worker, entries: list[FileInformation]) -> None:
        for batch in _batch_entries(entries):
            tar_bytes = self.artifacts.get_or_build(self.opts.local_path, batch)
            if tar_bytes:
                self._upload_raw(shell, worker, tar_bytes)

    def _upload_raw(self, shell: RemoteShell, worker, tar_bytes: bytes) -> None:
        shell.upload_tar(self._remote_dir(worker), tar_bytes, limiter=self._up_limiter)
        self._bump("bytes_sent", len(tar_bytes))

    def _apply_removes(self, relpaths: list[str]) -> None:
        def send(i: int) -> None:
            self._shells[i].remove_paths(self._remote_dir(self.workers[i]), relpaths)

        self._fan_out(send, "remove")
        for rel in relpaths:
            self.index.remove(rel)
        self._bump("removed_remote", len(relpaths))
        self.log.info(
            "[sync] Removed %d path(s) on %d worker(s)",
            len(relpaths),
            len(self._live_indices()),
        )

    # -- downstream --------------------------------------------------------
    def _poll_policy(self) -> RetryPolicy:
        """Downstream-poll failure budget (reference: downstream.go:199-203
        retries after 4s; we back off 2x up to the same 4s cap). Five
        consecutive failures — or a dead shell — end the session."""
        return RetryPolicy(
            max_attempts=5,
            base_delay=min(4.0, self.opts.downstream_interval * 2),
            max_delay=4.0,
            multiplier=2.0,
            seed=0,
            retry_on=(SyncError, TimeoutError, ConnectionError),
        )

    def _downstream_loop(self) -> None:
        """Poll worker 0; act only after `stable_polls` identical snapshots
        (reference: downstream.go mainLoop 105-134)."""
        assert self._down_shell is not None
        previous: Optional[dict[str, FileInformation]] = None
        stable = 0
        applied_version: Optional[frozenset] = None
        poll_policy = self._poll_policy()
        poll_delays = poll_policy.delays()
        try:
            while not self._stopped.is_set():
                if self._stopped.wait(self.opts.downstream_interval):
                    return
                try:
                    snap = self._down_shell.snapshot(
                        self._remote_dir(self.workers[0])
                    )
                    poll_delays = poll_policy.delays()  # success resets budget
                except poll_policy.retry_on as e:
                    # Transient poll failures retry under the policy; only a
                    # dead shell or an exhausted budget is fatal.
                    if not self._down_shell.alive():
                        raise
                    try:
                        delay = next(poll_delays)
                    except StopIteration:
                        raise e from None
                    self.log.warn(
                        "[sync] downstream poll failed, retrying in %.1fs: %s",
                        delay,
                        e,
                    )
                    if self._stopped.wait(delay):
                        return
                    continue
                snap = {
                    rel: info
                    for rel, info in snap.items()
                    if not self.exclude.matches(rel, info.is_directory)
                }
                with self._last_remote_lock:
                    self._last_remote = snap
                version = frozenset(
                    (rel, info.size, info.mtime) for rel, info in snap.items()
                )
                if previous is not None and version == frozenset(
                    (rel, i.size, i.mtime) for rel, i in previous.items()
                ):
                    stable += 1
                else:
                    stable = 1
                previous = snap
                if stable >= self.opts.stable_polls and version != applied_version:
                    self._apply_downstream(snap)
                    applied_version = version
        except BaseException as e:  # noqa: BLE001
            if not self._stopped.is_set():
                self.stop(e)

    def _apply_downstream(self, snap: dict[str, FileInformation]) -> None:
        downloads: list[str] = []
        local_removes: list[str] = []
        for rel, ri in snap.items():
            if self.download_exclude.matches(rel, ri.is_directory):
                continue
            if ri.is_directory:
                if rel not in self.index:
                    os.makedirs(
                        os.path.join(self.opts.local_path, rel.replace("/", os.sep)),
                        exist_ok=True,
                    )
                    self.index.set(ri)
                continue
            idx = self.index.get(rel)
            if idx is None or not ri.same_as(idx):
                li = local_file_information(self.opts.local_path, rel)
                if li is not None and li.mtime > ri.mtime:
                    continue  # local is newer — upstream will push it
                if li is not None and idx is not None and not li.same_as(idx):
                    continue  # local changed since last sync — upstream wins
                downloads.append(rel)
        for rel, idx in self.index.snapshot().items():
            if rel in snap:
                continue
            if self.download_exclude.matches(rel, idx.is_directory):
                continue
            # Deletion triple-check (reference: evaluater.go:139): the entry
            # is indexed, gone remotely (2 stable polls), and the local file
            # still matches the index exactly.
            li = local_file_information(self.opts.local_path, rel)
            if li is None:
                self.index.remove(rel)
                continue
            if idx.is_directory and li.is_directory:
                local_removes.append(rel)
            elif not idx.is_directory and not li.is_directory and li.same_as(idx):
                local_removes.append(rel)
        if downloads:
            self._apply_downloads(downloads)
        if local_removes:
            self._apply_local_removes(local_removes)

    def _apply_downloads(self, relpaths: list[str]) -> None:
        assert self._down_shell is not None
        remote_dir = self._remote_dir(self.workers[0])
        count = 0
        for batch in RemoteShell.iter_download_batches(relpaths):
            tar_bytes = self._down_shell.download_tar(
                remote_dir, batch, limiter=self._down_limiter
            )
            if not tar_bytes:
                continue
            applied = extract_tar(tar_bytes, self.opts.local_path, self.index)
            count += len(applied)
            if self.opts.verbose:
                for info in applied:
                    self.log.debug("[sync] download %s", info.name)
        self._bump("downloaded", count)
        self.log.info("[sync] Downloaded %d change(s)", count)
        self._publish_status()
        # Mirror downloads to non-authoritative workers so the slice stays
        # uniform (worker 0 is the source of truth).
        if len(self.workers) > 1:
            entries = [
                info
                for rel in relpaths
                if (info := local_file_information(self.opts.local_path, rel))
                is not None
            ]

            def send(i: int) -> None:
                if i == 0:
                    return  # source of truth — it already has these
                self._upload_to(self._shells[i], self.workers[i], entries)

            self._fan_out(send, "download mirror")

    def _apply_local_removes(self, relpaths: list[str]) -> None:
        """Careful local deletion (reference: deleteSafeRecursive,
        sync/util.go:247 — only delete what the index says we created)."""
        import shutil

        for rel in sorted(relpaths, key=len, reverse=True):
            full = os.path.join(self.opts.local_path, rel.replace("/", os.sep))
            idx = self.index.get(rel)
            if idx is None:
                continue
            try:
                if idx.is_directory:
                    # Only remove if every child is index-tracked AND still
                    # matches its index entry — a locally edited child means
                    # local state would be lost (reference: deleteSafeRecursive
                    # only deletes children matching the file map).
                    safe = True
                    for dirpath, dirnames, filenames in os.walk(full):
                        for name in filenames + list(dirnames):
                            sub = os.path.relpath(
                                os.path.join(dirpath, name), self.opts.local_path
                            ).replace(os.sep, "/")
                            sub_idx = self.index.get(sub)
                            if sub_idx is None:
                                safe = False
                                break
                            if not sub_idx.is_directory:
                                sub_li = local_file_information(
                                    self.opts.local_path, sub
                                )
                                if sub_li is None or not sub_li.same_as(sub_idx):
                                    safe = False
                                    break
                        if not safe:
                            break
                    if safe:
                        shutil.rmtree(full, ignore_errors=True)
                        self.index.remove(rel)
                        self._bump("removed_local", 1)
                else:
                    li = local_file_information(self.opts.local_path, rel)
                    if li is not None and li.same_as(idx):
                        os.unlink(full)
                        self.index.remove(rel)
                        self._bump("removed_local", 1)
            except OSError:
                continue
        self.log.info("[sync] Removed %d local path(s)", len(relpaths))

    # -- drift detection (verify loop) --------------------------------------
    def _verify_loop(self) -> None:
        """Periodically verify non-authoritative workers against the index
        and repair silent divergence (an in-container rm/edit on worker
        1..N-1 never surfaces through the worker-0 downstream poll).
        Worker 0 is the downstream authority — its changes are *meant* to
        differ until pulled, so it is never 'repaired'."""
        while not self._stopped.is_set():
            if self._stopped.wait(self.opts.verify_interval):
                return
            for i in self._live_indices():
                if i == 0 or self._stopped.is_set():
                    continue
                try:
                    repaired = self._verify_worker(i)
                except Exception as e:  # noqa: BLE001
                    # verify shares _fan_out's graded semantics: revive
                    # once, else quarantine; never fatal for a mirror.
                    if self._stopped.is_set():
                        return
                    if not self._try_revive(i):
                        self._mark_worker_failed(i, e)
                    continue
                self._worker_verified_at[i] = time.time()
                if repaired:
                    with self._workers_lock:
                        self._worker_repairs[i] = (
                            self._worker_repairs.get(i, 0) + repaired
                        )
                    self._bump("repaired", repaired)
                    self.log.warn(
                        "[sync] worker %s drifted — repaired %d path(s)",
                        getattr(self.workers[i], "name", i),
                        repaired,
                    )
            self._publish_status()

    def _verify_worker(self, i: int) -> int:
        """Compare worker ``i``'s tree to the index; upload missing/stale
        files and delete rogue ones. Returns the number of repairs."""
        shell = self._shells[i]
        worker = self.workers[i]
        snap = shell.snapshot(self._remote_dir(worker))
        index = self.index.snapshot()
        need = [
            info
            for rel, info in index.items()
            if not self.upload_exclude.matches(rel, info.is_directory)
            and (
                rel not in snap
                or (not info.is_directory and not info.same_as(snap[rel]))
            )
        ]
        candidates = {
            rel
            for rel, info in snap.items()
            if rel not in index
            and not self.exclude.matches(rel, info.is_directory)
            and not self.upload_exclude.matches(rel, info.is_directory)
        }
        # Two-sighting rule (the reference's stable-polls discipline,
        # downstream.go:117-128, applied to drift): only remove a rogue
        # path seen on BOTH this pass and the previous one. An upload
        # racing this pass (tar landed, index.set not yet run) can appear
        # index-less once, but is indexed long before the next pass —
        # so in-flight syncs are never deleted, real drift goes in two.
        confirmed = candidates & self._extra_candidates.get(i, set())
        confirmed &= {
            rel for rel in confirmed if self.index.get(rel) is None
        }  # late re-check right before acting
        self._extra_candidates[i] = candidates - confirmed
        extra = [
            rel
            for rel in confirmed
            if not any(parent in confirmed for parent in _ancestors(rel))
        ]
        if extra:
            shell.remove_paths(self._remote_dir(worker), sorted(extra))
        if need:
            self._upload_to(shell, worker, need)
        return len(need) + len(extra)

    # -- health / status surfaces -------------------------------------------
    def alive(self) -> bool:
        """Liveness probe for the session supervisor: running with no
        fatal error. Quarantined mirror workers do NOT make the session
        dead — that is the graded-degradation contract."""
        return not self._stopped.is_set() and self.error is None

    def worker_health(self) -> list[dict]:
        """Per-worker live state for `status sync` (the per-worker health
        view)."""
        out = []
        with self._workers_lock:
            errors = dict(self.worker_errors)
            repairs = dict(self._worker_repairs)
        for i, w in enumerate(self.workers):
            if i in errors:
                state = "quarantined"
            else:
                state = "authority" if i == 0 else "mirror"
            verified = self._worker_verified_at.get(i)
            out.append(
                {
                    "worker": getattr(w, "name", str(i)),
                    "state": state,
                    "last_error": errors.get(i, ""),
                    "repairs": repairs.get(i, 0),
                    "verified_ago": round(time.time() - verified, 1)
                    if verified
                    else None,
                }
            )
        return out

    def status_snapshot(self) -> dict:
        with self._stats_lock:
            stats = dict(self.stats)
        stats["pipeline_stall_s"] = round(stats.get("pipeline_stall_s", 0.0), 3)
        stats.update(self.artifacts.stats())
        return {
            "local_path": self.opts.local_path,
            "container_path": self.opts.container_path,
            "started_at": self.started_at,
            "updated_at": time.time(),
            "running": not self._stopped.is_set(),
            "error": str(self.error) if self.error else None,
            "stats": stats,
            "workers": self.worker_health(),
        }

    def _publish_status(self) -> None:
        """Write per-session/per-worker state to opts.status_path (JSON,
        atomic rename) so out-of-process `status sync` sees live health.
        The file is shared by every session in the project: a process-wide
        lock serializes threads, an fcntl flock on a sidecar lock file
        serializes read-modify-write ACROSS devspace processes (two CLIs
        publishing concurrently could otherwise interleave read->replace
        and silently drop each other's entry), and the temp file name is
        unique per process so rename never corrupts."""
        path = self.opts.status_path
        if not path:
            return
        import json

        with _STATUS_FILE_LOCK:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                lock_fh = open(f"{path}.lock", "a+", encoding="utf-8")
                try:
                    try:
                        import fcntl

                        fcntl.flock(lock_fh, fcntl.LOCK_EX)
                    except (ImportError, OSError):
                        # non-POSIX, or a filesystem without flock (some
                        # NFS mounts): publish anyway — the cross-process
                        # lock is an upgrade, not a prerequisite
                        pass
                    tmp = f"{path}.{os.getpid()}.tmp"
                    existing: dict = {}
                    try:
                        with open(path, "r", encoding="utf-8") as fh:
                            existing = json.load(fh)
                    except (OSError, ValueError):
                        existing = {}
                    # prune entries from long-gone runs (removed sync configs)
                    cutoff = time.time() - 24 * 3600
                    existing = {
                        k: v
                        for k, v in existing.items()
                        if (v.get("updated_at") or 0) > cutoff
                    }
                    key = f"{self.opts.local_path}->{self.opts.container_path}"
                    existing[key] = self.status_snapshot()
                    with open(tmp, "w", encoding="utf-8") as fh:
                        json.dump(existing, fh, indent=1)
                    os.replace(tmp, path)
                finally:
                    lock_fh.close()  # releases the flock
            except OSError:
                pass  # status publication is best-effort

    # -- one-shot copy (reference: sync/util.go:21 CopyToContainer) ---------


def copy_to_container(
    backend,
    worker,
    local_path: str,
    container_path: str,
    exclude_paths: Optional[list[str]] = None,
    container: Optional[str] = None,
    logger=None,
) -> int:
    """One-shot upload of a local tree into a container (used by the kaniko
    builder for build-context upload; reference: sync/util.go CopyToContainer).
    Returns the number of entries uploaded."""
    matcher = IgnoreMatcher(exclude_paths or [])
    proc = backend.exec_stream(worker, ["sh"], container=container, tty=False)
    shell = RemoteShell(proc, label="copy")
    try:
        entries = list(walk_local_tree(local_path, matcher).values())
        for batch in _batch_entries(entries):
            tar_bytes = build_tar(local_path, batch)
            if tar_bytes:
                shell.upload_tar(
                    backend.translate_path(worker, container_path), tar_bytes
                )
        return len(entries)
    finally:
        shell.close()


def _ancestors(rel: str):
    parts = rel.split("/")
    for n in range(1, len(parts)):
        yield "/".join(parts[:n])


def _batch_entries(entries: list[FileInformation]):
    """Split uploads into bounded batches (reference: 1000 files/batch,
    sync_config.go:20; plus a byte bound so tars stay in memory safely)."""
    batch: list[FileInformation] = []
    size = 0
    for info in entries:
        batch.append(info)
        size += info.size
        if len(batch) >= UPLOAD_BATCH_FILES or size >= UPLOAD_BATCH_BYTES:
            yield batch
            batch, size = [], 0
    if batch:
        yield batch


_register_sync_metrics()
