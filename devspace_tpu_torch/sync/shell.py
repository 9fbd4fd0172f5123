"""The agentless remote-shell protocol.

Reference: the sync engine drives a long-lived ``sh`` spawned via exec,
commanded over stdin with START/DONE/ERROR handshake tokens
(pkg/devspace/sync/sync_config.go:24-30, upstream.go:379-434,
downstream.go:346-443). Only sh+tar+stat+find+head are required in the
container — no agent. Differences from the reference, on purpose:

- exact-byte transfers use ``head -c N`` instead of the reference's
  ``cat </proc/$$/fd/0`` + size-polling loop — simpler and race-free;
- download sizes are announced on stdout (``SIZE:n`` line) instead of
  being parsed from a stderr side-channel;
- handshake tokens are namespaced and sequenced so a token can never
  collide with file content or a stale command's output.

The port's copy of ``devspace_tpu/sync/shell.py``, with the same
behaviour: ``build_tar`` packs batches of 64 entries or more with the
port's native ``libdevsync`` (``utils/native.py``) when that is built, and
with ``tarfile`` otherwise.
"""

from __future__ import annotations

import hashlib
import io
import shlex
import tarfile
import threading
import time
from typing import Optional

from ..kube.streams import RemoteProcess, StreamClosed
from .file_info import FileInformation, find_command, parse_stat_line


class SyncError(Exception):
    pass


class RateLimiter:
    """Token-bucket byte throttle (reference: juju/ratelimit wrapping the
    exec pipes, upstream.go:426-429, configured in KB/s)."""

    def __init__(self, kbytes_per_second: Optional[int]):
        self.rate = (kbytes_per_second or 0) * 1024
        self._allowance = float(self.rate)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def throttle(self, nbytes: int) -> None:
        if self.rate <= 0:
            return
        remaining = nbytes
        while remaining > 0:
            # Consume at most one second of budget per iteration so a
            # request larger than the bucket (chunk > rate) drains
            # incrementally instead of waiting for an unreachable fill.
            want = min(remaining, self.rate)
            wait = 0.0
            with self._lock:
                now = time.monotonic()
                self._allowance = min(
                    self.rate, self._allowance + (now - self._last) * self.rate
                )
                self._last = now
                if self._allowance >= want:
                    self._allowance -= want
                    remaining -= want
                else:
                    wait = min(1.0, (want - self._allowance) / self.rate)
            # Sleep with the lock RELEASED: a large transfer waiting out its
            # deficit must not serialize every other fan-out thread — those
            # with budget left should consume it and proceed immediately.
            if wait > 0:
                time.sleep(wait)


class RemoteShell:
    """A long-lived remote ``sh`` with sequenced command handshakes."""

    CHUNK = 1 << 16

    def __init__(self, proc: RemoteProcess, label: str = "sync"):
        self.proc = proc
        self.label = label
        self._seq = 0
        self._lock = threading.Lock()
        self._ensured_dirs: set[str] = set()

    def _tokens(self) -> tuple[str, str, str]:
        self._seq += 1
        base = f"__DS_{self.label}_{self._seq}"
        return f"{base}_START__", f"{base}_DONE__", f"{base}_ERR__"

    def close(self) -> None:
        try:
            # drop the reusable upload spool (see upload_tar) on the way out
            self.proc.write_stdin(b'rm -f "/tmp/.ds-up-$$"\nexit 0\n')
        except StreamClosed:
            pass
        self.proc.terminate()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def _trace_env(self) -> str:
        """Shell statement exporting the CALLER's active trace context as
        ``$TRACEPARENT`` on the remote side — the W3C header is how the
        trace crosses the exec boundary: remote tooling (or a
        nested devspace) reads the env var and parents its own spans
        under the sync operation that launched it. Empty when no span is
        active; re-exported per command so retries after a shell revive
        carry the CURRENT attempt's context, not the dead shell's."""
        from ..obs import tracing

        tp = tracing.current_traceparent()
        if not tp:
            return ""
        return f"TRACEPARENT={shlex.quote(tp)}; export TRACEPARENT; "

    # -- generic command ---------------------------------------------------
    def run(self, script: str, timeout: float = 60.0) -> str:
        """Run a script; returns its stdout. The script must not read stdin."""
        with self._lock:
            _, done, err = self._tokens()
            wrapped = (
                f"{self._trace_env()}"
                f"if {{ {script}\n}}; then printf '\\n%s\\n' {done}; "
                f"else printf '\\n%s\\n' {err}; fi\n"
            )
            self.proc.write_stdin(wrapped.encode())
            out, token = self.proc.stdout.read_until(
                [done.encode() + b"\n", err.encode() + b"\n"], timeout=timeout
            )
            if token.startswith(err.encode()):
                stderr = self.proc.stderr.drain().decode("utf-8", "replace")
                raise SyncError(
                    f"remote command failed: {script[:200]}\nstderr: {stderr[-2000:]}"
                )
            return out.decode("utf-8", "replace")

    # -- snapshot ----------------------------------------------------------
    def snapshot(self, remote_dir: str, timeout: float = 120.0) -> dict[str, FileInformation]:
        """Remote find/stat snapshot (reference: downstream.go collectChanges)."""
        out = self.run(find_command(remote_dir), timeout=timeout)
        result: dict[str, FileInformation] = {}
        for line in out.splitlines():
            info = parse_stat_line(line.rstrip("\r"), remote_dir)
            if info is not None:
                result[info.name] = info
        return result

    # -- upload ------------------------------------------------------------
    def ensure_dir(self, remote_dir: str, timeout: float = 30.0) -> None:
        """``mkdir -p`` the target once per shell lifetime. A dir deleted
        remotely mid-session makes the next upload's tar fail, which flows
        into the fan-out's revive path — and a revived shell starts with
        an empty ensured set, recreating the dir."""
        if remote_dir in self._ensured_dirs:
            return
        self.run(f"mkdir -p {shlex.quote(remote_dir)}", timeout=timeout)
        self._ensured_dirs.add(remote_dir)

    def upload_tar(
        self,
        remote_dir: str,
        tar_bytes: bytes,
        limiter: Optional[RateLimiter] = None,
        timeout: float = 300.0,
    ) -> None:
        """Stream a gzipped tar into remote_dir with exact byte count
        (reference: upstream.go uploadArchive; ``head -c`` replaces the
        /proc/fd trick).

        Fork budget (every exec costs ~10ms wall on a loaded single-core
        host, and the fan-out runs this once per worker per batch): the
        target dir is created once per shell (ensure_dir) instead of per
        upload, and the spool file is a fixed per-shell name truncated by
        ``>`` instead of rm'd per upload — 3 forks (head, tar, gzip)
        instead of 5."""
        self.ensure_dir(remote_dir)
        with self._lock:
            start, done, err = self._tokens()
            q = shlex.quote(remote_dir)
            # $$ (remote shell pid) keeps the spool name collision-free even
            # when several sessions share a filesystem (fake backend,
            # hostPath); self._lock means one upload per shell at a time, so
            # one spool per shell suffices. Removed on close().
            tmp = '"/tmp/.ds-up-$$"'
            script = (
                f"{self._trace_env()}"
                f"printf '%s\\n' {start}; "
                f"if head -c {len(tar_bytes)} > {tmp} "
                f"&& tar xzpf {tmp} -C {q}; "
                f"then printf '\\n%s\\n' {done}; "
                f"else printf '\\n%s\\n' {err}; fi\n"
            )
            self.proc.write_stdin(script.encode())
            self.proc.stdout.read_until([start.encode() + b"\n"], timeout=30.0)
            for i in range(0, len(tar_bytes), self.CHUNK):
                chunk = tar_bytes[i : i + self.CHUNK]
                if limiter:
                    limiter.throttle(len(chunk))
                self.proc.write_stdin(chunk)
            _, token = self.proc.stdout.read_until(
                [done.encode() + b"\n", err.encode() + b"\n"], timeout=timeout
            )
            if token.startswith(err.encode()):
                stderr = self.proc.stderr.drain().decode("utf-8", "replace")
                raise SyncError(f"remote untar failed: {stderr[-2000:]}")

    # -- download ----------------------------------------------------------
    # Argv budget per tar invocation; callers chunk big downloads. Kept well
    # under sh line limits — one tar per chunk, never xargs (which would
    # split into several tar runs, each clobbering the archive).
    DOWNLOAD_ARG_BYTES = 32 * 1024

    def download_tar(
        self,
        remote_dir: str,
        relpaths: list[str],
        limiter: Optional[RateLimiter] = None,
        timeout: float = 300.0,
    ) -> bytes:
        """Fetch one batch of files as a gzipped tar (reference:
        downstream.go downloadFiles/downloadArchive). The caller is
        responsible for batching within DOWNLOAD_ARG_BYTES of quoted paths
        (see iter_download_batches)."""
        if not relpaths:
            return b""
        args = " ".join(shlex.quote(p) for p in relpaths)
        with self._lock:
            start, done, err = self._tokens()
            q = shlex.quote(remote_dir)
            tmp = f'"/tmp/.ds-dl-$$-{self._seq}"'
            script = (
                f"printf '%s\\n' {start}; "
                f"if cd {q} && tar czf {tmp}.tgz -- {args}; "
                f"then printf 'SIZE:%s\\n' $(wc -c < {tmp}.tgz); "
                f"cat {tmp}.tgz; rm -f {tmp}.tgz; printf '\\n%s\\n' {done}; "
                f"else rm -f {tmp}.tgz; printf '\\n%s\\n' {err}; fi\n"
            )
            self.proc.write_stdin(script.encode())
            self.proc.stdout.read_until([start.encode() + b"\n"], timeout=30.0)
            _, token = self.proc.stdout.read_until(
                [b"SIZE:", err.encode() + b"\n"], timeout=timeout
            )
            if token != b"SIZE:":
                stderr = self.proc.stderr.drain().decode("utf-8", "replace")
                raise SyncError(f"remote tar failed: {stderr[-2000:]}")
            size_line, _ = self.proc.stdout.read_until([b"\n"], timeout=30.0)
            try:
                size = int(size_line.strip())
            except ValueError as e:
                raise SyncError(f"bad SIZE line: {size_line!r}") from e
            remaining = size
            chunks = []
            while remaining > 0:
                n = min(self.CHUNK, remaining)
                data = self.proc.stdout.read_exact(n, timeout=timeout)
                if limiter:
                    limiter.throttle(len(data))
                chunks.append(data)
                remaining -= len(data)
            self.proc.stdout.read_until(
                [done.encode() + b"\n", err.encode() + b"\n"], timeout=30.0
            )
            return b"".join(chunks)

    @classmethod
    def iter_download_batches(cls, relpaths: list[str]):
        """Split a path list into batches fitting the argv budget."""
        batch: list[str] = []
        used = 0
        for p in relpaths:
            cost = len(shlex.quote(p)) + 1
            if batch and used + cost > cls.DOWNLOAD_ARG_BYTES:
                yield batch
                batch, used = [], 0
            batch.append(p)
            used += cost
        if batch:
            yield batch

    # -- removes -----------------------------------------------------------
    REMOVE_BATCH = 50  # reference: upstream.go:470

    def remove_paths(self, remote_dir: str, relpaths: list[str], timeout: float = 60.0) -> None:
        """Batched remote removal (reference: applyRemoves — 50 per rm)."""
        for i in range(0, len(relpaths), self.REMOVE_BATCH):
            batch = relpaths[i : i + self.REMOVE_BATCH]
            args = " ".join(
                shlex.quote(f"{remote_dir.rstrip('/')}/{p}") for p in batch
            )
            self.run(f"rm -rf -- {args}", timeout=timeout)

    # -- metadata-only fixes -----------------------------------------------
    def touch_paths(
        self,
        remote_dir: str,
        pairs: list[tuple[str, int]],
        timeout: float = 60.0,
    ) -> None:
        """Set remote mtimes without transferring content: the digest-gated
        answer to a local touch/checkout that changed metadata but not
        bytes. ``touch -d @EPOCH`` is portable across GNU coreutils and
        busybox; ``-c`` skips files a concurrent remove already took."""
        root = remote_dir.rstrip("/")
        for i in range(0, len(pairs), self.REMOVE_BATCH):
            batch = pairs[i : i + self.REMOVE_BATCH]
            script = "; ".join(
                f"touch -c -d @{int(mtime)} -- {shlex.quote(f'{root}/{p}')}"
                for p, mtime in batch
            )
            self.run(script, timeout=timeout)


# -- tar helpers ------------------------------------------------------------
def build_tar(
    local_root: str,
    entries: list[FileInformation],
) -> bytes:
    """Gzipped tar of local files, paths relative to the sync root,
    preserving mtimes (so remote stat equals the index) and re-applying
    recorded remote mode/uid/gid (reference: tar.go:246-292).

    Large batches (the initial-sync snapshot of a many-small-files tree)
    assemble the tar in native code when libdevsync is available —
    CPython's per-member TarInfo bookkeeping is the cost there — and
    gzip here either way."""
    import os

    from ..utils import native

    if len(entries) >= 64:  # small batches: ctypes round-trip isn't worth it
        raw = native.pack_tar(
            local_root,
            [
                native.PackEntry(
                    name=info.name,
                    is_dir=bool(info.is_directory),
                    mode=(
                        info.remote_mode
                        if info.remote_mode is not None
                        else (0o755 if info.is_directory else -1)
                    ),
                    uid=info.remote_uid if info.remote_uid is not None else -1,
                    gid=info.remote_gid if info.remote_gid is not None else -1,
                    mtime=int(info.mtime),
                )
                for info in entries
            ],
        )
        if raw is not None:
            import gzip

            return gzip.compress(raw, compresslevel=4)

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz", compresslevel=4) as tf:
        for info in entries:
            full = os.path.join(local_root, info.name.replace("/", os.sep))
            try:
                if info.is_directory:
                    ti = tarfile.TarInfo(info.name)
                    ti.type = tarfile.DIRTYPE
                    ti.mode = (
                        info.remote_mode
                        if info.remote_mode is not None
                        else 0o755  # same default as the native PackEntry path
                    )
                    ti.mtime = info.mtime
                    tf.addfile(ti)
                else:
                    ti = tarfile.TarInfo(info.name)
                    # Record the INDEXED size/mtime, not a fresh os.stat:
                    # under a concurrent writer a fresh stat would make the
                    # remote copy disagree with the caller's index forever
                    # (neither side ever sees a change).
                    ti.size = info.size
                    ti.mtime = int(info.mtime)
                    if info.remote_mode is not None:
                        ti.mode = info.remote_mode
                    else:
                        st = os.stat(full)
                        ti.mode = st.st_mode & 0o7777
                    if info.remote_uid is not None:
                        ti.uid = info.remote_uid
                    if info.remote_gid is not None:
                        ti.gid = info.remote_gid
                    with open(full, "rb") as fh:
                        # exactly ti.size bytes must follow the header: a
                        # file that grew or shrank after indexing
                        # (concurrent writer) would otherwise abort addfile
                        # mid-copy and misalign every later member.
                        # Truncate/zero-fill to the indexed size like the
                        # native packer; the next change event re-syncs the
                        # real content.
                        tf.addfile(ti, _ExactSizeReader(fh, info.size))
            except OSError:
                continue  # raced with a concurrent delete; skip
    return buf.getvalue()


class _ExactSizeReader:
    """Wraps a file object to deliver EXACTLY ``size`` bytes: truncates
    a file that grew, zero-pads one that shrank (never raises on EOF) —
    keeps the surrounding tar stream well-formed under concurrent
    writes, matching the native packer's behavior."""

    def __init__(self, fh, size: int):
        self._fh = fh
        self._left = size

    def read(self, n: int = -1) -> bytes:
        if n < 0 or n > self._left:
            n = self._left
        if n == 0:
            return b""
        try:
            data = self._fh.read(n)
        except OSError:
            data = b""
        if len(data) < n:
            data += b"\0" * (n - len(data))
        self._left -= n
        return data


def extract_tar(
    tar_bytes: bytes,
    local_root: str,
    index,
) -> list[FileInformation]:
    """Extract a downloaded tar into local_root, skipping entries whose
    local copy is newer (reference: tar.go untarNext 61-77), restoring
    mtimes (129) and updating the index so upstream won't echo the file
    back (136-141). Returns the list of applied entries."""
    import os

    applied: list[FileInformation] = []
    with tarfile.open(fileobj=io.BytesIO(tar_bytes), mode="r:gz") as tf:
        for ti in tf:
            rel = ti.name
            while rel.startswith("./"):
                rel = rel[2:]
            rel = rel.strip("/")
            if not rel or rel == "." or rel.startswith("../") or "/../" in rel:
                continue
            full = os.path.join(local_root, rel.replace("/", os.sep))
            info = FileInformation(
                name=rel,
                size=0 if ti.isdir() else ti.size,
                mtime=int(ti.mtime),
                is_directory=ti.isdir(),
                remote_mode=ti.mode,
                remote_uid=ti.uid,
                remote_gid=ti.gid,
            )
            if ti.isdir():
                os.makedirs(full, exist_ok=True)
                index.set(info)
                applied.append(info)
                continue
            if not ti.isreg():
                continue  # links/devices are not synced (reference: symlink.go)
            try:
                st = os.stat(full)
                if int(st.st_mtime) > int(ti.mtime):
                    continue  # local copy is newer — keep it
            except OSError:
                pass
            os.makedirs(os.path.dirname(full), exist_ok=True)
            src = tf.extractfile(ti)
            if src is None:
                continue
            tmp = full + ".ds-tmp"
            try:
                # Hash while writing: a downloaded file's digest is free
                # here, and recording it lets the upstream digest-gate a
                # later touch of this file without a first re-upload.
                h = hashlib.blake2b(digest_size=16)
                with open(tmp, "wb") as dst:
                    while True:
                        chunk = src.read(1 << 20)
                        if not chunk:
                            break
                        h.update(chunk)
                        dst.write(chunk)
                info.digest = h.hexdigest()
                os.replace(tmp, full)
                os.utime(full, (ti.mtime, ti.mtime))
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                continue
            index.set(info)
            applied.append(info)
    return applied
