"""Leveled logger with status and table support.

The port's copy of ``devspace_tpu/utils/log.py`` (reference:
pkg/util/log/logger.go, stdout_logger.go, file_logger.go, log.go):
``Logger``, ``StdoutLogger``, ``DiscardLogger``, ``FatalError``, and the
JSON-lines ``FileLogger`` with ``start_file_logging``, which mirrors the
CLI's log into ``.devspace/logs/default.log``.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import IO, Iterable, Optional

# ANSI styles (applied only when the stream is a TTY).
_STYLES = {
    "debug": "\033[37m",
    "info": "\033[36m",
    "warn": "\033[33m",
    "error": "\033[91m",
    "fatal": "\033[91;1m",
    "done": "\033[32m",
    "fail": "\033[91m",
    "wait": "\033[35m",
}
_RESET = "\033[0m"

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "fatal": 50}


class FatalError(SystemExit):
    """Raised by Logger.fatal — carries exit status 1 like the reference's
    log.Fatalf (which os.Exit(1)s) but remains catchable in tests."""

    def __init__(self, message: str):
        super().__init__(1)
        self.message = message


class Logger:
    """Base logger. Subclasses implement :meth:`_write`."""

    def __init__(self, level: str = "info"):
        self.level = level
        self._lock = threading.RLock()
        self._mirrors: list[Logger] = []

    # -- plumbing ---------------------------------------------------------
    def _write(self, tag: str, msg: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def _emit(self, tag: str, msg: str, min_level: str = "info") -> None:
        with self._lock:
            if LEVELS.get(min_level, 20) >= LEVELS.get(self.level, 20):
                self._write(tag, msg)
            for m in self._mirrors:
                m._emit(tag, msg, min_level)

    def add_mirror(self, other: "Logger") -> None:
        """Mirror every message to another logger (reference: StartFileLogging
        wraps stdout so everything also lands in default.log)."""
        with self._lock:
            if other is not self and other not in self._mirrors:
                self._mirrors.append(other)

    # -- levels -----------------------------------------------------------
    def debug(self, msg: str, *args) -> None:
        self._emit("debug", msg % args if args else msg, "debug")

    def info(self, msg: str, *args) -> None:
        self._emit("info", msg % args if args else msg, "info")

    def warn(self, msg: str, *args) -> None:
        self._emit("warn", msg % args if args else msg, "warn")

    def error(self, msg: str, *args) -> None:
        self._emit("error", msg % args if args else msg, "error")

    def done(self, msg: str, *args) -> None:
        self._emit("done", msg % args if args else msg, "info")

    def fail(self, msg: str, *args) -> None:
        self._emit("fail", msg % args if args else msg, "error")

    def fatal(self, msg: str, *args) -> None:
        text = msg % args if args else msg
        self._emit("fatal", text, "fatal")
        raise FatalError(text)

    # -- spinner ----------------------------------------------------------
    def start_wait(self, msg: str) -> None:
        self._emit("wait", msg, "info")

    def stop_wait(self) -> None:
        pass

    class _Wait:
        def __init__(self, logger: "Logger", msg: str):
            self._logger, self._msg = logger, msg

        def __enter__(self):
            self._logger.start_wait(self._msg)
            return self

        def __exit__(self, *exc):
            self._logger.stop_wait()
            return False

    def wait(self, msg: str) -> "Logger._Wait":
        return Logger._Wait(self, msg)

    # -- tables ------------------------------------------------------------
    def print_table(self, header: Iterable[str], rows: Iterable[Iterable[str]]) -> None:
        header = [str(h) for h in header]
        rows = [[str(c) for c in r] for r in rows]
        widths = [len(h) for h in header]
        for r in rows:
            for i, c in enumerate(r):
                if i < len(widths):
                    widths[i] = max(widths[i], len(c))
                else:
                    widths.append(len(c))
        fmt = "  ".join("%%-%ds" % w for w in widths)
        self._emit("info", fmt % tuple(header + [""] * (len(widths) - len(header))))
        for r in rows:
            self._emit("info", fmt % tuple(r + [""] * (len(widths) - len(r))))


class StdoutLogger(Logger):
    def __init__(self, level: str = "info", stream: Optional[IO[str]] = None):
        super().__init__(level)
        self.stream = stream or sys.stdout

    def _write(self, tag: str, msg: str) -> None:
        if self.stream.isatty() if hasattr(self.stream, "isatty") else False:
            style = _STYLES.get(tag, "")
            prefix = f"{style}[{tag}]{_RESET} " if tag != "info" else ""
        else:
            prefix = f"[{tag}] " if tag != "info" else ""
        self.stream.write(prefix + msg + "\n")
        self.stream.flush()


class DiscardLogger(Logger):
    def _write(self, tag: str, msg: str) -> None:
        pass


class FileLogger(Logger):
    """JSON-lines file logger (reference: logrus JSON to
    .devspace/logs/<name>.log, pkg/util/log/file_logger.go). Oversized
    logs are rotated to ``<path>.old`` on open (reference: sync.log
    rotation, pkg/devspace/sync/util.go:305-340).

    Built on the structured-event pipeline: every line is an
    :class:`devspace_tpu_torch.obs.events.Event` serialized by the shared
    ``JsonlSink`` — same ``{"time", "level", "msg"}`` keys as before
    (scrapers like ``status sync`` keep working) plus ``subsystem``/
    ``event``/``trace_id`` so a CLI log line written inside a traced
    operation cross-references the span that produced it. Each line is
    also published on the process event bus, so an attached
    FlightRecorder sees CLI logs interleaved with engine events."""

    MAX_BYTES = 10 * 1024 * 1024

    def __init__(self, path: str, level: str = "debug"):
        super().__init__(level)
        from ..obs import events as _events  # lazy: log is imported early

        self._events = _events
        self.path = path
        stem = os.path.splitext(os.path.basename(path))[0]
        self._logger_name = stem or "default"
        self._sink = _events.JsonlSink(path, max_bytes=self.MAX_BYTES)

    def _write(self, tag: str, msg: str) -> None:
        ev = self._events.make_event(
            "cli", "log", level=tag,
            attrs={"msg": msg, "logger": self._logger_name},
        )
        self._sink.record(ev)
        self._events.get_bus().publish(ev)

    @property
    def closed(self) -> bool:
        return self._sink.closed

    def close(self) -> None:
        self._sink.close()


class DiscardLogger(Logger):
    def _write(self, tag: str, msg: str) -> None:
        pass


_file_loggers: dict[str, FileLogger] = {}
_default = StdoutLogger()
_file_loggers: dict[str, FileLogger] = {}


def get_logger() -> Logger:
    return _default


def set_logger(logger: Logger) -> None:
    global _default
    _default = logger


def get_file_logger(name: str, root: str = ".devspace") -> FileLogger:
    """Per-subsystem file logger under ``<root>/logs/<name>.log`` —
    reference: pkg/util/log/file_logger.go GetFileLogger."""
    path = os.path.join(root, "logs", name + ".log")
    fl = _file_loggers.get(path)
    if fl is None or fl.closed:
        fl = FileLogger(path)
        _file_loggers[path] = fl
    return fl


def start_file_logging(root: str = ".devspace") -> None:
    """Mirror the default logger into ``<root>/logs/default.log``
    (reference: log.StartFileLogging, pkg/util/log/log.go)."""
    _default.add_mirror(get_file_logger("default", root))
