"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (``sm_90a``) into
its own shared library with a plain C interface. Libraries are built at
first use, keyed by a hash of the source and the flags, into ``_build/``
inside the package (git-ignored), so a fresh checkout builds everything
it runs and a changed source is never served from a stale library.
Nothing is built on import, and nothing is built for CPU tensors: only a
kernel launch on a CUDA tensor reaches :func:`library`. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills, kept in BUILD_LOG
    "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output of each source built by this process (ptxas -v report)
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, else ``PATH``, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(source: Path, output: Path) -> list[str]:
    """The nvcc command line that builds ``source`` into ``output``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(source: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for dep in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Optional[float]]:
    """Build ``csrc/<name>.cu`` for each name whose library for the
    current hash is missing, one nvcc process per source, all started
    together. Returns, per name, the seconds from the start of the builds
    until its nvcc had finished, or None when nothing was built. Raises RuntimeError with the compiler output when
    a build fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict[str, Optional[float]]:
    jobs = {}
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no CUDA source {src}")
        out = library_path(src)
        if not out.exists():
            jobs[name] = (src, out, out.with_name(f"{out.name}.{os.getpid()}.tmp"))
    if jobs:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {
        name: subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        for name, (src, _, tmp) in jobs.items()
    }
    seconds: dict[str, Optional[float]] = dict.fromkeys(names)
    failed = []
    for name, proc in procs.items():
        BUILD_LOG[name] = proc.communicate()[0]
        seconds[name] = time.monotonic() - t0
        src, out, tmp = jobs[name]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {src.name} (exit {proc.returncode}):\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first when
    missing)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(CSRC_DIR / f"{name}.cu")))
            _LIBS[name] = lib
        return lib
