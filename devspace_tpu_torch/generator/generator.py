"""Project scaffolding for the port: language detection, Dockerfile and
chart generation.

Counterpart of ``devspace_tpu/generator/generator.py``, which gives a
project importing jax the TPU Dockerfile and the TPU slice chart. Here a
project importing torch or triton is ``"torch"``: it gets the CUDA
Dockerfile (``dockerfiles/torch``) and the GPU chart (``chart-gpu``: one
pod per GPU host, ``nvidia.com/gpu`` requests, torchrun wired from the
pod index). Every other language behaves as in the reference, from the
port's own copies of ``chart-cpu`` and the python/node/go Dockerfiles.
The port ships no TPU chart. Templates ship in the package: no clone,
no network.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from collections import Counter
from typing import Optional

TEMPLATES_DIR = os.path.join(os.path.dirname(__file__), "templates")

_EXT_LANG = {
    ".py": "python",
    ".js": "node",
    ".mjs": "node",
    ".ts": "node",
    ".go": "go",
}

_TORCH_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:torch|triton)\b", re.MULTILINE)

_log = logging.getLogger(__name__)


def detect_language(project_dir: str, max_files: int = 500) -> str:
    """Extension-count language detection with a torch sniff: any Python
    file importing torch or triton promotes the project to 'torch'."""
    counts: Counter[str] = Counter()
    torch_found = False
    scanned = 0
    for root, dirs, files in os.walk(project_dir):
        dirs[:] = [
            d
            for d in dirs
            if d not in (".git", "node_modules", "__pycache__", ".devspace", "venv")
        ]
        for name in files:
            lang = _EXT_LANG.get(os.path.splitext(name)[1].lower())
            if not lang:
                continue
            counts[lang] += 1
            scanned += 1
            if lang == "python" and not torch_found:
                try:
                    with open(
                        os.path.join(root, name), "r", encoding="utf-8", errors="ignore"
                    ) as fh:
                        if _TORCH_IMPORT.search(fh.read(65536)):
                            torch_found = True
                except OSError:
                    pass
            if scanned >= max_files:
                break
        if scanned >= max_files:
            break
    if torch_found:
        return "torch"
    if not counts:
        return "python"
    return counts.most_common(1)[0][0]


def create_dockerfile(
    project_dir: str, language: str, logger: Optional[logging.Logger] = None
) -> str:
    """Copy the language's Dockerfile template unless one exists."""
    log = logger or _log
    dest = os.path.join(project_dir, "Dockerfile")
    if os.path.exists(dest):
        log.info("[init] keeping existing Dockerfile")
        return dest
    src = os.path.join(TEMPLATES_DIR, "dockerfiles", language, "Dockerfile")
    if not os.path.isfile(src):
        src = os.path.join(TEMPLATES_DIR, "dockerfiles", "python", "Dockerfile")
    shutil.copyfile(src, dest)
    log.info("[init] created Dockerfile (%s)", language)
    return dest


def create_chart(
    project_dir: str, language: str, logger: Optional[logging.Logger] = None
) -> str:
    """Copy the chart template (the GPU chart for torch, the plain chart
    otherwise) into ``<project>/chart``."""
    log = logger or _log
    dest = os.path.join(project_dir, "chart")
    if os.path.isdir(dest):
        log.info("[init] keeping existing chart/")
        return dest
    flavor = "chart-gpu" if language == "torch" else "chart-cpu"
    shutil.copytree(os.path.join(TEMPLATES_DIR, flavor), dest)
    log.info("[init] created chart/ (%s)", flavor)
    return dest
