"""Dockerfile introspection (reference: pkg/util/dockerfile — EXPOSE port
extraction used by ``init`` to propose default forwarded ports).

The port's copy of ``devspace_tpu/utils/dockerfile.py``, with the same behaviour.
"""

from __future__ import annotations

import re

_EXPOSE = re.compile(r"^\s*EXPOSE\s+(.+)$", re.IGNORECASE)


def get_ports(dockerfile_path: str) -> list[int]:
    ports: list[int] = []
    try:
        with open(dockerfile_path, "r", encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return ports
    for line in lines:
        m = _EXPOSE.match(line)
        if not m:
            continue
        for token in m.group(1).split():
            port = token.split("/")[0]
            if port.isdigit():
                ports.append(int(port))
    return ports
