"""Shared `NxMxK` topology parsing.

The port's copy of ``devspace_tpu/utils/topology.py``: the product of
the topology string is the device count, and a zero/negative part is a
config bug that must be reported, not silently multiplied through.
"""

from __future__ import annotations


def parse_topology(topology: str) -> int:
    """Device count of an ``NxMxK``-style topology string (e.g. ``2x4`` ->
    8, ``4x4x4`` -> 64). Case-insensitive separator. Raises ``ValueError``
    with a human-readable reason for anything that is not a product of
    positive integers."""
    parts = str(topology).lower().split("x")
    product = 1
    for part in parts:
        try:
            n = int(part)
        except ValueError:
            raise ValueError(
                f"part {part!r} is not an integer"
            ) from None
        if n < 1:
            raise ValueError(f"part {part!r} must be a positive integer")
        product *= n
    return product
