"""Deep merge / split of config trees.

The port's copy of ``devspace_tpu/config/merge.py`` (reference:
pkg/devspace/config/configutil/merge.go — maps merged recursively,
slices replaced — and split.go, its inverse), over plain YAML trees.
"""

from __future__ import annotations

import copy
from typing import Any


def merge(base: Any, override: Any) -> Any:
    """Merge ``override`` onto ``base``: dicts recurse, lists and scalars
    replace. Returns a new tree; inputs are not mutated."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = {k: copy.deepcopy(v) for k, v in base.items()}
        for k, v in override.items():
            out[k] = merge(out[k], v) if k in out else copy.deepcopy(v)
        return out
    return copy.deepcopy(override)


def split(merged: Any, override: Any) -> Any:
    """Inverse of :func:`merge`: given the merged tree and the override tree,
    return the base tree — merged minus values contributed by the override.
    Keys whose value equals the override's contribution are dropped from the
    base unless the override recursion retains siblings."""
    if isinstance(merged, dict) and isinstance(override, dict):
        out = {}
        for k, v in merged.items():
            if k in override:
                if isinstance(v, dict) and isinstance(override[k], dict):
                    sub = split(v, override[k])
                    if sub:
                        out[k] = sub
                elif v == override[k]:
                    continue  # fully contributed by override
                else:
                    out[k] = copy.deepcopy(v)
            else:
                out[k] = copy.deepcopy(v)
        return out
    return copy.deepcopy(merged)
