"""Config version registry and upgrade chain.

The port's copy of ``devspace_tpu/config/versions.py`` (reference:
pkg/devspace/config/versions/versions.go:19-63): look up the ``version:``
key, strictly unmarshal into that version's schema, then apply
``upgrade()`` until the latest schema is reached. A config with a
``tpu`` block is refused with a ``ConfigError`` that names the ``gpu``
block.
"""

from __future__ import annotations

from typing import Any, Callable

from . import latest, v1alpha1
from .structs import ConfigError, from_dict

# Ordered oldest -> newest. Each non-latest entry's parse returns an object
# with .upgrade() producing the next version's object.
_PARSERS: dict[str, Callable[[dict], Any]] = {
    v1alpha1.VERSION: v1alpha1.parse,
    latest.VERSION: lambda data: from_dict(latest.Config, data),
}


def parse(data: dict) -> latest.Config:
    if not isinstance(data, dict):
        raise ConfigError("config root must be a mapping")
    if "tpu" in data:
        raise ConfigError(
            "tpu: the port ships no TPU chart; describe the job's cards in a "
            "'gpu' block instead (gpu: {workers, perWorker, product})"
        )
    version = data.get("version")
    if version is None:
        raise ConfigError("config is missing the 'version' key")
    parser = _PARSERS.get(version)
    if parser is None:
        raise ConfigError(
            f"unknown config version '{version}' (known: {', '.join(_PARSERS)})"
        )
    cfg = parser(data)
    while not isinstance(cfg, latest.Config):
        cfg = cfg.upgrade()
    cfg.version = latest.VERSION
    return cfg
