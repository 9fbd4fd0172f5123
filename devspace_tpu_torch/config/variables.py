"""``${var}`` substitution over the raw YAML tree.

The port's copy of ``devspace_tpu/config/variables.py`` (reference:
pkg/devspace/config/configutil/load.go — regex-driven replacement,
resolution order env ``DEVSPACE_VAR_<NAME>`` -> cached generated vars ->
interactive question).
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Optional

from ..utils import stdinutil

_VAR_RE = re.compile(r"\$\{([A-Za-z0-9_.-]+)\}")

ENV_PREFIX = "DEVSPACE_VAR_"


class VariableDefinition:
    """From configs.yaml: name + question/default/validation
    (reference: pkg/devspace/config/configs/schema.go Variable)."""

    def __init__(
        self,
        name: str,
        question: Optional[str] = None,
        default: Optional[str] = None,
        regex_pattern: Optional[str] = None,
    ):
        self.name = name
        self.question = question
        self.default = default
        self.regex_pattern = regex_pattern


def resolve_vars(
    tree: Any,
    cache: dict[str, str],
    definitions: Optional[dict[str, VariableDefinition]] = None,
    interactive: Optional[bool] = None,
    asker: Optional[Callable[[stdinutil.Question], str]] = None,
) -> Any:
    """Walk the YAML tree replacing ``${name}``. New answers are written into
    ``cache`` (persisted to generated.yaml by the caller)."""
    definitions = definitions or {}

    def lookup(name: str) -> str:
        env_val = os.environ.get(ENV_PREFIX + name.upper().replace("-", "_").replace(".", "_"))
        if env_val is not None:
            return env_val
        if name in cache:
            return cache[name]
        d = definitions.get(name)
        q = stdinutil.Question(
            question=(d.question if d and d.question else f"Please enter a value for '{name}'"),
            default=(d.default if d and d.default else ""),
            validation_pattern=(d.regex_pattern if d else None),
        )
        value = asker(q) if asker else stdinutil.ask(q, interactive=interactive)
        cache[name] = value
        return value

    def replace(value: Any) -> Any:
        if isinstance(value, str):
            full = _VAR_RE.fullmatch(value)
            if full:
                return lookup(full.group(1))
            return _VAR_RE.sub(lambda m: str(lookup(m.group(1))), value)
        if isinstance(value, dict):
            return {replace(k): replace(v) for k, v in value.items()}
        if isinstance(value, list):
            return [replace(v) for v in value]
        return value

    return replace(tree)


def substitute_known(value: str, cache: dict[str, str]) -> Optional[str]:
    """Resolve ``${var}`` in a string using only env + already-cached answers;
    returns None if any referenced var is unknown (never asks)."""
    missing = False

    def repl(m: re.Match) -> str:
        nonlocal missing
        name = m.group(1)
        env_val = os.environ.get(
            ENV_PREFIX + name.upper().replace("-", "_").replace(".", "_")
        )
        if env_val is not None:
            return env_val
        if name in cache:
            return cache[name]
        missing = True
        return m.group(0)

    out = _VAR_RE.sub(repl, value)
    return None if missing else out


def find_vars(tree: Any) -> list[str]:
    """List variable names referenced anywhere in the tree."""
    found: list[str] = []

    def walk(value: Any) -> None:
        if isinstance(value, str):
            for m in _VAR_RE.finditer(value):
                if m.group(1) not in found:
                    found.append(m.group(1))
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(k)
                walk(v)
        elif isinstance(value, list):
            for v in value:
                walk(v)

    walk(tree)
    return found
