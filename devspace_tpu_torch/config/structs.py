"""Strict dict <-> dataclass conversion for versioned config schemas.

The port's copy of ``devspace_tpu/config/structs.py``. Reference
behaviour: the Go schemas use pointer fields so "unset" differs from zero
(pkg/devspace/config/versions/latest/schema.go) and parsing is strict —
unknown YAML keys are errors (versions/versions.go:19-63). Every schema
field defaults to None ("unset"), and :func:`from_dict` raises on unknown
keys.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


class ConfigError(Exception):
    pass


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _unwrap_optional(tp: Any) -> Any:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_dict(cls: Type[T], data: Any, path: str = "") -> T:
    """Build dataclass ``cls`` from a YAML-parsed tree, strictly."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"{path or cls.__name__}: expected mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    by_camel = {_camel(n): n for n in fields}
    hints = _type_hints(cls)
    kwargs: dict[str, Any] = {}
    for key, value in data.items():
        name = by_camel.get(key) or (key if key in fields else None)
        if name is None:
            raise ConfigError(f"{path or cls.__name__}: unknown key '{key}'")
        ftype = _unwrap_optional(hints[name])
        kwargs[name] = _convert(ftype, value, f"{path}.{key}" if path else key)
    return cls(**kwargs)


_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _type_hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


def _convert(ftype: Any, value: Any, path: str) -> Any:
    if value is None:
        return None
    origin = get_origin(ftype)
    if dataclasses.is_dataclass(ftype):
        return from_dict(ftype, value, path)
    if origin in (list, typing.List):
        (item_type,) = get_args(ftype) or (Any,)
        if not isinstance(value, list):
            raise ConfigError(f"{path}: expected list")
        return [_convert(_unwrap_optional(item_type), v, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (dict, typing.Dict):
        args = get_args(ftype)
        vt = _unwrap_optional(args[1]) if len(args) == 2 else Any
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping")
        return {k: _convert(vt, v, f"{path}.{k}") for k, v in value.items()}
    if ftype is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"{path}: expected bool, got {value!r}")
        return value
    if ftype is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected int, got {value!r}")
        return value
    if ftype is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected number, got {value!r}")
        return float(value)
    if ftype is str:
        if isinstance(value, (int, float, bool)):
            return str(value)
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected string, got {value!r}")
        return value
    return value


def to_dict(obj: Any) -> Any:
    """Dataclass -> plain tree with camelCase keys; None fields omitted."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_dict(getattr(obj, f.name))
            if v is not None:
                out[_camel(f.name)] = v
        return out
    if isinstance(obj, list):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj
