"""Project config loading: root discovery, multi-config, overrides, vars.

The port's copy of ``devspace_tpu/config/loader.py`` (reference:
pkg/devspace/config/configutil/get.go — ``.devspace/`` root discovery up
the directory tree, configs.yaml multi-config vs a single config.yaml,
override merging, vars question-asking, validation; configs.yaml schema
at pkg/devspace/config/configs/schema.go). It validates the ``gpu`` block
where the reference validates its ``tpu`` block.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional

import yaml

from ..utils import log as logutil
from . import latest, versions
from .generated import DEVSPACE_DIR, GeneratedConfig
from .merge import merge, split
from .structs import ConfigError, from_dict, to_dict
from .variables import (
    _VAR_RE,
    VariableDefinition,
    find_vars,
    resolve_vars,
    substitute_known,
)

CONFIG_FILE = "config.yaml"
CONFIGS_FILE = "configs.yaml"
OVERRIDES_FILE = "overrides.yaml"


def find_root(start: str = ".") -> Optional[str]:
    """Walk up from ``start`` looking for a ``.devspace/`` project root
    (reference: SetDevSpaceRoot)."""
    d = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(d, DEVSPACE_DIR)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def config_exists(root: str) -> bool:
    return os.path.isfile(os.path.join(root, DEVSPACE_DIR, CONFIG_FILE)) or os.path.isfile(
        os.path.join(root, DEVSPACE_DIR, CONFIGS_FILE)
    )


class ConfigLoader:
    def __init__(self, root: str = ".", logger: Optional[logutil.Logger] = None):
        self.root = os.path.abspath(root)
        self.log = logger or logutil.get_logger()
        self.generated = GeneratedConfig.load(self.root)
        self._raw_tree: Optional[dict] = None  # post-merge, pre-var tree
        self._base_tree: Optional[dict] = None  # pre-merge, pre-var tree
        self._base_path: Optional[str] = None  # file the base tree came from
        self._override_tree: Optional[dict] = None

    # -- paths ------------------------------------------------------------
    def _p(self, name: str) -> str:
        return os.path.join(self.root, DEVSPACE_DIR, name)

    def _load_yaml(self, path: str) -> Any:
        with open(path, "r", encoding="utf-8") as fh:
            return yaml.safe_load(fh)

    # -- loading ----------------------------------------------------------
    def load(
        self, config_name: Optional[str] = None, interactive: Optional[bool] = None
    ) -> latest.Config:
        """Load, merge, var-substitute, parse+upgrade, default+validate."""
        tree, var_defs = self._load_raw(config_name)
        cache = self.generated.get_active()
        tree = resolve_vars(tree, cache.vars, var_defs, interactive=interactive)
        cfg = versions.parse(tree)
        self.validate(cfg)
        return cfg

    def _load_raw(
        self, config_name: Optional[str]
    ) -> tuple[dict, dict[str, VariableDefinition]]:
        configs_path = self._p(CONFIGS_FILE)
        var_defs: dict[str, VariableDefinition] = {}
        if os.path.isfile(configs_path):
            configs = self._load_yaml(configs_path) or {}
            if not isinstance(configs, dict) or not configs:
                raise ConfigError(f"{configs_path}: empty or invalid configs.yaml")
            name = config_name or self.generated.active_config
            if name not in configs:
                if config_name is None:
                    # Stale generated active config — fall back gracefully.
                    name = "default" if "default" in configs else next(iter(configs))
                else:
                    raise ConfigError(
                        f"config '{name}' not found in configs.yaml "
                        f"(available: {', '.join(configs)})"
                    )
            self.generated.active_config = name
            definition = configs[name] or {}
            entry = definition.get("config")
            tree = self._resolve_entry(entry)
            self._base_tree = copy.deepcopy(tree)
            if isinstance(entry, dict) and "path" in entry:
                self._base_path = os.path.join(self.root, entry["path"])
            else:
                self._base_path = None  # inline config — not saveable
            self._override_tree = {}
            for ov in definition.get("overrides") or []:
                ov_tree = self._resolve_entry(ov)
                self._override_tree = merge(self._override_tree, ov_tree)
                tree = merge(tree, ov_tree)
            for v in definition.get("vars") or []:
                if isinstance(v, dict) and v.get("name"):
                    var_defs[v["name"]] = VariableDefinition(
                        name=v["name"],
                        question=v.get("question"),
                        default=v.get("default"),
                        regex_pattern=v.get("regexPattern"),
                    )
        else:
            config_path = self._p(CONFIG_FILE)
            if not os.path.isfile(config_path):
                raise ConfigError(
                    f"no {CONFIG_FILE} or {CONFIGS_FILE} found under "
                    f"{os.path.join(self.root, DEVSPACE_DIR)} — run 'init' first"
                )
            tree = self._load_yaml(config_path) or {}
            self._base_tree = copy.deepcopy(tree)
            self._base_path = config_path
            self._override_tree = None
            overrides_path = self._p(OVERRIDES_FILE)
            if os.path.isfile(overrides_path):
                self._override_tree = self._load_yaml(overrides_path) or {}
                tree = merge(tree, self._override_tree)
        self._raw_tree = tree
        for name in find_vars(tree):
            var_defs.setdefault(name, VariableDefinition(name=name))
        return tree, var_defs

    def _resolve_entry(self, entry: Any) -> dict:
        """A configs.yaml entry is either inline (``config:``) or a file
        reference (``path:``)."""
        if entry is None:
            return {}
        if isinstance(entry, dict) and "path" in entry:
            return self._load_yaml(os.path.join(self.root, entry["path"])) or {}
        if isinstance(entry, dict) and "config" in entry:
            return entry["config"] or {}
        if isinstance(entry, dict):
            return entry
        raise ConfigError(f"invalid configs.yaml entry: {entry!r}")

    # -- validation -------------------------------------------------------
    # Note: no defaults are injected into the config object — "unset" stays
    # None (tri-state) so save() never bakes derived values into the user's
    # file; consumers use get_default_namespace() and friends.
    def validate(self, cfg: latest.Config) -> None:
        """Reference: ValidateOnce (configutil/get.go:234)."""
        for i, d in enumerate(cfg.deployments or []):
            if not d.name:
                raise ConfigError(f"deployments[{i}]: name is required")
            if d.chart is None and d.manifests is None:
                raise ConfigError(
                    f"deployments[{i}] ({d.name}): needs 'chart' or 'manifests'"
                )
        for name, img in (cfg.images or {}).items():
            if not img.image:
                raise ConfigError(f"images.{name}: image is required")
        selector_names = {s.name for s in (cfg.dev.selectors or [])} if cfg.dev else set()
        if cfg.dev:
            for i, s in enumerate(cfg.dev.sync or []):
                if s.selector and s.selector not in selector_names:
                    raise ConfigError(
                        f"dev.sync[{i}]: unknown selector '{s.selector}'"
                    )
                if not s.container_path:
                    raise ConfigError(f"dev.sync[{i}]: containerPath is required")
            for i, p in enumerate(cfg.dev.ports or []):
                if p.selector and p.selector not in selector_names:
                    raise ConfigError(
                        f"dev.ports[{i}]: unknown selector '{p.selector}'"
                    )
                if not p.port_mappings:
                    raise ConfigError(f"dev.ports[{i}]: portMappings is required")
            t = cfg.dev.terminal
            if t and t.selector and t.selector not in selector_names:
                raise ConfigError(f"dev.terminal: unknown selector '{t.selector}'")
        if cfg.gpu:
            for key, value in (("workers", cfg.gpu.workers),
                               ("perWorker", cfg.gpu.per_worker)):
                if value is not None and value < 1:
                    raise ConfigError(f"gpu.{key} must be >= 1")

    # -- saving -----------------------------------------------------------
    def save(self, cfg: latest.Config) -> None:
        """Write the base config file, keeping override-contributed values out
        (reference: SaveBaseConfig + configutil/split.go) and restoring
        ``${var}`` placeholders for values whose resolution is unchanged, so
        variables (and the secrets behind them) are never baked into the file.
        """
        if self._base_path is None and self._raw_tree is not None:
            raise ConfigError(
                "cannot save: active config is defined inline in configs.yaml — "
                "move it to a file (config: {path: ...}) to make it editable"
            )
        path = self._base_path or self._p(CONFIG_FILE)
        tree = to_dict(cfg)
        cache = self.generated.get_active().vars
        if self._override_tree:
            # Resolve override vars from env+cache only (never ask, never
            # cache '' for unknowns) purely for value comparison in split().
            resolved_override = _resolve_tree_known(self._override_tree, cache)
            tree = split(tree, resolved_override)
        if self._base_tree is not None:
            tree = _unresolve(tree, self._base_tree, cache)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            yaml.safe_dump(tree, fh, sort_keys=False)

    def save_generated(self) -> None:
        self.generated.save()


def _resolve_tree_known(tree: Any, cache: dict[str, str]) -> Any:
    """Substitute ${var} from env+cache only; unknown vars keep their
    placeholder (they then simply won't match during split comparison)."""
    if isinstance(tree, dict):
        return {k: _resolve_tree_known(v, cache) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_resolve_tree_known(v, cache) for v in tree]
    if isinstance(tree, str) and _VAR_RE.search(tree):
        resolved = substitute_known(tree, cache)
        return resolved if resolved is not None else tree
    return tree


def _unresolve(new: Any, base: Any, cache: dict[str, str]) -> Any:
    """Restore ``${var}`` placeholders: wherever the original base tree had a
    string containing variables and its (env+cache) resolution equals the new
    value, keep the placeholder string."""
    if isinstance(new, dict) and isinstance(base, dict):
        return {
            k: (_unresolve(v, base[k], cache) if k in base else v)
            for k, v in new.items()
        }
    if isinstance(new, list) and isinstance(base, list) and len(new) == len(base):
        return [_unresolve(n, b, cache) for n, b in zip(new, base)]
    if isinstance(base, str) and _VAR_RE.search(base):
        resolved = substitute_known(base, cache)
        if resolved is not None and (resolved == new or resolved == str(new)):
            return base
    return new


# -- selector helpers (reference: configutil.GetSelector / GetDefaultNamespace)
def get_selector(cfg: latest.Config, name: str) -> Optional[latest.SelectorConfig]:
    for s in (cfg.dev.selectors if cfg.dev else None) or []:
        if s.name == name:
            return s
    return None


def get_default_namespace(cfg: latest.Config) -> str:
    if cfg.cluster and cfg.cluster.namespace:
        return cfg.cluster.namespace
    return "default"
