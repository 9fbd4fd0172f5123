"""Chart package management — dependencies from chart repositories.

Reference: ``devspace add package`` (cmd/add/package.go ->
pkg/devspace/configure/package.go:25-253: merges a helm chart into
chart/requirements.yaml and appends its values) and chart-repo search
(pkg/devspace/helm/search.go). Redesigned for our chart format:

- A **repo** is a directory / ``file://`` / ``http(s)://`` URL containing
  ``index.yaml``::

      entries:
        redis:
          - version: "1.0.0"
            description: in-memory store
            path: charts/redis        # chart dir, local/file repos
            archive: redis-1.0.0.tgz  # OR a tarball, http repos

- ``add_package`` vendors the chart into ``<chart>/packages/<name>/`` and
  records it in ``<chart>/requirements.yaml``; the renderer picks every
  vendored package up automatically, scoping its values under
  ``values.packages.<name>``.

Vendoring (not helm's install-time fetch) keeps deploys hermetic — the
right call for a cluster with no egress.

The port's copy of ``devspace_tpu/deploy/packages.py``, with the same
behaviour: the vendored tree and ``requirements.yaml`` are the reference's
byte for byte, and the port's renderer (``deploy/chart.py``) picks the
vendored packages up as the reference's does.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import tempfile
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Optional

import yaml

from ..utils import log as logutil

REQUIREMENTS_FILE = "requirements.yaml"
PACKAGES_DIR = "packages"


class PackageError(Exception):
    pass


@dataclass
class ChartEntry:
    name: str
    version: str
    description: str = ""
    path: Optional[str] = None
    archive: Optional[str] = None


def _is_url(repo: str) -> bool:
    return repo.startswith(("http://", "https://", "file://"))


def _read_repo_file(repo: str, relpath: str) -> bytes:
    """Read a file from a repo (dir, file:// or http(s)://)."""
    if _is_url(repo):
        url = repo.rstrip("/") + "/" + urllib.parse.quote(relpath)
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                return resp.read()
        except OSError as e:
            raise PackageError(f"cannot read {url}: {e}") from e
    path = os.path.join(repo, relpath)
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError as e:
        raise PackageError(f"cannot read {path}: {e}") from e


def load_index(repo: str) -> dict[str, list[ChartEntry]]:
    """Parse the repo's index.yaml into {name: [entries newest-first]}."""
    try:
        raw = yaml.safe_load(_read_repo_file(repo, "index.yaml")) or {}
    except yaml.YAMLError as e:
        raise PackageError(f"invalid index.yaml in {repo}: {e}") from e
    out: dict[str, list[ChartEntry]] = {}
    for name, versions in (raw.get("entries") or {}).items():
        entries = []
        for v in versions or []:
            # upstream helm index.yaml carries a `urls:` list per version
            # (helm/search.go searches the same structure); ours uses
            # `archive:`/`path:` — accept both.
            archive = v.get("archive")
            if archive is None and v.get("urls"):
                archive = v["urls"][0]
            entries.append(
                ChartEntry(
                    name=name,
                    version=str(v.get("version", "0")),
                    description=v.get("description", ""),
                    path=v.get("path"),
                    archive=archive,
                )
            )
        entries.sort(key=lambda e: _version_key(e.version), reverse=True)
        out[name] = entries
    return out


def _version_key(version: str) -> tuple:
    """Semver-style ordering key: numeric dotted core, with a
    pre-release suffix ranking BELOW its release (1.2.3-rc1 < 1.2.3 —
    `update packages` must never call a pre-release an upgrade over the
    vendored stable)."""
    core, _, pre = version.lstrip("v").partition("-")
    parts = []
    for p in core.split("."):
        try:
            parts.append((0, int(p), ""))
        except ValueError:
            parts.append((1, 0, p))
    return (tuple(parts), 1 if not pre else 0, pre)


def search_charts(repo: str, query: str = "") -> list[ChartEntry]:
    """Newest version of every chart matching ``query`` (substring over
    name+description; reference: helm/search.go)."""
    query = query.lower()
    hits = []
    for name, entries in sorted(load_index(repo).items()):
        if not entries:
            continue
        newest = entries[0]
        if query in name.lower() or query in newest.description.lower():
            hits.append(newest)
    return hits


def resolve(
    repo: str,
    name: str,
    version: Optional[str] = None,
    index: Optional[dict[str, list[ChartEntry]]] = None,
) -> ChartEntry:
    """Pick a chart entry. ``index`` lets callers reuse an already-loaded
    index (check_updates/--apply hit the same repo once, not per-dep)."""
    if index is None:
        index = load_index(repo)
    entries = index.get(name)
    if not entries:
        available = ", ".join(sorted(index)) or "none"
        raise PackageError(f"chart '{name}' not found in {repo} (available: {available})")
    if version is None:
        return entries[0]
    for e in entries:
        if e.version == version:
            return e
    raise PackageError(
        f"chart '{name}' has no version {version} "
        f"(available: {', '.join(e.version for e in entries)})"
    )


def _fetch_chart(repo: str, entry: ChartEntry, dest: str) -> None:
    """Materialize the chart directory at ``dest``."""
    if entry.path and not _is_url(repo):
        src = os.path.join(repo, entry.path)
        if not os.path.isdir(src):
            raise PackageError(f"repo entry path missing: {src}")
        shutil.copytree(src, dest)
        return
    if entry.path and repo.startswith("file://"):
        src = os.path.join(urllib.parse.urlparse(repo).path, entry.path)
        if not os.path.isdir(src):
            raise PackageError(f"repo entry path missing: {src}")
        shutil.copytree(src, dest)
        return
    if not entry.archive:
        raise PackageError(
            f"chart '{entry.name}' {entry.version}: http repos need an 'archive' entry"
        )
    # `urls:` entries in upstream helm indexes may be absolute — fetch
    # those verbatim (no re-quoting: signed/encoded URLs must not change).
    # Scheme-restricted: an index is untrusted input, and a file:// (or
    # other-scheme) absolute URL would read local files into the vendored
    # chart dir.
    if _is_url(entry.archive):
        scheme = urllib.parse.urlparse(entry.archive).scheme
        if scheme not in ("http", "https"):
            raise PackageError(
                f"chart archive URL scheme '{scheme}' not allowed "
                f"(http/https only): {entry.archive}"
            )
        try:
            with urllib.request.urlopen(entry.archive, timeout=30) as resp:
                blob = resp.read()
        except OSError as e:
            raise PackageError(f"cannot read {entry.archive}: {e}") from e
    else:
        blob = _read_repo_file(repo, entry.archive)
    with tempfile.TemporaryDirectory() as tmp:
        tarball = os.path.join(tmp, "chart.tgz")
        with open(tarball, "wb") as fh:
            fh.write(blob)
        with tarfile.open(tarball, "r:gz") as tf:
            # refuse path escapes before extracting anything
            for m in tf.getmembers():
                target = os.path.normpath(os.path.join(tmp, "x", m.name))
                if not target.startswith(os.path.join(tmp, "x")):
                    raise PackageError(f"archive member escapes: {m.name}")
            tf.extractall(os.path.join(tmp, "x"), filter="data")
        extracted = os.path.join(tmp, "x")
        # archives may wrap the chart in a single top-level dir
        entries = os.listdir(extracted)
        root = (
            os.path.join(extracted, entries[0])
            if len(entries) == 1 and os.path.isdir(os.path.join(extracted, entries[0]))
            else extracted
        )
        # accept our chart.yaml or upstream helm Chart.yaml naming
        if not any(
            os.path.isfile(os.path.join(root, n)) for n in ("chart.yaml", "Chart.yaml")
        ):
            raise PackageError(
                f"archive for '{entry.name}' contains no chart.yaml/Chart.yaml"
            )
        shutil.copytree(root, dest)


# -- requirements bookkeeping -------------------------------------------------
def load_requirements(chart_dir: str) -> list[dict]:
    path = os.path.join(chart_dir, REQUIREMENTS_FILE)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return (yaml.safe_load(fh) or {}).get("dependencies") or []
    except OSError:
        return []


def _save_requirements(chart_dir: str, deps: list[dict]) -> None:
    path = os.path.join(chart_dir, REQUIREMENTS_FILE)
    if not deps:
        if os.path.isfile(path):
            os.unlink(path)
        return
    with open(path, "w", encoding="utf-8") as fh:
        yaml.safe_dump({"dependencies": deps}, fh, sort_keys=False)


def add_package(
    chart_dir: str,
    repo: str,
    name: str,
    version: Optional[str] = None,
    logger: Optional[logutil.Logger] = None,
) -> ChartEntry:
    """Vendor a chart from ``repo`` under ``<chart_dir>/packages/<name>``
    and record it in requirements.yaml. Package default values are merged
    into the parent values.yaml under ``packages.<name>`` so users can see
    and edit the knobs (reference appends README'd values the same way)."""
    log = logger or logutil.get_logger()
    from .chart import chart_meta_path

    if chart_meta_path(chart_dir) is None:
        raise PackageError(f"not a chart dir: {chart_dir}")
    entry = resolve(repo, name, version)
    dest = os.path.join(chart_dir, PACKAGES_DIR, name)
    if os.path.isdir(dest):
        raise PackageError(f"package '{name}' already added — remove it first")
    _fetch_chart(repo, entry, dest)

    deps = [d for d in load_requirements(chart_dir) if d.get("name") != name]
    deps.append({"name": name, "version": entry.version, "repository": repo})
    _save_requirements(chart_dir, deps)

    # surface package defaults in the parent values.yaml
    pkg_values_path = os.path.join(dest, "values.yaml")
    parent_values_path = os.path.join(chart_dir, "values.yaml")
    pkg_values = {}
    if os.path.isfile(pkg_values_path):
        with open(pkg_values_path, "r", encoding="utf-8") as fh:
            pkg_values = yaml.safe_load(fh) or {}
    parent_values = {}
    if os.path.isfile(parent_values_path):
        with open(parent_values_path, "r", encoding="utf-8") as fh:
            parent_values = yaml.safe_load(fh) or {}
    parent_values.setdefault("packages", {})[name] = pkg_values
    with open(parent_values_path, "w", encoding="utf-8") as fh:
        yaml.safe_dump(parent_values, fh, sort_keys=False)

    log.done("[package] added %s %s from %s", name, entry.version, repo)
    return entry


def remove_package(
    chart_dir: str, name: str, logger: Optional[logutil.Logger] = None
) -> bool:
    log = logger or logutil.get_logger()
    dest = os.path.join(chart_dir, PACKAGES_DIR, name)
    removed = False
    if os.path.isdir(dest):
        shutil.rmtree(dest)
        removed = True
    deps = load_requirements(chart_dir)
    kept = [d for d in deps if d.get("name") != name]
    if len(kept) != len(deps):
        removed = True
    _save_requirements(chart_dir, kept)
    parent_values_path = os.path.join(chart_dir, "values.yaml")
    if os.path.isfile(parent_values_path):
        with open(parent_values_path, "r", encoding="utf-8") as fh:
            parent_values = yaml.safe_load(fh) or {}
        if name in (parent_values.get("packages") or {}):
            del parent_values["packages"][name]
            if not parent_values["packages"]:
                del parent_values["packages"]
            with open(parent_values_path, "w", encoding="utf-8") as fh:
                yaml.safe_dump(parent_values, fh, sort_keys=False)
    if removed:
        log.done("[package] removed %s", name)
    else:
        log.warn("[package] %s not found", name)
    return removed


def check_updates(
    chart_dir: str, index_cache: Optional[dict] = None
) -> list[dict]:
    """Refresh every requirement's repo index and report newer versions
    (reference: helm/client.go:169 UpdateRepos refreshes repo indexes
    before installs; vendoring makes this an explicit command here).
    ``index_cache`` ({repo: index}) dedupes fetches when several deps
    share a repo and lets --apply reuse the same indexes. Returns
    [{name, current, latest, repository, update, error}]."""
    cache = index_cache if index_cache is not None else {}
    out = []
    for dep in load_requirements(chart_dir):
        name = dep.get("name", "?")
        repo = dep.get("repository", "")
        current = str(dep.get("version", "?"))
        row = {
            "name": name,
            "current": current,
            "latest": current,
            "repository": repo,
            "update": False,
            "error": "",
        }
        try:
            if repo not in cache:
                cache[repo] = load_index(repo)
            newest = resolve(repo, name, index=cache[repo])
            row["latest"] = newest.version
            row["update"] = _version_key(newest.version) > _version_key(current)
        except PackageError as e:
            row["error"] = str(e)
        out.append(row)
    return out


def upgrade_package(
    chart_dir: str,
    name: str,
    version: Optional[str] = None,
    logger: Optional[logutil.Logger] = None,
    index_cache: Optional[dict] = None,
) -> ChartEntry:
    """Re-vendor a package at ``version`` (default: newest in its repo).
    The user's ``packages.<name>`` overrides in the parent values.yaml are
    preserved; NEW default keys from the upgraded chart are added without
    clobbering existing ones."""
    log = logger or logutil.get_logger()
    deps = load_requirements(chart_dir)
    dep = next((d for d in deps if d.get("name") == name), None)
    if dep is None:
        raise PackageError(f"package '{name}' is not in {REQUIREMENTS_FILE}")
    repo = dep.get("repository", "")
    old_version = str(dep.get("version", "?"))
    index = (index_cache or {}).get(repo)
    entry = resolve(repo, name, version, index=index)
    if entry.version == old_version:
        log.info("[package] %s already at %s", name, entry.version)
        return entry
    dest = os.path.join(chart_dir, PACKAGES_DIR, name)
    backup = None
    if os.path.isdir(dest):
        backup = dest + ".upgrading"
        if os.path.isdir(backup):
            shutil.rmtree(backup)
        os.rename(dest, backup)
    try:
        _fetch_chart(repo, entry, dest)
    except BaseException:
        if backup:  # restore the old vendored chart on any failure
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            os.rename(backup, dest)
        raise
    if backup:
        shutil.rmtree(backup)
    dep["version"] = entry.version
    _save_requirements(chart_dir, deps)

    # merge NEW defaults under packages.<name> without overwriting the
    # user's existing values; only rewrite values.yaml when the merge
    # actually added something (safe_dump strips the user's comments and
    # formatting — don't pay that for a no-op)
    pkg_values_path = os.path.join(dest, "values.yaml")
    parent_values_path = os.path.join(chart_dir, "values.yaml")
    new_defaults = {}
    if os.path.isfile(pkg_values_path):
        with open(pkg_values_path, "r", encoding="utf-8") as fh:
            new_defaults = yaml.safe_load(fh) or {}
    parent_values = {}
    if os.path.isfile(parent_values_path):
        with open(parent_values_path, "r", encoding="utf-8") as fh:
            parent_values = yaml.safe_load(fh) or {}
    # tolerate null `packages:` / `packages.<name>:` keys
    packages = parent_values.get("packages") or {}
    parent_values["packages"] = packages
    current = packages.get(name) or {}
    packages[name] = current
    if _merge_missing(current, new_defaults):
        log.warn(
            "[package] values.yaml rewritten with %s's new default keys "
            "(comments/formatting are not preserved)", name
        )
        with open(parent_values_path, "w", encoding="utf-8") as fh:
            yaml.safe_dump(parent_values, fh, sort_keys=False)
    log.done("[package] upgraded %s %s -> %s", name, old_version, entry.version)
    return entry


def _merge_missing(dst: dict, src: dict) -> bool:
    """Recursively add keys from src absent in dst (never overwrite).
    Returns True if anything was added."""
    changed = False
    for k, v in (src or {}).items():
        if k not in dst:
            dst[k] = v
            changed = True
        elif isinstance(dst[k], dict) and isinstance(v, dict):
            changed |= _merge_missing(dst[k], v)
    return changed


def list_packages(chart_dir: str) -> list[dict]:
    """Requirements + whether the vendored dir actually exists."""
    out = []
    for dep in load_requirements(chart_dir):
        name = dep.get("name", "?")
        out.append(
            {
                "name": name,
                "version": dep.get("version", "?"),
                "repository": dep.get("repository", "?"),
                "vendored": os.path.isdir(os.path.join(chart_dir, PACKAGES_DIR, name)),
            }
        )
    return out
