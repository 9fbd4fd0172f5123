"""Shared machinery for the Python-source (AST) rule packs.

The port's copy of ``devspace_tpu/lint/pysource.py``.

The hot-path (``rules_hotpath``) and concurrency (``rules_concurrency``)
packs both walk the same parsed modules, so parsing is done once per
:class:`~devspace_tpu_torch.lint.engine.LintContext` and cached on it. A module
that does not parse is itself a finding (PY500) — a syntax error in a
shipped file is the most static of all static-analysis results.

Inline suppressions: a finding whose source line (the flagged statement's
first line) carries ``lint: allow(RULEID)`` is dropped — RULEID may be a
full id (``JIT502``) or a family prefix (``JIT``). This is the designed
escape hatch for *intentional* sync points (a readback that IS the
product) so the self-lint gate can stay at zero without baselining whole
files.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional

from .engine import ERROR, Finding, LintContext, rule

_ALLOW_RE = re.compile(r"lint:\s*allow\(\s*([A-Za-z0-9_,\s]+?)\s*\)")


class ParsedModule:
    """One Python source file, parsed: AST + source lines + per-line
    suppression sets."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.error = e
        # line number -> frozenset of allowed rule ids/prefixes
        self.allows: dict[int, tuple] = {}
        for i, line in enumerate(self.lines, start=1):
            if "lint:" not in line:
                continue
            m = _ALLOW_RE.search(line)
            if m:
                self.allows[i] = tuple(
                    p.strip().upper() for p in m.group(1).split(",") if p.strip()
                )

    def allowed(self, rule_id: str, lineno: int) -> bool:
        rid = rule_id.upper()
        return any(
            rid.startswith(p) for p in self.allows.get(lineno, ())
        )

    def finding(
        self,
        rule_id: str,
        severity: str,
        category: str,
        message: str,
        node: ast.AST,
        location: str = "",
    ) -> Optional[Finding]:
        """Build a Finding anchored at ``node`` unless an inline
        ``lint: allow(...)`` suppresses it."""
        lineno = getattr(node, "lineno", 0) or 0
        if lineno and self.allowed(rule_id, lineno):
            return None
        return Finding(
            rule_id=rule_id,
            severity=severity,
            category=category,
            message=message,
            location=location,
            artifact=self.path,
            line=lineno,
        )


def parsed_sources(ctx: LintContext) -> list[ParsedModule]:
    """Parse ``ctx.python_sources`` once; cached on the context object so
    every AST rule shares one parse per file."""
    cache = getattr(ctx, "_parsed_python", None)
    if cache is None:
        cache = [ParsedModule(p, t) for p, t in (ctx.python_sources or ())]
        ctx._parsed_python = cache
    return cache


def each_module(ctx: LintContext) -> Iterator[ParsedModule]:
    for mod in parsed_sources(ctx):
        if mod.tree is not None:
            yield mod


def collect_python_sources(
    root: str, subdirs: tuple = ("devspace_tpu_torch",)
) -> list[tuple[str, str]]:
    """``[(relpath, text)]`` for every ``.py`` under ``root/<subdir>``,
    sorted for deterministic rule output."""
    out: list[tuple[str, str]] = []
    skip = {"__pycache__", "venv", "node_modules"}
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(
                d for d in dirnames if d not in skip and not d.startswith(".")
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    with open(path, encoding="utf-8", errors="replace") as fh:
                        out.append((os.path.relpath(path, root), fh.read()))
                except OSError:
                    continue
    return out


def lint_python_sources(
    sources: list, categories: Optional[set] = None
) -> list[Finding]:
    """Run the AST rule packs over ``[(relpath, text)]``. Default
    categories: both source packs."""
    from .engine import run_rules

    ctx = LintContext(python_sources=list(sources))
    return run_rules(
        ctx, categories=categories or {"hotpath", "concurrency"}
    )


# -- helpers shared by the packs ------------------------------------------

def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``torch.compile`` for
    ``Call(func=Attribute(Name torch, compile))``, ``f`` for ``Call(Name f)``,
    ``self._programs.run`` for attribute chains on self. Empty string when the
    target is dynamic (subscripts yield their value's name)."""
    if isinstance(node, ast.Call):
        node = node.func
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Subscript):
        # e.g. self._decode_chunk[(k, f)](...) — name the mapping
        return call_name(node.value)
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("")  # dynamic base, keep the attribute tail
    return ".".join(reversed(parts)).strip(".")


def const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
        and isinstance(node.operand.value, int)
    ):
        return -node.operand.value
    return None


def walk_functions(
    tree: ast.Module,
) -> Iterator[tuple[str, ast.AST]]:
    """Yield ``(qualname, funcdef)`` for every function/method, with
    ``Class.method`` qualnames one level deep."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
            yield from _nested(node.name, node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub
                    yield from _nested(f"{node.name}.{sub.name}", sub)


def _nested(prefix: str, fn: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    for node in ast.iter_child_nodes(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield f"{prefix}.{node.name}", node
            yield from _nested(f"{prefix}.{node.name}", node)


@rule(
    "PY500",
    severity=ERROR,
    category="hotpath",
    description="Python source must parse (syntax errors block all AST "
    "analysis)",
)
def check_parses(ctx: LintContext):
    for mod in parsed_sources(ctx):
        if mod.error is not None:
            yield Finding(
                rule_id="PY500",
                severity=ERROR,
                category="hotpath",
                message=f"syntax error: {mod.error.msg}",
                artifact=mod.path,
                line=mod.error.lineno or 0,
            )
