"""Hot-path rules for the port (JIT5xx, category ``hotpath``).

Torch counterparts of ``devspace_tpu/lint/rules_hotpath.py`` under the
same ids. The port's counterpart of a recompile is a program built again:
a CUDA graph captured after ``prewarm``, a graph captured per iteration,
or a Python value that a captured graph bakes in (``inference/graphs.py``:
a graph holds every address and every host-side value it was captured
with). All of these are visible in the AST.

Two kinds of callee are "captured or compiled code" below:

- a call lexically inside the body of ``with torch.cuda.graph(...)``
  (``cuda.graph``): what it receives is baked into the graph;
- a compiled callable: a name bound from ``torch.compile(...)`` or
  ``torch.cuda.make_graphed_callables(...)`` (assignment targets register
  their terminal name, so ``self._step = torch.compile(f)`` registers
  ``_step``), or a function decorated ``@torch.compile`` /
  ``@torch.compile(...)``. The port itself never calls ``torch.compile``.

A *loop-varying int* is a name that varies with the iteration of an
enclosing loop: the target of a ``for`` over ``range(...)``, the index
of a ``for`` over ``enumerate(...)``, or a name rebound by an augmented
assignment (``offset += n``) in the loop's body; or arithmetic
(``+ - * // % <<``, unary minus) over one.

- **JIT500** (error) a ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
  ``torch.compile(...)``, ``torch.cuda.make_graphed_callables(...)`` or
  ``ProgramTable(...)`` created inside a loop: a program built per
  iteration (build the table once and ``prewarm`` it).
- **JIT501** (error) a loop-varying int passed, positionally or by
  keyword, to captured or compiled code inside a loop: the graph bakes
  the first value in (A3a's ``offset`` to ``prefill_chunk_paged``), and a
  compiled callable re-specialises per value. Keep it in a device buffer.
- **JIT502** (warning) a host sync inside a loop: ``.item()``,
  ``.tolist()`` and ``.cpu()`` with no arguments, ``.numpy(...)``, any
  ``....synchronize()`` (``torch.cuda.synchronize()``, an event's, a
  stream's), and ``float()``/``int()``/``bool()`` of a tensor expression.
  A tensor expression is a call into ``torch.`` (not ``torch.cuda.`` or
  ``torch.backends.``) or ``F.``, a name or attribute the function
  assigned from one, and a method call, subscript or arithmetic over one.
  One finding a line. Designed sync points (a readback that IS the
  product, a timing loop) carry ``lint: allow(JIT502)`` with the reason.
- **JIT503** (error) a captured graph's static output read after a later
  replay without a clone, the port's use-after-donate (the buffers a
  graph writes are rewritten by its next replay). A replay is
  ``<g>.replay()`` or ``<t>.run(...)`` on a name bound from
  ``ProgramTable(...)``. Flagged (a) inside a loop that replays: an
  ``.append(E)`` / ``.add(E)`` / ``X[k] = E`` of a bare name, attribute
  or subscript ``E`` whose root name the loop does not rebind (every
  iteration stores the same buffer); (b) in straight-line code: ``v = E``
  (no call in ``E``) after a replay of a receiver, then a later replay of
  the same receiver, then a read of ``v`` before it is rebound. The
  finding is anchored at the store.
- **JIT504** (warning) a slice with non-constant bounds passed to
  captured or compiled code inside a loop: the argument's shape varies
  per iteration (pad to a fixed bucket, as the engine's chunk sizes are).
"""

from __future__ import annotations

import ast
from typing import Optional

from .engine import ERROR, LintContext, WARNING, rule
from .pysource import (
    ParsedModule,
    call_name,
    const_int,
    each_module,
    walk_functions,
)

_GRAPH_CTORS = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph")
_CAPTURE_CTX = ("torch.cuda.graph", "cuda.graph")
_COMPILERS = ("torch.compile", "torch.cuda.make_graphed_callables",
              "cuda.make_graphed_callables")
_TENSOR_PREFIXES = ("torch.", "F.")
_NOT_TENSOR_PREFIXES = ("torch.cuda.", "torch.backends.")
_VARYING_OPS = (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod, ast.LShift)


def _registry(tree: ast.Module) -> tuple[set, set]:
    """``(compiled callables, program tables)`` the module binds, by
    terminal name."""
    compiled: set = set()
    tables: set = set()

    def terminal(t) -> Optional[str]:
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute):
            return t.attr
        return None

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if call_name(dec) in _COMPILERS:
                    compiled.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(node.value, ast.Call):
            name = call_name(node.value)
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if name in _COMPILERS:
                compiled.update(filter(None, map(terminal, targets)))
            elif name.rsplit(".", 1)[-1] == "ProgramTable":
                tables.update(filter(None, map(terminal, targets)))
    return compiled, tables


def _loop_varying(loop: ast.AST) -> set:
    """Names that vary with ``loop``'s iteration (module docstring)."""
    out: set = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)) and isinstance(loop.iter, ast.Call):
        it = call_name(loop.iter)
        if it == "range" and isinstance(loop.target, ast.Name):
            out.add(loop.target.id)
        elif (it == "enumerate" and isinstance(loop.target, ast.Tuple)
              and loop.target.elts and isinstance(loop.target.elts[0], ast.Name)):
            out.add(loop.target.elts[0].id)
    for stmt in loop.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                out.add(node.target.id)
    return out


def _bound_in(stmts: list) -> set:
    """Root names (re)bound anywhere in ``stmts``: assignment, loop and
    with targets."""
    out: set = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                out.add(node.id)
    return out


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _has_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) for n in ast.walk(node))


def _is_buffer_ref(node: ast.AST) -> bool:
    """A bare name, attribute or subscript: a reference, not a copy."""
    return isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)) and not _has_call(node)


def _replay_receiver(call: ast.Call, tables: set) -> Optional[str]:
    """The dotted receiver of a replay call (module docstring), else None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    recv = call_name(func.value)
    if func.attr == "replay" and not call.args and not call.keywords:
        return recv or None
    if func.attr == "run" and recv and recv.rsplit(".", 1)[-1] in tables:
        return recv
    return None


class _FnScan:
    """One pass over a function body tracking loops and capture regions,
    collecting JIT5xx findings."""

    def __init__(self, mod: ParsedModule, qualname: str, fn, compiled: set, tables: set,
                 findings: list):
        self.mod = mod
        self.qualname = qualname
        self.fn = fn
        self.compiled = compiled
        self.tables = tables
        self.findings = findings
        self.loops: list = []  # enclosing loop nodes
        self.varying: list = []  # loop-varying names per enclosing loop
        self.capture_depth = 0
        self.tensor_names: set = set()
        self._collect_tensor_names()

    def emit(self, rule_id, severity, message, node):
        f = self.mod.finding(rule_id, severity, "hotpath", message, node,
                             location=self.qualname)
        if f is not None:
            self.findings.append(f)

    # -- structure ---------------------------------------------------------
    def run(self):
        for stmt in self.fn.body:
            self._stmt(stmt)
        self._straight_line_aliases()

    def _stmt(self, stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs get their own scan via walk_functions
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            capture = any(call_name(item.context_expr) in _CAPTURE_CTX
                          for item in stmt.items if isinstance(item.context_expr, ast.Call))
            for item in stmt.items:
                self._node(item)
            self.capture_depth += capture
            for sub in stmt.body:
                self._stmt(sub)
            self.capture_depth -= capture
            return
        loop = isinstance(stmt, (ast.For, ast.AsyncFor, ast.While))
        if loop:
            # the iterable / condition is evaluated outside the body
            self._node(stmt.iter if not isinstance(stmt, ast.While) else stmt.test)
            self.loops.append(stmt)
            self.varying.append(_loop_varying(stmt))
            self._loop_stores(stmt)
            for sub in stmt.body + stmt.orelse:
                self._stmt(sub)
            self.varying.pop()
            self.loops.pop()
            return
        for sub in ast.iter_child_nodes(stmt):
            self._node(sub)

    def _node(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.stmt):
            self._stmt(node)
            return
        if isinstance(node, ast.Call):
            self._call(node)
        for sub in ast.iter_child_nodes(node):
            self._node(sub)

    # -- helpers -------------------------------------------------------------
    def _is_varying(self, node: ast.AST) -> bool:
        names = set().union(*self.varying) if self.varying else set()
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.BinOp) and isinstance(node.op, _VARYING_OPS):
            return self._is_varying(node.left) or self._is_varying(node.right)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return self._is_varying(node.operand)
        return False

    def _is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name.startswith(_TENSOR_PREFIXES) and not name.startswith(_NOT_TENSOR_PREFIXES):
                return True
            return isinstance(node.func, ast.Attribute) and self._is_tensor(node.func.value)
        if isinstance(node, ast.Subscript):
            return self._is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tensor(node.left) or self._is_tensor(node.right)
        if isinstance(node, (ast.Name, ast.Attribute)):
            return call_name(node) in self.tensor_names
        return False

    def _collect_tensor_names(self) -> None:
        """Dotted names this function binds from tensor expressions — one
        forward pass in line order, no flow sensitivity."""
        assigns = sorted((n for n in ast.walk(self.fn) if isinstance(n, ast.Assign)),
                         key=lambda n: n.lineno)
        for node in assigns:
            if not self._is_tensor(node.value):
                continue
            for t in node.targets:
                for elt in t.elts if isinstance(t, ast.Tuple) else [t]:
                    if isinstance(elt, (ast.Name, ast.Attribute)):
                        self.tensor_names.add(call_name(elt))

    # -- the checks ----------------------------------------------------------
    def _call(self, node: ast.Call):
        name = call_name(node)
        tail = name.rsplit(".", 1)[-1] if name else ""
        if self.loops and (name in _GRAPH_CTORS + _CAPTURE_CTX + _COMPILERS
                           or tail == "ProgramTable"):
            self.emit(
                "JIT500", ERROR,
                f"{name}() inside a loop — a program is built per iteration "
                "(build it once, before the loop, and prewarm it)",
                node,
            )
            return
        if self.loops and (self.capture_depth or tail in self.compiled):
            self._captured_call(node, name)
        self._host_sync(node, name, tail)

    def _captured_call(self, node: ast.Call, name: str):
        what = "compiled" if not self.capture_depth else "graph-captured"
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if self._is_varying(arg):
                self.emit(
                    "JIT501", ERROR,
                    f"loop-varying Python int passed to {what} {name}() — "
                    "the graph bakes in the value it was captured with (a "
                    "compiled callable re-specialises per value); pass it "
                    "in a device buffer",
                    arg,
                )
            if (isinstance(arg, ast.Subscript) and isinstance(arg.slice, ast.Slice)
                    and any(b is not None and const_int(b) is None
                            for b in (arg.slice.lower, arg.slice.upper))):
                self.emit(
                    "JIT504", WARNING,
                    f"slice with non-constant bounds passed to {what} "
                    f"{name}() inside a loop — the argument shape varies per "
                    "iteration (pad to a fixed bucket instead)",
                    arg,
                )

    def _host_sync(self, node: ast.Call, name: str, tail: str):
        if not self.loops:
            return
        noargs = not node.args and not node.keywords
        if tail in ("item", "tolist", "cpu") and noargs and isinstance(node.func, ast.Attribute):
            what = f".{tail}()"
        elif tail == "numpy" and isinstance(node.func, ast.Attribute):
            what = ".numpy()"
        elif tail == "synchronize":
            what = f"{name}()"
        elif name in ("float", "int", "bool") and len(node.args) == 1 and self._is_tensor(
                node.args[0]):
            what = f"{name}() of a tensor"
        else:
            return
        self.emit(
            "JIT502", WARNING,
            f"{what} inside a loop blocks the host on the card's stream "
            "every iteration (read back once, outside the loop)",
            node,
        )

    def _loop_stores(self, loop: ast.AST):
        """JIT503 (a): a loop that replays and stores the same buffer
        every iteration."""
        body = loop.body
        replays = any(isinstance(n, ast.Call) and _replay_receiver(n, self.tables)
                      for s in body for n in ast.walk(s))
        if not replays:
            return
        rebound = _bound_in(body) | (_bound_in([loop.target])
                                     if isinstance(loop, (ast.For, ast.AsyncFor)) else set())
        for s in body:
            for n in ast.walk(s):
                stored = None
                if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("append", "add") and len(n.args) == 1):
                    stored = n.args[0]
                elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                      and isinstance(n.targets[0], ast.Subscript)):
                    stored = n.value
                if stored is None or not _is_buffer_ref(stored):
                    continue
                root = _root_name(stored)
                if root is None or root in rebound:
                    continue
                self.emit(
                    "JIT503", ERROR,
                    f"{ast.unparse(stored)} is stored without a clone in a "
                    "loop that replays a graph — every iteration stores the "
                    "same static buffer, which the next replay rewrites "
                    "(store .clone() or read it back)",
                    n,
                )

    def _straight_line_aliases(self):
        """JIT503 (b): ``v = buf`` between two replays of one receiver,
        read after the second."""
        events = []  # (line, kind, payload, node)
        for n in ast.walk(self.fn):
            if isinstance(n, ast.Call):
                recv = _replay_receiver(n, self.tables)
                if recv:
                    events.append((n.lineno, "replay", recv, n))
            elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                  and isinstance(n.targets[0], ast.Name) and _is_buffer_ref(n.value)):
                events.append((n.lineno, "alias", n.targets[0].id, n))
            elif isinstance(n, ast.Name):
                kind = "store" if isinstance(n.ctx, ast.Store) else "load"
                events.append((n.lineno, kind, n.id, n))
        events.sort(key=lambda e: (e[0], e[1] != "alias"))
        replays = [(line, recv) for line, kind, recv, _ in events if kind == "replay"]
        for line, kind, var, node in events:
            if kind != "alias":
                continue
            before = {recv for rl, recv in replays if rl < line}
            later = [(rl, recv) for rl, recv in replays if rl > line and recv in before]
            if not later:
                continue
            stale_from, recv = min(later)
            for l2, k2, v2, _ in events:
                if v2 != var or l2 <= line or k2 not in ("store", "load"):
                    continue
                if k2 == "store":
                    break  # rebound before any stale read
                if l2 > stale_from:
                    self.emit(
                        "JIT503", ERROR,
                        f"{var} aliases a buffer after {recv}'s replay and is "
                        f"read after its next replay (line {stale_from}) — the "
                        "replay rewrote it (take .clone() or read it back first)",
                        node,
                    )
                    break


def _run_pack(ctx: LintContext) -> list:
    """All JIT5xx findings for the context, computed once and cached —
    the per-rule entries below filter by id so each keeps its own
    registry metadata without re-walking the ASTs."""
    cache = getattr(ctx, "_hotpath_findings", None)
    if cache is None:
        raw: list = []
        for mod in each_module(ctx):
            compiled, tables = _registry(mod.tree)
            for qualname, fn in walk_functions(mod.tree):
                _FnScan(mod, qualname, fn, compiled, tables, raw).run()
        # one finding per rule and line (``x.cpu().numpy()`` is one sync)
        seen: set = set()
        cache = []
        for f in raw:
            key = (f.artifact, f.line, f.rule_id)
            if key not in seen:
                seen.add(key)
                cache.append(f)
        ctx._hotpath_findings = cache
    return cache


def _only(ctx: LintContext, rule_id: str):
    return [f for f in _run_pack(ctx) if f.rule_id == rule_id]


@rule(
    "JIT500",
    severity=ERROR,
    category="hotpath",
    description="CUDA graphs, captures, compiled callables and program "
    "tables must not be built inside a loop",
)
def check_build_in_loop(ctx: LintContext):
    return _only(ctx, "JIT500")


@rule(
    "JIT501",
    severity=ERROR,
    category="hotpath",
    description="no loop-varying Python int passed to graph-captured or "
    "compiled code (baked in / re-specialised per value)",
)
def check_varying_int(ctx: LintContext):
    return _only(ctx, "JIT501")


@rule(
    "JIT502",
    severity=WARNING,
    category="hotpath",
    description="no host sync (.item()/.tolist()/.cpu()/.numpy()/"
    "synchronize()/float() of a tensor) inside hot loops",
)
def check_host_sync_in_loop(ctx: LintContext):
    return _only(ctx, "JIT502")


@rule(
    "JIT503",
    severity=ERROR,
    category="hotpath",
    description="a graph's static output must not be read after a later "
    "replay without a clone",
)
def check_use_after_replay(ctx: LintContext):
    return _only(ctx, "JIT503")


@rule(
    "JIT504",
    severity=WARNING,
    category="hotpath",
    description="arguments to graph-captured or compiled code in loops "
    "must not be non-constant slices (shape varies per iteration)",
)
def check_shape_varying_arg(ctx: LintContext):
    return _only(ctx, "JIT504")
