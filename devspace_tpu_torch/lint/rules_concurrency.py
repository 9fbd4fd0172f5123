"""Static concurrency rules (CON6xx, category ``concurrency``).

The port's copy of ``devspace_tpu/lint/rules_concurrency.py``: the pack
reads Python, not JAX, so on the same source it gives exactly the
reference pack's findings (``tests/test_torch_lint_concurrency.py``).

Every obs/serving subsystem since PR 5 added threads and locks with no
machine-checked discipline. This pack extracts a *static lock graph* per
module — which locks each function acquires (``with self._lock:``), in
what nesting order, and what it calls while holding them — and lints the
graph:

- **CON600** a cycle in the acquisition-order graph is a potential
  deadlock: two call paths that take the same locks in opposite orders
  only need two threads to wedge forever.
- **CON601** a blocking call (``.join()``, ``queue.get()``,
  ``time.sleep``, device readback, subprocess/socket I/O, ``.result()``)
  made while holding a lock stalls every other thread contending for it
  — the RateLimiter.throttle bug class PR 4 fixed by hand.
- **CON602** ``Condition.wait()`` outside a ``while`` predicate loop:
  condition waits wake spuriously and on every ``notify_all``; a bare
  ``if``/straight-line wait acts on stale state.
- **CON603** a non-daemon ``threading.Thread`` in a module with no
  ``.join()`` anywhere: the process cannot exit cleanly.
- **CON604** bare ``lock.acquire()`` whose ``release()`` is not in a
  ``finally:`` — an exception between them leaks the lock; use ``with``.

The extractor (:func:`extract_lock_graph`) is shared with the runtime
half: ``lint.runtime.LockOrderMonitor`` records real acquisition orders
and compares them against these static edges, so a schedule the tests
never produced still gets flagged when production wanders into it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from .engine import ERROR, LintContext, WARNING, rule
from .pysource import ParsedModule, call_name, each_module, walk_functions

_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "OrderedLock": "lock",
}

# Call patterns that block the calling thread. ``.join``/``.get``/
# ``.result``/``.wait`` are attribute tails matched only with zero
# positional args (str.join/dict.get always take one), so the common
# false positives disambiguate themselves.
_BLOCKING_NAMES = {
    "time.sleep",
    "jax.device_get",
    "device_get",
    "subprocess.run",
    "subprocess.check_output",
    "subprocess.check_call",
    "subprocess.call",
    "select.select",
    "urlopen",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
}
_BLOCKING_TAILS_NOARG = {"join", "get", "result", "acquire", "wait"}
_BLOCKING_TAILS_ALWAYS = {"block_until_ready", "recv", "accept", "connect"}


@dataclass
class LockGraph:
    """The static lock discipline of one module."""

    path: str
    # lock id ("Class._lock" / module-level "name") -> kind
    locks: dict = field(default_factory=dict)
    # (outer, inner) -> [(qualname, lineno), ...] acquisition-order edges
    edges: dict = field(default_factory=dict)
    # qualname -> set of lock ids the function acquires directly
    acquires: dict = field(default_factory=dict)
    # [(qualname, lock_id, callee_qualname, lineno)] calls made while held
    held_calls: list = field(default_factory=list)
    # [(qualname, lock_id, call_display, lineno)] blocking-while-held
    blocking: list = field(default_factory=list)
    # [(qualname, lock_id, lineno)] condition waits without a while loop
    naked_waits: list = field(default_factory=list)
    # [(qualname, lineno)] non-daemon Thread() constructions
    nondaemon_threads: list = field(default_factory=list)
    has_join: bool = False
    # [(qualname, lock_id, lineno)] bare acquire() without finally release
    bare_acquires: list = field(default_factory=list)
    # qualname -> [(what, lineno)]: direct blocking calls anywhere in the
    # function (fuel for one-level interprocedural CON601)
    fn_blocking: dict = field(default_factory=dict)
    # qualname -> set of self-method tails it calls (call graph for the
    # transitive-acquire closure)
    self_calls: dict = field(default_factory=dict)

    def add_edge(self, outer: str, inner: str, qualname: str, lineno: int):
        self.edges.setdefault((outer, inner), []).append((qualname, lineno))

    def cycles(self) -> list:
        """Elementary cycles over the edge set, canonicalised (rotated to
        the smallest node, deduplicated) and sorted for stable output."""
        adj: dict[str, set] = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
        found: set = set()

        def dfs(start: str, node: str, path: list, on_path: set):
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    cyc = _canon(path)
                    found.add(cyc)
                elif nxt not in on_path and nxt > start:
                    # only explore nodes > start: each cycle is found
                    # exactly once, from its smallest node
                    path.append(nxt)
                    on_path.add(nxt)
                    dfs(start, nxt, path, on_path)
                    on_path.discard(nxt)
                    path.pop()

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return sorted(found)


def _canon(path: list) -> tuple:
    i = path.index(min(path))
    return tuple(path[i:] + path[:i])


def _lock_kind(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    name = call_name(value)
    if name in ("field", "dataclasses.field"):
        # dataclass idiom: x: Lock = field(default_factory=threading.Lock)
        for kw in value.keywords:
            if kw.arg == "default_factory":
                return _LOCK_CTORS.get(call_name(kw.value))
        return None
    return _LOCK_CTORS.get(name)


def _discover_locks(tree: ast.Module) -> dict:
    """``{lock id: kind}``: ``self.X = threading.Lock()`` under a class
    registers ``Class.X`` *and* bare ``X`` (call sites inside the class
    reference ``self.X``; attribute matching is by terminal name);
    module-level ``X = threading.Lock()`` registers ``X``."""
    locks: dict[str, str] = {}

    def scan(node, class_name: Optional[str]):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                scan(sub, node.name)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            kind = _lock_kind(node.value) if node.value is not None else None
            if kind:
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        locks[t.attr] = kind
                        if class_name:
                            locks[f"{class_name}.{t.attr}"] = kind
                    elif isinstance(t, ast.Name):
                        locks[t.id] = kind
                        if class_name:
                            # annotated class attr: call sites use self.X
                            locks[f"{class_name}.{t.id}"] = kind
        for sub in ast.iter_child_nodes(node):
            scan(sub, class_name)

    for top in tree.body:
        scan(top, None)
    return locks


def _lock_id(node: ast.AST, locks: dict) -> Optional[str]:
    """Resolve a with-item / attribute expression to a known lock id."""
    if isinstance(node, ast.Attribute):
        return node.attr if node.attr in locks else None
    if isinstance(node, ast.Name):
        return node.id if node.id in locks else None
    return None


def _is_blocking(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if name in _BLOCKING_NAMES:
        return name
    tail = name.rsplit(".", 1)[-1] if name else ""
    if tail in _BLOCKING_TAILS_ALWAYS:
        return name
    if tail in _BLOCKING_TAILS_NOARG and not node.args:
        return name
    if tail in _BLOCKING_TAILS_NOARG and tail == "get" and node.args:
        # queue.get(True) / .get(block=True)
        first = node.args[0]
        if isinstance(first, ast.Constant) and first.value is True:
            return name
    return None


class _LockScan:
    """Walk one function tracking the held-lock stack."""

    def __init__(self, graph: LockGraph, qualname: str, fn, locks: dict):
        self.g = graph
        self.qualname = qualname
        self.fn = fn
        self.locks = locks
        self.held: list[str] = []
        self.in_finally = 0

    def run(self):
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _stmt(self, stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt)
            return
        if isinstance(stmt, ast.Try):
            for sub in stmt.body:
                self._stmt(sub)
            for handler in stmt.handlers:
                for sub in handler.body:
                    self._stmt(sub)
            for sub in stmt.orelse:
                self._stmt(sub)
            self.in_finally += 1
            for sub in stmt.finalbody:
                self._stmt(sub)
            self.in_finally -= 1
            return
        for sub in ast.iter_child_nodes(stmt):
            self._node(sub)

    def _node(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, ast.stmt):
            self._stmt(node)
            return
        if isinstance(node, ast.Call):
            self._call(node)
        for sub in ast.iter_child_nodes(node):
            self._node(sub)

    def _with(self, stmt):
        acquired: list[str] = []
        for item in stmt.items:
            lid = _lock_id(item.context_expr, self.locks)
            if lid is None:
                # still scan the context expression itself for calls
                self._node(item.context_expr)
                continue
            for outer in self.held:
                if outer != lid:
                    self.g.add_edge(
                        outer, lid, self.qualname, stmt.lineno
                    )
            self.held.append(lid)
            acquired.append(lid)
            self.g.acquires.setdefault(self.qualname, set()).add(lid)
        for sub in stmt.body:
            self._stmt(sub)
        for _ in acquired:
            self.held.pop()

    def _call(self, node: ast.Call):
        name = call_name(node)
        tail = name.rsplit(".", 1)[-1] if name else ""
        # Thread bookkeeping is global to the module
        if name in ("threading.Thread", "Thread"):
            daemon = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            if not daemon:
                self.g.nondaemon_threads.append((self.qualname, node.lineno))
        if tail == "join":
            self.g.has_join = True
        # bare acquire on a known lock outside a finally
        if tail == "acquire":
            lid = _lock_id(getattr(node.func, "value", None), self.locks)
            if lid is not None and not self.in_finally:
                # blocking acquire() as a statement (not `with`): flag
                # unless a kwarg makes it non-blocking
                nonblocking = any(
                    kw.arg == "blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in node.keywords
                ) or (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is False
                )
                if not nonblocking:
                    self.g.bare_acquires.append(
                        (self.qualname, lid, node.lineno)
                    )
        if name.startswith("self."):
            self.g.self_calls.setdefault(self.qualname, set()).add(
                name[len("self."):]
            )
        direct_blocking = _is_blocking(node)
        if direct_blocking and tail != "wait":
            self.g.fn_blocking.setdefault(self.qualname, []).append(
                (direct_blocking, node.lineno)
            )
        if not self.held:
            return
        held_top = self.held[-1]
        # condition wait under its own lock is CON602's business, not
        # CON601's — unless OTHER locks are also held
        if tail == "wait":
            lid = _lock_id(getattr(node.func, "value", None), self.locks)
            if lid is not None and self.locks.get(lid) == "condition":
                others = [h for h in self.held if h != lid]
                if others:
                    self.g.blocking.append(
                        (self.qualname, others[-1],
                         f"{name}() while also holding {others[-1]}",
                         node.lineno)
                    )
                if not self._wait_in_while(node):
                    self.g.naked_waits.append(
                        (self.qualname, lid, node.lineno)
                    )
                return
        blocking = _is_blocking(node)
        if blocking:
            self.g.blocking.append(
                (self.qualname, held_top, f"{blocking}()", node.lineno)
            )
            return
        # same-object method call while held: candidate interprocedural
        # edge, resolved against the module's other functions later
        if name.startswith("self."):
            self.g.held_calls.append(
                (self.qualname, held_top, name[len("self."):], node.lineno)
            )

    def _wait_in_while(self, wait_node: ast.Call) -> bool:
        """Is the wait() enclosed in a While between it and the with
        that acquired its condition? Ancestor scan by position."""
        target = wait_node

        def contains(node) -> bool:
            return any(n is target for n in ast.walk(node))

        # find the innermost While containing the wait, inside this fn
        for node in ast.walk(self.fn):
            if isinstance(node, ast.While) and contains(node):
                return True
        return False


def extract_lock_graph(path: str, text: str) -> Optional[LockGraph]:
    """Parse one module and build its :class:`LockGraph` (None when the
    source does not parse — PY500 owns that)."""
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError:
        return None
    graph = LockGraph(path=path)
    graph.locks = _discover_locks(tree)
    for qualname, fn in walk_functions(tree):
        _LockScan(graph, qualname, fn, graph.locks).run()
    # interprocedural: while holding L, calling a self-method that
    # (transitively, over the self-call graph) acquires M adds edge
    # L->M; a callee with a *direct* blocking call propagates one level
    # as blocking-while-held.
    all_fns = set(graph.acquires) | set(graph.self_calls) | set(
        graph.fn_blocking
    )
    methods = {q.rsplit(".", 1)[-1]: q for q in sorted(all_fns)}
    trans: dict[str, set] = {
        q: set(graph.acquires.get(q, ())) for q in all_fns
    }
    changed = True
    while changed:
        changed = False
        for q in all_fns:
            for callee in graph.self_calls.get(q, ()):
                callee_q = methods.get(callee)
                if callee_q is None or callee_q == q:
                    continue
                add = trans.get(callee_q, set()) - trans[q]
                if add:
                    trans[q] |= add
                    changed = True
    for qualname, lock_id, callee, lineno in graph.held_calls:
        callee_q = methods.get(callee)
        if callee_q is None:
            continue
        for inner in sorted(trans.get(callee_q, ())):
            if inner != lock_id:
                graph.add_edge(
                    lock_id, inner, f"{qualname}->{callee_q}", lineno
                )
        for what, _bline in graph.fn_blocking.get(callee_q, ()):
            graph.blocking.append(
                (qualname, lock_id, f"{callee}() → {what}()", lineno)
            )
    return graph


def _graphs(ctx: LintContext) -> list:
    cache = getattr(ctx, "_lock_graphs", None)
    if cache is None:
        cache = []
        for mod in each_module(ctx):
            g = extract_lock_graph(mod.path, mod.text)
            if g is not None:
                cache.append((mod, g))
        ctx._lock_graphs = cache
    return cache


@rule(
    "CON600",
    severity=ERROR,
    category="concurrency",
    description="the static lock-acquisition graph must be acyclic "
    "(a cycle is a potential deadlock)",
)
def check_lock_order_cycles(ctx: LintContext):
    from .engine import Finding

    for mod, g in _graphs(ctx):
        for cyc in g.cycles():
            chain = " -> ".join(cyc + (cyc[0],))
            sites = []
            first_line = 0
            for a, b in zip(cyc, cyc[1:] + cyc[:1]):
                for fn, line in g.edges.get((a, b), ())[:1]:
                    sites.append(f"{a}->{b} in {fn}:{line}")
                for _fn, line in g.edges.get((a, b), ()):
                    first_line = line if not first_line else min(first_line, line)
            if mod.allowed("CON600", first_line):
                continue
            yield Finding(
                rule_id="CON600", severity=ERROR, category="concurrency",
                message=f"lock-order cycle {chain} — two threads taking "
                f"these locks in opposite orders deadlock "
                f"({'; '.join(sites)})",
                artifact=mod.path, line=first_line,
            )


@rule(
    "CON601",
    severity=WARNING,
    category="concurrency",
    description="no blocking call (join/get/result/sleep/readback/"
    "subprocess) while holding a lock",
)
def check_blocking_while_locked(ctx: LintContext):
    for mod, g in _graphs(ctx):
        for qualname, lock_id, what, lineno in g.blocking:
            if mod.allowed("CON601", lineno):
                continue
            from .engine import Finding

            yield Finding(
                rule_id="CON601", severity=WARNING, category="concurrency",
                message=f"blocking {what} while holding {lock_id} — every "
                "thread contending for the lock stalls behind this call",
                location=qualname, artifact=mod.path, line=lineno,
            )


@rule(
    "CON602",
    severity=ERROR,
    category="concurrency",
    description="Condition.wait() must sit inside a while-predicate "
    "loop (spurious wakeups, stale state)",
)
def check_naked_condition_wait(ctx: LintContext):
    for mod, g in _graphs(ctx):
        for qualname, lock_id, lineno in g.naked_waits:
            if mod.allowed("CON602", lineno):
                continue
            from .engine import Finding

            yield Finding(
                rule_id="CON602", severity=ERROR, category="concurrency",
                message=f"{lock_id}.wait() outside a while-predicate loop "
                "— condition waits wake spuriously; re-check the "
                "predicate in a while loop",
                location=qualname, artifact=mod.path, line=lineno,
            )


@rule(
    "CON603",
    severity=WARNING,
    category="concurrency",
    description="non-daemon threads need a join() somewhere in the "
    "module, or process exit hangs",
)
def check_nondaemon_thread(ctx: LintContext):
    for mod, g in _graphs(ctx):
        if g.has_join:
            continue
        for qualname, lineno in g.nondaemon_threads:
            if mod.allowed("CON603", lineno):
                continue
            from .engine import Finding

            yield Finding(
                rule_id="CON603", severity=WARNING, category="concurrency",
                message="non-daemon Thread with no join() anywhere in the "
                "module — a live thread here blocks interpreter exit",
                location=qualname, artifact=mod.path, line=lineno,
            )


@rule(
    "CON604",
    severity=WARNING,
    category="concurrency",
    description="bare lock.acquire() outside try/finally leaks the "
    "lock on exceptions — use a with-statement",
)
def check_bare_acquire(ctx: LintContext):
    for mod, g in _graphs(ctx):
        for qualname, lock_id, lineno in g.bare_acquires:
            if mod.allowed("CON604", lineno):
                continue
            from .engine import Finding

            yield Finding(
                rule_id="CON604", severity=WARNING, category="concurrency",
                message=f"bare {lock_id}.acquire() — an exception before "
                "release() leaks the lock; prefer `with`",
                location=qualname, artifact=mod.path, line=lineno,
            )
