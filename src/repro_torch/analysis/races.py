"""Lock-discipline analysis for the serving engine (DESIGN.md §5).

The port of ``repro.analysis.races``, run over ``repro_torch/serve``.
The thread driver coordinates four locks — the blessed acquisition
order is

    ``_engine_lock`` → ``_results_lock`` → ``_stamp_lock`` →
    ``ProducerRegistry._lock``

(:data:`BLESSED_LOCK_ORDER`; outermost first — a thread holding a lock
may only acquire locks strictly later in the list, so every
acquisition path is a chain in one total order and deadlock-freedom is
a corollary).  The port's server and registry keep the reference's lock
names, so the order is the reference's.  Two complementary checkers
enforce it:

**Static pass** (:func:`analyze_locks`): an AST walk over
``repro_torch/serve/`` that

  * discovers each class's lock attributes (``self._x =
    threading.Lock()`` / ``RLock()``) and which classes its other
    attributes instantiate (so ``with self._registry._lock:`` and
    ``self._registry.stamp(...)`` resolve to ``ProducerRegistry``);
  * tracks the lexical ``with``-stack per method, recording every
    attribute access with the locks held around it and every
    lock-acquisition nesting edge — including edges reached through
    method calls (``self.m()`` / ``self._attr.m()``), closed over the
    call graph to a fixpoint;
  * reports **order violations** (a nesting edge that runs backwards
    against the blessed order, or any cycle among unordered locks),
    **non-reentrant re-acquisition** (a plain ``Lock`` taken while
    already held), and **mixed guarded/unguarded attributes** — a
    ``self._*`` attribute whose accesses are dominantly under one lock
    but also happen outside it (the unguarded-shared-write bug class).

  Conventions the pass understands: accesses inside ``__init__`` are
  construction-time (exempt); a method whose name ends in ``_locked``
  is a caller-holds-the-lock helper (its accesses count as guarded by
  its class's single lock); a line whose trailing comment contains
  ``unlocked:`` documents a deliberate lock-free access and is exempt
  (use it for append-only snapshot reads, with the reason after the
  colon).

**Runtime monitor** (:class:`LockMonitor` via :func:`monitor_server`):
wraps a live server's four locks so every real acquisition records the
locks the acquiring thread already holds.  The multiproducer stress
tests and the card's threaded runs go under it and cross-check the
observed edge set against the static graph and the blessed order — the
static pass over-approximates (it cannot see which branches run), the
monitor under-approximates (it sees only exercised schedules), so
agreement from both sides brackets the truth.
"""

from __future__ import annotations

import ast
import dataclasses
import threading
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

#: The blessed acquisition order, outermost lock first (DESIGN.md §5).
#: A thread holding one of these may only acquire locks strictly later
#: in the tuple.
BLESSED_LOCK_ORDER: Tuple[str, ...] = (
    "ShardedEmbeddingServer._engine_lock",
    "ShardedEmbeddingServer._results_lock",
    "ShardedEmbeddingServer._stamp_lock",
    "ProducerRegistry._lock",
)

#: Suppression marker for deliberate lock-free accesses: any line whose
#: trailing comment contains this token is exempt from the mixed-access
#: report (document the reason after the colon).
UNLOCKED_MARKER = "unlocked:"


class LockOrderError(RuntimeError):
    """A runtime lock acquisition violated the blessed order."""


@dataclasses.dataclass(frozen=True)
class AttrAccess:
    """One ``self._*`` attribute access found by the static pass."""

    cls: str
    attr: str
    method: str
    path: str
    line: int
    locks: frozenset
    is_write: bool


@dataclasses.dataclass(frozen=True)
class OrderEdge:
    """One lock-nesting edge: ``held`` was held when ``acquired`` was
    taken (at ``path:line``, possibly through ``via`` method calls)."""

    held: str
    acquired: str
    path: str
    line: int
    via: str = ""


@dataclasses.dataclass
class MixedAccess:
    """An attribute guarded by ``lock`` at most sites but not all."""

    cls: str
    attr: str
    lock: str
    guarded: int
    unguarded_sites: List[Tuple[str, int, str]]  # (path, line, method)


@dataclasses.dataclass
class LockReport:
    """Everything the static pass extracted, plus derived findings."""

    locks: Dict[str, Set[str]]                  # class -> lock attrs
    rlocks: Set[str]                            # qualified reentrant locks
    edges: List[OrderEdge]
    accesses: List[AttrAccess]
    order_violations: List[str] = dataclasses.field(default_factory=list)
    cycles: List[List[str]] = dataclasses.field(default_factory=list)
    reentrancy_violations: List[str] = dataclasses.field(default_factory=list)
    mixed: List[MixedAccess] = dataclasses.field(default_factory=list)

    def findings(self) -> List[str]:
        """Flat human-readable finding list (empty = discipline holds)."""
        out = list(self.order_violations)
        for cyc in self.cycles:
            out.append(
                "lock-order cycle: " + " -> ".join(cyc + [cyc[0]])
            )
        out.extend(self.reentrancy_violations)
        for m in self.mixed:
            sites = ", ".join(
                f"{p}:{ln} ({meth})" for p, ln, meth in m.unguarded_sites
            )
            out.append(
                f"{m.cls}.{m.attr}: guarded by {m.lock} at {m.guarded} "
                f"site(s) but accessed without it at {sites}"
            )
        return out


def _lock_ctor(node: ast.AST) -> Optional[bool]:
    """``threading.Lock()`` → False, ``threading.RLock()`` → True."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = None
    if isinstance(f, ast.Attribute):
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    if name == "Lock":
        return False
    if name == "RLock":
        return True
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` → ``"X"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassScan(ast.NodeVisitor):
    """First pass over one class: lock attrs + attr → class bindings."""

    def __init__(self, known_classes: Set[str]):
        self.known = known_classes
        self.locks: Dict[str, bool] = {}        # attr -> is_rlock
        self.attr_class: Dict[str, str] = {}    # attr -> class name

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is None:
                continue
            rlock = _lock_ctor(node.value)
            if rlock is not None:
                self.locks[attr] = rlock
                continue
            if isinstance(node.value, ast.Call):
                f = node.value.func
                cname = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else None
                )
                if cname in self.known:
                    self.attr_class[attr] = cname
        self.generic_visit(node)


class _MethodWalk(ast.NodeVisitor):
    """Second pass over one method: with-stack, accesses, edges, calls."""

    def __init__(self, analyzer: "_Analyzer", cls: str, method: str,
                 base_locks: frozenset):
        self.an = analyzer
        self.cls = cls
        self.method = method
        self.held: List[str] = list(base_locks)
        self.acquired: Set[str] = set()          # locks taken directly
        self.calls: List[Tuple[Tuple[str, str], frozenset, int]] = []

    # ----- lock resolution ------------------------------------------------
    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        """``self._x`` / ``self._attr._y`` → qualified lock name."""
        attr = _self_attr(expr)
        if attr is not None:
            if attr in self.an.class_locks.get(self.cls, {}):
                return f"{self.cls}.{attr}"
            return None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Attribute)):
            base = _self_attr(expr.value)
            if base is not None:
                owner = self.an.attr_class.get((self.cls, base))
                if owner and expr.attr in self.an.class_locks.get(owner, {}):
                    return f"{owner}.{expr.attr}"
        return None

    # ----- with-stack -----------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        taken: List[str] = []
        for item in node.items:
            lock = self._resolve_lock(item.context_expr)
            if lock is None:
                self.visit(item.context_expr)
                continue
            self.an.record_acquire(
                lock, list(self.held), self.method, node.lineno
            )
            self.acquired.add(lock)
            self.held.append(lock)
            taken.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for lock in reversed(taken):
            self.held.remove(lock)

    # ----- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            base = _self_attr(f.value)
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                self.calls.append((
                    (self.cls, f.attr), frozenset(self.held), node.lineno
                ))
            elif base is not None:
                owner = self.an.attr_class.get((self.cls, base))
                if owner is not None:
                    self.calls.append((
                        (owner, f.attr), frozenset(self.held), node.lineno
                    ))
        self.generic_visit(node)

    # ----- attribute accesses ---------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if (attr is not None and attr.startswith("_")
                and attr not in self.an.class_locks.get(self.cls, {})):
            self.an.accesses.append(AttrAccess(
                cls=self.cls, attr=attr, method=self.method,
                path=self.an.current_path, line=node.lineno,
                locks=frozenset(self.held),
                is_write=isinstance(node.ctx, (ast.Store, ast.AugStore
                                               if hasattr(ast, "AugStore")
                                               else ast.Store)),
            ))
        self.generic_visit(node)


class _Analyzer:
    """Whole-package state shared by the per-method walks."""

    def __init__(self):
        self.class_locks: Dict[str, Dict[str, bool]] = {}
        self.attr_class: Dict[Tuple[str, str], str] = {}
        self.accesses: List[AttrAccess] = []
        self.edges: List[OrderEdge] = []
        self.direct_acquires: Dict[Tuple[str, str], Set[str]] = {}
        self.calls: Dict[
            Tuple[str, str], List[Tuple[Tuple[str, str], frozenset, int]]
        ] = {}
        self.method_paths: Dict[Tuple[str, str], str] = {}
        self.current_path = ""
        self.source_lines: Dict[str, List[str]] = {}

    def record_acquire(
        self, lock: str, held: List[str], method: str, line: int,
        via: str = "",
    ) -> None:
        for h in held:
            self.edges.append(OrderEdge(
                held=h, acquired=lock, path=self.current_path,
                line=line, via=via,
            ))

    # -------------------------------------------------------------- scan --
    def scan(self, sources: Dict[str, str]) -> None:
        trees: Dict[str, ast.Module] = {}
        for path, src in sources.items():
            trees[path] = ast.parse(src)
            self.source_lines[path] = src.splitlines()
        # pass 1: lock + attr-class discovery needs every class known
        known = {
            n.name
            for tree in trees.values()
            for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
        }
        scans: Dict[str, _ClassScan] = {}
        for tree in trees.values():
            for n in tree.body:
                if not isinstance(n, ast.ClassDef):
                    continue
                sc = _ClassScan(known)
                sc.visit(n)
                scans[n.name] = sc
                if sc.locks:
                    self.class_locks[n.name] = sc.locks
        for cname, sc in scans.items():
            for attr, owner in sc.attr_class.items():
                if owner in self.class_locks:
                    self.attr_class[(cname, attr)] = owner
        # pass 2: per-method walks
        for path, tree in trees.items():
            self.current_path = path
            for n in tree.body:
                if not isinstance(n, ast.ClassDef):
                    continue
                for m in n.body:
                    if not isinstance(
                        m, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    base: frozenset = frozenset()
                    if m.name.endswith("_locked"):
                        # caller-holds-the-lock helper: guarded by the
                        # class's single lock (convention)
                        locks = self.class_locks.get(n.name, {})
                        if len(locks) == 1:
                            base = frozenset(
                                f"{n.name}.{a}" for a in locks
                            )
                    walk = _MethodWalk(self, n.name, m.name, base)
                    for stmt in m.body:
                        walk.visit(stmt)
                    self.direct_acquires[(n.name, m.name)] = walk.acquired
                    self.calls[(n.name, m.name)] = walk.calls
                    self.method_paths[(n.name, m.name)] = path

    # ----------------------------------------------------------- closure --
    def close_over_calls(self) -> None:
        """Fixpoint: locks a method may acquire transitively; then emit
        edges for calls made while holding locks."""
        closure: Dict[Tuple[str, str], Set[str]] = {
            k: set(v) for k, v in self.direct_acquires.items()
        }
        changed = True
        while changed:
            changed = False
            for caller, callees in self.calls.items():
                acc = closure.setdefault(caller, set())
                for callee, _held, _line in callees:
                    extra = closure.get(callee)
                    if extra and not extra <= acc:
                        acc |= extra
                        changed = True
        for caller, callees in self.calls.items():
            for callee, held, line in callees:
                if not held:
                    continue
                for lock in sorted(closure.get(callee, ())):
                    self.current_path = self.method_paths.get(caller, "")
                    self.record_acquire(
                        lock, [h for h in held], caller[1], line,
                        via=f"{callee[0]}.{callee[1]}",
                    )

    # ---------------------------------------------------------- findings --
    def derive(self, report: LockReport) -> None:
        order = {name: i for i, name in enumerate(BLESSED_LOCK_ORDER)}
        graph: Dict[str, Set[str]] = {}
        seen_edges: Set[Tuple[str, str]] = set()
        for e in report.edges:
            if e.held == e.acquired:
                if e.acquired not in report.rlocks:
                    report.reentrancy_violations.append(
                        f"{e.acquired} re-acquired while held at "
                        f"{e.path}:{e.line} ({e.via or e.acquired}) — "
                        f"plain Lock, this deadlocks"
                    )
                continue
            if (e.held, e.acquired) not in seen_edges:
                seen_edges.add((e.held, e.acquired))
                graph.setdefault(e.held, set()).add(e.acquired)
            if e.held in order and e.acquired in order:
                if order[e.held] >= order[e.acquired]:
                    via = f" via {e.via}" if e.via else ""
                    report.order_violations.append(
                        f"{e.acquired} acquired while holding {e.held} at "
                        f"{e.path}:{e.line}{via} — runs backwards against "
                        f"the blessed order "
                        f"{' -> '.join(BLESSED_LOCK_ORDER)}"
                    )
        report.cycles = _find_cycles(graph)
        report.mixed = _mixed_accesses(
            report.accesses, self.class_locks, self.source_lines
        )


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Simple-cycle enumeration (the graphs here have ≤ a dozen nodes)."""
    cycles: List[List[str]] = []
    seen_keys: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                key = tuple(sorted(path))
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(list(path))
            elif nxt not in path and nxt > start:
                # only expand nodes ordered after start: each cycle is
                # found exactly once, rooted at its smallest node
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return cycles


def _mixed_accesses(
    accesses: List[AttrAccess],
    class_locks: Dict[str, Dict[str, bool]],
    source_lines: Dict[str, List[str]],
) -> List[MixedAccess]:
    """Attributes dominantly guarded by one lock but not always.

    The dominant lock must guard at least two accesses AND a strict
    majority of all of them — attributes that are simply never locked
    (single-thread-by-design driver state) have no dominant lock and
    never report.  ``__init__`` accesses are construction-time; lines
    carrying the ``unlocked:`` marker are documented exemptions.
    """
    grouped: Dict[Tuple[str, str], List[AttrAccess]] = {}
    for a in accesses:
        if a.cls not in class_locks or a.method == "__init__":
            continue
        line = ""
        lines = source_lines.get(a.path)
        if lines and 0 < a.line <= len(lines):
            line = lines[a.line - 1]
        if UNLOCKED_MARKER in line:
            continue
        grouped.setdefault((a.cls, a.attr), []).append(a)
    out: List[MixedAccess] = []
    for (cls, attr), accs in sorted(grouped.items()):
        counts: Dict[str, int] = {}
        for a in accs:
            for lock in a.locks:
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            continue
        lock = max(counts, key=lambda k: (counts[k], k))
        guarded = counts[lock]
        unguarded = [a for a in accs if lock not in a.locks]
        if guarded >= 2 and guarded > len(unguarded) and unguarded:
            out.append(MixedAccess(
                cls=cls, attr=attr, lock=lock, guarded=guarded,
                unguarded_sites=sorted(
                    (a.path, a.line, a.method) for a in unguarded
                ),
            ))
    return out


def _default_sources() -> Dict[str, str]:
    root = Path(__file__).resolve().parents[1] / "serve"
    return {
        f"repro_torch/serve/{p.name}": p.read_text()
        for p in sorted(root.glob("*.py"))
    }


def analyze_locks(
    sources: Optional[Dict[str, str]] = None,
) -> LockReport:
    """Runs the static lock-discipline pass.

    Args:
      sources: ``{display path: source text}`` to analyze; ``None``
        analyzes the installed ``repro_torch/serve`` package (the CLI
        gate's configuration).

    Returns:
      A :class:`LockReport`; ``report.findings()`` is empty when the
      discipline holds.
    """
    if sources is None:
        sources = _default_sources()
    an = _Analyzer()
    an.scan(sources)
    an.close_over_calls()
    report = LockReport(
        locks={c: set(l) for c, l in an.class_locks.items()},
        rlocks={
            f"{c}.{a}"
            for c, locks in an.class_locks.items()
            for a, rl in locks.items() if rl
        },
        edges=an.edges,
        accesses=an.accesses,
    )
    an.derive(report)
    return report


# --------------------------------------------------------------- runtime --


class OrderGraph:
    """Thread-safe record of runtime lock-acquisition edges."""

    def __init__(self):
        self._mu = threading.Lock()
        self.edges: Dict[Tuple[str, str], int] = {}
        self._tls = threading.local()

    def held(self) -> List[str]:
        """Locks the calling thread currently holds (monitor names)."""
        return list(getattr(self._tls, "stack", ()))

    def _record(self, name: str) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        if name not in stack:
            with self._mu:
                for h in stack:
                    key = (h, name)
                    self.edges[key] = self.edges.get(key, 0) + 1
        stack.append(name)

    def _release(self, name: str) -> None:
        stack = getattr(self._tls, "stack", [])
        if name in stack:
            # remove the innermost occurrence (reentrant acquires push
            # one entry each)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break

    def edge_set(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self.edges)

    def check_blessed(
        self, order: Tuple[str, ...] = BLESSED_LOCK_ORDER
    ) -> List[str]:
        """Observed edges violating the blessed order (empty = clean)."""
        idx = {name: i for i, name in enumerate(order)}
        out = []
        for held, acquired in sorted(self.edge_set()):
            if held in idx and acquired in idx and idx[held] >= idx[acquired]:
                out.append(
                    f"{acquired} acquired while holding {held} "
                    f"({self.edges[(held, acquired)]}x)"
                )
        return out

    def cycles(self) -> List[List[str]]:
        graph: Dict[str, Set[str]] = {}
        for held, acquired in self.edge_set():
            if held != acquired:
                graph.setdefault(held, set()).add(acquired)
        return _find_cycles(graph)


class LockMonitor:
    """Drop-in wrapper for a ``Lock``/``RLock`` recording real
    acquisition orders into an :class:`OrderGraph`.

    Delegates ``acquire``/``release``/context-manager protocol to the
    wrapped lock; every acquisition by a thread already holding other
    monitored locks records a ``held → acquired`` edge.  Reentrant
    re-acquisition (RLocks) records no self-edge.  With
    ``enforce=True`` an acquisition that runs backwards against
    :data:`BLESSED_LOCK_ORDER` raises :class:`LockOrderError`
    immediately — deadlocks become deterministic test failures.
    """

    def __init__(self, name: str, lock, graph: OrderGraph,
                 *, enforce: bool = False):
        self.name = name
        self._lock = lock
        self._graph = graph
        self._enforce = enforce

    def _check(self) -> None:
        if not self._enforce:
            return
        idx = {n: i for i, n in enumerate(BLESSED_LOCK_ORDER)}
        mine = idx.get(self.name)
        if mine is None:
            return
        for held in self._graph.held():
            if held != self.name and idx.get(held, -1) >= mine:
                raise LockOrderError(
                    f"acquiring {self.name} while holding {held} runs "
                    f"backwards against the blessed order"
                )

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._graph._record(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._graph._release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()


def monitor_server(server, *, enforce: bool = False) -> OrderGraph:
    """Wraps a live server's four locks with :class:`LockMonitor`\\ s.

    Returns the shared :class:`OrderGraph`; the stress tests drive
    traffic, then assert ``graph.check_blessed() == []`` and compare
    ``graph.edge_set()`` against the static pass.  The wrap is
    permanent for the server's lifetime (monitors are drop-in
    replacements, so serving behavior is unchanged).
    """
    graph = OrderGraph()
    server._engine_lock = LockMonitor(
        "ShardedEmbeddingServer._engine_lock", server._engine_lock, graph,
        enforce=enforce,
    )
    server._results_lock = LockMonitor(
        "ShardedEmbeddingServer._results_lock", server._results_lock, graph,
        enforce=enforce,
    )
    server._stamp_lock = LockMonitor(
        "ShardedEmbeddingServer._stamp_lock", server._stamp_lock, graph,
        enforce=enforce,
    )
    server._registry._lock = LockMonitor(
        "ProducerRegistry._lock", server._registry._lock, graph,
        enforce=enforce,
    )
    return graph
