"""Port of ``distriflow_tpu/analysis/lock_check.py`` (copied with its imports rewritten).

dfcheck lock-discipline and lock-order verification.

Two invariants over the repo's ``# guarded-by:`` annotation convention
(see :mod:`distriflow_tpu_torch.analysis.core` for the comment grammar):

**lock-discipline** — for every field declared ``self.field = ...
# guarded-by: _lock``, every read or write of ``self.field`` in a method
body must be dominated by ``with self._lock:``.  Exemptions, in order:

* ``__init__`` / ``__new__`` / ``__del__`` — single-threaded construction
  and teardown; nothing else can hold a reference yet (or still).
* methods whose name ends in ``_locked`` — the repo-wide allowlist
  convention for helpers documented to run under the caller's lock
  (e.g. ``PrefetchingDataset._try_next_locked``).
* methods annotated ``# dfcheck: holds _lock`` — analyzed as if the lock
  were acquired at entry (the static analog of a "call with self._lock
  held" docstring contract).
* nested functions and lambdas are analyzed with an EMPTY held-lock set:
  a closure handed to a thread/timer runs long after the enclosing
  ``with`` exited, so inheriting the lexical lock state would be unsound
  in exactly the cases that matter.

**lock-order** — a static acquisition graph: while lock A is held
(lexically, or via a ``holds`` annotation), acquiring lock B adds the
edge ``A -> B``; calls to same-class methods made while holding A
propagate the callee's **transitive** acquisition set (a per-class
fixpoint over the same-class call graph — v1 stopped at one level, so a
``with self._lb`` two calls deep was invisible).  Lock identity is
``RootClass.attr`` where RootClass is the topmost base among the
analyzed classes, so ``AsynchronousSGDServer`` and ``FederatedServer``
share their inherited ``AbstractServer`` locks.  Any cycle in the graph
is a potential deadlock and is reported once, on each participating
acquisition edge's first site.

**holds-at-callsite inference** (v2) — a private (``_``-prefixed)
method with no ``holds`` annotation whose every recorded same-class
callsite runs with a common lock held is analyzed as if that lock were
held at entry, instead of with held=∅.  Callsites are recorded with the
exact held set at the call expression (callsites inside nested
functions/lambdas record ∅, soundly blocking inference — a closure can
run after the lock is dropped).  Inference iterates to a fixpoint so a
locked wrapper chain propagates depth-first; public methods and
constructors are never inferred (anyone may call them unlocked).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from distriflow_tpu_torch.analysis.core import Finding, SourceModule

_CONSTRUCTORS = {"__init__", "__new__", "__del__", "__post_init__"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _ClassInfo:
    def __init__(self, module: SourceModule, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.bases = [b.id for b in node.bases if isinstance(b, ast.Name)] + [
            b.attr for b in node.bases if isinstance(b, ast.Attribute)
        ]
        #: field name -> guarding lock attr (from ``# guarded-by:`` comments)
        self.guarded: Dict[str, str] = {}
        #: lock attrs this class (or its methods) acquire via ``with self.X``
        self.methods: Dict[str, ast.FunctionDef] = {}
        for item in ast.walk(node):
            if isinstance(item, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    item.targets if isinstance(item, ast.Assign) else [item.target]
                )
                for t in targets:
                    attr = _self_attr(t)
                    # class-level ``name = default  # guarded-by: X`` counts too
                    if attr is None and isinstance(t, ast.Name) and item in node.body:
                        attr = t.id
                    if attr is not None and item.lineno in module.guarded_by:
                        self.guarded[attr] = module.guarded_by[item.lineno]
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item


def _with_locks(stmt: ast.With) -> List[str]:
    """Lock attrs acquired by a ``with`` statement's items (``self.X`` only)."""
    out = []
    for item in stmt.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            out.append(attr)
    return out


def _collect_acquisitions(fn: ast.AST) -> Set[str]:
    """Every ``self.X`` lock attr a function body acquires, at any depth."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            out.update(_with_locks(node))  # type: ignore[arg-type]
    return out


def _self_callees(fn: ast.AST) -> Set[str]:
    """Every ``self.X(...)`` callee name in a function body, at any depth."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            callee = _self_attr(node.func)
            if callee is not None:
                out.add(callee)
    return out


def _transitive_acquisitions(cls: "_ClassInfo") -> Dict[str, Set[str]]:
    """Per-method fixpoint ``acq*(m) = lexical(m) ∪ ⋃ acq*(same-class
    callees of m)`` — the full same-module call-graph propagation that
    replaced v1's one-level lookup."""
    lexical = {n: _collect_acquisitions(fn) for n, fn in cls.methods.items()}
    callees = {
        n: {c for c in _self_callees(fn) if c in cls.methods}
        for n, fn in cls.methods.items()
    }
    acq = {n: set(s) for n, s in lexical.items()}
    changed = True
    while changed:
        changed = False
        for n in acq:
            for c in callees[n]:
                if not acq[c] <= acq[n]:
                    acq[n] |= acq[c]
                    changed = True
    return acq


class _MethodChecker:
    """Walk one method with an explicit held-lock set.

    Nested functions restart with held=∅ (see module docstring); ``with
    self.X`` pushes X for its body; field accesses are checked against the
    class's guarded map; acquisitions and same-class calls feed the order
    graph via the ``edges`` callback.
    """

    def __init__(
        self,
        cls: _ClassInfo,
        method: ast.AST,
        method_name: str,
        guarded: Dict[str, str],
        findings: List[Finding],
        edges: Dict[Tuple[str, str], Tuple[str, int]],
        lock_id,  # (attr) -> qualified lock id string
        entry_holds,  # str | Iterable[str] | None — locks held at entry
        acq_star: Optional[Dict[str, Set[str]]] = None,
        on_call=None,  # callback(callee_name, frozenset(held)) per callsite
    ):
        self.cls = cls
        self.mod = cls.module
        self.method_name = method_name
        self.guarded = guarded
        self.findings = findings
        self.edges = edges
        self.lock_id = lock_id
        self.acq_star = acq_star
        self.on_call = on_call
        self.symbol = f"{cls.name}.{method_name}"
        held: List[str] = []
        if isinstance(entry_holds, str):
            held.append(entry_holds)
        elif entry_holds:
            held.extend(sorted(entry_holds))
        self._visit_body(getattr(method, "body", []), held)

    # -- helpers ----------------------------------------------------------
    def _flag(self, node: ast.AST, field: str, lock: str) -> None:
        line = getattr(node, "lineno", 0)
        if self.mod.ignored(line, "lock-discipline"):
            return
        self.findings.append(
            Finding(
                check="lock-discipline",
                path=self.mod.relpath,
                line=line,
                symbol=self.symbol,
                message=(
                    f"access to self.{field} (guarded-by: {lock}) "
                    f"without holding self.{lock}"
                ),
                detail=field,
            )
        )

    def _record_edge(self, outer: str, inner: str, line: int) -> None:
        a, b = self.lock_id(outer), self.lock_id(inner)
        if a == b:
            return  # re-entrant RLock patterns are not an order edge
        self.edges.setdefault((a, b), (self.mod.relpath, line))

    def _check_expr(self, node: ast.AST, held: List[str]) -> None:
        """Check every guarded self.X access inside an expression/target.

        Nested function/lambda subtrees are pruned — they are analyzed
        separately with held=∅ by _visit_stmt."""
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            attr = _self_attr(sub)
            if attr is not None and attr in self.guarded:
                lock = self.guarded[attr]
                if lock not in held:
                    self._flag(sub, attr, lock)
            if self.on_call is not None and isinstance(sub, ast.Call):
                callee = _self_attr(sub.func)
                if callee is not None and callee in self.cls.methods:
                    self.on_call(callee, frozenset(held))
            stack.extend(ast.iter_child_nodes(sub))

    # -- traversal --------------------------------------------------------
    def _visit_body(self, body: List[ast.stmt], held: List[str]) -> None:
        for stmt in body:
            self._visit_stmt(stmt, held)

    def _visit_stmt(self, stmt: ast.stmt, held: List[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: a closure may outlive the lexical lock scope
            self._visit_body(stmt.body, [])
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locks = _with_locks(stmt)  # type: ignore[arg-type]
            for outer in held:
                for inner in locks:
                    self._record_edge(outer, inner, stmt.lineno)
            if len(locks) > 1:  # with self.a, self.b: a -> b
                for i, outer in enumerate(locks[:-1]):
                    self._record_edge(outer, locks[i + 1], stmt.lineno)
            for item in stmt.items:
                self._check_expr(item.context_expr, held)
            self._visit_body(stmt.body, held + locks)
            return
        # same-class call made while holding a lock: propagate the callee's
        # transitive acquisition set into the order graph
        if held:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    callee = _self_attr(sub.func)
                    if callee and callee in self.cls.methods:
                        if self.acq_star is not None:
                            inner_set = self.acq_star.get(callee, set())
                        else:
                            inner_set = _collect_acquisitions(
                                self.cls.methods[callee])
                        for inner in inner_set:
                            for outer in held:
                                self._record_edge(outer, inner, sub.lineno)
        # generic statements: check every expression field with the current
        # held set, recurse into compound bodies with it too
        for field_name in (
            "test", "iter", "value", "targets", "target", "exc", "cause", "msg",
        ):
            val = getattr(stmt, field_name, None)
            if val is None:
                continue
            for v in val if isinstance(val, list) else [val]:
                if isinstance(v, ast.AST):
                    self._check_expr(v, held)
        for body_field in ("body", "orelse", "finalbody"):
            sub_body = getattr(stmt, body_field, None)
            if isinstance(sub_body, list):
                self._visit_body(sub_body, held)
        for handler in getattr(stmt, "handlers", []):
            self._visit_body(handler.body, held)
        # lambdas anywhere in the statement run later: analyze with held=∅
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Lambda):
                self._check_expr(sub.body, [])


def _root_class(name: str, classes: Dict[str, _ClassInfo], _seen=None) -> str:
    """Topmost analyzed ancestor — unifies inherited locks across subclasses."""
    if _seen is None:
        _seen = set()
    if name in _seen or name not in classes:
        return name
    _seen.add(name)
    for base in classes[name].bases:
        if base in classes:
            return _root_class(base, classes, _seen)
    return name


def _inherited_guarded(
    cls: _ClassInfo, classes: Dict[str, _ClassInfo], _seen=None
) -> Dict[str, str]:
    """Guarded-field map including annotations declared on analyzed bases."""
    if _seen is None:
        _seen = set()
    if cls.name in _seen:
        return {}
    _seen.add(cls.name)
    merged: Dict[str, str] = {}
    for base in cls.bases:
        if base in classes:
            merged.update(_inherited_guarded(classes[base], classes, _seen))
    merged.update(cls.guarded)
    return merged


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]) -> List[List[str]]:
    """Simple-cycle detection via DFS; each cycle reported once, canonically
    rotated to start at its smallest node."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                k = cyc.index(min(cyc))
                cycles.add(tuple(cyc[k:] + cyc[:k]))
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return [list(c) for c in sorted(cycles)]


def check_locks(modules: List[SourceModule]) -> List[Finding]:
    findings: List[Finding] = []
    classes: Dict[str, _ClassInfo] = {}
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, _ClassInfo(mod, node))

    #: (outer_lock_id, inner_lock_id) -> first (path, line) that records it
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    for cls in classes.values():
        guarded = _inherited_guarded(cls, classes)
        root = _root_class(cls.name, classes)
        acq_star = _transitive_acquisitions(cls)

        def lock_id(attr: str, _root=root) -> str:
            return f"{_root}.{attr}"

        def entry_for(name: str, method: ast.AST,
                      inferred: Dict[str, Set[str]]) -> Set[str]:
            holds: Set[str] = set(inferred.get(name, set()))
            ann = cls.module.holds_for_def(method)
            if ann:
                holds.add(ann)
            return holds

        # -- holds-at-callsite inference fixpoint ---------------------------
        # dry passes record (callee, held-at-callsite) pairs; a private
        # unannotated method whose every callsite holds a common lock is
        # then analyzed with that lock held at entry.  Re-running lets a
        # chain of locked private wrappers propagate (bounded: held sets
        # only grow from annotations + with-statements, so ~4 rounds).
        inferred: Dict[str, Set[str]] = {}
        for _ in range(4):
            callsites: Dict[str, List[frozenset]] = {}

            def on_call(callee: str, held: frozenset) -> None:
                callsites.setdefault(callee, []).append(held)

            for name, method in cls.methods.items():
                if name in _CONSTRUCTORS or name.endswith("_locked"):
                    continue
                _MethodChecker(
                    cls, method, name, guarded, [], {}, lock_id,
                    entry_for(name, method, inferred),
                    acq_star=acq_star, on_call=on_call,
                )
            new_inferred: Dict[str, Set[str]] = {}
            for name, method in cls.methods.items():
                if (not name.startswith("_") or name in _CONSTRUCTORS
                        or name.startswith("__") or name.endswith("_locked")):
                    continue
                if cls.module.holds_for_def(method):
                    continue  # annotation wins over inference
                sites = callsites.get(name)
                if not sites:
                    continue
                common = set(sites[0])
                for s in sites[1:]:
                    common &= s
                if common:
                    new_inferred[name] = common
            if new_inferred == inferred:
                break
            inferred = new_inferred

        # -- final pass: real findings + order edges ------------------------
        for name, method in cls.methods.items():
            if name in _CONSTRUCTORS or name.endswith("_locked"):
                continue
            _MethodChecker(
                cls, method, name, guarded, findings, edges, lock_id,
                entry_for(name, method, inferred), acq_star=acq_star,
            )

    for cycle in _find_cycles(edges):
        arc = " -> ".join(cycle + [cycle[0]])
        # anchor the finding on the first edge of the cycle we recorded
        first = None
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            if (a, b) in edges:
                first = edges[(a, b)]
                break
        path, line = first if first else ("<unknown>", 0)
        findings.append(
            Finding(
                check="lock-order",
                path=path,
                line=line,
                symbol="<lock-graph>",
                message=f"potential deadlock: acquisition cycle {arc}",
                detail=arc,
            )
        )
    return findings
