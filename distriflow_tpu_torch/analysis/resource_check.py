"""Port of ``distriflow_tpu/analysis/resource_check.py`` (copied with its imports rewritten).

resource family: acquire/release balance proofs for annotated pairs.

``# dfcheck: pairs acquire=X release=Y[|Z] [counter=attr] [mode=state]`` on
a ``def`` declares a resource lifecycle the analyzer must prove balanced:
page-pool allocate/release, lease grant vs expire/complete, slot insert vs
retire/cancel, the request-id in-flight gate, refcount inc/dec.

Checks:

* ``resource-pair`` — structural sanity of the annotation itself: the
  ``acquire`` name must match the annotated def, and every named release
  must resolve to a def in the same class (or module scope).
* ``resource-leak`` — **value mode** (default): every callsite of the
  acquire in the module must keep the returned resource alive — a bare
  discard is a leak; a tracked local must escape (returned / stored /
  passed on) or be passed to a release; when it is released in the same
  function, an explicit ``raise`` or ``return`` between acquire and
  release leaks unless the release sits in a ``finally`` / ``except``.
  **state mode**: acquire/release mutate shared state, so the proof is
  release liveness — every declared release must actually be invoked
  somewhere in the module outside its own def.
* ``counter-unpaired`` — when the annotation names ``counter=<attr>``,
  every release def must bump it (``self.<attr>.inc(...)``): a counter
  bumped on only one of two release paths undercounts forever.  On
  whole-package runs the metric registry itself is linted: every
  ``*_allocated_total`` ident needs a ``*_released_total`` sibling.

The port adds one proof the reference does not make (``resource-leak``,
detail ``...:counted-unreleased``): in a release def that bumps the pair's
counter, every local the bump counts (``counter.inc(len(pages) + ...)``)
must be passed to a release of some pair declared in the module (the
page pool's ``unref``).  A release path that detaches pages from its
slot, counts them as freed and never returns them is a page leak the
counter hides; a parameter is the caller's to release and is not held
to this.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import PACKAGE_REL, Finding, PairSpec, SourceModule, covers_package
from .obs_check import collect_code_metrics

_PAIRED_SUFFIX = ("_allocated_total", "_released_total")


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    return {
        child: parent
        for parent in ast.walk(tree)
        for child in ast.iter_child_nodes(parent)
    }


def _call_name(node: ast.Call) -> Optional[str]:
    """Bare callee name: ``obj.meth(...)`` -> "meth", ``fn(...)`` -> "fn"."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _functions(tree: ast.AST):
    """(qualname, def node) for every function, any nesting."""
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((f"{qual}{child.name}", child))
                visit(child, f"{qual}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{qual}{child.name}.")
            else:
                visit(child, qual)

    visit(tree, "")
    return out


def _emit(mod: SourceModule, findings: List[Finding], check: str, line: int,
          symbol: str, message: str, detail: str) -> None:
    if mod.ignored(line, check):
        return
    findings.append(Finding(check=check, path=mod.relpath, line=line,
                            symbol=symbol, message=message, detail=detail))


class _Pair:
    """A pairs annotation resolved against its module: the acquire def, its
    owning class (if any), and the located release defs."""

    def __init__(self, mod: SourceModule, spec: PairSpec,
                 cls: Optional[ast.ClassDef], fn: ast.FunctionDef,
                 qual: str):
        self.mod = mod
        self.spec = spec
        self.cls = cls
        self.fn = fn
        self.qual = qual
        self.release_defs: Dict[str, ast.FunctionDef] = {}


def _collect_pairs(mod: SourceModule) -> List[_Pair]:
    pairs: List[_Pair] = []

    def visit(node: ast.AST, cls: Optional[ast.ClassDef], qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child, f"{qual}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spec = mod.pairs_for_def(child)
                if spec is not None:
                    pairs.append(_Pair(mod, spec, cls, child,
                                       f"{qual}{child.name}"))
                visit(child, cls, f"{qual}{child.name}.")
            else:
                visit(child, cls, qual)

    visit(mod.tree, None, "")
    return pairs


def _sibling_defs(pair: _Pair) -> Dict[str, ast.FunctionDef]:
    """Defs visible to the pair's releases: same class when the acquire is a
    method, else module scope."""
    scope = pair.cls.body if pair.cls is not None else pair.mod.tree.body
    return {
        item.name: item
        for item in scope
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


# ---------------------------------------------------------------------------
# value-mode leak analysis
# ---------------------------------------------------------------------------


def _release_protected(call: ast.Call,
                       parents: Dict[ast.AST, ast.AST]) -> bool:
    """True when the release call sits in a ``finally`` block or an
    ``except`` handler — i.e. it runs on the exception path."""
    node: ast.AST = call
    while node in parents:
        parent = parents[node]
        if isinstance(parent, ast.ExceptHandler):
            return True
        if isinstance(parent, ast.Try) and any(
                n is node or node in ast.walk(n) for n in parent.finalbody):
            return True
        node = parent
    return False


def _check_value_callsite(pair: _Pair, mod: SourceModule,
                          fn_qual: str, fn: ast.AST,
                          call: ast.Call,
                          parents: Dict[ast.AST, ast.AST],
                          findings: List[Finding]) -> None:
    spec = pair.spec
    detail_base = f"{spec.acquire}:{fn_qual}"
    parent = parents.get(call)
    # 1) bare discard: `self.pool.alloc(n)` as a statement
    if isinstance(parent, ast.Expr):
        _emit(mod, findings, "resource-leak", call.lineno, fn_qual,
              f"return value of {spec.acquire}() is discarded — the "
              f"acquired resource can never be released "
              f"(release: {'|'.join(spec.releases)})",
              f"{detail_base}:discarded")
        return
    # 2) tracked local: `x = obj.alloc(n)`
    if not (isinstance(parent, ast.Assign)
            and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        return  # escapes directly (return / arg / store / container)
    var = parent.targets[0].id
    acquire_line = parent.lineno

    release_calls: List[ast.Call] = []
    later_loads = 0
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in spec.releases and any(
                    isinstance(a, ast.Name) and a.id == var
                    for a in node.args):
                release_calls.append(node)
        if (isinstance(node, ast.Name) and node.id == var
                and isinstance(node.ctx, ast.Load)
                and node.lineno > acquire_line):
            later_loads += 1

    if release_calls:
        if any(_release_protected(c, parents) for c in release_calls):
            return  # exception path covered
        first_release = min(c.lineno for c in release_calls)
        for node in ast.walk(fn):
            if (isinstance(node, (ast.Raise, ast.Return))
                    and acquire_line < node.lineno < first_release):
                _emit(mod, findings, "resource-leak", node.lineno, fn_qual,
                      f"{'raise' if isinstance(node, ast.Raise) else 'return'}"
                      f" between {spec.acquire}() at line {acquire_line} and "
                      f"its release at line {first_release} leaks the "
                      f"resource — release in a finally/except or before "
                      f"exiting", f"{detail_base}:unprotected-exit")
                return
        return
    if later_loads == 0:
        _emit(mod, findings, "resource-leak", acquire_line, fn_qual,
              f"{var!r} holds the result of {spec.acquire}() but is never "
              f"used, released, or passed on",
              f"{detail_base}:{var}:never-released")


def _check_value_mode(pair: _Pair, mod: SourceModule,
                      parents: Dict[ast.AST, ast.AST],
                      findings: List[Finding]) -> None:
    skip = {pair.fn} | set(pair.release_defs.values())
    for fn_qual, fn in _functions(mod.tree):
        if fn in skip:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _call_name(node) == \
                    pair.spec.acquire:
                _check_value_callsite(pair, mod, fn_qual, fn, node,
                                      parents, findings)


def _check_state_mode(pair: _Pair, mod: SourceModule,
                      findings: List[Finding]) -> None:
    for rel_name, rel_def in pair.release_defs.items():
        called = False
        for fn_qual, fn in _functions(mod.tree):
            if fn is rel_def:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _call_name(node) == rel_name:
                    # calls inside the release def itself don't count; calls
                    # inside nested helpers of it do not occur in practice
                    called = True
                    break
            if called:
                break
        if not called:
            _emit(mod, findings, "resource-leak", pair.fn.lineno, pair.qual,
                  f"state pair {pair.spec.acquire}/{rel_name}: the release "
                  f"{rel_name}() is never invoked in this module — acquired "
                  f"state can never drain", f"{pair.spec.acquire}:"
                  f"{rel_name}:release-dead")


def _check_counter(pair: _Pair, mod: SourceModule,
                   findings: List[Finding]) -> None:
    counter = pair.spec.counter
    if counter is None:
        return
    for rel_name, rel_def in pair.release_defs.items():
        bumped = any(
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "inc"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == counter
            for node in ast.walk(rel_def))
        if not bumped:
            _emit(mod, findings, "counter-unpaired", rel_def.lineno,
                  f"{pair.qual.rsplit('.', 1)[0]}.{rel_name}"
                  if "." in pair.qual else rel_name,
                  f"release path {rel_name}() never bumps the declared "
                  f"pair counter {counter!r} — releases through it are "
                  f"invisible to the *_released_total ledger",
                  f"{pair.spec.acquire}:{rel_name}:{counter}:unbumped")


def _counted_unreleased(pair: _Pair, mod: SourceModule,
                        module_releases: Set[str],
                        findings: List[Finding]) -> None:
    """Port-only: each local a release def's counter bump counts must go
    to a release call in the same def (see the module docstring)."""
    counter = pair.spec.counter
    if counter is None:
        return
    for rel_name, rel_def in pair.release_defs.items():
        locals_: Set[str] = {
            t.id for node in ast.walk(rel_def)
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name)}
        released: Set[str] = set()
        counted: Dict[str, int] = {}
        for node in ast.walk(rel_def):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) in module_releases:
                released.update(a.id for a in node.args
                                if isinstance(a, ast.Name))
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "inc"
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == counter):
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call) and _call_name(sub) == "len"
                            and len(sub.args) == 1
                            and isinstance(sub.args[0], ast.Name)):
                        counted.setdefault(sub.args[0].id, node.lineno)
        for var, line in sorted(counted.items()):
            if var in locals_ and var not in released:
                _emit(mod, findings, "resource-leak", line,
                      f"{pair.qual.rsplit('.', 1)[0]}.{rel_name}"
                      if "." in pair.qual else rel_name,
                      f"{rel_name}() counts {var!r} into {counter!r} but "
                      f"never passes it to a release "
                      f"({'|'.join(sorted(module_releases))}): the counted "
                      f"resource is never returned",
                      f"{pair.spec.acquire}:{rel_name}:{var}:counted-unreleased")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def check_resource(modules: Sequence[SourceModule]) -> List[Finding]:
    findings: List[Finding] = []
    whole_package = covers_package(modules)

    for mod in modules:
        in_tests = (mod.relpath.startswith("tests/")
                    or "/fixtures/" in mod.relpath)
        if in_tests:
            continue
        pairs = _collect_pairs(mod)
        if not pairs:
            continue
        parents = _parent_map(mod.tree)
        module_releases = {r for pair in pairs for r in pair.spec.releases}
        for pair in pairs:
            spec = pair.spec
            if spec.acquire != pair.fn.name:
                _emit(mod, findings, "resource-pair", pair.fn.lineno,
                      pair.qual,
                      f"annotation says acquire={spec.acquire!r} but the "
                      f"annotated def is {pair.fn.name!r}",
                      f"{spec.acquire}:{pair.fn.name}:acquire-mismatch")
                continue
            siblings = _sibling_defs(pair)
            for rel in spec.releases:
                if rel in siblings:
                    pair.release_defs[rel] = siblings[rel]
                else:
                    _emit(mod, findings, "resource-pair", pair.fn.lineno,
                          pair.qual,
                          f"declared release {rel!r} has no def in "
                          f"{'class ' + pair.cls.name if pair.cls else 'module scope'}",
                          f"{spec.acquire}:{rel}:release-missing")
            _check_counter(pair, mod, findings)
            _counted_unreleased(pair, mod, module_releases, findings)
            if spec.mode == "value":
                _check_value_mode(pair, mod, parents, findings)
            else:
                _check_state_mode(pair, mod, findings)

    if whole_package:
        idents = {name for (_, _, name) in collect_code_metrics(list(modules))}
        alloc_sfx, rel_sfx = _PAIRED_SUFFIX
        for name in sorted(idents):
            if name.endswith(alloc_sfx):
                sibling = name[: -len(alloc_sfx)] + rel_sfx
                if sibling not in idents:
                    findings.append(Finding(
                        check="counter-unpaired",
                        path=PACKAGE_REL, line=1, symbol=name,
                        message=(f"metric {name!r} has no registered "
                                 f"{sibling!r} sibling — allocations are "
                                 f"counted but releases are not"),
                        detail=f"{name}:no-release-sibling"))
    return findings
