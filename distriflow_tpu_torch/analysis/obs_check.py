"""Port of ``distriflow_tpu/analysis/obs_check.py`` (copied with its imports rewritten).

dfcheck observability-contract checks.

Three contracts between code and the obs plane:

* **metric-invalid / metric-undocumented / metric-unknown** — every metric
  ident registered in code (literal first argument of ``.counter()`` /
  ``.gauge()`` / ``.histogram()`` or ``metric_ident()``) must parse via
  :func:`distriflow_tpu_torch.obs.registry.parse_ident` and appear in the
  docs/OBSERVABILITY.md metric tables; conversely, every ident a metric
  table documents must still exist in code (doc drift is a finding too).
* **metric-no-help** — every statically-resolvable factory registration
  (``.counter()/.gauge()/.histogram()`` with a literal or constant name)
  must carry a literal ``help=`` string: the registry's first-write-wins
  help text is what the Prometheus renderer emits as ``# HELP``, so a
  registration without one ships an operator-opaque metric. Tests and
  fixtures are exempt; dynamically-named sites (the collector's
  ``fleet/`` re-aggregation) are unresolvable and therefore out of scope.
* **span-unbalanced** — every ``tracer.span(...)`` / ``prof.phase(...)`` /
  ``prof.step(...)`` enter must have a matching exit on all code paths.
  Statically we accept exactly the shapes that guarantee it: used directly
  as a ``with`` item, returned to the caller (factory pattern — balance is
  the caller's obligation and is checked at ITS site), registered on an
  ``ExitStack`` via ``enter_context``, or assigned to a name that the same
  function later uses as a ``with`` item or explicitly ``__exit__``\\ s.
  Anything else — a discarded call, an assignment never entered — leaks an
  open span on some path.
* **fleet-loopback** — ``fleet/``-prefixed idents are collector-derived
  (server-side re-aggregation of client reports) and must never be shipped
  by a client: registering one outside ``obs/collector.py`` would loop
  fleet sums back into the fleet, double-counting every report cycle.
* **phase-undocumented / phase-unknown** — every span/phase name emitted in
  code (literal first argument of ``tracer.span()`` / ``prof.phase()`` /
  ``tracer.emit()``, plus the name argument of the ``_phase``/``_req_span``
  emission helpers) must appear in a *taxonomy table* (any table whose
  header has a ``phase`` or ``span`` column) of docs/OBSERVABILITY.md or of
  the port's own ``analysis/taxonomy.md``, which lists the phases only the
  port emits; conversely
  every name a taxonomy table documents must still be emitted somewhere in
  code. The assembler's sweep and ``dump`` renderings key on these names,
  so an undocumented phase is invisible to operators and a stale doc row
  describes attribution that no longer happens.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from distriflow_tpu_torch.analysis.core import (
    PACKAGE_REL,
    PACKAGE_ROOT,
    REPO_ROOT,
    Finding,
    SourceModule,
    covers_package,
)

_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_DOC_PATH = REPO_ROOT / "docs" / "OBSERVABILITY.md"
#: the port's own taxonomy rows (phases only the port emits), read beside
#: the reference's doc so that doc stays as it is
_PORT_TAXONOMY = PACKAGE_ROOT / "analysis" / "taxonomy.md"
_BACKTICK_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_]*(?:\{[^`]*\})?)`")
_FLEET_PREFIX = "fleet/"
#: modules allowed to register fleet/ idents (the collector's own
#: re-aggregation gauges) and test/fixture trees exempt from doc contracts
_FLEET_ALLOWED = (f"{PACKAGE_REL}/obs/collector.py",)


def _base_ident(ident: str) -> str:
    """``phase_ms{role=server}`` -> ``phase_ms``."""
    return ident.split("{", 1)[0]


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _module_str_constants(mod: SourceModule) -> Dict[str, str]:
    """Top-level ``NAME = "literal"`` assignments — metric-name constants
    like ``BREACH_COUNTER`` / ``STEP_WALL`` resolve through these."""
    out: Dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            val = _literal_str(node.value)
            if isinstance(t, ast.Name) and val is not None:
                out[t.id] = val
    return out


def collect_code_metrics(
    modules: List[SourceModule],
) -> List[Tuple[SourceModule, ast.Call, str]]:
    """(module, call, ident) for every statically-resolvable metric
    registration site: literal first args plus module-level constants, for
    ``.counter()/.gauge()/.histogram()`` and ``metric_ident()`` calls."""
    # constants are resolved cross-module too (health.py's BREACH_COUNTER is
    # imported by doctor/tests), keyed by bare name — collisions are
    # acceptable for a lint
    constants: Dict[str, str] = {}
    for mod in modules:
        constants.update(_module_str_constants(mod))
    out = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            is_factory = (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_FACTORIES
            ) or (isinstance(node.func, ast.Name) and node.func.id == "metric_ident")
            if not is_factory:
                continue
            arg = node.args[0]
            name = _literal_str(arg)
            if name is None and isinstance(arg, ast.Name):
                name = constants.get(arg.id)
            if name is not None:
                out.append((mod, node, name))
    return out


def collect_doc_metrics(doc_path: Path = _DOC_PATH) -> Tuple[Set[str], Set[str]]:
    """(table_idents, all_idents) from OBSERVABILITY.md.

    ``table_idents`` — first-cell backticked idents of rows in tables whose
    header mentions "Metric"; these anchor the doc->code direction.
    ``all_idents`` — every backticked ident-shaped token anywhere in the
    doc; this (more lenient) set anchors the code->doc direction, so prose
    mentions count as documentation.
    """
    table: Set[str] = set()
    everything: Set[str] = set()
    if not doc_path.exists():
        return table, everything
    in_metric_table = False
    for line in doc_path.read_text().splitlines():
        for m in _BACKTICK_RE.finditer(line):
            everything.add(_base_ident(m.group(1)))
        stripped = line.strip()
        if stripped.startswith("|"):
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            head = cells[0].lower() if cells else ""
            if head in ("name", "metric", "ident") or "metric" in head:
                in_metric_table = True
                continue
            if in_metric_table and cells and not set(cells[0]) <= {"-", ":", " "}:
                m = _BACKTICK_RE.search(cells[0])
                if m:
                    table.add(_base_ident(m.group(1)))
        else:
            in_metric_table = False
    return table, everything


def _check_metrics(modules: List[SourceModule], findings: List[Finding]) -> None:
    from distriflow_tpu_torch.obs.registry import parse_ident

    table_idents, doc_idents = collect_doc_metrics()
    code_idents: Set[str] = set()
    for mod, call, ident in collect_code_metrics(modules):
        in_tests = mod.relpath.startswith("tests/") or "/fixtures/" in mod.relpath
        base = _base_ident(ident)
        # fleet-loopback guard: only the literal "fleet/" namespace is
        # reserved ("fleet_*" server-side counters are ordinary idents)
        if ident.startswith(_FLEET_PREFIX):
            if mod.relpath not in _FLEET_ALLOWED and not in_tests:
                if not mod.ignored(call.lineno, "fleet-loopback"):
                    findings.append(
                        Finding(
                            check="fleet-loopback",
                            path=mod.relpath,
                            line=call.lineno,
                            symbol="<metrics>",
                            message=(
                                f"ident {ident!r} uses the collector-reserved "
                                "fleet/ prefix outside obs/collector.py"
                            ),
                            detail=ident,
                        )
                    )
            continue
        try:
            parse_ident(ident if "{" in ident else base)
        except Exception as exc:
            if not mod.ignored(call.lineno, "metric-invalid"):
                findings.append(
                    Finding(
                        check="metric-invalid",
                        path=mod.relpath,
                        line=call.lineno,
                        symbol="<metrics>",
                        message=f"ident {ident!r} does not parse: {exc}",
                        detail=ident,
                    )
                )
            continue
        if in_tests:
            continue  # test-local metrics carry no doc/help obligation
        # metric-no-help: a resolvable factory registration must carry a
        # literal help= string — that text IS the `# HELP` line scrapers
        # see, so a silent registration is an operator-invisible metric
        is_factory = (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _METRIC_FACTORIES
        )
        has_help = any(
            kw.arg == "help" and _literal_str(kw.value) is not None
            for kw in call.keywords
        )
        if is_factory and not has_help:
            if not mod.ignored(call.lineno, "metric-no-help"):
                findings.append(
                    Finding(
                        check="metric-no-help",
                        path=mod.relpath,
                        line=call.lineno,
                        symbol="<metrics>",
                        message=(
                            f"metric {base!r} is registered without help= "
                            "text (the Prometheus renderer emits it as the "
                            "# HELP line)"
                        ),
                        detail=base,
                    )
                )
        code_idents.add(base)
        if base not in doc_idents:
            if not mod.ignored(call.lineno, "metric-undocumented"):
                findings.append(
                    Finding(
                        check="metric-undocumented",
                        path=mod.relpath,
                        line=call.lineno,
                        symbol="<metrics>",
                        message=(
                            f"metric {base!r} is registered here but absent "
                            "from docs/OBSERVABILITY.md"
                        ),
                        detail=base,
                    )
                )
    # doc -> code: a table row naming a metric no code registers is drift.
    # Only meaningful when the WHOLE package was analyzed — a single-file
    # run would report every other module's metrics as unknown.
    if not covers_package(modules):
        return
    for ident in sorted(table_idents - code_idents):
        if ident.startswith(_FLEET_PREFIX):
            # collector-derived idents (fleet/<name>) are dynamic by design
            continue
        findings.append(
            Finding(
                check="metric-unknown",
                path="docs/OBSERVABILITY.md",
                line=0,
                symbol="<metrics>",
                message=(
                    f"metric table documents {ident!r} but no literal "
                    "registration site exists in code"
                ),
                detail=ident,
            )
        )


# ---------------------------------------------------------------------------
# phase taxonomy (code span/phase names <-> doc taxonomy tables)
# ---------------------------------------------------------------------------

#: emission helpers whose name argument is positional, not the receiver's
#: attr: ``AsyncSGD._phase(name, t0, ...)`` and
#: ``InferenceServer._req_span(req, name, ...)``
_PHASE_HELPERS = {"_phase": 0, "_req_span": 1}
#: receiver substrings that mark a call as span/phase emission per attr
_PHASE_RECEIVERS = {
    "span": ("tracer", "telemetry"),
    "phase": ("prof", "profiler"),
    "emit": ("tracer",),
}


def collect_code_phases(
    modules: List[SourceModule],
) -> List[Tuple[SourceModule, ast.Call, str]]:
    """(module, call, name) for every statically-resolvable span/phase
    emission site — the code side of the §5/§11 taxonomy contract."""
    out = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            attr = node.func.attr
            idx = None
            if attr in _PHASE_RECEIVERS:
                recv = ast.unparse(node.func.value).lower()
                if any(tok in recv for tok in _PHASE_RECEIVERS[attr]):
                    idx = 0
            elif attr in _PHASE_HELPERS:
                idx = _PHASE_HELPERS[attr]
            if idx is None or len(node.args) <= idx:
                continue
            name = _literal_str(node.args[idx])
            if name is not None:
                out.append((mod, node, name))
    return out


def collect_doc_phases(
    doc_paths: Tuple[Path, ...] = (_DOC_PATH, _PORT_TAXONOMY),
) -> Set[str]:
    """Every backticked name in the phase/span column of any table whose
    header declares one, in docs/OBSERVABILITY.md and the port's
    analysis/taxonomy.md — a cell may carry several
    (```stage`/`snapshot`/...``); all count."""
    names: Set[str] = set()
    lines: List[str] = []
    for doc_path in doc_paths:
        if doc_path.exists():
            lines.extend(doc_path.read_text().splitlines())
            lines.append("")  # a table never runs across two files
    phase_col: Optional[int] = None
    for line in lines:
        stripped = line.strip()
        if not stripped.startswith("|"):
            phase_col = None
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        lowered = [c.lower() for c in cells]
        if "phase" in lowered or "span" in lowered:
            phase_col = (lowered.index("phase") if "phase" in lowered
                         else lowered.index("span"))
            continue
        if phase_col is None or phase_col >= len(cells):
            continue
        cell = cells[phase_col]
        if set(cell) <= {"-", ":", " "}:
            continue  # the |---|---| separator row
        for m in _BACKTICK_RE.finditer(cell):
            names.add(_base_ident(m.group(1)))
    return names


def _check_phases(modules: List[SourceModule], findings: List[Finding]) -> None:
    doc_names = collect_doc_phases()
    code_names: Set[str] = set()
    for mod, call, name in collect_code_phases(modules):
        if mod.relpath.startswith("tests/") or "/fixtures/" in mod.relpath:
            continue
        code_names.add(name)
        if name not in doc_names:
            if not mod.ignored(call.lineno, "phase-undocumented"):
                findings.append(
                    Finding(
                        check="phase-undocumented",
                        path=mod.relpath,
                        line=call.lineno,
                        symbol="<phases>",
                        message=(
                            f"span/phase {name!r} is emitted here but absent "
                            "from every taxonomy table of docs/OBSERVABILITY.md "
                            "and analysis/taxonomy.md"
                        ),
                        detail=name,
                    )
                )
    # doc -> code needs the whole package, same as metric-unknown
    if not covers_package(modules):
        return
    unknown = []
    for doc_path in (_DOC_PATH, _PORT_TAXONOMY):
        rel = str(doc_path.relative_to(REPO_ROOT))
        unknown += [(rel, n) for n in collect_doc_phases((doc_path,)) - code_names]
    for rel, name in sorted(unknown):
        findings.append(
            Finding(
                check="phase-unknown",
                path=rel,
                line=0,
                symbol="<phases>",
                message=(
                    f"taxonomy table documents phase {name!r} but no literal "
                    "emission site exists in code"
                ),
                detail=name,
            )
        )


# ---------------------------------------------------------------------------
# span balance
# ---------------------------------------------------------------------------

_SPAN_ATTRS = {"span": ("tracer",), "phase": ("prof", "profiler"), "step": ("prof", "profiler")}


def _is_span_creator(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    attr = call.func.attr
    if attr not in _SPAN_ATTRS:
        return False
    recv = ast.unparse(call.func.value).lower()
    return any(tok in recv for tok in _SPAN_ATTRS[attr])


def _build_parents(tree: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _enclosing_function(node: ast.AST, parents: Dict[int, ast.AST]) -> Optional[ast.AST]:
    cur: Optional[ast.AST] = parents.get(id(node))
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return cur
        cur = parents.get(id(cur))
    return None


def _qualname(node: ast.AST, parents: Dict[int, ast.AST]) -> str:
    parts: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(cur.name)
        cur = parents.get(id(cur))
    return ".".join(reversed(parts)) or "<module>"


def _name_balanced_in(fn: ast.AST, name: str) -> bool:
    """True when ``name`` is later entered/exited inside ``fn``: used as a
    ``with`` item, ``enter_context``-ed, or explicitly ``__exit__``/
    ``close``/``release``-d (the try/finally pattern)."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if (
                isinstance(node.func.value, ast.Name)
                and node.func.value.id == name
                and node.func.attr in ("__exit__", "close", "release", "finish")
            ):
                return True
            if node.func.attr == "enter_context":
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id == name:
                        return True
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
            if node.value.id == name:
                return True  # handed to the caller; balance checked there
    return False


def _check_spans(modules: List[SourceModule], findings: List[Finding]) -> None:
    for mod in modules:
        parents = _build_parents(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not _is_span_creator(node):
                continue
            parent = parents.get(id(node))
            # 1. with x.span(...):  — balanced by the context manager
            if isinstance(parent, ast.withitem):
                continue
            # 2. return x.span(...) — factory; caller's obligation
            if isinstance(parent, ast.Return):
                continue
            # 3. stack.enter_context(x.span(...)) — ExitStack balances it
            if (
                isinstance(parent, ast.Call)
                and isinstance(parent.func, ast.Attribute)
                and parent.func.attr == "enter_context"
            ):
                continue
            # 4. span = x.span(...) with a later with/__exit__ on the name
            if isinstance(parent, ast.Assign) and all(
                isinstance(t, ast.Name) for t in parent.targets
            ):
                fn = _enclosing_function(node, parents)
                if fn is not None and all(
                    _name_balanced_in(fn, t.id) for t in parent.targets  # type: ignore[union-attr]
                ):
                    continue
            if mod.ignored(node.lineno, "span-unbalanced"):
                continue
            findings.append(
                Finding(
                    check="span-unbalanced",
                    path=mod.relpath,
                    line=node.lineno,
                    symbol=_qualname(node, parents),
                    message=(
                        f"{ast.unparse(node.func)}(...) creates a span that is "
                        "not provably exited on all paths (use `with`, "
                        "try/finally __exit__, or return it to the caller)"
                    ),
                    detail=ast.unparse(node.func),
                )
            )


def check_obs(modules: List[SourceModule]) -> List[Finding]:
    findings: List[Finding] = []
    _check_metrics(modules, findings)
    _check_phases(modules, findings)
    _check_spans(modules, findings)
    return findings
