"""Port of ``distriflow_tpu/analysis/core.py`` (copied with its imports rewritten).

dfcheck core: findings, source annotations, and the suppression baseline.

The analyzer (``python -m distriflow_tpu_torch.analysis``) is a project-native
static-analysis plane: it parses the package with :mod:`ast` and proves (or
flags violations of) the repo's hand-maintained concurrency and tracing
invariants.  This module holds the pieces every check family shares:

* :class:`Finding` — one violation, carrying ``file:line`` plus an invariant
  name and a line-number-independent fingerprint so baseline entries survive
  unrelated edits.
* :class:`SourceModule` — a parsed file plus its annotation comments.
* Annotation comments (all trailing-comment based, so they survive ``ast``
  round trips and never affect runtime):

  - ``# guarded-by: _lock`` on a ``self.field = ...`` assignment declares the
    field must only be read/written while ``with self._lock`` is held.
  - ``# dfcheck: holds _lock`` on (or immediately above) a ``def`` line
    declares the method is documented to be called with the lock already
    held, so its body is analyzed as if the lock were taken at entry.
  - ``# dfcheck: ignore[check-name]`` on a line suppresses findings of that
    check on that line (``ignore[*]`` suppresses all checks).
  - ``# dfcheck: pairs acquire=X release=Y[|Z] [counter=attr] [mode=state]``
    on (or above) a ``def`` declares an acquire/release resource pair
    verified by :mod:`.resource_check` (page pools, leases, slots,
    refcounts).
  - ``# dfcheck: payload [param=schema, ...] [-> schema]`` on (or above) a
    ``def`` binds named parameters (and returned dict literals) to a wire
    payload schema from :mod:`distriflow_tpu_torch.comm.schema`; the single-name
    form trailing an assignment (``x = ...  # dfcheck: payload name``)
    binds the assigned variable.  Consumed by :mod:`.wire_check`.

* :func:`load_baseline` / :func:`match_baseline` — the triaged-suppression
  workflow.  ``analysis/baseline.json`` is a checked-in list of
  ``{"fingerprint": ..., "reason": ...}`` entries; the tier-1 gate asserts
  zero findings outside it.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: package root (distriflow_tpu_torch/) and repo root, resolved from this
#: file so the CLI works from any cwd
PACKAGE_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_ROOT.parent
#: repo-relative name of the analyzed package: the whole-package checks
#: key on its ``__init__.py``, and findings outside a source file name it
PACKAGE_REL = PACKAGE_ROOT.name

BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_HOLDS_RE = re.compile(r"#\s*dfcheck:\s*holds\s+([A-Za-z_][A-Za-z0-9_]*)")
_IGNORE_RE = re.compile(r"#\s*dfcheck:\s*ignore\[([A-Za-z0-9_*,\- ]+)\]")
_PAIRS_RE = re.compile(
    r"#\s*dfcheck:\s*pairs\s+acquire=([A-Za-z_][A-Za-z0-9_]*)"
    r"\s+release=([A-Za-z_][A-Za-z0-9_|]*)"
    r"(?:\s+counter=([A-Za-z_][A-Za-z0-9_]*))?"
    r"(?:\s+mode=(value|state))?"
)
_PAYLOAD_RE = re.compile(r"#\s*dfcheck:\s*payload\s+([A-Za-z0-9_=,>\- ]+)")


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """One ``# dfcheck: pairs`` annotation: an acquire def plus the names of
    the defs that release what it acquires.  ``mode="value"`` means the
    acquire *returns* the resource (the value must not be dropped);
    ``mode="state"`` means acquire/release mutate shared state and the
    check only proves release liveness + counter pairing."""

    acquire: str
    releases: Tuple[str, ...]
    counter: Optional[str] = None
    mode: str = "value"


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """One ``# dfcheck: payload`` annotation.

    ``params`` maps parameter names to schema names (def form); ``returns``
    names the schema the function's returned dict literals must satisfy;
    ``bare`` is the single-name assignment form binding the assigned
    variable."""

    params: Tuple[Tuple[str, str], ...] = ()
    returns: Optional[str] = None
    bare: Optional[str] = None


def _parse_payload_spec(spec: str) -> Optional[PayloadSpec]:
    returns = None
    if "->" in spec:
        left, _, right = spec.partition("->")
        returns = right.strip() or None
        spec = left
    params: List[Tuple[str, str]] = []
    bare = None
    for tok in re.split(r"[,\s]+", spec.strip()):
        if not tok:
            continue
        if "=" in tok:
            k, _, v = tok.partition("=")
            if k and v:
                params.append((k, v))
        else:
            bare = tok
    if not params and not returns and not bare:
        return None
    return PayloadSpec(params=tuple(params), returns=returns, bare=bare)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at a specific source location.

    ``fingerprint`` deliberately excludes the line number: baselines keyed on
    ``check:path:symbol:detail`` survive edits elsewhere in the file, which
    is what makes a checked-in suppression list maintainable.
    """

    check: str  # invariant name, e.g. "lock-discipline"
    path: str  # repo-relative path
    line: int
    symbol: str  # Class.method / function qualname / "<module>"
    message: str
    detail: str = ""  # stable discriminator for the fingerprint

    @property
    def fingerprint(self) -> str:
        return f"{self.check}:{self.path}:{self.symbol}:{self.detail}"

    def to_json(self) -> Dict[str, object]:
        return {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.symbol}: {self.message}"


class SourceModule:
    """A parsed source file plus its dfcheck annotation maps."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        # line -> annotation payloads (1-based, matching ast lineno)
        self.guarded_by: Dict[int, str] = {}
        self.holds: Dict[int, str] = {}
        self.ignores: Dict[int, Set[str]] = {}
        self.pairs: Dict[int, PairSpec] = {}
        self.payloads: Dict[int, PayloadSpec] = {}
        for i, text in enumerate(self.lines, start=1):
            if "#" not in text:
                continue
            m = _GUARDED_BY_RE.search(text)
            if m:
                self.guarded_by[i] = m.group(1)
            m = _HOLDS_RE.search(text)
            if m:
                self.holds[i] = m.group(1)
            m = _IGNORE_RE.search(text)
            if m:
                self.ignores[i] = {
                    tok.strip() for tok in m.group(1).split(",") if tok.strip()
                }
            m = _PAIRS_RE.search(text)
            if m:
                self.pairs[i] = PairSpec(
                    acquire=m.group(1),
                    releases=tuple(
                        r for r in m.group(2).split("|") if r
                    ),
                    counter=m.group(3),
                    mode=m.group(4) or "value",
                )
            m = _PAYLOAD_RE.search(text)
            if m:
                spec = _parse_payload_spec(m.group(1))
                if spec is not None:
                    self.payloads[i] = spec

    def ignored(self, line: int, check: str) -> bool:
        """True when ``# dfcheck: ignore[...]`` on ``line`` covers ``check``."""
        toks = self.ignores.get(line)
        if not toks:
            return False
        return "*" in toks or check in toks

    def holds_for_def(self, node: ast.AST) -> Optional[str]:
        """Lock declared held at entry of a ``def`` — the annotation may sit
        on the ``def`` line itself or on the line directly above it (above
        the decorators, if any)."""
        first = min(
            [node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])]
        )
        for ln in (node.lineno, first - 1):
            if ln in self.holds:
                return self.holds[ln]
        return None

    def pairs_for_def(self, node: ast.AST) -> Optional[PairSpec]:
        """``pairs`` annotation on a ``def`` line or the line above it."""
        first = min(
            [node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])]
        )
        for ln in (node.lineno, first - 1):
            if ln in self.pairs:
                return self.pairs[ln]
        return None

    def payload_for_def(self, node: ast.AST) -> Optional[PayloadSpec]:
        """``payload`` annotation on a ``def`` line or the line above it."""
        first = min(
            [node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])]
        )
        for ln in (node.lineno, first - 1):
            if ln in self.payloads:
                return self.payloads[ln]
        return None


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    # the analyzer must not analyze its own fixture-style internals twice
    seen: Set[Path] = set()
    uniq = []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def covers_package(modules: Sequence["SourceModule"]) -> bool:
    """True when the package's ``__init__.py`` was analyzed: the checks
    that compare code with a doc or a registry in both directions run
    only then (a single-file run would report everything else as
    missing)."""
    return any(m.relpath == f"{PACKAGE_REL}/__init__.py" for m in modules)


def load_modules(paths: Sequence[Path]) -> List[SourceModule]:
    mods: List[SourceModule] = []
    for p in iter_py_files(paths):
        try:
            rel = str(p.resolve().relative_to(REPO_ROOT))
        except ValueError:
            rel = str(p)
        try:
            mods.append(SourceModule(p, rel, p.read_text()))
        except (SyntaxError, UnicodeDecodeError):
            # non-parse files (templates, py2 fixtures) are out of scope
            continue
    return mods


# ---------------------------------------------------------------------------
# baseline workflow
# ---------------------------------------------------------------------------


def load_baseline(path: Path = BASELINE_PATH) -> Dict[str, str]:
    """fingerprint -> triage reason.  Every entry MUST carry a non-empty
    reason string — an un-triaged suppression defeats the gate's purpose and
    is rejected loudly here (the tier-1 test exercises this)."""
    if not path.exists():
        return {}
    entries = json.loads(path.read_text())
    out: Dict[str, str] = {}
    for e in entries:
        fp = e.get("fingerprint", "")
        reason = e.get("reason", "")
        if not fp or not isinstance(reason, str) or not reason.strip():
            raise ValueError(
                f"baseline entry missing fingerprint or triage reason: {e!r}"
            )
        out[fp] = reason
    return out


def match_baseline(
    findings: Iterable[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[str]]:
    """Split findings into (non-baselined, stale-baseline-fingerprints).

    Stale entries — baseline fingerprints no finding matched — are reported
    so a fix that removes a violation also prompts shrinking the baseline.
    """
    fresh: List[Finding] = []
    hit: Set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            hit.add(f.fingerprint)
        else:
            fresh.append(f)
    stale = [fp for fp in baseline if fp not in hit]
    return fresh, stale


def write_baseline(findings: Iterable[Finding], path: Path, reason: str) -> None:
    """Emit a baseline file for the given findings (dedup by fingerprint).

    Used by ``--write-baseline``; the committed file is then hand-edited so
    each entry carries a real triage reason."""
    seen: Set[str] = set()
    entries = []
    for f in findings:
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        entries.append({"fingerprint": f.fingerprint, "reason": reason})
    path.write_text(json.dumps(entries, indent=2, sort_keys=False) + "\n")
