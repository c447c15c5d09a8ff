"""Port of ``distriflow_tpu/analysis/wire_check.py`` (copied with its imports rewritten).

wire family: static protocol-drift checks against the schema registry.

Single source of truth is :mod:`distriflow_tpu_torch.comm.schema` — every wire
message (``MESSAGES``) and bare-dict payload format (``PAYLOADS``) is
declared there once.  This module proves the code agrees with it:

* ``wire-schema-drift`` — ``to_wire`` emits only registered fields and all
  required ones; ``from_wire`` reads only registered fields.
* ``wire-version`` — a field that can be absent on the wire (optional, or
  ``since`` > 1) must not be read with ``d["k"]`` unless a membership guard
  proves presence; also lints the registry itself (a field's ``since`` must
  not exceed its format's declared version — "new field ⇒ version bump").
* ``wire-unknown-field`` — attribute access on message instances
  (``x = UploadMsg(...)``, ``x = UploadMsg.from_wire(d)``, parameters
  annotated ``: UploadMsg``) must name registered fields; chained access
  follows ``field.message`` (``msg.gradients.version``).  Constructor
  keywords are checked too.
* ``wire-unknown-key`` — dicts bound to a payload schema via
  ``# dfcheck: payload`` annotations may only construct/read registered
  keys, and dict literals bound to a schema must carry every required key.
* ``wire-doc-drift`` — the wire tables in ``docs/ANALYSIS.md`` and the
  registry must agree in both directions (whole-package runs only, like
  the obs doc check).

Payload binding grammar (parsed in :mod:`.core`):

* on/above a ``def``: ``# dfcheck: payload req=generate_request -> generate_ack``
  binds parameter ``req`` and requires returned dict literals to satisfy
  ``generate_ack``;
* trailing an assignment or ``for``: ``# dfcheck: payload serving_meta``
  binds the assigned/loop-target name.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..comm import schema as wire_schema
from .core import PACKAGE_REL, REPO_ROOT, Finding, SourceModule, covers_package

_DOC_PATH = REPO_ROOT / "docs" / "ANALYSIS.md"
_SCHEMA_REL = f"{PACKAGE_REL}/comm/schema.py"

#: attribute names always legal on a message instance
_MSG_METHODS = {"to_wire", "from_wire"}


def _fmt(name: str):
    """Look up a format by name in either registry table."""
    return wire_schema.MESSAGES.get(name) or wire_schema.PAYLOADS.get(name)


def _wire_field(fmt, key: str):
    """The field for an on-the-wire key, or None (attr-only fields like
    DataMsg.x don't count as wire keys)."""
    f = fmt.field(key)
    return f if f is not None and getattr(f, "wire", True) else None


def _attr_field(fmt, key: str):
    """The field for a dataclass attribute, or None (wire-only keys like
    DataMsg.xy don't count as attributes)."""
    f = fmt.field(key)
    return f if f is not None and getattr(f, "attr", True) else None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _FnWireChecker:
    """Per-function walker: tracks name -> schema bindings, key reads and
    writes, membership-guard proof, and attribute access on messages."""

    def __init__(self, mod: SourceModule, symbol: str,
                 fn: ast.AST, findings: List[Finding]):
        self.mod = mod
        self.symbol = symbol
        self.fn = fn
        self.findings = findings
        # local name -> payload schema name
        self.payload_env: Dict[str, str] = {}
        # local name -> message schema name
        self.msg_env: Dict[str, str] = {}
        self.returns_schema: Optional[str] = None
        spec = mod.payload_for_def(fn)
        if spec is not None:
            for param, schema_name in spec.params:
                self.payload_env[param] = schema_name
            self.returns_schema = spec.returns
        # parameters annotated with a message class
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                ann = a.annotation
                if isinstance(ann, ast.Name) and ann.id in wire_schema.MESSAGES:
                    self.msg_env[a.arg] = ann.id
                elif (isinstance(ann, ast.Constant)
                      and isinstance(ann.value, str)
                      and ann.value in wire_schema.MESSAGES):
                    self.msg_env[a.arg] = ann.value

    # -- findings -----------------------------------------------------------

    def _emit(self, check: str, line: int, message: str, detail: str) -> None:
        if self.mod.ignored(line, check):
            return
        self.findings.append(Finding(
            check=check, path=self.mod.relpath, line=line,
            symbol=self.symbol, message=message, detail=detail))

    # -- schema helpers -----------------------------------------------------

    def _check_key_read(self, schema_name: str, key: str, line: int,
                        subscript: bool, proven: Set[Tuple[str, str]],
                        name: str) -> None:
        fmt = _fmt(schema_name)
        if fmt is None:
            return
        field = _wire_field(fmt, key)
        if field is None:
            self._emit(
                "wire-unknown-key", line,
                f"reads key {key!r} not declared in wire schema "
                f"{schema_name!r}", f"{schema_name}.{key}:read")
            return
        can_be_absent = (not field.required) or field.since > 1
        if subscript and can_be_absent and (name, key) not in proven:
            self._emit(
                "wire-version", line,
                f"{schema_name}.{key} can be absent on the wire "
                f"(optional or since=v{field.since}) but is read with "
                f"[{key!r}] — use .get or a membership guard",
                f"{schema_name}.{key}:unversioned-read")

    def _check_key_store(self, schema_name: str, key: str, line: int) -> None:
        fmt = _fmt(schema_name)
        if fmt is not None and _wire_field(fmt, key) is None:
            self._emit(
                "wire-unknown-key", line,
                f"stores key {key!r} not declared in wire schema "
                f"{schema_name!r}", f"{schema_name}.{key}:store")

    def _check_dict_literal(self, schema_name: str, node: ast.Dict,
                            require_required: bool = True) -> None:
        fmt = _fmt(schema_name)
        if fmt is None:
            return
        seen: Set[str] = set()
        exhaustive = True  # no **spread / computed keys
        for k in node.keys:
            if k is None:
                exhaustive = False
                continue
            ks = _const_str(k)
            if ks is None:
                exhaustive = False
                continue
            seen.add(ks)
            self._check_key_store(schema_name, ks, node.lineno)
        if require_required and exhaustive:
            missing = sorted(set(fmt.required_names) - seen)
            if missing:
                self._emit(
                    "wire-schema-drift", node.lineno,
                    f"dict literal bound to {schema_name!r} misses required "
                    f"wire keys {missing}",
                    f"{schema_name}:missing:{','.join(missing)}")

    def _resolve_msg(self, node: ast.AST) -> Optional[str]:
        """Message schema of an expression, following field.message chains."""
        if isinstance(node, ast.Name):
            return self.msg_env.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._resolve_msg(node.value)
            if base is None:
                return None
            fmt = wire_schema.MESSAGES.get(base)
            field = _attr_field(fmt, node.attr) if fmt is not None else None
            return field.message if field is not None else None
        return None

    # -- binding collection -------------------------------------------------

    def _bind_assign(self, node: ast.Assign) -> None:
        # annotation-driven payload binding: `x = ...  # dfcheck: payload nm`
        spec = self.mod.payloads.get(node.lineno)
        if spec is not None and spec.bare is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.payload_env[tgt.id] = spec.bare
        # message binding by construction / from_wire
        ctor = None
        v = node.value
        if isinstance(v, ast.Call):
            if isinstance(v.func, ast.Name) and v.func.id in wire_schema.MESSAGES:
                ctor = v.func.id
            elif (isinstance(v.func, ast.Attribute)
                  and v.func.attr == "from_wire"
                  and isinstance(v.func.value, ast.Name)
                  and v.func.value.id in wire_schema.MESSAGES):
                ctor = v.func.value.id
        if ctor is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.msg_env[tgt.id] = ctor

    def _bind_for(self, node: ast.For) -> None:
        spec = self.mod.payloads.get(node.lineno)
        if spec is not None and spec.bare is not None:
            if isinstance(node.target, ast.Name):
                self.payload_env[node.target.id] = spec.bare

    # -- traversal ----------------------------------------------------------

    def run(self) -> None:
        body = list(getattr(self.fn, "body", []))
        # bindings may be introduced mid-body; a pre-pass over every
        # statement (incl. nested blocks, excl. nested defs) keeps the later
        # expression walk simple while staying flow-insensitive for binding.
        for stmt in self._own_statements(body):
            if isinstance(stmt, ast.Assign):
                self._bind_assign(stmt)
            elif isinstance(stmt, ast.For):
                self._bind_for(stmt)
        self._walk_block(body, proven=set())

    def _own_statements(self, body: Sequence[ast.stmt]):
        """All statements of this function, not descending into nested
        function/class definitions (they get their own checker)."""
        stack = list(body)
        while stack:
            stmt = stack.pop()
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                stack.extend(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                stack.extend(h.body)

    def _membership_guard(self, test: ast.AST) -> Optional[Tuple[str, str, bool]]:
        """Recognize ``"k" in d`` / ``"k" not in d`` on a bound name.
        Returns (name, key, positive)."""
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.comparators[0], ast.Name)):
            key = _const_str(test.left)
            name = test.comparators[0].id
            if key is not None and name in self.payload_env:
                if isinstance(test.ops[0], ast.In):
                    return (name, key, True)
                if isinstance(test.ops[0], ast.NotIn):
                    return (name, key, False)
        return None

    @staticmethod
    def _always_exits(body: Sequence[ast.stmt]) -> bool:
        return bool(body) and isinstance(
            body[-1], (ast.Raise, ast.Return, ast.Continue, ast.Break))

    def _walk_block(self, body: Sequence[ast.stmt],
                    proven: Set[Tuple[str, str]]) -> None:
        proven = set(proven)
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes get their own checker
            if isinstance(stmt, ast.If):
                guard = self._membership_guard(stmt.test)
                self._check_exprs(stmt.test, proven)
                if guard is not None and guard[2]:
                    self._walk_block(stmt.body, proven | {guard[:2]})
                    self._walk_block(stmt.orelse, proven)
                elif guard is not None and not guard[2]:
                    self._walk_block(stmt.body, proven)
                    self._walk_block(stmt.orelse, proven | {guard[:2]})
                    # `if "k" not in d: raise/return` proves k afterwards
                    if self._always_exits(stmt.body):
                        proven.add(guard[:2])
                else:
                    self._walk_block(stmt.body, proven)
                    self._walk_block(stmt.orelse, proven)
                continue
            # other compound statements: check own expressions, then blocks
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk_block(sub, proven)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk_block(h.body, proven)
            self._check_stmt_exprs(stmt, proven)
        # returned dict literals against the def-level `-> schema`
        # (handled per-statement in _check_stmt_exprs)

    def _check_stmt_exprs(self, stmt: ast.stmt, proven) -> None:
        if isinstance(stmt, ast.Return):
            if (self.returns_schema is not None
                    and isinstance(stmt.value, ast.Dict)):
                self._check_dict_literal(self.returns_schema, stmt.value)
                # keys inside the literal's values still need walking
                for v in stmt.value.values:
                    if v is not None:
                        self._check_exprs(v, proven)
                return
            if stmt.value is not None:
                self._check_exprs(stmt.value, proven)
            return
        if isinstance(stmt, ast.Assign):
            # dict literal assigned to a payload-bound name
            bound = None
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id in self.payload_env:
                    bound = self.payload_env[tgt.id]
            if bound is not None and isinstance(stmt.value, ast.Dict):
                self._check_dict_literal(bound, stmt.value)
                for v in stmt.value.values:
                    if v is not None:
                        self._check_exprs(v, proven)
            else:
                self._check_exprs(stmt.value, proven)
            for tgt in stmt.targets:
                self._check_exprs(tgt, proven)
            return
        # generic: every expression child
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._check_exprs(child, proven)

    def _check_exprs(self, expr: ast.AST, proven) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Subscript):
                self._visit_subscript(node, proven)
            elif isinstance(node, ast.Call):
                self._visit_call(node, proven)
            elif isinstance(node, ast.Attribute):
                self._visit_attribute(node)
            elif isinstance(node, ast.Compare):
                self._visit_compare(node)

    def _visit_subscript(self, node: ast.Subscript, proven) -> None:
        if not isinstance(node.value, ast.Name):
            return
        schema_name = self.payload_env.get(node.value.id)
        if schema_name is None:
            return
        key = _const_str(node.slice)
        if key is None:
            return
        if isinstance(node.ctx, ast.Store):
            self._check_key_store(schema_name, key, node.lineno)
        else:
            self._check_key_read(schema_name, key, node.lineno,
                                 subscript=True, proven=proven,
                                 name=node.value.id)

    def _visit_call(self, node: ast.Call, proven) -> None:
        f = node.func
        # d.get("k") / d.update({...}) / d.setdefault / d.pop on bound dicts
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            schema_name = self.payload_env.get(f.value.id)
            if schema_name is not None:
                if f.attr in ("get", "pop") and node.args:
                    key = _const_str(node.args[0])
                    if key is not None:
                        self._check_key_read(
                            schema_name, key, node.lineno, subscript=False,
                            proven=proven, name=f.value.id)
                elif f.attr in ("update", "setdefault"):
                    if node.args and isinstance(node.args[0], ast.Dict):
                        self._check_dict_literal(
                            schema_name, node.args[0], require_required=False)
                    elif node.args:
                        key = _const_str(node.args[0])
                        if key is not None:
                            self._check_key_store(schema_name, key,
                                                  node.lineno)
                    for kw in node.keywords:
                        if kw.arg is not None:
                            self._check_key_store(schema_name, kw.arg,
                                                  node.lineno)
        # message constructor keywords
        if isinstance(f, ast.Name) and f.id in wire_schema.MESSAGES:
            fmt = wire_schema.MESSAGES[f.id]
            for kw in node.keywords:
                if kw.arg is not None and _attr_field(fmt, kw.arg) is None:
                    self._emit(
                        "wire-unknown-field", node.lineno,
                        f"constructor keyword {kw.arg!r} is not a field of "
                        f"wire message {f.id}", f"{f.id}.{kw.arg}:ctor")

    def _visit_attribute(self, node: ast.Attribute) -> None:
        base = self._resolve_msg(node.value)
        if base is None:
            return
        if node.attr in _MSG_METHODS or node.attr.startswith("__"):
            return
        fmt = wire_schema.MESSAGES.get(base)
        if fmt is not None and _attr_field(fmt, node.attr) is None:
            self._emit(
                "wire-unknown-field", node.lineno,
                f"attribute {node.attr!r} is not a field of wire message "
                f"{base}", f"{base}.{node.attr}:attr")

    def _visit_compare(self, node: ast.Compare) -> None:
        # `"k" in d` on a bound dict: unknown key is drift even in a probe
        if (len(node.ops) == 1 and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.comparators[0], ast.Name)):
            schema_name = self.payload_env.get(node.comparators[0].id)
            key = _const_str(node.left)
            if schema_name is not None and key is not None:
                fmt = _fmt(schema_name)
                if fmt is not None and _wire_field(fmt, key) is None:
                    self._emit(
                        "wire-unknown-key", node.lineno,
                        f"membership test for key {key!r} not declared in "
                        f"wire schema {schema_name!r}",
                        f"{schema_name}.{key}:probe")


# ---------------------------------------------------------------------------
# to_wire / from_wire conventions on message dataclasses
# ---------------------------------------------------------------------------


def _check_message_class(mod: SourceModule, cls: ast.ClassDef,
                         findings: List[Finding]) -> None:
    fmt = wire_schema.MESSAGES.get(cls.name)
    if fmt is None:
        return
    for item in cls.body:
        if not isinstance(item, ast.FunctionDef):
            continue
        if item.name == "to_wire":
            _check_to_wire(mod, cls.name, fmt, item, findings)
        elif item.name == "from_wire":
            _check_from_wire(mod, cls.name, fmt, item, findings)


def _emit(mod: SourceModule, findings: List[Finding], check: str, line: int,
          symbol: str, message: str, detail: str) -> None:
    if mod.ignored(line, check):
        return
    findings.append(Finding(check=check, path=mod.relpath, line=line,
                            symbol=symbol, message=message, detail=detail))


def _check_to_wire(mod: SourceModule, cls_name: str, fmt,
                   fn: ast.FunctionDef, findings: List[Finding]) -> None:
    symbol = f"{cls_name}.to_wire"
    emitted: Set[str] = set()
    # dict literals passed as call arguments are nested payloads being
    # packed (e.g. DataMsg's pack_bytes({"x": ..., "y": ...})), not this
    # message's wire envelope — exclude their keys from the emit set
    nested: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Dict):
                        nested.add(id(sub))
    for node in ast.walk(fn):
        if id(node) in nested:
            continue
        if isinstance(node, ast.Dict):
            for k in node.keys:
                ks = _const_str(k) if k is not None else None
                if ks is None:
                    continue
                emitted.add(ks)
                if _wire_field(fmt, ks) is None:
                    _emit(mod, findings, "wire-schema-drift", node.lineno,
                          symbol,
                          f"to_wire emits key {ks!r} not declared in the "
                          f"{cls_name} schema", f"{cls_name}.{ks}:emit")
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)):
            ks = _const_str(node.slice)
            if ks is None:
                continue
            emitted.add(ks)
            if _wire_field(fmt, ks) is None:
                _emit(mod, findings, "wire-schema-drift", node.lineno, symbol,
                      f"to_wire emits key {ks!r} not declared in the "
                      f"{cls_name} schema", f"{cls_name}.{ks}:emit")
    missing = sorted(set(fmt.required_names) - emitted)
    if missing:
        _emit(mod, findings, "wire-schema-drift", fn.lineno, symbol,
              f"to_wire never emits required wire keys {missing}",
              f"{cls_name}:to_wire-missing:{','.join(missing)}")


def _check_from_wire(mod: SourceModule, cls_name: str, fmt,
                     fn: ast.FunctionDef, findings: List[Finding]) -> None:
    symbol = f"{cls_name}.from_wire"
    args = [a.arg for a in fn.args.args if a.arg not in ("cls", "self")]
    if not args:
        return
    dict_name = args[0]

    def probe_keys(test: ast.AST) -> Set[str]:
        """Keys whose presence a guard expression establishes: ``"k" in d``
        membership tests and ``d.get("k")``-style probes."""
        keys: Set[str] = set()
        for node in ast.walk(test):
            if (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.ops[0], ast.In)
                    and isinstance(node.comparators[0], ast.Name)
                    and node.comparators[0].id == dict_name):
                k = _const_str(node.left)
                if k is not None:
                    keys.add(k)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "get"
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == dict_name
                  and node.args):
                k = _const_str(node.args[0])
                if k is not None:
                    keys.add(k)
        return keys

    def check_key(node: ast.AST, key: str, subscript: bool,
                  proven: Set[str]) -> None:
        field = _wire_field(fmt, key)
        if field is None:
            _emit(mod, findings, "wire-schema-drift", node.lineno, symbol,
                  f"from_wire reads key {key!r} not declared in the "
                  f"{cls_name} schema", f"{cls_name}.{key}:read")
        elif (subscript and ((not field.required) or field.since > 1)
              and key not in proven):
            _emit(mod, findings, "wire-version", node.lineno, symbol,
                  f"{cls_name}.{key} can be absent on the wire but "
                  f"from_wire reads it with [{key!r}] — use .get or a "
                  f"membership guard", f"{cls_name}.{key}:unversioned-read")

    def walk(node: ast.AST, proven: Set[str]) -> None:
        if isinstance(node, ast.IfExp):
            walk(node.test, proven)
            walk(node.body, proven | probe_keys(node.test))
            walk(node.orelse, proven)
            return
        if isinstance(node, ast.If):
            walk(node.test, proven)
            inside = proven | probe_keys(node.test)
            for s in node.body:
                walk(s, inside)
            for s in node.orelse:
                walk(s, proven)
            return
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == dict_name
                and isinstance(node.ctx, ast.Load)):
            key = _const_str(node.slice)
            if key is not None:
                check_key(node, key, subscript=True, proven=proven)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == dict_name
              and node.args):
            key = _const_str(node.args[0])
            if key is not None:
                check_key(node, key, subscript=False, proven=proven)
        elif (isinstance(node, ast.Compare) and len(node.ops) == 1
              and isinstance(node.ops[0], (ast.In, ast.NotIn))
              and isinstance(node.comparators[0], ast.Name)
              and node.comparators[0].id == dict_name):
            key = _const_str(node.left)
            if key is not None:
                check_key(node, key, subscript=False, proven=proven)
        for child in ast.iter_child_nodes(node):
            walk(child, proven)

    for stmt in fn.body:
        walk(stmt, set())


# ---------------------------------------------------------------------------
# registry + doc lints
# ---------------------------------------------------------------------------


def _registry_findings() -> List[Finding]:
    """Encoding-version discipline inside the registry itself: a field's
    ``since`` must not exceed the format's declared version — adding a field
    without bumping the version is exactly the drift this family exists to
    stop."""
    out: List[Finding] = []
    tables = list(wire_schema.MESSAGES.items()) + list(
        wire_schema.PAYLOADS.items())
    for name, fmt in tables:
        for f in fmt.fields:
            if f.since > fmt.version:
                out.append(Finding(
                    check="wire-version",
                    path=_SCHEMA_REL, line=1,
                    symbol=name,
                    message=(f"field {f.name!r} declares since=v{f.since} "
                             f"but {name} is only at version {fmt.version} "
                             f"— bump the format version"),
                    detail=f"{name}.{f.name}:since-gt-version"))
            if f.required and f.since > 1:
                out.append(Finding(
                    check="wire-version",
                    path=_SCHEMA_REL, line=1,
                    symbol=name,
                    message=(f"field {f.name!r} added in v{f.since} cannot "
                             f"be required — old writers never emit it"),
                    detail=f"{name}.{f.name}:required-late-field"))
    return out


def _doc_rows(doc_path: Path) -> Set[str]:
    """Backticked ``Format.field`` tokens anywhere in the doc whose prefix
    is a registered format name."""
    import re

    rows: Set[str] = set()
    if not doc_path.exists():
        return rows
    known = set(wire_schema.MESSAGES) | set(wire_schema.PAYLOADS)
    for tok in re.findall(r"`([A-Za-z_][\w]*\.[A-Za-z_][\w]*)`",
                          doc_path.read_text()):
        fmt_name = tok.split(".", 1)[0]
        if fmt_name in known:
            rows.add(tok)
    return rows


def _doc_findings(doc_path: Path) -> List[Finding]:
    out: List[Finding] = []
    rows = _doc_rows(doc_path)
    try:
        doc_rel = str(doc_path.resolve().relative_to(REPO_ROOT))
    except ValueError:
        doc_rel = str(doc_path)
    tables = list(wire_schema.MESSAGES.items()) + list(
        wire_schema.PAYLOADS.items())
    # code -> doc: every registry field must appear in the doc tables
    for name, fmt in tables:
        for f in fmt.fields:
            tok = f"{name}.{f.name}"
            if tok not in rows:
                out.append(Finding(
                    check="wire-doc-drift", path=doc_rel, line=1,
                    symbol=name,
                    message=(f"wire field `{tok}` is in the schema registry "
                             f"but missing from the doc wire tables"),
                    detail=f"{tok}:undocumented"))
    # doc -> code: every doc row must exist in the registry
    valid = {f"{name}.{f.name}" for name, fmt in tables for f in fmt.fields}
    for tok in sorted(rows - valid):
        out.append(Finding(
            check="wire-doc-drift", path=doc_rel, line=1,
            symbol=tok.split(".", 1)[0],
            message=(f"doc wire table row `{tok}` names a field the schema "
                     f"registry does not declare"),
            detail=f"{tok}:phantom"))
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def check_wire(modules: Sequence[SourceModule],
               doc_path: Optional[Path] = None) -> List[Finding]:
    findings: List[Finding] = []
    whole_package = covers_package(modules)
    registry_in_scope = any(m.relpath == _SCHEMA_REL for m in modules)

    for mod in modules:
        in_tests = (mod.relpath.startswith("tests/")
                    or "/fixtures/" in mod.relpath)
        if in_tests:
            continue
        # message-class conventions + per-function payload/attribute checks
        scope: List[Tuple[str, ast.AST]] = []

        def visit(node: ast.AST, qual: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    _check_message_class(mod, child, findings)
                    visit(child, f"{qual}{child.name}.")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    _FnWireChecker(mod, f"{qual}{child.name}",
                                   child, findings).run()
                    visit(child, f"{qual}{child.name}.")
                else:
                    visit(child, qual)

        del scope
        visit(mod.tree, "")

    if registry_in_scope:
        findings.extend(_registry_findings())
    if whole_package:
        findings.extend(_doc_findings(doc_path or _DOC_PATH))
    elif doc_path is not None:
        findings.extend(_doc_findings(doc_path))
    return findings
