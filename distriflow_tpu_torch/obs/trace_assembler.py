"""Port of ``distriflow_tpu/obs/trace_assembler.py`` (copied with its imports rewritten).

Round-trip trace assembly + critical-path attribution.

The span substrate (``obs/tracing.py``) leaves per-role rows in
``spans.jsonl``; the phase profiler (``obs/profiler.py``) digests each
role in isolation. This module joins them into the causal picture the
paper's loop actually is — one **round** per update: server dispatch →
client install/fit/serialize/submit → server decode/quarantine/apply →
broadcast — and answers the question none of the per-role surfaces can:
*which phase bounds throughput, and where does the round sit idle?*

Rounds are keyed ``(trace_id, update_id)`` with chaos tolerance
(docs/OBSERVABILITY.md §9):

- retries re-send the same wire bytes, so every delivery of an update —
  including the duplicates the server dedups — lands in ONE trace and
  therefore one round (``dedup_deliveries`` counts the suppressed ones);
- a batch redelivered after a reconnect is answered from the client's
  upload cache, whose message still names the ORIGINAL trace — traces
  sharing an ``update_id`` are merged into the one applied round;
- a dispatch whose client vanished (or whose batch was re-dispatched
  and lost the first-wins race) assembles into an *unapplied* round,
  never an orphan.

Clock skew: rows are ordered on the per-process monotonic anchor
(``mono``) and clock domains (``(host, pid)``) are aligned via each
domain's median wall-minus-mono offset, so a wall-clock step mid-run
cannot shuffle a timeline. Rows without a ``host`` key (local spans;
every row before the fleet telemetry plane) fall in the ``(None, pid)``
domain — single-host assembly is byte-identical to the per-pid
behavior, while span rows shipped from other hosts by the fleet
collector (``obs/collector.py``, which stamps each with the client's
``host``) get their own domain even when two hosts reuse a pid.

Attribution sweeps each round's segments on a shared timeline: at any
instant the highest-priority active segment owns the time (server apply
work carves its slice out of the client's enclosing submit window; the
quarantine gate carves out of apply), uncovered time is an idle gap
between named phases, and ``overlap_ms = max(0, busy - wall)`` — the
same definition the profiler's step digest uses, so the two accountings
are mutually checkable (bench pins them within 10%).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: the round taxonomy (docs/OBSERVABILITY.md §5/§9). Higher priority wins
#: an instant when segments overlap: server-side work is carved out of the
#: client's enclosing submit/ack window, quarantine out of apply.
_PRIORITY = {
    "quarantine": 9,
    "apply": 8,
    "decode": 7,
    # speculative serving phases (docs/PERFORMANCE.md §7g): verify is the
    # target-model pass and owns overlapped instants; draft and commit are
    # the small-model halves on either side of it
    "spec_verify": 7,
    "spec_draft": 6,
    "spec_commit": 6,
    "fit": 6,
    "ef_compress": 6,
    "serialize": 5,
    "install": 4,
    "broadcast": 3,
    "submit": 2,
    "ack_wait": 1,
    # serving request-round taxonomy (docs/OBSERVABILITY.md §11): engine
    # work (prefill/decode) owns overlapped instants; the router's route
    # attempt and the client's request root are the enclosing windows the
    # replica phases carve their time out of
    "prefill": 7,
    "decode_iter": 7,
    "admission": 5,
    "retire": 4,
    "queue_wait": 3,
    "route": 2,
    "request": 1,
}

#: structural span names — everything else is treated as a generic phase
#: segment under its own name, so unknown emitters still assemble.
_STRUCTURAL = {"round", "dispatch", "upload", "decode", "apply", "install",
               "fit"}


@dataclasses.dataclass
class Round:
    """One assembled update round and its critical-path attribution."""

    trace_id: str
    update_id: Optional[str]
    kind: str  # "wire" | "step" (trainer) | "request" (serving, §11)
    applied: bool
    wall_ms: float
    phases: Dict[str, float]  # exclusive critical-path ms per phase
    bound_by: str
    overlap_ms: float
    idle_ms: float
    gaps: List[Tuple[str, str, float]]  # (after_phase, before_phase, ms)
    retries: int = 0
    dedup_deliveries: int = 0
    apply_spans: int = 0
    span_count: int = 0
    ack_wait_ms: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Assembly:
    """Every round assembled from one span set, plus the leftovers."""

    rounds: List[Round]
    orphans: List[Dict[str, Any]]  # rows with no trace_id — emit-site bugs
    skipped: int = 0  # malformed jsonl lines (when read from a file)

    def applied(self) -> List[Round]:
        return [r for r in self.rounds if r.applied]

    def requests(self) -> List[Round]:
        """The serving request rounds (kind == "request")."""
        return [r for r in self.rounds if r.kind == "request"]

    def request_attribution(self) -> Dict[str, Any]:
        """Per-SLO-tier TTFT/TPOT and goodput over the request rounds —
        the ``dump --requests`` table (docs/OBSERVABILITY.md §11)."""
        reqs = self.requests()
        tiers: Dict[int, Dict[str, Any]] = {}
        for r in reqs:
            t = r.attrs.get("tier")
            row = tiers.setdefault(int(t) if t is not None else -1, {
                "requests": 0, "committed": 0, "shed": 0, "failovers": 0,
                "ttft": [], "tpot": []})
            row["requests"] += 1
            row["committed"] += 1 if r.applied else 0
            row["shed"] += 1 if r.attrs.get("verdict") == "shed" else 0
            row["failovers"] += r.retries
            for k in ("ttft", "tpot"):
                v = r.attrs.get(f"{k}_ms")
                if v is not None:
                    row[k].append(float(v))
        out: Dict[int, Dict[str, Any]] = {}
        for t, row in sorted(tiers.items()):
            o = {k: row[k] for k in
                 ("requests", "committed", "shed", "failovers")}
            for k in ("ttft", "tpot"):
                vals = sorted(row[k])
                o[f"{k}_p50_ms"] = _pct(vals, 0.50)
                o[f"{k}_p99_ms"] = _pct(vals, 0.99)
            out[t] = o
        return {"requests": len(reqs),
                "committed": sum(1 for r in reqs if r.applied),
                "orphans": len(self.orphans),
                "tiers": out}

    def attribution(self) -> Dict[str, Any]:
        """Aggregate critical-path attribution over the APPLIED rounds."""
        rounds = self.applied()
        totals: Dict[str, float] = {}
        bound_counts: Dict[str, int] = {}
        for r in rounds:
            for phase, ms in r.phases.items():
                totals[phase] = totals.get(phase, 0.0) + ms
            bound_counts[r.bound_by] = bound_counts.get(r.bound_by, 0) + 1
        n = len(rounds)
        idle_total = sum(r.idle_ms for r in rounds)
        candidates = dict(totals)
        candidates["idle"] = idle_total
        bound_by = (max(sorted(candidates), key=lambda k: candidates[k])
                    if n else None)
        return {
            "rounds": len(self.rounds),
            "applied": n,
            "bound_by": bound_by,
            "bound_counts": bound_counts,
            "phase_total_ms": {k: round(v, 3)
                               for k, v in sorted(totals.items())},
            "phase_mean_ms": {k: round(v / n, 3)
                              for k, v in sorted(totals.items())} if n else {},
            "overlap_ms": round(sum(r.overlap_ms for r in rounds) / n, 3)
            if n else 0.0,
            "idle_ms": round(idle_total / n, 3) if n else 0.0,
            "wall_ms": round(sum(r.wall_ms for r in rounds) / n, 3)
            if n else 0.0,
            "retries": sum(r.retries for r in rounds),
            "dedup_deliveries": sum(r.dedup_deliveries for r in rounds),
            "orphans": len(self.orphans),
            "skipped_lines": self.skipped,
        }


def _pct(vals: List[float], q: float) -> Optional[float]:
    """Percentile over a small sorted sample (nearest-rank); None when
    empty — matching the registry histogram's summary convention."""
    if not vals:
        return None
    return round(vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))], 3)


def _f(row: Dict[str, Any], key: str, default: float = 0.0) -> float:
    try:
        v = row.get(key)
        return float(v) if v is not None else default
    except (TypeError, ValueError):
        return default


def _domain_offsets(rows: List[Dict[str, Any]]) -> Dict[Any, float]:
    """Per-(host, pid) wall-minus-mono offset (median): maps each clock
    domain's monotonic anchors onto the shared wall timeline. ``host`` is
    None for local rows, so single-host assembly degrades to exactly the
    old per-pid alignment; rows shipped by the fleet collector carry the
    client's host and get their own domain."""
    by_domain: Dict[Any, List[float]] = {}
    for r in rows:
        if r.get("mono") is not None and r.get("start") is not None:
            by_domain.setdefault((r.get("host"), r.get("pid")), []).append(
                _f(r, "start") - _f(r, "mono"))
    return {dom: statistics.median(d) for dom, d in by_domain.items()}


def _interval(row: Dict[str, Any],
              offsets: Dict[Any, float]) -> Tuple[float, float]:
    """(t0, t1) of a span row in wall seconds, skew-tolerantly: monotonic
    anchor + its domain's offset when available, raw wall otherwise."""
    mono = row.get("mono")
    dom = (row.get("host"), row.get("pid"))
    if mono is not None and dom in offsets:
        t0 = _f(row, "mono") + offsets[dom]
    else:
        t0 = _f(row, "start")
    return t0, t0 + _f(row, "dur_ms") / 1e3


def _sweep(segments: List[Tuple[str, float, float, int]]
           ) -> Tuple[Dict[str, float], float, List[Tuple[str, str, float]],
                      float]:
    """Exclusive per-phase attribution over the segments' hull.

    Returns ``(phase_ms, idle_ms, gaps, wall_ms)``. At every elementary
    window the highest-priority active segment owns the time; windows no
    segment covers are idle gaps, labelled with the phases on either
    side."""
    segs = [(p, a, b, pr) for p, a, b, pr in segments if b > a]
    if not segs:
        return {}, 0.0, [], 0.0
    points = sorted({t for _, a, b, _ in segs for t in (a, b)})
    phase_ms: Dict[str, float] = {}
    windows: List[Tuple[Optional[str], float]] = []  # (owner|None, dt_ms)
    for a, b in zip(points, points[1:]):
        if b <= a:
            continue
        dt = (b - a) * 1e3
        active = [s for s in segs if s[1] <= a and s[2] >= b]
        if active:
            owner = max(active, key=lambda s: (s[3], -s[1]))[0]
            phase_ms[owner] = phase_ms.get(owner, 0.0) + dt
            windows.append((owner, dt))
        else:
            windows.append((None, dt))
    idle = 0.0
    gaps: List[Tuple[str, str, float]] = []
    i = 0
    while i < len(windows):
        owner, dt = windows[i]
        if owner is None:
            gap = dt
            j = i + 1
            while j < len(windows) and windows[j][0] is None:
                gap += windows[j][1]
                j += 1
            before = next((windows[k][0] for k in range(i - 1, -1, -1)
                           if windows[k][0]), "start")
            after = windows[j][0] if j < len(windows) else "end"
            gaps.append((before, after, gap))
            idle += gap
            i = j
        else:
            i += 1
    wall = (points[-1] - points[0]) * 1e3
    return phase_ms, idle, gaps, wall


def _truthy(v: Any) -> bool:
    return bool(v) and v not in ("False", "false", "0")


def _assemble_step_round(trace_id: str, rows: List[Dict[str, Any]],
                         offsets: Dict[Any, float]) -> Round:
    """An in-process trainer round: a ``round`` root span plus flat phase
    children. Matches the profiler's step semantics — busy is the phase
    sum, overlap is busy beyond the wall, idle the uncovered wall."""
    root = next(r for r in rows if r.get("name") == "round")
    children = [r for r in rows if r.get("name") != "round"]
    wall = _f(root, "dur_ms")
    phases: Dict[str, float] = {}
    overlap_phases: Dict[str, float] = {}
    for c in children:
        # a child stamped overlap=True ran on a comm thread concurrent
        # with the round's wall (the double-buffered upload): its time is
        # pure overlap and must not compete for bound_by, or a fully
        # hidden submit would still look like the bottleneck.
        target = overlap_phases if _truthy(c.get("overlap")) else phases
        target[c["name"]] = target.get(c["name"], 0.0) + _f(c, "dur_ms")
    busy = sum(phases.values())
    overlap = sum(overlap_phases.values()) + max(0.0, busy - wall)
    idle = max(0.0, wall - busy)
    candidates = dict(phases)
    candidates["idle"] = idle
    bound = (max(sorted(candidates), key=lambda k: candidates[k])
             if candidates else "idle")
    attrs = {k: root[k] for k in ("role", "worker") if k in root}
    if overlap_phases:
        attrs["overlap_phase_ms"] = {
            k: round(v, 3) for k, v in sorted(overlap_phases.items())}
    return Round(
        trace_id=trace_id, update_id=root.get("update_id"), kind="step",
        applied=str(root.get("status", "ok")) == "ok",
        wall_ms=wall, phases=phases, bound_by=bound, overlap_ms=overlap,
        idle_ms=idle, gaps=[], span_count=len(rows),
        attrs=attrs,
    )


def _assemble_wire_round(key: str, rows: List[Dict[str, Any]],
                         offsets: Dict[Any, float]) -> Round:
    """A cross-role round: dispatch/install/fit/upload/decode/apply spans
    (any subset — chaos leaves partial rounds) swept into exclusive
    per-phase critical time."""
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_name.setdefault(str(r.get("name", "?")), []).append(r)

    applies = by_name.get("apply", [])
    owned = [a for a in applies if not _truthy(a.get("dedup"))]
    dedups = [a for a in applies if _truthy(a.get("dedup"))]
    applied_span = next(
        (a for a in owned
         if str(a.get("status", "ok")) == "ok"
         and _truthy(a.get("accepted", True))), None)

    uploads = by_name.get("upload", [])
    upload = None
    if applied_span is not None and applied_span.get("parent_id"):
        upload = next((u for u in uploads
                       if u.get("span_id") == applied_span["parent_id"]),
                      None)
    if upload is None and uploads:
        upload = min(uploads, key=lambda u: _interval(u, offsets)[0])

    segments: List[Tuple[str, float, float, int]] = []

    def seg(phase: str, t0: float, t1: float) -> None:
        segments.append((phase, t0, t1, _PRIORITY.get(phase, 0)))

    for d in by_name.get("dispatch", ()):
        a, b = _interval(d, offsets)
        seg("broadcast", a, b)
    for name in ("install", "fit", "decode"):
        for r in by_name.get(name, ()):
            a, b = _interval(r, offsets)
            seg(name, a, b)
    ack_wait = 0.0
    if upload is not None:
        a, b = _interval(upload, offsets)
        ser = min(_f(upload, "serialize_ms"), _f(upload, "dur_ms")) / 1e3
        seg("serialize", a, a + ser)
        seg("submit", a + ser, b)
        ack_wait = _f(upload, "ack_wait_ms")
    for ap in owned:
        a, b = _interval(ap, offsets)
        q = min(_f(ap, "quarantine_ms"), _f(ap, "dur_ms")) / 1e3
        if q > 0:
            seg("quarantine", a, a + q)
        seg("apply", a, b)
    # anything outside the structural set is a generic segment of its own
    for name, group in by_name.items():
        if name not in _STRUCTURAL:
            for r in group:
                a, b = _interval(r, offsets)
                seg(name, a, b)

    phases, idle, gaps, wall = _sweep(segments)
    busy = sum((s[2] - s[1]) * 1e3 for s in segments)
    overlap = max(0.0, busy - wall)
    candidates = dict(phases)
    candidates["idle"] = idle
    bound = (max(sorted(candidates), key=lambda k: candidates[k])
             if candidates else "idle")
    retries = 0
    if upload is not None:
        retries = max(0, int(_f(upload, "attempts", 1)) - 1)
    src = applied_span or upload or (rows[0] if rows else {})
    update_id = next((r.get("update_id") for r in rows
                      if r.get("update_id")), None)
    return Round(
        trace_id=str(rows[0].get("trace_id", key)) if rows else key,
        update_id=update_id, kind="wire",
        applied=applied_span is not None,
        wall_ms=wall, phases=phases, bound_by=bound, overlap_ms=overlap,
        idle_ms=idle, gaps=gaps, retries=retries,
        dedup_deliveries=len(dedups), apply_spans=len(owned),
        span_count=len(rows), ack_wait_ms=ack_wait,
        attrs={k: src[k] for k in ("client_id", "model_version", "verdict",
                                   "staleness", "queue_depth")
               if src.get(k) is not None},
    )


#: span names that mark a trace as a serving request round (§11); any row
#: carrying a ``request_id`` attr qualifies too, so replica-only span sets
#: (no router, no client root) still assemble as request timelines.
_REQUEST_NAMES = {"request", "route", "queue_wait", "admission", "prefill",
                  "decode_iter", "retire"}


def _is_request_trace(rows: List[Dict[str, Any]]) -> bool:
    return any(str(r.get("name")) in _REQUEST_NAMES or r.get("request_id")
               for r in rows)


def _assemble_request_round(key: str, rows: List[Dict[str, Any]],
                            offsets: Dict[Any, float]) -> Round:
    """One serving request's timeline: the client's ``request`` root, one
    ``route`` span per router attempt, and the replica engine spans
    (queue_wait/admission/prefill/decode_iter/spec_*/retire). Failover
    hops land in the SAME trace (the headers ride the resubmitted
    payload), so the attempt list carries per-replica segments and the
    round checks the exactly-once commit: routed requests must show
    exactly one ``forwarded`` attempt; shed and whole-fleet-drain
    requests assemble as terminated (unapplied) rounds carrying that
    verdict."""
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_name.setdefault(str(r.get("name", "?")), []).append(r)

    routes = sorted(by_name.get("route", ()),
                    key=lambda r: _interval(r, offsets)[0])
    attempts: List[Dict[str, Any]] = []
    for rt in routes:
        attempts.append({
            "replica": rt.get("replica"),
            "verdict": str(rt.get("verdict", "?")),
            "dur_ms": round(_f(rt, "dur_ms"), 3),
        })
    forwarded = [a for a in attempts if a["verdict"] == "forwarded"]
    failovers = sum(1 for a in attempts
                    if a["verdict"].startswith("failover"))
    retires = by_name.get("retire", ())
    outcomes = sorted({str(r.get("outcome")) for r in retires
                       if r.get("outcome") is not None})

    segments: List[Tuple[str, float, float, int]] = []
    for name, group in by_name.items():
        for r in group:
            a, b = _interval(r, offsets)
            segments.append((name, a, b, _PRIORITY.get(name, 0)))
    phases, idle, gaps, wall = _sweep(segments)
    busy = sum((s[2] - s[1]) * 1e3 for s in segments)
    overlap = max(0.0, busy - wall)
    candidates = dict(phases)
    candidates["idle"] = idle
    bound = (max(sorted(candidates), key=lambda k: candidates[k])
             if candidates else "idle")

    if any(a["verdict"] == "shed" for a in attempts):
        verdict = "shed"
    elif forwarded:
        verdict = "forwarded"
    elif any(a["verdict"] == "drain" for a in attempts):
        verdict = "drain"
    elif "complete" in outcomes:
        verdict = "complete"
    elif outcomes:
        verdict = outcomes[0]
    else:
        roots = by_name.get("request", ())
        status = str(roots[0].get("status", "ok")) if roots else "ok"
        verdict = "ok" if status == "ok" else status
    # exactly-once commit: a routed request is applied iff exactly ONE
    # attempt forwarded; an unrouted (direct) one iff the replica retired
    # it complete (or, client-side-only traces, the root closed ok)
    if routes:
        applied = len(forwarded) == 1
    elif retires:
        applied = "complete" in outcomes
    else:
        applied = verdict == "ok"

    attrs: Dict[str, Any] = {"verdict": verdict}
    tier = next((r.get("tier") for r in rows if r.get("tier") is not None),
                None)
    if tier is not None:
        attrs["tier"] = int(tier)
    rid = next((r.get("request_id") for r in rows if r.get("request_id")),
               None)
    if rid is not None:
        attrs["request_id"] = str(rid)
    # SLO latencies: the forwarded route echoes the replica's measured
    # values, so router-run-dir-only assembly still attributes them; a
    # replica-local span set falls back to the retire span's copies
    src_rows = ([rt for rt in routes
                 if str(rt.get("verdict")) == "forwarded"]
                + [r for r in retires if r.get("outcome") == "complete"])
    for k in ("ttft_ms", "tpot_ms"):
        v = next((r.get(k) for r in src_rows if r.get(k) is not None), None)
        if v is not None:
            attrs[k] = float(v)
    if attempts:
        attrs["attempts"] = attempts
        replicas = [a["replica"] for a in attempts if a["replica"]]
        attrs["replicas"] = sorted(set(replicas))

    return Round(
        trace_id=str(rows[0].get("trace_id", key)) if rows else key,
        update_id=None, kind="request", applied=applied,
        wall_ms=wall, phases=phases, bound_by=bound, overlap_ms=overlap,
        idle_ms=idle, gaps=gaps, retries=failovers,
        apply_spans=len(forwarded), span_count=len(rows),
        attrs=attrs,
    )


def assemble(rows: Iterable[Dict[str, Any]], skipped: int = 0) -> Assembly:
    """Stitch span rows (any order, any role mix) into rounds.

    Rows with no ``trace_id`` are orphans. Traces sharing an
    ``update_id`` merge into one round (reconnect redelivery); a trace
    with a ``round`` root span assembles as an in-process step round."""
    rows = [r for r in rows if isinstance(r, dict)]
    orphans = [r for r in rows if not r.get("trace_id")]
    traced = [r for r in rows if r.get("trace_id")]
    offsets = _domain_offsets(traced)

    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for r in traced:
        by_trace.setdefault(str(r["trace_id"]), []).append(r)

    # merge traces that name the same update (chaos: cached re-upload of a
    # redelivered batch rides the original trace; its fresh dispatch does
    # not — both describe the one applied update)
    trace_update: Dict[str, Optional[str]] = {}
    trace_request: Dict[str, Optional[str]] = {}
    for tid, group in by_trace.items():
        uids = {r.get("update_id") for r in group if r.get("update_id")}
        trace_update[tid] = sorted(uids)[0] if len(uids) == 1 else None
        rids = {r.get("request_id") for r in group if r.get("request_id")}
        trace_request[tid] = sorted(rids)[0] if len(rids) == 1 else None

    merged: Dict[str, List[Dict[str, Any]]] = {}
    for tid, group in sorted(by_trace.items()):
        uid = trace_update[tid]
        # request rounds merge on the idempotency key (§11): a client
        # retry that re-sends the same request_id under a fresh trace
        # still describes the one answered request, exactly like the
        # update_id merge above
        rid = trace_request[tid] if _is_request_trace(group) else None
        key = (f"u:{uid}" if uid
               else f"r:{rid}" if rid else f"t:{tid}")
        merged.setdefault(key, []).extend(group)

    rounds: List[Round] = []
    for key, group in sorted(merged.items()):
        group.sort(key=lambda r: _interval(r, offsets)[0])
        if any(r.get("name") == "round" for r in group):
            # one step round per root (a merged key never mixes kinds)
            roots = [r for r in group if r.get("name") == "round"]
            for root in roots:
                tid = str(root["trace_id"])
                rounds.append(_assemble_step_round(
                    tid, [r for r in group if r.get("trace_id") == tid],
                    offsets))
        elif _is_request_trace(group):
            rounds.append(_assemble_request_round(key, group, offsets))
        else:
            rounds.append(_assemble_wire_round(key, group, offsets))
    return Assembly(rounds=rounds, orphans=orphans, skipped=skipped)


def assemble_dir(run_dir: str) -> Assembly:
    """Assemble a run directory's ``spans.jsonl`` (malformed lines are
    counted, not fatal — a crashed run truncates its last line)."""
    from distriflow_tpu_torch.obs.tracing import SPANS_FILENAME
    from distriflow_tpu_torch.utils.metrics_log import read_metrics_counted

    path = os.path.join(run_dir, SPANS_FILENAME)
    if not os.path.exists(path):
        return Assembly(rounds=[], orphans=[], skipped=0)
    rows, skipped = read_metrics_counted(path)
    return assemble(rows, skipped=skipped)


def render_requests(assembly: Assembly, max_rounds: int = 20,
                    tier: Optional[int] = None) -> List[str]:
    """Request-round timelines + per-tier attribution table for
    ``dump --requests [--tier N]`` (docs/OBSERVABILITY.md §11)."""
    lines: List[str] = []
    reqs = assembly.requests()
    if tier is not None:
        reqs = [r for r in reqs if r.attrs.get("tier") == tier]
    agg = assembly.request_attribution()
    lines.append(
        f"requests: {agg['requests']} assembled, {agg['committed']} "
        f"committed, {agg['orphans']} orphan span(s)"
        + (f" (showing tier {tier}: {len(reqs)})" if tier is not None
           else ""))
    for r in reqs[:max_rounds]:
        rid = str(r.attrs.get("request_id", "-"))[:12]
        t = r.attrs.get("tier", "-")
        hops = " -> ".join(
            f"{a['replica'] or '?'}[{a['verdict']}]"
            for a in r.attrs.get("attempts", ())) or "(direct)"
        slo = ""
        if r.attrs.get("ttft_ms") is not None:
            slo = f" ttft={r.attrs['ttft_ms']:.1f}ms"
        if r.attrs.get("tpot_ms") is not None:
            slo += f" tpot={r.attrs['tpot_ms']:.2f}ms"
        top = sorted(r.phases.items(), key=lambda kv: -kv[1])[:3]
        top_s = " ".join(f"{k}={v:.1f}ms" for k, v in top)
        lines.append(
            f"  {r.trace_id[:8]}/{rid} tier={t} {r.attrs['verdict']} "
            f"wall={r.wall_ms:.1f}ms{slo} bound_by={r.bound_by} {top_s}")
        lines.append(f"    attempts: {hops}")
    if len(reqs) > max_rounds:
        lines.append(f"  (+{len(reqs) - max_rounds} more requests)")
    if agg["tiers"]:
        lines.append("per-tier SLO attribution:")
        lines.append("  tier  reqs  commit  shed  failover  "
                     "ttft_p50/p99 ms   tpot_p50/p99 ms")
        for t, row in agg["tiers"].items():
            def _fmt(a: Optional[float], b: Optional[float]) -> str:
                if a is None:
                    return "-/-"
                return f"{a:.1f}/{b:.1f}"
            lines.append(
                f"  {t:>4}  {row['requests']:>4}  {row['committed']:>6}  "
                f"{row['shed']:>4}  {row['failovers']:>8}  "
                f"{_fmt(row['ttft_p50_ms'], row['ttft_p99_ms']):>15}  "
                f"{_fmt(row['tpot_p50_ms'], row['tpot_p99_ms']):>15}")
    return lines


def render(assembly: Assembly, max_rounds: int = 20) -> List[str]:
    """Human-readable round + attribution tables for the dump CLI."""
    lines: List[str] = []
    agg = assembly.attribution()
    lines.append(
        f"rounds: {agg['rounds']} assembled, {agg['applied']} applied, "
        f"{agg['retries']} retried upload(s), "
        f"{agg['dedup_deliveries']} dedup-suppressed deliver(ies), "
        f"{agg['orphans']} orphan span(s)")
    if assembly.skipped:
        lines.append(f"  ({assembly.skipped} malformed jsonl line(s) skipped)")
    shown = assembly.rounds[:max_rounds]
    for r in shown:
        uid = (r.update_id or "-")[:8]
        top = sorted(r.phases.items(), key=lambda kv: -kv[1])[:3]
        top_s = " ".join(f"{k}={v:.1f}ms" for k, v in top)
        lines.append(
            f"  {r.trace_id[:8]}/{uid} [{r.kind}] "
            f"{'applied' if r.applied else 'unapplied'} "
            f"wall={r.wall_ms:.1f}ms bound_by={r.bound_by} "
            f"idle={r.idle_ms:.1f}ms {top_s}")
        for before, after, ms in r.gaps[:2]:
            lines.append(f"    gap {before} -> {after}: {ms:.1f}ms")
    if len(assembly.rounds) > max_rounds:
        lines.append(f"  (+{len(assembly.rounds) - max_rounds} more rounds)")
    if agg["applied"]:
        lines.append(
            f"critical path (mean/applied round, wall {agg['wall_ms']}ms): "
            f"bound_by={agg['bound_by']} overlap={agg['overlap_ms']}ms "
            f"idle={agg['idle_ms']}ms")
        for phase, ms in sorted(agg["phase_mean_ms"].items(),
                                key=lambda kv: -kv[1]):
            bound_n = agg["bound_counts"].get(phase, 0)
            lines.append(f"  {phase:<12} {ms:>10.2f} ms"
                         + (f"  (bounds {bound_n} round(s))" if bound_n
                            else ""))
    return lines
