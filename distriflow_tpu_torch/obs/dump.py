"""Port of ``distriflow_tpu/obs/dump.py`` (copied with its imports rewritten).

Offline run summary: ``python -m distriflow_tpu_torch.obs.dump <dir>``.

Reads a run directory's ``metrics.jsonl`` and ``spans.jsonl`` (both
optional — missing files are reported, not fatal) and prints:

- the latest telemetry snapshot row's counters/gauges,
- per-span-name duration stats (count, p50/p95 ms, error count),
- trace linkage: how many traces have both a client-side ``upload`` span
  and a server-side ``apply`` span (the cross-endpoint join wire tracing
  exists to provide), and how many upload spans recorded a reconnect.

Malformed JSONL lines (a crashed run truncates its last line) are
skipped and COUNTED, never fatal — each summary reports its skipped
count.

``--critical-path`` runs the trace assembler over ``spans.jsonl``
instead: per-round tables (wall, bound_by, idle, top phases, gaps) plus
the aggregate critical-path attribution — see ``docs/OBSERVABILITY.md``
§9 for the taxonomy.

``--requests [--tier N]`` assembles the serving request rounds instead
(docs/OBSERVABILITY.md §11): per-request timelines with the failover
attempt chain and the per-SLO-tier TTFT/TPOT attribution table.

``--flight`` additionally summarizes the postmortem bundles the flight
recorder wrote under ``<dir>/flight/`` (trigger, event counts, context —
see ``docs/OBSERVABILITY.md``). ``--watch`` tails the run live instead:
every ``--interval`` seconds it re-reads the latest snapshot row and
prints which counters/gauges moved (``--iterations`` bounds the loop;
0 = forever).

``--timeline`` renders the run's ``timeline.jsonl`` (written when the
run was started with a timeline sampling interval — see
``docs/OBSERVABILITY.md`` §12): per-ident ASCII sparklines on a shared
time axis, an event-marker strip (controller adaptations/ramps, churn
kills/rejoins, SLO breaches, quarantines, resyncs), and a timestamped
event legend. ``--window S`` clips to the trailing S seconds;
``--idents a,b`` overrides the auto-picked movers. ``--watch`` shares
the same machinery: each poll feeds the latest snapshot row into an
in-memory timeline store and prints windowed deltas across the last two
samples.

``--fleet`` renders the fleet telemetry plane (docs/OBSERVABILITY.md
§10) from a SERVER's run dir: the per-client table (connection state,
server-observed round latency, and the client-authoritative columns the
collector folded in — fit_ms/submit_ms phase digests, host, RSS/CPU)
plus the ``fleet/*`` aggregate gauges. ``--fleet --watch`` re-renders
the live table every ``--interval`` seconds.

Exit code is 0 when at least one summarized source existed, 2 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List

from distriflow_tpu_torch.obs.tracing import SPANS_FILENAME
from distriflow_tpu_torch.utils.metrics_log import read_metrics, read_metrics_counted

METRICS_FILENAME = "metrics.jsonl"


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _rows_line(kind: str, path: str, rows: List[Any],
               skipped: int) -> str:
    line = f"{kind}: {len(rows)} rows ({path})"
    if skipped:
        line += f" [{skipped} malformed line(s) skipped]"
    return line


def summarize_metrics(path: str) -> List[str]:
    rows, skipped = read_metrics_counted(path)
    lines = [_rows_line("metrics", path, rows, skipped)]
    snaps = [r for r in rows if r.get("kind") == "telemetry_snapshot"]
    if snaps:
        last = snaps[-1]
        lines.append(f"  latest snapshot ({len(snaps)} total):")
        for key in sorted(last):
            if key.startswith(("counter:", "gauge:")):
                lines.append(f"    {key.split(':', 1)[1]} = {last[key]:g}")
    return lines


#: per-client columns rendered first (when present), in this order; any
#: other non-underscore column the row carries follows alphabetically
_FLEET_COLS = ("client", "host", "connected", "uploads", "round_ms",
               "fit_ms", "submit_ms", "rss_bytes", "cpu_s", "staleness",
               "report_seq")


def _fleet_lines(row: Dict[str, Any]) -> List[str]:
    """Render one snapshot row's fleet table + fleet/* aggregates."""
    lines: List[str] = []
    fleet = row.get("fleet")
    if isinstance(fleet, dict) and fleet:
        lines.append(f"  clients ({len(fleet)}):")
        for cid in sorted(fleet):
            r = fleet[cid]
            if not isinstance(r, dict):
                continue
            parts = [f"conn={cid[:8]}"]
            shown = set()
            for col in _FLEET_COLS:
                if col in r and r[col] is not None:
                    v = r[col]
                    parts.append(f"{col}={str(v)[:12]}")
                    shown.add(col)
            for col in sorted(r):
                if col not in shown and r[col] is not None:
                    parts.append(f"{col}={str(r[col])[:12]}")
            lines.append("    " + " ".join(parts))
    else:
        lines.append("  clients: (no fleet rows in the latest snapshot)")
    aggregates = sorted(k for k in row
                        if k.startswith("gauge:fleet/"))
    if aggregates:
        lines.append("  aggregates:")
        for k in aggregates:
            lines.append(f"    {k.split(':', 1)[1]} = {row[k]:g}")
    return lines


def summarize_fleet(run_dir: str) -> List[str]:
    """The live fleet view from a server run dir's latest snapshot row."""
    path = os.path.join(run_dir, METRICS_FILENAME)
    if not os.path.exists(path):
        return [f"(no {METRICS_FILENAME} in {run_dir} — is this the "
                f"server's run dir?)"]
    rows, skipped = read_metrics_counted(path)
    snaps = [r for r in rows if r.get("kind") == "telemetry_snapshot"]
    lines = [_rows_line("fleet", path, snaps, skipped)]
    if not snaps:
        lines.append("  (no telemetry_snapshot rows yet)")
        return lines
    return lines + _fleet_lines(snaps[-1])


def watch_fleet(run_dir: str, interval: float, iterations: int) -> int:
    """Live fleet mode: re-render the per-client table every poll."""
    metrics_path = os.path.join(run_dir, METRICS_FILENAME)
    seen = False
    i = 0
    while iterations <= 0 or i < iterations:
        if i:  # no sleep before the first poll (mirrors watch())
            time.sleep(interval)
        i += 1
        if not os.path.exists(metrics_path):
            print(f"fleet[{i}] (waiting for {METRICS_FILENAME} in "
                  f"{run_dir})", flush=True)
            continue
        seen = True
        rows = [r for r in read_metrics(metrics_path)
                if r.get("kind") == "telemetry_snapshot"]
        if not rows:
            print(f"fleet[{i}] (no telemetry_snapshot rows yet)", flush=True)
            continue
        print(f"fleet[{i}] {len(rows)} snapshot(s):", flush=True)
        print("\n".join(_fleet_lines(rows[-1])), flush=True)
    return 0 if seen else 2


def summarize_spans(path: str) -> List[str]:
    rows, skipped = read_metrics_counted(path)
    lines = [_rows_line("spans", path, rows, skipped)]

    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_name.setdefault(r.get("name", "?"), []).append(r)
    for name in sorted(by_name):
        spans = by_name[name]
        durs = sorted(float(s.get("dur_ms", 0.0)) for s in spans)
        errors = sum(1 for s in spans
                     if str(s.get("status", "ok")) != "ok")
        lines.append(
            f"  {name}: n={len(spans)} p50={_pctl(durs, 0.5):.2f}ms "
            f"p95={_pctl(durs, 0.95):.2f}ms errors={errors}")

    traces: Dict[str, set] = {}
    for r in rows:
        tid = r.get("trace_id")
        if tid:
            traces.setdefault(tid, set()).add(r.get("name"))
    linked = sum(1 for names in traces.values()
                 if "upload" in names and "apply" in names)
    reconnect_spanning = sum(
        1 for r in rows
        if r.get("name") == "upload"
        and float(r.get("reconnects_spanned", 0) or 0) > 0)
    lines.append(f"  traces: {len(traces)} total, "
                 f"{linked} with linked upload+apply spans, "
                 f"{reconnect_spanning} uploads spanning a reconnect")
    return lines


def summarize_flight(run_dir: str) -> List[str]:
    from distriflow_tpu_torch.obs.flight_recorder import FLIGHT_DIRNAME, read_bundles

    bundles = read_bundles(run_dir)
    lines = [f"flight: {len(bundles)} bundle(s) "
             f"({os.path.join(run_dir, FLIGHT_DIRNAME)})"]
    for b in bundles:
        events = b.get("events", [])
        kinds: Dict[str, int] = {}
        for e in events:
            k = str(e.get("kind", "?"))
            kinds[k] = kinds.get(k, 0) + 1
        dropped = int(b.get("events_dropped", 0) or 0)
        line = (f"  {b.get('_file')}: trigger={b.get('trigger')} "
                f"pid={b.get('pid')} events={len(events)}")
        if dropped:
            line += f" (+{dropped} dropped for size)"
        if kinds:
            line += " [" + " ".join(
                f"{k}x{n}" for k, n in sorted(kinds.items())) + "]"
        lines.append(line)
        ctx = b.get("context") or {}
        if ctx:
            lines.append("    context: " + ", ".join(
                f"{k}={v}" for k, v in sorted(ctx.items())))
    return lines


def summarize_critical_path(run_dir: str, max_rounds: int = 20) -> List[str]:
    """Assemble ``spans.jsonl`` into rounds and render the attribution."""
    from distriflow_tpu_torch.obs.trace_assembler import assemble_dir, render

    spans_path = os.path.join(run_dir, SPANS_FILENAME)
    if not os.path.exists(spans_path):
        return [f"(no {SPANS_FILENAME} in {run_dir} — nothing to assemble)"]
    assembly = assemble_dir(run_dir)
    return [f"critical path ({spans_path}):"] + render(
        assembly, max_rounds=max_rounds)


def summarize_requests(run_dir: str, max_rounds: int = 20,
                       tier: int = None) -> List[str]:
    """Assemble ``spans.jsonl`` and render the serving request rounds
    (docs/OBSERVABILITY.md §11): per-request timelines with failover
    attempt chains plus the per-SLO-tier TTFT/TPOT table."""
    from distriflow_tpu_torch.obs.trace_assembler import (assemble_dir,
                                                    render_requests)

    spans_path = os.path.join(run_dir, SPANS_FILENAME)
    if not os.path.exists(spans_path):
        return [f"(no {SPANS_FILENAME} in {run_dir} — nothing to assemble)"]
    assembly = assemble_dir(run_dir)
    return [f"serving requests ({spans_path}):"] + render_requests(
        assembly, max_rounds=max_rounds, tier=tier)


#: sparkline glyphs, 0 = empty bin; values map onto indices 1..8
_SPARK = " ▁▂▃▄▅▆▇█"

#: event-kind -> single-letter axis marker (anything else renders "*")
_EVENT_LETTERS = {
    "controller_adapt": "A",
    "controller_ramp": "R",
    "churn_kill": "K",
    "churn_rejoin": "J",
    "slo_breach": "B",
    "quarantine": "Q",
    "resync": "S",
    "rollback": "L",
    "lease_expiry": "E",
}


def _bin_index(t: float, t_lo: float, t_hi: float, width: int) -> int:
    if t_hi <= t_lo:
        return 0
    return min(width - 1, max(0, int((t - t_lo) / (t_hi - t_lo) * width)))


def _sparkline(bins: List[Any]) -> str:
    """Render per-bin values (None = no data) as a ``▁▂▃▄▅▆▇█`` strip."""
    present = [v for v in bins if v is not None]
    if not present:
        return " " * len(bins)
    lo, hi = min(present), max(present)
    out = []
    for v in bins:
        if v is None:
            out.append(" ")
        elif hi <= lo:
            out.append(_SPARK[5])  # flat series: mid-height
        else:
            out.append(_SPARK[1 + int(round((v - lo) / (hi - lo) * 7.0))])
    return "".join(out)


def _bin_deltas(samples: List[Dict[str, Any]], values: List[Any],
                t_lo: float, t_hi: float, width: int) -> List[Any]:
    """Per-bin increase of a cumulative series (counter values or
    histogram counts); a bin stays None until a sample-to-sample delta
    lands in it."""
    bins: List[Any] = [None] * width
    prev = None
    for s, cur in zip(samples, values):
        if cur is None:
            continue
        if prev is not None and t_lo <= s["t"] <= t_hi:
            b = _bin_index(s["t"], t_lo, t_hi, width)
            bins[b] = (bins[b] or 0.0) + max(0.0, float(cur) - prev)
        prev = float(cur)
    return bins


def _bin_means(samples: List[Dict[str, Any]], values: List[Any],
               t_lo: float, t_hi: float, width: int) -> List[Any]:
    """Per-bin mean of a point-in-time series (gauge values)."""
    sums = [0.0] * width
    counts = [0] * width
    for s, v in zip(samples, values):
        if v is None or not (t_lo <= s["t"] <= t_hi):
            continue
        b = _bin_index(s["t"], t_lo, t_hi, width)
        sums[b] += float(v)
        counts[b] += 1
    return [sums[i] / counts[i] if counts[i] else None
            for i in range(width)]


def _timeline_pick_idents(store: Any, samples: List[Dict[str, Any]],
                          window_s: float) -> List[Any]:
    """Auto-select the idents worth plotting: the counters that moved
    most, the gauges that swung most, the histograms that observed most.
    Returns ``[(kind, ident), ...]``."""
    newest = samples[-1]
    ranked = []
    for k in newest["counters"]:
        ranked.append((abs(store.delta(k, window_s) or 0.0), "counter", k))
    for k in newest["gauges"]:
        st = store.gauge_stats(k, window_s)
        ranked.append(((st["max"] - st["min"]) if st else 0.0, "gauge", k))
    for k in newest["hists"]:
        d = store.hist_delta(k, window_s)
        ranked.append((float(d["count"]) if d else 0.0, "hist", k))
    ranked.sort(key=lambda r: -r[0])
    moved = [(kind, k) for score, kind, k in ranked if score > 0.0]
    picks = ([(k, i) for k, i in moved if k == "counter"][:4]
             + [(k, i) for k, i in moved if k == "gauge"][:2]
             + [(k, i) for k, i in moved if k == "hist"][:2])
    for score, kind, k in ranked:  # pad flat runs up to a useful minimum
        if len(picks) >= 3:
            break
        if (kind, k) not in picks:
            picks.append((kind, k))
    return picks


def _timeline_resolve_idents(samples: List[Dict[str, Any]],
                             wanted: List[str]) -> List[Any]:
    """Map ``--idents`` entries (exact ident, or bare metric name
    matching every labeled ident of that metric) to ``(kind, ident)``."""
    newest = samples[-1]
    kinds = {}
    for kind in ("counter", "gauge", "hist"):
        for k in newest[kind + "s"]:
            kinds[k] = kind
    out = []
    for want in wanted:
        if want in kinds:
            out.append((kinds[want], want))
            continue
        hits = [k for k in sorted(kinds) if k.split("{", 1)[0] == want]
        out.extend((kinds[k], k) for k in hits)
        if not hits:
            out.append((None, want))  # rendered as a "(not found)" row
    return out


def summarize_timeline(run_dir: str, window_s: float = None,
                       idents: List[str] = None,
                       width: int = 60) -> "tuple[List[str], bool]":
    """Render the run timeline — per-ident sparklines with event markers
    on a shared time axis — from ``timeline.jsonl`` alone. Returns
    ``(lines, found)``."""
    from distriflow_tpu_torch.obs.timeline import TIMELINE_FILENAME, TimelineStore

    path = run_dir
    if not path.endswith(".jsonl"):
        path = os.path.join(run_dir, TIMELINE_FILENAME)
    if not os.path.exists(path):
        return [f"(no {TIMELINE_FILENAME} in {run_dir} — was the run "
                f"started with a timeline interval?)"], False
    store = TimelineStore.load(path)
    samples = store.samples()
    events = store.events()
    head = f"timeline: {len(samples)} sample(s), {len(events)} event(s)"
    if store.skipped:
        head += f" [{store.skipped} malformed line(s) skipped]"
    head += f" ({path})"
    lines = [head]
    if not samples:
        lines.append("  (no samples)")
        return lines, True
    # the shared axis spans samples AND events: a breach stamped after
    # the final sample (e.g. a post-run sentinel check) must still land
    # on the strip instead of being clipped
    all_t = [s["t"] for s in samples] + [e["t"] for e in events]
    t_hi = max(all_t)
    t_lo = min(all_t)
    if window_s is not None:
        t_lo = max(t_lo, t_hi - float(window_s))
        samples = [s for s in samples if s["t"] >= t_lo]
        events = [e for e in events if e["t"] >= t_lo]
        if not samples:
            lines.append(f"  (no samples in the trailing {window_s:g}s)")
            return lines, True
    span = t_hi - t_lo
    # size the window queries to the clipped axis so stats match the strip
    q_window = span + 1e-9 if span > 0 else None
    if idents:
        picked = _timeline_resolve_idents(samples, idents)
    else:
        picked = _timeline_pick_idents(store, samples, q_window)
    lines.append(f"  span={span:.2f}s bins={width} "
                 f"bin={span / width * 1000.0:.0f}ms" if span > 0
                 else f"  span=0.00s (single instant)")
    label_w = max([len(i) for _, i in picked] + [6])
    label_w = min(label_w, 40)
    for kind, ident in picked:
        label = ident[:label_w].ljust(label_w)
        if kind is None:
            lines.append(f"  {label} (not found in the newest sample)")
            continue
        if kind == "counter":
            vals = [s["counters"].get(ident) for s in samples]
            bins = _bin_deltas(samples, vals, t_lo, t_hi, width)
            d = store.delta(ident, q_window) or 0.0
            r = store.rate(ident, q_window)
            note = f"delta={d:g}" + (f" rate={r:.3g}/s" if r is not None
                                     else "")
        elif kind == "gauge":
            vals = [s["gauges"].get(ident) for s in samples]
            bins = _bin_means(samples, vals, t_lo, t_hi, width)
            st = store.gauge_stats(ident, q_window)
            note = (f"min={st['min']:g} mean={st['mean']:g} "
                    f"max={st['max']:g}" if st else "")
        else:
            vals = [(s["hists"].get(ident) or {}).get("count")
                    for s in samples]
            bins = _bin_deltas(samples, vals, t_lo, t_hi, width)
            summ = store.window_summary(ident, q_window)
            note = (f"n={summ['count']:g} p50={summ['p50']:g} "
                    f"p95={summ['p95']:g}" if summ else "n=0")
        lines.append(f"  {label} |{_sparkline(bins)}| {note}")
    # event marker strip on the same axis
    marker = [" "] * width
    for e in events:
        b = _bin_index(e["t"], t_lo, t_hi, width)
        letter = _EVENT_LETTERS.get(e["kind"], "*")
        marker[b] = letter if marker[b] in (" ", letter) else "*"
    lines.append(f"  {'events'.ljust(label_w)} |{''.join(marker)}| "
                 f"{len(events)} event(s)")
    shown = events[:20]
    for e in shown:
        letter = _EVENT_LETTERS.get(e["kind"], "*")
        fields = " ".join(f"{k}={e[k]}" for k in sorted(e)
                          if k not in ("t", "kind"))
        lines.append(f"    +{e['t'] - t_lo:.2f}s {letter} {e['kind']}"
                     + (f" {fields}" if fields else ""))
    if len(events) > len(shown):
        lines.append(f"    (+{len(events) - len(shown)} more)")
    return lines, True


def _snapshot_scalars(row: Dict[str, Any]
                      ) -> "tuple[Dict[str, float], Dict[str, float]]":
    """Split one flattened snapshot row back into counter/gauge maps."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    for k, v in row.items():
        if not isinstance(v, (int, float)):
            continue
        if k.startswith("counter:"):
            counters[k.split(":", 1)[1]] = float(v)
        elif k.startswith("gauge:"):
            gauges[k.split(":", 1)[1]] = float(v)
    return counters, gauges


def watch(run_dir: str, interval: float, iterations: int) -> int:
    """Live mode: feed each polled snapshot row into an offline
    :class:`~distriflow_tpu_torch.obs.timeline.TimelineStore` and print the
    windowed movement between the last two samples — the same delta
    machinery ``--timeline`` rates come from. Returns 0 once a metrics
    file was seen."""
    from distriflow_tpu_torch.obs.timeline import TimelineStore

    metrics_path = os.path.join(run_dir, METRICS_FILENAME)
    store = TimelineStore()  # offline: fed by hand, no thread, no sink
    seen = False
    i = 0
    while iterations <= 0 or i < iterations:
        if i:  # no sleep before the first poll: --iterations 1 is instant
            time.sleep(interval)
        i += 1
        if not os.path.exists(metrics_path):
            print(f"watch[{i}] (waiting for {METRICS_FILENAME} in "
                  f"{run_dir})", flush=True)
            continue
        seen = True
        rows = [r for r in read_metrics(metrics_path)
                if r.get("kind") == "telemetry_snapshot"]
        if not rows:
            print(f"watch[{i}] (no telemetry_snapshot rows yet)", flush=True)
            continue
        counters, gauges = _snapshot_scalars(rows[-1])
        t = float(rows[-1].get("snapshot_time") or time.time())
        samples = store.samples()
        fresh = not samples or t > samples[-1]["t"]
        if fresh:
            store.add_sample(t, counters, gauges)
            samples = store.samples()
        parts = []
        n_changed = 0
        if fresh and len(samples) == 1:
            # first sample: everything is new, show absolute values
            idents = sorted(set(counters) | set(gauges))
            n_changed = len(idents)
            parts = [f"{k}={counters.get(k, gauges.get(k)):g}"
                     for k in idents[:12]]
        elif fresh:
            # windowed delta across the last two samples — the same
            # edge-subtraction --timeline rates come from
            # epsilon so t1 - window_s lands at-or-before the previous
            # sample's exact timestamp despite float rounding
            dt = samples[-1]["t"] - samples[-2]["t"] + 1e-9
            for k in sorted(set(counters) | set(gauges)):
                d = store.delta(k, window_s=dt)
                if not d:
                    continue
                n_changed += 1
                if n_changed <= 12:
                    cur = counters.get(k, gauges.get(k))
                    parts.append(f"{k} {cur - d:g}->{cur:g}")
        if n_changed > 12:
            parts.append(f"(+{n_changed - 12} more)")
        print(f"watch[{i}] {len(rows)} snapshot(s); "
              + ("; ".join(parts) if parts else "no change"), flush=True)
    return 0 if seen else 2


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distriflow_tpu_torch.obs.dump",
        description="Summarize a run directory's metrics.jsonl/spans.jsonl.")
    parser.add_argument("run_dir", help="directory holding the JSONL files")
    parser.add_argument("--flight", action="store_true",
                        help="also summarize flight-recorder bundles")
    parser.add_argument("--critical-path", action="store_true",
                        help="assemble spans.jsonl into rounds and print "
                             "per-round + aggregate critical-path "
                             "attribution")
    parser.add_argument("--max-rounds", type=int, default=20,
                        help="cap per-round lines in --critical-path "
                             "output (default 20)")
    parser.add_argument("--requests", action="store_true",
                        help="assemble spans.jsonl into serving request "
                             "rounds and print per-request timelines + "
                             "the per-tier TTFT/TPOT attribution table")
    parser.add_argument("--tier", type=int, default=None,
                        help="with --requests: only list requests of this "
                             "SLO tier (the aggregate table always covers "
                             "all tiers)")
    parser.add_argument("--fleet", action="store_true",
                        help="render the fleet telemetry plane (per-client "
                             "table + fleet/* aggregates) from a server "
                             "run dir")
    parser.add_argument("--timeline", action="store_true",
                        help="render timeline.jsonl as per-ident "
                             "sparklines with event markers on a shared "
                             "time axis")
    parser.add_argument("--window", type=float, default=None,
                        help="with --timeline: only the trailing WINDOW "
                             "seconds (default: the whole run)")
    parser.add_argument("--idents", type=str, default=None,
                        help="with --timeline: comma-separated idents (or "
                             "bare metric names) to plot instead of the "
                             "auto-picked movers")
    parser.add_argument("--watch", action="store_true",
                        help="poll the latest snapshot and print deltas "
                             "(with --fleet: re-render the live table)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between --watch polls (default 2)")
    parser.add_argument("--iterations", type=int, default=0,
                        help="stop --watch after N polls (0 = forever)")
    args = parser.parse_args(argv)

    if args.fleet and args.watch:
        return watch_fleet(args.run_dir, args.interval, args.iterations)

    if args.fleet:
        print("\n".join(summarize_fleet(args.run_dir)))
        return 0 if os.path.exists(
            os.path.join(args.run_dir, METRICS_FILENAME)) else 2

    if args.timeline:
        wanted = ([s.strip() for s in args.idents.split(",") if s.strip()]
                  if args.idents else None)
        lines, found = summarize_timeline(
            args.run_dir, window_s=args.window, idents=wanted)
        print("\n".join(lines))
        return 0 if found else 2

    if args.watch:
        return watch(args.run_dir, args.interval, args.iterations)

    if args.requests:
        spans_path = os.path.join(args.run_dir, SPANS_FILENAME)
        print("\n".join(summarize_requests(
            args.run_dir, max_rounds=args.max_rounds, tier=args.tier)))
        return 0 if os.path.exists(spans_path) else 2

    if args.critical_path:
        spans_path = os.path.join(args.run_dir, SPANS_FILENAME)
        print("\n".join(summarize_critical_path(
            args.run_dir, max_rounds=args.max_rounds)))
        return 0 if os.path.exists(spans_path) else 2

    metrics_path = os.path.join(args.run_dir, METRICS_FILENAME)
    spans_path = os.path.join(args.run_dir, SPANS_FILENAME)
    found = False
    for path, fn in ((metrics_path, summarize_metrics),
                     (spans_path, summarize_spans)):
        if os.path.exists(path):
            found = True
            print("\n".join(fn(path)))
        else:
            print(f"(no {os.path.basename(path)} in {args.run_dir})")
    if args.flight:
        lines = summarize_flight(args.run_dir)
        found = found or len(lines) > 1  # bundles count as a found source
        print("\n".join(lines))
    return 0 if found else 2


if __name__ == "__main__":
    sys.exit(main())
