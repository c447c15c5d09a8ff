"""Port of ``distriflow_tpu/obs/collector.py``: the client-side
``ReportBuilder`` and the server-side ``TelemetryCollector``.

A report is delta-encoded in its keys and cumulative in its values: each
build ships every metric that changed since the last build (or all of
them, when ``full``), so a dropped report is healed by the next one and a
duplicate is idempotent. Reports ride a training client's upload metadata
or an inference client's heartbeat; the servers' :class:`TelemetryCollector`
merges them (``fleet/<metric>`` gauges, client columns of the
``FleetTable``, shipped span rows in the server's ``spans.jsonl``).
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from distriflow_tpu_torch.obs.registry import Histogram, metric_ident, parse_ident

REPORT_VERSION = 1

#: fleet-namespace prefix: idents under it are the collector's OWN output
#: and are never shipped back out by a builder (a client sharing the
#: server's Telemetry — the loopback tests — must not echo aggregates).
FLEET_PREFIX = "fleet/"

_DEFAULT_MAX_SPANS = 64
_DEFAULT_MAX_HIST_WINDOW = 256
_SPAN_LRU = 8192


class ReportBuilder:
    """Client-side report factory: delta-encoded keys, cumulative values.

    One builder per client identity. NOT thread-safe by itself — the
    client calls :meth:`build` from the one thread that sends uploads
    (or heartbeats), which is also the only place the interval gate
    lives. :meth:`reset` (called from the reconnect path) only sets a
    flag, so cross-thread use of *that* is fine.
    """

    def __init__(self, telemetry: Any, client_id: str,
                 max_spans: int = _DEFAULT_MAX_SPANS,
                 max_hist_window: int = _DEFAULT_MAX_HIST_WINDOW):
        self.telemetry = telemetry
        self.client_id = str(client_id)
        self.max_spans = int(max_spans)
        self.max_hist_window = int(max_hist_window)
        self.host = socket.gethostname()
        self._seq = 0                     # monotonic across resets
        self._full_next = True            # first report is always full
        self._shipped_counters: Dict[str, float] = {}
        self._shipped_gauges: Dict[str, float] = {}
        self._shipped_hist_counts: Dict[str, int] = {}
        self._last_span_id: Optional[str] = None

    def reset(self) -> None:
        """Arm the full-snapshot fallback: the next report re-ships every
        metric. Called after a reconnect handshake, when the server may
        be fresh (restart) or may have missed in-flight deltas."""
        self._full_next = True

    # dfcheck: payload -> report
    def build(self) -> Dict[str, Any]:
        """One report: everything changed since the last build (or
        everything, when full). Values are cumulative — see module doc."""
        run = getattr(self.telemetry, "run_samplers", None)
        if run is not None:
            run()  # pull-gauge refresh (process sampler et al.)
        reg = self.telemetry.registry
        snap = reg.snapshot()
        full = self._full_next
        self._full_next = False
        self._seq += 1

        counters: Dict[str, float] = {}
        for ident, v in snap["counters"].items():
            if ident.startswith(FLEET_PREFIX):
                continue
            if full or self._shipped_counters.get(ident) != v:
                counters[ident] = v
                self._shipped_counters[ident] = v
        gauges: Dict[str, float] = {}
        for ident, v in snap["gauges"].items():
            if ident.startswith(FLEET_PREFIX):
                continue
            if full or self._shipped_gauges.get(ident) != v:
                gauges[ident] = v
                self._shipped_gauges[ident] = v
        hists: Dict[str, Dict[str, Any]] = {}
        for ident, state in reg.histogram_states(
                max_window=self.max_hist_window).items():
            if ident.startswith(FLEET_PREFIX):
                continue
            count = int(state.get("count", 0))
            if full or self._shipped_hist_counts.get(ident) != count:
                hists[ident] = state
                self._shipped_hist_counts[ident] = count

        return {
            "v": REPORT_VERSION,
            "client_id": self.client_id,
            "host": self.host,
            "pid": os.getpid(),
            "seq": self._seq,
            "full": full,
            "time": time.time(),
            "counters": counters,
            "gauges": gauges,
            "hists": hists,
            "spans": self._span_batch(),
        }

    def _span_batch(self) -> List[Dict[str, Any]]:
        """Finished-span rows newer than the last shipped one, newest
        ``max_spans`` if the high-water row already aged out of the
        tracer's bounded deque (re-shipping is safe — the collector
        dedups on span_id)."""
        rows = self.telemetry.tracer.finished()
        if self._last_span_id is not None:
            for i in range(len(rows) - 1, -1, -1):
                if rows[i].get("span_id") == self._last_span_id:
                    rows = rows[i + 1:]
                    break
        rows = rows[-self.max_spans:]
        if rows:
            self._last_span_id = rows[-1].get("span_id")
        return rows


class TelemetryCollector:
    """Server-side report sink: merge, aggregate, and re-export.

    Thread-safe; ``ingest`` is called from the upload handler (comm
    executor) and the heartbeat hook concurrently.
    """

    #: per-client state entries kept (LRU by last ingest): at hundreds of
    #: churning clients, state for departed clients must age out, not grow
    #: forever. Must exceed the number of LIVE stable clients — evicting a
    #: client that later reports a delta loses its un-refreshed idents from
    #: the fleet totals until its next full snapshot.
    MAX_CLIENTS = 1024

    def __init__(self, telemetry: Any = None, fleet: Any = None,
                 max_clients: Optional[int] = None):
        if telemetry is None:
            from distriflow_tpu_torch.obs.telemetry import get_telemetry
            telemetry = get_telemetry()
        self.telemetry = telemetry
        self.fleet = fleet  # FleetTable to fold per-client rows into
        self.max_clients = max_clients if max_clients is not None else self.MAX_CLIENTS
        self._lock = threading.Lock()
        # per-client replace-not-add state: seq high-water + latest
        # cumulative maps (counters/gauges/hists keyed by ident), bounded
        # LRU on last-ingest order
        self._clients: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()  # guarded-by: _lock
        # span_ids already written (bounded): retries/duplicates and the
        # shared-Telemetry loopback case must not duplicate rows
        self._span_seen: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()  # guarded-by: _lock
        self._span_logger = None  # guarded-by: _lock
        self.reports_ingested = 0  # guarded-by: _lock
        self.full_reports = 0  # guarded-by: _lock
        self.stale_dropped = 0  # guarded-by: _lock
        self.clients_evicted = 0  # guarded-by: _lock
        self._c_reports = telemetry.counter(
            "fleet_reports_total",
            help="client telemetry reports ingested by the collector")
        self._c_full = telemetry.counter(
            "fleet_reports_full_total",
            help="full (non-delta) telemetry reports ingested")
        self._c_stale = telemetry.counter(
            "fleet_reports_stale_total",
            help="reports dropped for stale/duplicate sequence numbers")
        self._c_evicted = telemetry.counter(
            "fleet_clients_evicted_total",
            help="client rows evicted after the retention deadline")

    # -- ingest -------------------------------------------------------------

    # dfcheck: payload report=report
    def ingest(self, client_id: str, report: Any) -> bool:
        """Merge one shipped report; returns True when it was applied
        (False: wrong version / stale seq — both counted, never raised:
        a malformed report must not take down the upload path)."""
        if not isinstance(report, dict) or report.get("v") != REPORT_VERSION:
            return False
        cid = str(report.get("client_id") or client_id)
        try:
            seq = int(report.get("seq", 0))
        except (TypeError, ValueError):
            return False
        full = bool(report.get("full"))
        with self._lock:
            st = self._clients.get(cid)
            if st is None:
                st = self._clients[cid] = {
                    "seq": 0, "counters": {}, "gauges": {}, "hists": {},
                    "host": None, "pid": None, "time": 0.0,
                }
            if seq <= st["seq"]:
                self.stale_dropped += 1
                self._c_stale.inc()
                return False
            st["seq"] = seq
            if full:
                # replace wholesale: the client re-shipped its world, and
                # anything we remembered beyond it is from a past life
                st["counters"] = dict(report.get("counters") or {})
                st["gauges"] = dict(report.get("gauges") or {})
                st["hists"] = dict(report.get("hists") or {})
                self.full_reports += 1
                self._c_full.inc()
            else:
                st["counters"].update(report.get("counters") or {})
                st["gauges"].update(report.get("gauges") or {})
                st["hists"].update(report.get("hists") or {})
            st["host"] = report.get("host")
            st["pid"] = report.get("pid")
            st["time"] = report.get("time")
            self.reports_ingested += 1
            changed_c = set(st["counters"]) if full \
                else set(report.get("counters") or {})
            changed_g = set(st["gauges"]) if full \
                else set(report.get("gauges") or {})
            # bounded LRU: this client is freshest; evict the stalest
            # beyond capacity and re-sum everything they contributed so
            # the fleet/* aggregates drop their share
            self._clients.move_to_end(cid)
            evicted = 0
            while len(self._clients) > self.max_clients:
                _, old = self._clients.popitem(last=False)
                changed_c |= set(old["counters"])
                changed_g |= set(old["gauges"])
                evicted += 1
            self.clients_evicted += evicted
        for _ in range(evicted):
            self._c_evicted.inc()
        self._c_reports.inc()
        self._refresh_fleet_gauges(changed_c, changed_g)
        self._fold_fleet_row(cid, str(client_id))
        self._write_spans(report.get("spans") or (), report.get("host"))
        return True

    # -- fleet aggregates ---------------------------------------------------

    def _refresh_fleet_gauges(self, counter_idents: Iterable[str],
                              gauge_idents: Iterable[str]) -> None:
        """Re-sum the touched idents across clients into ``fleet/<name>``
        gauges (same labels), so aggregates ride every existing export
        surface. Sums are the right fold for counters and for the
        resource gauges; point-in-time gauges where a sum is meaningless
        still expose per-client truth via the fleet table."""
        reg = self.telemetry.registry
        with self._lock:
            states = [st for st in self._clients.values()]
            for section, idents in (("counters", set(counter_idents)),
                                    ("gauges", set(gauge_idents))):
                for ident in idents:
                    if ident.startswith(FLEET_PREFIX):
                        continue
                    total = 0.0
                    for st in states:
                        v = st[section].get(ident)
                        if v is not None:
                            total += float(v)
                    name, labels = parse_ident(ident)
                    reg.gauge(FLEET_PREFIX + name, **labels).set(total)

    def totals(self, section: str = "counters") -> Dict[str, float]:
        """``{ident: sum across clients}`` of the latest cumulative
        values — what the chaos test and the doctor's fleet leg reconcile
        against per-client local snapshots."""
        out: Dict[str, float] = {}
        with self._lock:
            for st in self._clients.values():
                for ident, v in st[section].items():
                    out[ident] = out.get(ident, 0.0) + float(v)
        return out

    def client_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._clients)

    def client_state(self, client_id: str) -> Optional[Dict[str, Any]]:
        """A copy of one client's merged cumulative state (or None)."""
        with self._lock:
            st = self._clients.get(str(client_id))
            if st is None:
                return None
            return {"seq": st["seq"], "host": st["host"], "pid": st["pid"],
                    "time": st["time"],
                    "counters": dict(st["counters"]),
                    "gauges": dict(st["gauges"]),
                    "hists": dict(st["hists"])}

    def fleet_histogram(self, name: str, **labels: Any) -> Histogram:
        """A fresh histogram holding the MERGE of every client's latest
        state for ``name{labels}`` — mergeable bucket counts + union of
        windows, so fleet-wide p50/p99 queries work (the sentinel's
        fleet ack-p99 band reads this)."""
        ident = metric_ident(name, labels)
        merged = Histogram(name, {str(k): str(v) for k, v in labels.items()})
        with self._lock:
            states = [st["hists"].get(ident) for st in self._clients.values()]
        for state in states:
            if state:
                merged.merge(state)
        return merged

    # -- fleet table fold ---------------------------------------------------

    def _fold_fleet_row(self, cid: str, row_key: str) -> None:
        """Merge client-authoritative columns into the fleet table row of
        the CONNECTION the report arrived on (``row_key`` — the same key
        ``note_upload`` writes), carrying the client's stable identity as
        a column."""
        if self.fleet is None:
            return
        st = self.client_state(cid)
        if st is None:
            return
        cols: Dict[str, Any] = {"client": cid, "host": st["host"],
                                "report_seq": st["seq"]}
        for col, gauge_name in (("rss_bytes", "process_rss_bytes"),
                                ("cpu_s", "process_cpu_s")):
            v = st["gauges"].get(gauge_name)
            if v is not None:
                cols[col] = v
        # client-authoritative phase digests: recent p50 of the shipped
        # window (mean fallback when the window was trimmed away)
        for col, phase in (("fit_ms", "fit"), ("submit_ms", "submit")):
            state = st["hists"].get(
                metric_ident("phase_ms", {"phase": phase, "role": "client"}))
            if not state:
                continue
            window = state.get("window") or []
            if window:
                s = sorted(window)
                cols[col] = round(s[len(s) // 2], 3)
            elif state.get("count"):
                cols[col] = round(
                    float(state.get("sum", 0.0)) / int(state["count"]), 3)
        self.fleet.note_report(row_key, **cols)

    # -- shipped spans ------------------------------------------------------

    def _write_spans(self, rows: Iterable[Any],
                     host: Optional[str] = None) -> None:
        """Append shipped span rows to the server's own ``spans.jsonl``
        (via the tracer's writer so there is exactly one file), each
        stamped with the report's ``host`` for the assembler's
        per-(host,pid) clock alignment. Dedup on span_id covers upload
        retries, duplicated reports, AND the loopback case where client
        and server share one Telemetry (the local tracer already wrote
        the row)."""
        rows = [r for r in rows if isinstance(r, dict) and r.get("span_id")]
        if not rows:
            return
        logger = self._span_sink()
        local = {r.get("span_id")
                 for r in self.telemetry.tracer.finished()}
        with self._lock:
            for r in rows:
                sid = r["span_id"]
                if sid in self._span_seen or sid in local:
                    continue
                self._span_seen[sid] = None
                while len(self._span_seen) > _SPAN_LRU:
                    self._span_seen.popitem(last=False)
                if logger is not None:
                    out = dict(r)
                    out.setdefault("host", host)
                    logger.log(**out)

    def _span_sink(self):
        """The tracer's spans.jsonl writer when exporting; else a private
        one in ``telemetry.save_dir``; else None (in-memory-only run)."""
        t = self.telemetry.tracer
        if getattr(t, "_logger", None) is not None:
            return t._logger
        # lazy init under the lock: two handler threads ingesting reports
        # concurrently must not each build a MetricsLogger for the same
        # file (two handles interleaving writes into one spans.jsonl)
        with self._lock:
            if self._span_logger is None and self.telemetry.save_dir is not None:
                from distriflow_tpu_torch.obs.tracing import SPANS_FILENAME
                from distriflow_tpu_torch.utils.metrics_log import MetricsLogger
                self._span_logger = MetricsLogger(
                    os.path.join(self.telemetry.save_dir, SPANS_FILENAME),
                    stamp_time=False)
            return self._span_logger
