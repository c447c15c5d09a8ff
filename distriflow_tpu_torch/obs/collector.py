"""Port of ``distriflow_tpu/obs/collector.py``: the client-side
``ReportBuilder`` only (the server-side collector is not ported yet).

A report is delta-encoded in its keys and cumulative in its values: each
build ships every metric that changed since the last build (or all of
them, when ``full``), so a dropped report is healed by the next one and a
duplicate is idempotent. Reports ride the inference client's heartbeat.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, Dict, List, Optional

REPORT_VERSION = 1

#: fleet-namespace prefix: idents under it are the collector's OWN output
#: and are never shipped back out by a builder (a client sharing the
#: server's Telemetry — the loopback tests — must not echo aggregates).
FLEET_PREFIX = "fleet/"

_DEFAULT_MAX_SPANS = 64
_DEFAULT_MAX_HIST_WINDOW = 256


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
