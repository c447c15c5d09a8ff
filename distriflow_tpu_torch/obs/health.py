"""Port of ``distriflow_tpu/obs/health.py``: the per-connection
``FleetTable`` only (the SLO sentinel is not ported yet).

The server-side per-connection health surface: round latency, wire bytes,
KV pages held and last-seen per client, exposed through
``Telemetry.snapshot()["fleet"]``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict


class FleetTable:
    """Per-connection health rows: the router/soak admission substrate.

    Thread-safe; rows survive disconnects (marked ``connected=False``)
    up to ``capacity`` total, evicting the longest-gone disconnected row
    first so a churny fleet cannot grow the table without bound.
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._rows: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    # dfcheck: holds _lock
    def _row(self, client_id: str) -> Dict[str, Any]:
        row = self._rows.get(client_id)
        if row is None:
            if len(self._rows) >= self.capacity:
                gone = [(r["last_seen"], cid) for cid, r in self._rows.items()
                        if not r["connected"]]
                if gone:
                    self._rows.pop(min(gone)[1], None)
            row = self._rows[client_id] = {
                "connected": False, "connected_at": None, "last_seen": 0.0,
                "uploads": 0, "round_ms": None, "staleness": None,
                "quarantine_hits": 0, "resyncs": 0,
                "up_bytes": 0, "down_bytes": 0, "_last_down_t": None,
                "pages": 0,
            }
        return row

    def connect(self, client_id: str) -> None:
        now = time.time()
        with self._lock:
            row = self._row(client_id)
            row["connected"] = True
            row["connected_at"] = now
            row["last_seen"] = now

    def disconnect(self, client_id: str) -> None:
        with self._lock:
            row = self._rows.get(client_id)
            if row is not None:
                row["connected"] = False
                row["last_seen"] = time.time()

    def note_upload(self, client_id: str, nbytes: int = 0) -> None:
        """One gradient upload arrived; round latency is measured from
        the last weight send to this connection (dispatch -> upload)."""
        now = time.time()
        with self._lock:
            row = self._row(client_id)
            row["last_seen"] = now
            row["uploads"] += 1
            row["up_bytes"] += int(nbytes)
            t = row["_last_down_t"]
            if t is not None:
                row["round_ms"] = round((now - t) * 1e3, 3)

    def note_download(self, client_id: str, nbytes: int = 0) -> None:
        with self._lock:
            row = self._row(client_id)
            row["down_bytes"] += int(nbytes)
            row["_last_down_t"] = time.time()

    def note_staleness(self, client_id: str, staleness: float) -> None:
        with self._lock:
            self._row(client_id)["staleness"] = staleness

    def note_quarantine(self, client_id: str) -> None:
        with self._lock:
            self._row(client_id)["quarantine_hits"] += 1

    def note_resync(self, client_id: str) -> None:
        with self._lock:
            self._row(client_id)["resyncs"] += 1

    def note_report(self, client_id: str, **cols: Any) -> None:
        """Fold client-authoritative columns from a shipped telemetry
        report (``obs/collector.py``) into this connection's row —
        fit_ms/submit_ms phase digests, host resource gauges, the
        client's stable identity, report seq. Arbitrary columns merge;
        ``snapshot()`` only strips ``_``-prefixed keys, so new report
        columns flow to the fleet view without a schema change here."""
        with self._lock:
            row = self._row(client_id)
            row["last_seen"] = time.time()
            row.update(cols)

    def note_pages(self, client_id: str, pages: int) -> None:
        """Absolute KV pages a serving client currently holds across its
        in-flight requests (0 once everything retired) — lets a soak
        operator spot the one connection pinning the pool."""
        with self._lock:
            self._row(client_id)["pages"] = int(pages)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-able ``{client_id: row}`` (internal fields stripped)."""
        with self._lock:
            return {cid: {k: v for k, v in row.items()
                          if not k.startswith("_")}
                    for cid, row in self._rows.items()}
