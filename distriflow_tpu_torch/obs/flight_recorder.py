"""Port of ``distriflow_tpu/obs/flight_recorder.py`` (copied with its imports rewritten).

Flight recorder: a bounded per-process ring of recent structured
events, dumped to disk as a postmortem bundle when something goes wrong.

The ring holds the last ``capacity`` events (phase edges worth keeping,
state transitions, fault-plan decisions, resyncs, lease expirations —
whatever call sites :meth:`FlightRecorder.record`). Recording is cheap
(one lock + deque append) and loses the oldest event first. A **dump**
is triggered by quarantine, rollback, Resync, lease expiry, an SLO
breach (``obs/health.py``), or a crash (:meth:`install_excepthook`) and
writes one self-contained JSON bundle under ``<save_dir>/flight/`` —
bounded in size (oldest events dropped first) and scrubbed of secrets
and raw payload bytes before anything reaches disk.

Bundles are JSON files, which ``python -m distriflow_tpu_torch.obs.dump
--flight`` summarizes (:func:`distriflow_tpu_torch.obs.dump.summarize_flight`;
the JAX package's ``obs.dump --flight`` reads them too). A disabled :class:`~distriflow_tpu_torch.obs.telemetry.Telemetry`
hands out the shared :data:`NOOP_FLIGHT` (records nothing, dumps
nothing).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

FLIGHT_DIRNAME = "flight"
FLIGHT_SCHEMA = 1

#: field names whose values never reach the ring (let alone disk)
_SENSITIVE = re.compile(
    r"secret|token|password|passwd|credential|api_key|auth", re.IGNORECASE)
_MAX_STR = 256  # longest string value kept per event field
_MAX_SEQ = 64  # longest list/tuple value kept per event field


def _scrub_value(v: Any, depth: int = 0) -> Any:
    if isinstance(v, (bytes, bytearray, memoryview)):
        return f"<{len(v)} bytes>"
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        return v if len(v) <= _MAX_STR else v[:_MAX_STR] + "..."
    if isinstance(v, (list, tuple)) and depth < 2:
        # bounded scalar series (e.g. a breach bundle's trailing
        # timeline series) stay structured — newest items win
        return [_scrub_value(x, depth + 1) for x in list(v)[-_MAX_SEQ:]]
    r = repr(v)
    return r if len(r) <= _MAX_STR else r[:_MAX_STR] + "..."


def _scrub(fields: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-able, secrets-free, size-bounded copy of one event's fields."""
    out: Dict[str, Any] = {}
    for k, v in fields.items():
        if _SENSITIVE.search(k):
            out[k] = "<redacted>"
        else:
            out[k] = _scrub_value(v)
    return out


class _NoopFlight:
    """Shared no-op recorder handed out by disabled telemetry."""

    __slots__ = ()

    def record(self, kind: str, **fields: Any) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def dump(self, trigger: str, save_dir: Optional[str] = None,
             **context: Any) -> Optional[str]:
        return None

    def install_excepthook(self) -> None:
        pass


NOOP_FLIGHT = _NoopFlight()


class FlightRecorder:
    """Bounded ring of recent events + postmortem bundle writer."""

    def __init__(self, capacity: int = 512, save_dir: Optional[str] = None,
                 max_bundle_bytes: int = 256 * 1024):
        self.capacity = int(capacity)
        self.save_dir = save_dir
        self.max_bundle_bytes = int(max_bundle_bytes)
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._seq = itertools.count()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._dumps = itertools.count()
        self.dumped: List[str] = []  # paths written this process

    def record(self, kind: str, **fields: Any) -> None:
        """Append one structured event (oldest evicted past capacity)."""
        evt = {"seq": None, "t": time.time(), "kind": kind}
        evt.update(_scrub(fields))
        with self._lock:
            evt["seq"] = next(self._seq)
            self._ring.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def dump(self, trigger: str, save_dir: Optional[str] = None,
             **context: Any) -> Optional[str]:
        """Write one postmortem bundle; returns its path (None when no
        directory is configured). Never raises — a failing postmortem
        write must not take down the thing being postmortemed."""
        root = save_dir or self.save_dir
        if root is None:
            return None
        try:
            bundle: Dict[str, Any] = {
                "schema": FLIGHT_SCHEMA,
                "trigger": trigger,
                "pid": os.getpid(),
                "written_at": time.time(),
                "context": _scrub(context),
                "events": self.events(),
            }
            data = json.dumps(bundle)
            dropped = 0
            while len(data) > self.max_bundle_bytes and bundle["events"]:
                bundle["events"].pop(0)  # oldest first, like the ring
                dropped += 1
                bundle["events_dropped"] = dropped
                data = json.dumps(bundle)
            flight_dir = os.path.join(root, FLIGHT_DIRNAME)
            os.makedirs(flight_dir, exist_ok=True)
            slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", trigger)[:48]
            path = os.path.join(
                flight_dir,
                f"flight_{os.getpid()}_{next(self._dumps):04d}_{slug}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic: readers never see a torn bundle
            self.dumped.append(path)
            return path
        except Exception:
            return None

    def install_excepthook(self) -> None:
        """Chain onto ``sys.excepthook`` so an unhandled crash dumps a
        final bundle (trigger ``crash``) before the process dies."""
        prev = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.record("crash", error=f"{exc_type.__name__}: {exc}")
            self.dump("crash", error=f"{exc_type.__name__}: {exc}")
            prev(exc_type, exc, tb)

        sys.excepthook = _hook


def read_bundles(run_dir: str) -> List[Dict[str, Any]]:
    """Load every flight bundle under ``run_dir/flight/``, oldest first;
    unreadable files are skipped (a crash can tear the last write's tmp)."""
    flight_dir = os.path.join(run_dir, FLIGHT_DIRNAME)
    if not os.path.isdir(flight_dir):
        return []
    out = []
    for name in sorted(os.listdir(flight_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(flight_dir, name)) as f:
                bundle = json.load(f)
            bundle["_file"] = name
            out.append(bundle)
        except Exception:
            continue
    return out
