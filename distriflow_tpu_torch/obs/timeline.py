"""Port of ``distriflow_tpu/obs/timeline.py`` (copied with its imports rewritten).

Time-resolved telemetry: the windowed timeline store.

Every metric in the registry is cumulative-since-epoch; every snapshot
is a point in time. This module adds the time axis: a
:class:`TimelineStore` samples the live registry on a background thread
every ``interval_s`` into a bounded ring of ``(t, counters, gauges,
histogram bucket-states)`` samples, persists them as a schema-versioned
``timeline.jsonl`` in the run dir, and answers windowed queries over the
ring:

- :meth:`TimelineStore.rate` / :meth:`TimelineStore.delta` — counter
  movement over a trailing window, exact from the cumulative values at
  the window edges;
- :meth:`TimelineStore.gauge_stats` — min/mean/max of a gauge over the
  window's samples;
- :meth:`TimelineStore.quantile` / :meth:`TimelineStore.window_summary`
  — windowed histogram quantiles from bucket-state *deltas*: the
  cumulative :meth:`~distriflow_tpu_torch.obs.registry.Histogram.export_state`
  bucket counts at the window edges subtract element-wise, so the
  windowed distribution is exact at bucket resolution (the same
  mergeable-state machinery the fleet collector adds element-wise, run
  in reverse);
- :meth:`TimelineStore.series` — one value per sample for trend
  evaluation (the ``sustained`` / ``slope`` band kinds in
  ``obs/health.py``).

A timestamped **event channel** rides the same store and file:
:meth:`TimelineStore.event` records control-plane moments (SLO
breaches, controller adaptations/ramps, soak kills/rejoins,
quarantines, resyncs) so every sample series carries the events that
explain it. The JAX package's ``python -m distriflow_tpu.obs.dump
RUN_DIR --timeline`` reads the same file and reconstructs the whole
picture — per-ident sparklines with event markers on a shared time axis
— from the run dir alone via :meth:`TimelineStore.load`.

A disabled :class:`~distriflow_tpu_torch.obs.telemetry.Telemetry` (or one
that never called ``start_timeline``) hands out the shared
:data:`NOOP_TIMELINE`: records nothing, answers every query with
None/empty. See docs/OBSERVABILITY.md §12.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

from distriflow_tpu_torch.obs.flight_recorder import _scrub
from distriflow_tpu_torch.obs.registry import BUCKET_BOUNDS, NOOP_HANDLE

TIMELINE_FILENAME = "timeline.jsonl"
TIMELINE_SCHEMA = 1

#: the histogram keys a timeline sample retains per ident — everything
#: from ``Histogram.export_state`` EXCEPT the raw ``window`` samples
#: (bucket counts subtract exactly; window rings do not, and persisting
#: them would grow each sample row by the whole ring)
_HIST_KEYS = ("count", "sum", "min", "max", "buckets")


def quantile_from_buckets(buckets: Mapping[str, Any], q: float,
                          ) -> Optional[float]:
    """Nearest-rank quantile over sparse log2 bucket counts (the
    :data:`~distriflow_tpu_torch.obs.registry.BUCKET_BOUNDS` table; index
    ``len(BUCKET_BOUNDS)`` is the overflow bucket, reported as the last
    bound). Returns the upper bound of the bucket holding the rank —
    exact at bucket resolution, None when the counts are empty."""
    counts = sorted((int(i), int(c)) for i, c in buckets.items()
                    if int(c) > 0)
    total = sum(c for _, c in counts)
    if total <= 0:
        return None
    rank = min(total - 1, max(0, int(round(q * (total - 1)))))
    cum = 0
    for i, c in counts:
        cum += c
        if cum > rank:
            return BUCKET_BOUNDS[min(i, len(BUCKET_BOUNDS) - 1)]
    return BUCKET_BOUNDS[min(counts[-1][0], len(BUCKET_BOUNDS) - 1)]


def fit_slope(points: List[Tuple[float, float]]) -> Optional[float]:
    """Least-squares slope (value per second) of ``[(t, v), ...]``;
    None with fewer than 2 distinct times."""
    if len(points) < 2:
        return None
    n = float(len(points))
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    den = sum((t - mt) ** 2 for t, _ in points)
    if den <= 0.0:
        return None
    return sum((t - mt) * (v - mv) for t, v in points) / den


class _NoopTimeline:
    """Shared no-op store handed out by disabled/unstarted telemetry."""

    __slots__ = ()

    active = False
    interval_s = 0.0

    def start(self) -> "_NoopTimeline":
        return self

    def stop(self, final_sample: bool = True) -> None:
        pass

    def sample(self, now: Optional[float] = None) -> None:
        return None

    def add_sample(self, t: float, counters: Mapping[str, float],
                   gauges: Mapping[str, float],
                   hists: Optional[Mapping[str, Any]] = None) -> None:
        return None

    def event(self, kind: str, t: Optional[float] = None,
              **fields: Any) -> None:
        return None

    def samples(self, window_s: Optional[float] = None) -> List[Any]:
        return []

    def events(self, window_s: Optional[float] = None) -> List[Any]:
        return []

    def span_s(self) -> float:
        return 0.0

    def rate(self, ident: str, window_s: Optional[float] = None) -> None:
        return None

    def delta(self, ident: str, window_s: Optional[float] = None) -> None:
        return None

    def gauge_stats(self, ident: str,
                    window_s: Optional[float] = None) -> None:
        return None

    def hist_delta(self, ident: str,
                   window_s: Optional[float] = None) -> None:
        return None

    def quantile(self, ident: str, q: float,
                 window_s: Optional[float] = None) -> None:
        return None

    def window_summary(self, ident: str,
                       window_s: Optional[float] = None) -> None:
        return None

    def series(self, ident: str, stat: str = "value",
               window_s: Optional[float] = None) -> List[Any]:
        return []

    def slope(self, ident: str, stat: str = "value",
              window_s: Optional[float] = None) -> None:
        return None


NOOP_TIMELINE = _NoopTimeline()


class TimelineStore:
    """Bounded ring of registry samples + events, with windowed queries.

    Attach to a live :class:`~distriflow_tpu_torch.obs.telemetry.Telemetry`
    via ``telemetry.start_timeline(...)`` (which owns the background
    thread), feed it by hand with :meth:`add_sample` (the ``dump
    --watch`` path and tests), or rebuild one offline from a run dir
    with :meth:`load`. All public methods are thread-safe.
    """

    active = True  # vs NOOP_TIMELINE; real stores always answer queries

    def __init__(self, telemetry: Any = None, interval_s: float = 0.25,
                 capacity: int = 4096, save_dir: Optional[str] = None,
                 event_capacity: int = 4096):
        self.telemetry = telemetry
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.save_dir = save_dir
        self.header: Optional[Dict[str, Any]] = None  # set by load()
        self.skipped = 0  # malformed lines skipped by load()
        self._samples: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._events: deque = deque(maxlen=int(event_capacity))  # guarded-by: _lock
        self._lock = threading.Lock()
        self._file = None  # guarded-by: _io_lock
        self._io_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        if telemetry is not None and getattr(telemetry, "enabled", False):
            self._c_samples = telemetry.counter(
                "obs_timeline_samples_total",
                help="registry samples taken by the timeline store")
            self._c_events = telemetry.counter(
                "obs_timeline_events_total",
                help="control-plane events recorded on the run timeline")
        else:
            self._c_samples = NOOP_HANDLE
            self._c_events = NOOP_HANDLE

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TimelineStore":
        """Start the background sampler thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="timeline-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_sample: bool = True) -> None:
        """Stop the sampler, take one closing sample (so even a short
        run has a window edge to diff against), and flush the sink."""
        t = self._thread
        if t is not None:
            self._stop_evt.set()
            t.join(timeout=5.0)
            self._thread = None
        if final_sample and self.telemetry is not None:
            self.sample()
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except Exception:
                    pass
                self._file = None

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.sample()
            except Exception:
                pass  # a torn snapshot must not kill the sampler
            self._stop_evt.wait(self.interval_s)

    # -- write side ---------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> Optional[float]:
        """Take one sample of the live registry (the sampler thread's
        body; also callable directly for deterministic tests/drills)."""
        tel = self.telemetry
        if tel is None:
            return None
        tel.run_samplers()
        counters, gauges = tel.registry.scalars()
        hists = {
            ident: {k: state.get(k) for k in _HIST_KEYS}
            for ident, state in tel.registry.histogram_states(
                max_window=1).items()
        }
        t = time.time() if now is None else float(now)
        self.add_sample(t, counters, gauges, hists)
        return t

    def add_sample(self, t: float, counters: Mapping[str, float],
                   gauges: Mapping[str, float],
                   hists: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Append one sample (oldest evicted past ``capacity``)."""
        sample = {"t": float(t), "counters": dict(counters),
                  "gauges": dict(gauges), "hists": dict(hists or {})}
        with self._lock:
            self._samples.append(sample)
        self._c_samples.inc()
        self._persist({"kind": "timeline_sample", **sample})
        return sample

    def event(self, kind: str, t: Optional[float] = None,
              **fields: Any) -> Dict[str, Any]:
        """Record one timestamped control-plane event (scrubbed like a
        flight-recorder event; oldest evicted past the event ring)."""
        evt = {"t": time.time() if t is None else float(t),
               "kind": str(kind)}
        evt.update(_scrub(fields))
        with self._lock:
            self._events.append(evt)
        self._c_events.inc()
        row = {"kind": "timeline_event", "t": evt["t"],
               "event": evt["kind"]}
        row.update({k: v for k, v in evt.items() if k not in ("t", "kind")})
        self._persist(row)
        return evt

    def _persist(self, row: Dict[str, Any]) -> None:
        """Append one JSONL row to ``<save_dir>/timeline.jsonl``; never
        raises (a full disk must not take down the thing it observes)."""
        if self.save_dir is None:
            return
        try:
            with self._io_lock:
                if self._file is None:
                    os.makedirs(self.save_dir, exist_ok=True)
                    path = os.path.join(self.save_dir, TIMELINE_FILENAME)
                    fresh = not os.path.exists(path)
                    self._file = open(path, "a")
                    if fresh:
                        header = {"kind": "timeline_header",
                                  "schema": TIMELINE_SCHEMA,
                                  "interval_s": self.interval_s,
                                  "pid": os.getpid(),
                                  "written_at": time.time()}
                        self._file.write(json.dumps(header) + "\n")
                self._file.write(json.dumps(row) + "\n")
                self._file.flush()
        except Exception:
            pass

    # -- read side ----------------------------------------------------------

    def samples(self, window_s: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        """Samples (oldest first), optionally only the trailing window
        measured back from the newest sample."""
        with self._lock:
            out = list(self._samples)
        if window_s is not None and out:
            lo = out[-1]["t"] - float(window_s)
            out = [s for s in out if s["t"] >= lo]
        return out

    def events(self, window_s: Optional[float] = None
               ) -> List[Dict[str, Any]]:
        """Events (oldest first), optionally only the trailing window."""
        with self._lock:
            out = list(self._events)
        if window_s is not None and out:
            lo = out[-1]["t"] - float(window_s)
            out = [e for e in out if e["t"] >= lo]
        return out

    def span_s(self) -> float:
        """Wall-clock span covered by the retained samples."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            return self._samples[-1]["t"] - self._samples[0]["t"]

    def _bracket(self, window_s: Optional[float]
                 ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """The two samples bracketing a trailing window: the newest
        sample and the newest sample at or before ``newest.t -
        window_s`` (the oldest retained one when the window predates the
        ring). None with fewer than 2 samples."""
        with self._lock:
            samps = list(self._samples)
        if len(samps) < 2:
            return None
        s1 = samps[-1]
        if window_s is None:
            return samps[0], s1
        cutoff = s1["t"] - float(window_s)
        s0 = samps[0]
        for s in samps[:-1]:
            if s["t"] <= cutoff:
                s0 = s
            else:
                break
        return s0, s1

    @staticmethod
    def _scalar(sample: Dict[str, Any], ident: str) -> Optional[float]:
        v = sample["counters"].get(ident)
        if v is None:
            v = sample["gauges"].get(ident)
        return None if v is None else float(v)

    def delta(self, ident: str, window_s: Optional[float] = None
              ) -> Optional[float]:
        """Counter (or gauge) movement across the window edges. A
        counter absent from the older edge reads 0 there (it was created
        mid-window). None without two samples or when absent from the
        newest sample."""
        br = self._bracket(window_s)
        if br is None:
            return None
        s0, s1 = br
        v1 = self._scalar(s1, ident)
        if v1 is None:
            return None
        v0 = self._scalar(s0, ident)
        return v1 - (0.0 if v0 is None else v0)

    def rate(self, ident: str, window_s: Optional[float] = None
             ) -> Optional[float]:
        """Per-second rate from the counter delta across the window
        edges (exact: cumulative values subtract)."""
        br = self._bracket(window_s)
        if br is None:
            return None
        s0, s1 = br
        dt = s1["t"] - s0["t"]
        d = self.delta(ident, window_s)
        if d is None or dt <= 0.0:
            return None
        return d / dt

    def gauge_stats(self, ident: str, window_s: Optional[float] = None
                    ) -> Optional[Dict[str, float]]:
        """min/mean/max/n of a gauge (or counter) over the window's
        samples; None when never present."""
        vals = [v for v in (self._scalar(s, ident)
                            for s in self.samples(window_s))
                if v is not None]
        if not vals:
            return None
        return {"min": min(vals), "mean": sum(vals) / len(vals),
                "max": max(vals), "n": float(len(vals))}

    def hist_delta(self, ident: str, window_s: Optional[float] = None
                   ) -> Optional[Dict[str, Any]]:
        """Windowed histogram state: bucket counts / count / sum are
        the element-wise difference of the cumulative states at the
        window edges (exact — the merge machinery run in reverse);
        ``min``/``max`` are lifetime extrema (not invertible) from the
        newest edge."""
        br = self._bracket(window_s)
        if br is None:
            return None
        s0, s1 = br
        h1 = s1["hists"].get(ident)
        if h1 is None:
            return None
        h0 = s0["hists"].get(ident) or {}
        b0 = h0.get("buckets") or {}
        buckets = {}
        for i, c in (h1.get("buckets") or {}).items():
            d = int(c) - int(b0.get(i, 0))
            if d > 0:
                buckets[i] = d
        return {
            "count": int(h1.get("count", 0) or 0) - int(h0.get("count", 0) or 0),
            "sum": float(h1.get("sum", 0.0) or 0.0) - float(h0.get("sum", 0.0) or 0.0),
            "min": h1.get("min"),
            "max": h1.get("max"),
            "buckets": buckets,
        }

    def quantile(self, ident: str, q: float,
                 window_s: Optional[float] = None) -> Optional[float]:
        """Windowed quantile from the bucket-state delta (exact at
        bucket resolution); None when the window saw no observations."""
        d = self.hist_delta(ident, window_s)
        if d is None or d["count"] <= 0:
            return None
        return quantile_from_buckets(d["buckets"], q)

    def window_summary(self, ident: str, window_s: Optional[float] = None
                       ) -> Optional[Dict[str, float]]:
        """count/sum/mean/p50/p95/p99 of a histogram over the window."""
        d = self.hist_delta(ident, window_s)
        if d is None or d["count"] <= 0:
            return None
        out = {"count": float(d["count"]), "sum": d["sum"],
               "mean": d["sum"] / d["count"]}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = quantile_from_buckets(d["buckets"], q)
        return out

    def series(self, ident: str, stat: str = "value",
               window_s: Optional[float] = None
               ) -> List[Tuple[float, Optional[float]]]:
        """One ``(t, value)`` point per sample for trend evaluation
        (oldest first), trailing ``window_s`` from the newest sample.

        - counters: ``value`` (cumulative) or ``rate`` (per-interval
          delta / dt vs the previous sample);
        - gauges: ``value``;
        - histograms: ``count`` (cumulative), ``rate`` (observations/s
          per interval), or ``p50``/``p95``/``p99``/``mean`` over the
          interval's bucket-state delta — ``None`` for an interval that
          saw no observations, so a single spike stays a single point
          rather than smearing forward (the ``sustained`` band contract
          in ``obs/health.py``).
        """
        samps = self.samples()
        if not samps:
            return []
        lo = None if window_s is None else samps[-1]["t"] - float(window_s)
        out: List[Tuple[float, Optional[float]]] = []
        prev: Optional[Dict[str, Any]] = None
        for s in samps:
            v = self._series_value(ident, stat, s, prev)
            prev = s
            if lo is None or s["t"] >= lo:
                out.append((s["t"], v))
        return out

    def _series_value(self, ident: str, stat: str, s: Dict[str, Any],
                      prev: Optional[Dict[str, Any]]) -> Optional[float]:
        if ident in s["counters"]:
            c = float(s["counters"][ident])
            if stat != "rate":
                return c
            if prev is None:
                return None
            dt = s["t"] - prev["t"]
            if dt <= 0.0:
                return None
            return (c - float(prev["counters"].get(ident, 0.0))) / dt
        if ident in s["gauges"]:
            return float(s["gauges"][ident])
        h = s["hists"].get(ident)
        if h is None:
            return None
        if stat == "count":
            return float(h.get("count", 0) or 0)
        if prev is None:
            return None
        ph = prev["hists"].get(ident) or {}
        dcount = int(h.get("count", 0) or 0) - int(ph.get("count", 0) or 0)
        if stat == "rate":
            dt = s["t"] - prev["t"]
            return None if dt <= 0.0 else dcount / dt
        if dcount <= 0:
            return None  # no new observations this interval
        if stat == "mean":
            dsum = (float(h.get("sum", 0.0) or 0.0)
                    - float(ph.get("sum", 0.0) or 0.0))
            return dsum / dcount
        pb = ph.get("buckets") or {}
        buckets = {}
        for i, c in (h.get("buckets") or {}).items():
            d = int(c) - int(pb.get(i, 0))
            if d > 0:
                buckets[i] = d
        q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}.get(stat)
        if q is None:
            return None
        return quantile_from_buckets(buckets, q)

    def slope(self, ident: str, stat: str = "value",
              window_s: Optional[float] = None) -> Optional[float]:
        """Least-squares rate-of-change (per second) of a series over
        the trailing window; None with fewer than 3 observed points."""
        pts = [(t, v) for t, v in self.series(ident, stat, window_s)
               if v is not None]
        if len(pts) < 3:
            return None
        return fit_slope(pts)

    # -- offline reconstruction ---------------------------------------------

    @classmethod
    def load(cls, run_dir: str) -> "TimelineStore":
        """Rebuild an offline store (no telemetry, no thread) from a run
        dir's ``timeline.jsonl``. Malformed lines (a crash tears the
        last write) are skipped and counted on ``store.skipped``."""
        path = run_dir
        if not path.endswith(".jsonl"):
            path = os.path.join(run_dir, TIMELINE_FILENAME)
        samples: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        header: Optional[Dict[str, Any]] = None
        skipped = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except Exception:
                    skipped += 1
                    continue
                kind = row.get("kind")
                if kind == "timeline_header":
                    header = row
                elif kind == "timeline_sample":
                    samples.append({
                        "t": float(row.get("t", 0.0)),
                        "counters": row.get("counters") or {},
                        "gauges": row.get("gauges") or {},
                        "hists": row.get("hists") or {},
                    })
                elif kind == "timeline_event":
                    evt = {"t": float(row.get("t", 0.0)),
                           "kind": str(row.get("event", "?"))}
                    evt.update({k: v for k, v in row.items()
                                if k not in ("kind", "t", "event")})
                    events.append(evt)
                else:
                    skipped += 1
        store = cls(telemetry=None,
                    interval_s=float((header or {}).get("interval_s", 0.0)
                                     or 0.0),
                    capacity=max(len(samples), 1),
                    event_capacity=max(len(events), 1))
        store._samples.extend(samples)
        store._events.extend(events)
        store.header = header
        store.skipped = skipped
        return store
