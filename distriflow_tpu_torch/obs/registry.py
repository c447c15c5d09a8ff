"""Port of ``distriflow_tpu/obs/registry.py`` (copied with its imports rewritten).

Thread-safe metrics registry: counters, gauges, bounded histograms.

The one telemetry spine every layer shares (transport -> server/client ->
trainers). Design constraints, in order:

- **cheap when disabled**: a disabled :class:`Telemetry` hands out shared
  no-op singletons — no per-call allocation, no dict growth, nothing to
  snapshot (tier-1 tested in ``tests/test_obs.py``);
- **cheap when enabled**: handles are created once and cached by
  ``(name, labels)`` key; the hot path (``inc``/``set``/``observe``) is a
  lock-free attribute bump for counters/gauges and one lock + ring-buffer
  append for histograms. Hot callers cache the handle at construction
  (``self._hist = telemetry.histogram(...)``) so steady state does no
  registry lookups at all;
- **plain-dict snapshot**: :meth:`Telemetry.snapshot` returns
  JSON-able values only, so it drops straight into
  ``utils.metrics_log.MetricsLogger`` rows, the Prometheus text renderer
  (:func:`render_prometheus`), and the doctor's reconciliation checks.

Histograms are bounded (a fixed-size ring of recent observations) so a
long-running server's memory does not grow with step count; quantiles
(p50/p95/p99) are computed lazily at snapshot time over that window,
while ``count``/``sum``/``min``/``max`` are exact over the full life of
the handle.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, Optional, Tuple

_DEFAULT_HISTOGRAM_WINDOW = 1024

#: log2-spaced bucket bounds for the mergeable wire export
#: (``obs/collector.py``): bucket ``i`` counts observations ``<=
#: BUCKET_BOUNDS[i]``, with one overflow bucket beyond the last bound.
#: Spanning 2^-10 .. 2^30 covers sub-ms phase times through multi-hour
#: totals in one fixed table, so two processes' bucket counts always
#: add element-wise.
BUCKET_BOUNDS = tuple(float(2.0 ** e) for e in range(-10, 31))

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def metric_ident(name: str, labels: Any) -> str:
    """Canonical snapshot spelling: ``name`` or ``name{k=v,...}`` (sorted
    labels) — the same form ``snapshot()`` and the Prometheus renderer
    use, and the key the fleet collector aggregates under."""
    items = labels.items() if isinstance(labels, dict) else labels
    label_s = ",".join(f"{k}={v}" for k, v in sorted(
        (str(k), str(v)) for k, v in items))
    return f"{name}{{{label_s}}}" if label_s else name


def parse_ident(ident: str) -> Tuple[str, Dict[str, str]]:
    """Invert :func:`metric_ident`: ``name{k=v,...}`` -> (name, labels).
    Tolerant of label values containing ``=`` never being produced by
    ``metric_ident`` (values are str()'d scalars in practice)."""
    if "{" not in ident:
        return ident, {}
    name, _, rest = ident.partition("{")
    rest = rest.rstrip("}")
    labels: Dict[str, str] = {}
    for part in rest.split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """Monotonic counter. ``inc`` is a GIL-atomic float add — no lock."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (model version, connected clients, ...)."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded histogram: exact count/sum/min/max, windowed quantiles.

    The ring holds the most recent ``window`` observations; p50/p95/p99
    describe that window (recent behaviour — what an operator asks a
    running server about), while the scalar aggregates cover everything
    ever observed.
    """

    __slots__ = ("name", "labels", "window", "_ring", "_n", "_i",
                 "count", "sum", "min", "max", "_buckets", "_lock")

    def __init__(self, name: str, labels: Dict[str, str],
                 window: int = _DEFAULT_HISTOGRAM_WINDOW):
        self.name = name
        self.labels = labels
        self.window = int(window)
        self._ring = [0.0] * self.window  # guarded-by: _lock
        self._n = 0  # filled slots (<= window)  # guarded-by: _lock
        self._i = 0  # next write index  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self.min: Optional[float] = None  # guarded-by: _lock
        self.max: Optional[float] = None  # guarded-by: _lock
        # cumulative bucket counts over the FULL life of the handle (the
        # mergeable fleet export; see BUCKET_BOUNDS) — one overflow slot
        self._buckets = [0] * (len(BUCKET_BOUNDS) + 1)  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self.window
            if self._n < self.window:
                self._n += 1
            self.count += 1
            self.sum += v
            self._buckets[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        """Nearest-rank quantiles over the retained window."""
        with self._lock:
            data = sorted(self._ring[: self._n])
        if not data:
            return {f"p{int(q * 100)}": 0.0 for q in qs}
        out = {}
        for q in qs:
            idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
            out[f"p{int(q * 100)}"] = data[idx]
        return out

    def summary(self) -> Dict[str, float]:
        # snapshot the scalar aggregates under the lock: a concurrent
        # observe() between the count and sum reads would otherwise hand
        # back a torn (count, sum) pair whose mean never happened
        with self._lock:
            s: Dict[str, float] = {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
            }
        s.update(self.percentiles())
        return s

    def bucket_counts(self) -> Dict[str, int]:
        """Sparse ``{bucket_index: count}`` over :data:`BUCKET_BOUNDS`
        (index ``len(BUCKET_BOUNDS)`` is the overflow bucket). String keys
        so the dict survives a JSON round trip unchanged."""
        with self._lock:
            return {str(i): c for i, c in enumerate(self._buckets) if c}

    def export_state(self, max_window: Optional[int] = None
                     ) -> Dict[str, Any]:
        """JSON-able mergeable state: exact ``count``/``sum``/``min``/
        ``max``, cumulative bucket counts, and the retained window samples
        (oldest first; ``max_window`` keeps only the newest N so a wire
        report stays bounded). Values are CUMULATIVE since the handle's
        epoch — re-delivering a state never corrupts a merge target that
        replaces rather than adds (see ``obs/collector.py``)."""
        with self._lock:
            if self._n < self.window:
                window = self._ring[: self._n]
            else:
                window = self._ring[self._i:] + self._ring[: self._i]
            if max_window is not None and len(window) > int(max_window):
                window = window[-int(max_window):]
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "buckets": {str(i): c for i, c in enumerate(self._buckets)
                            if c},
                "window": list(window),
            }

    def merge(self, other: Any) -> "Histogram":
        """Fold another histogram — a live :class:`Histogram` or an
        :meth:`export_state` dict — into this one.

        Exact aggregates (count/sum/min/max) and bucket counts add;
        the other's window samples are appended to our ring, so the
        post-merge ``percentiles()`` describe the union of both windows
        (exact while the union fits the ring, a recent-biased
        approximation beyond — the property test in
        ``tests/test_fleetobs.py`` pins the tolerance, p50/p99 included).
        Returns ``self`` for chaining."""
        state = other.export_state() if isinstance(other, Histogram) else other
        with self._lock:
            self.count += int(state.get("count", 0) or 0)
            self.sum += float(state.get("sum", 0.0) or 0.0)
            o_min, o_max = state.get("min"), state.get("max")
            if o_min is not None:
                self.min = o_min if self.min is None else min(self.min, o_min)
            if o_max is not None:
                self.max = o_max if self.max is None else max(self.max, o_max)
            for i, c in (state.get("buckets") or {}).items():
                idx = int(i)
                if 0 <= idx < len(self._buckets):
                    self._buckets[idx] += int(c)
            for v in state.get("window") or ():
                self._ring[self._i] = float(v)
                self._i = (self._i + 1) % self.window
                if self._n < self.window:
                    self._n += 1
        return self


class _NoopHandle:
    """Shared do-nothing handle: every metric method is a pass.

    ONE module-level instance serves every disabled counter/gauge/histogram
    — handing it out allocates nothing and registers nothing, which is the
    "zero-allocation-cheap when disabled" contract the obs-marker test
    pins.
    """

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {}


NOOP_HANDLE = _NoopHandle()


class MetricsRegistry:
    """The handle factory + snapshot surface. Thread-safe."""

    def __init__(self, enabled: bool = True,
                 histogram_window: int = _DEFAULT_HISTOGRAM_WINDOW):
        self.enabled = bool(enabled)
        self.histogram_window = histogram_window
        self._metrics: Dict[LabelKey, Any] = {}
        # per-NAME help text (shared across label sets; first writer
        # wins) — the `# HELP` line in the Prometheus exposition
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        if not self.enabled:
            return NOOP_HANDLE
        key = _key(name, labels)
        m = self._metrics.get(key)  # fast path: no lock on hit
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, dict(key[1]), **kw)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, help: Optional[str] = None,
                **labels: Any) -> Counter:
        if help:
            self._help.setdefault(name, help)
        return self._get(Counter, name, labels)

    def gauge(self, name: str, help: Optional[str] = None,
              **labels: Any) -> Gauge:
        if help:
            self._help.setdefault(name, help)
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: Optional[int] = None,
                  help: Optional[str] = None, **labels: Any) -> Histogram:
        if help:
            self._help.setdefault(name, help)
        return self._get(Histogram, name, labels,
                         window=window or self.histogram_window)

    def help_text(self, name: str) -> Optional[str]:
        """The registered ``help=`` text for a metric name, if any."""
        return self._help.get(name)

    # -- read side ---------------------------------------------------------

    def find(self, name: str, **labels: Any) -> Optional[Any]:
        """Existing handle for an exact ``(name, labels)`` key, or None —
        a pure lookup that never registers (the factories would create an
        empty metric, which a reader like the health sentinel must not)."""
        return self._metrics.get(_key(name, labels))

    def counter_value(self, name: str, **labels: Any) -> float:
        """Exact-key counter read; 0.0 when never incremented."""
        m = self._metrics.get(_key(name, labels))
        return m.value if m is not None else 0.0

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across every label set (e.g. both
        transport roles) — what the doctor reconciles against a shared
        :class:`FaultPlan`'s injected-event counts."""
        with self._lock:
            metrics = list(self._metrics.items())
        return sum(m.value for (n, _), m in metrics
                   if n == name and isinstance(m, (Counter, Gauge)))

    def snapshot(self) -> Dict[str, Any]:
        """Plain JSON-able dict of everything registered.

        Metric identity renders as ``name`` or ``name{k=v,...}`` — the
        same spelling the Prometheus text form uses, so the two surfaces
        never drift.
        """
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.items())
        for (name, labels), m in sorted(metrics, key=lambda kv: kv[0]):
            ident = metric_ident(name, labels)
            if isinstance(m, Counter):
                out["counters"][ident] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][ident] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][ident] = m.summary()
        return out

    def scalars(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """``(counters, gauges)`` values keyed by snapshot ident — the
        timeline sampler's cheap read (no histogram window sorting)."""
        with self._lock:
            metrics = list(self._metrics.items())
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for (name, labels), m in metrics:
            if isinstance(m, Counter):
                counters[metric_ident(name, labels)] = m.value
            elif isinstance(m, Gauge):
                gauges[metric_ident(name, labels)] = m.value
        return counters, gauges

    def histogram_states(self, max_window: Optional[int] = None
                         ) -> Dict[str, Dict[str, Any]]:
        """Mergeable :meth:`Histogram.export_state` per histogram, keyed
        by snapshot ident — what a telemetry report ships so the fleet
        collector can :meth:`Histogram.merge` cross-process quantiles."""
        with self._lock:
            metrics = list(self._metrics.items())
        out: Dict[str, Dict[str, Any]] = {}
        for (name, labels), m in sorted(metrics, key=lambda kv: kv[0]):
            if isinstance(m, Histogram):
                out[metric_ident(name, labels)] = m.export_state(
                    max_window=max_window)
        return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(registry: "MetricsRegistry") -> str:
    """Prometheus text exposition (0.0.4) of the registry's current state.

    Counters render as ``counter``, gauges as ``gauge``, histograms as
    summaries (windowed quantiles + exact ``_count``/``_sum``) — scrape
    this from a debug endpoint or dump it at run end. Metrics registered
    with ``help=`` text get a ``# HELP`` line ahead of their ``# TYPE``.
    """
    with registry._lock:
        metrics = sorted(registry._metrics.items(), key=lambda kv: kv[0])
    lines = []
    typed = set()

    def _head(pname: str, name: str, ptype: str) -> None:
        if pname in typed:
            return
        typed.add(pname)
        h = registry._help.get(name)
        if h:
            lines.append(f"# HELP {pname} {h}")
        lines.append(f"# TYPE {pname} {ptype}")

    for (name, labels), m in metrics:
        pname = _prom_name(name)
        if isinstance(m, Counter):
            _head(pname, name, "counter")
            lines.append(f"{pname}{_prom_labels(labels)} {m.value:g}")
        elif isinstance(m, Gauge):
            _head(pname, name, "gauge")
            lines.append(f"{pname}{_prom_labels(labels)} {m.value:g}")
        elif isinstance(m, Histogram):
            _head(pname, name, "summary")
            s = m.summary()
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                qlabel = 'quantile="%s"' % q
                lines.append(
                    f"{pname}{_prom_labels(labels, qlabel)} {s[key]:g}")
            lines.append(f"{pname}_count{_prom_labels(labels)} {s['count']:g}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {s['sum']:g}")
    return "\n".join(lines) + ("\n" if lines else "")
