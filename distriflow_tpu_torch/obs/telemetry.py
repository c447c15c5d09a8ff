"""Port of ``distriflow_tpu/obs/telemetry.py`` (copied with its imports rewritten).

The `Telemetry` facade: one object per process (or per test) that owns
the metrics registry, the tracer, and the export paths.

Components accept ``telemetry=None`` and fall back to the process-global
instance (:func:`get_telemetry`), which starts enabled but export-less —
counters and spans accumulate in memory and cost one attribute bump per
event. Pass ``save_dir`` to also stream ``metrics.jsonl`` snapshots and
``spans.jsonl`` rows to disk; pass ``enabled=False`` to get shared no-op
handles everywhere (see ``registry.NOOP_HANDLE`` / ``tracing.NOOP_SPAN``).

Loopback tests and the doctor hand ONE ``Telemetry`` to both the server
and client configs, so cross-endpoint traces land in a single tracer and
the snapshot can be reconciled against a shared ``FaultPlan``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from distriflow_tpu_torch.obs.registry import (
    MetricsRegistry,
    render_prometheus,
)
from distriflow_tpu_torch.obs.tracing import Tracer

METRICS_FILENAME = "metrics.jsonl"


class Telemetry:
    """Registry + tracer + snapshot surface, one handle per process."""

    def __init__(self, enabled: bool = True, save_dir: Optional[str] = None,
                 histogram_window: int = 1024):
        self.enabled = bool(enabled)
        self.save_dir = save_dir
        self.registry = MetricsRegistry(enabled=self.enabled,
                                        histogram_window=histogram_window)
        self.tracer = Tracer(enabled=self.enabled, save_dir=save_dir)
        self._metrics_logger = None
        self._profilers: Dict[str, Any] = {}
        self._profilers_lock = threading.Lock()
        self._flight = None
        self._fleet_providers: Dict[Any, Any] = {}
        self._samplers: list = []
        self._process_sampler_on = False
        self._timeline = None

    # -- handle factories (delegate to the registry) -----------------------

    def counter(self, name: str, help: Optional[str] = None, **labels: Any):
        return self.registry.counter(name, help=help, **labels)

    def gauge(self, name: str, help: Optional[str] = None, **labels: Any):
        return self.registry.gauge(name, help=help, **labels)

    def histogram(self, name: str, help: Optional[str] = None,
                  **labels: Any):
        return self.registry.histogram(name, help=help, **labels)

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs: Any):
        return self.tracer.span(name, trace_id=trace_id,
                                parent_id=parent_id, **attrs)

    def profiler(self, role: str):
        """Phase profiler for one role, cached per role (the shared
        ``NOOP_PROFILER`` when disabled — nothing allocated per step)."""
        from distriflow_tpu_torch.obs.profiler import NOOP_PROFILER, PhaseProfiler
        if not self.enabled:
            return NOOP_PROFILER
        p = self._profilers.get(role)  # fast path: no lock on hit
        if p is None:
            with self._profilers_lock:
                p = self._profilers.get(role)
                if p is None:
                    p = PhaseProfiler(self.registry, role)
                    self._profilers[role] = p
        return p

    @property
    def flight(self):
        """The process flight recorder (lazy; the shared ``NOOP_FLIGHT``
        when disabled). Bundles land under ``<save_dir>/flight/`` — a
        dump with no ``save_dir`` anywhere is a no-op returning None."""
        from distriflow_tpu_torch.obs.flight_recorder import (
            NOOP_FLIGHT, FlightRecorder)
        if not self.enabled:
            return NOOP_FLIGHT
        if self._flight is None:
            with self._profilers_lock:
                if self._flight is None:
                    self._flight = FlightRecorder(save_dir=self.save_dir)
        return self._flight

    # -- timeline (obs/timeline.py; docs/OBSERVABILITY.md §12) -------------

    @property
    def timeline(self):
        """The process timeline store — the shared ``NOOP_TIMELINE``
        until :meth:`start_timeline` (or when disabled), so event call
        sites never pay for an unstarted timeline."""
        from distriflow_tpu_torch.obs.timeline import NOOP_TIMELINE
        if not self.enabled or self._timeline is None:
            return NOOP_TIMELINE
        return self._timeline

    def start_timeline(self, interval_s: float = 0.25,
                       save_dir: Optional[str] = None,
                       capacity: int = 4096):
        """Start (or return, idempotently) the background timeline
        sampler; samples + events persist to ``<save_dir>/timeline.jsonl``
        (defaulting to this telemetry's ``save_dir``; in-memory-only
        when both are None). Returns the live store (``NOOP_TIMELINE``
        when disabled)."""
        from distriflow_tpu_torch.obs.timeline import NOOP_TIMELINE, TimelineStore
        if not self.enabled:
            return NOOP_TIMELINE
        with self._profilers_lock:
            if self._timeline is None:
                self._timeline = TimelineStore(
                    telemetry=self, interval_s=interval_s,
                    capacity=capacity,
                    save_dir=self.save_dir if save_dir is None else save_dir)
        return self._timeline.start()

    def stop_timeline(self) -> None:
        """Stop the background sampler (keeps the store attached, so
        windowed queries over the retained ring keep working)."""
        t = self._timeline
        if t is not None:
            t.stop()

    # -- fleet health table -------------------------------------------------

    def register_fleet(self, key: Any, provider) -> None:
        """Attach a per-connection health provider (a zero-arg callable
        returning ``{client_id: row}``); its rows merge into
        ``snapshot()["fleet"]``. No-op when disabled."""
        if self.enabled:
            self._fleet_providers[key] = provider

    def unregister_fleet(self, key: Any) -> None:
        self._fleet_providers.pop(key, None)

    def register_sampler(self, fn) -> None:
        """Attach a zero-arg callable run at the top of every
        ``snapshot()`` to refresh pull-style gauges (device memory
        watermarks, queue depths read from foreign objects). Sampler
        errors are swallowed — a dead device must not break a snapshot.
        No-op when disabled."""
        if self.enabled:
            self._samplers.append(fn)

    def register_process_sampler(self) -> None:
        """Built-in :meth:`register_sampler` refreshing host resource
        gauges — ``process_rss_bytes`` (peak RSS) and ``process_cpu_s``
        (user+system CPU seconds) via the stdlib ``resource``/``os``
        modules — so every telemetry report ships them into the fleet
        table for free. Idempotent: clients sharing one Telemetry (the
        loopback tests) register once. No-op when disabled."""
        if not self.enabled or self._process_sampler_on:
            return
        self._process_sampler_on = True
        import resource  # stdlib on POSIX; this repo targets Linux/TPU VMs
        rss = self.registry.gauge(
            "process_rss_bytes", help="peak process RSS (ru_maxrss)")
        cpu = self.registry.gauge(
            "process_cpu_s", help="user+system CPU seconds this process")

        def _sample() -> None:
            ru = resource.getrusage(resource.RUSAGE_SELF)
            # ru_maxrss is KiB on Linux (bytes on macOS; Linux is the target)
            rss.set(ru.ru_maxrss * 1024)
            t = os.times()
            cpu.set(t.user + t.system)

        self._samplers.append(_sample)

    # -- read side ---------------------------------------------------------

    def counter_value(self, name: str, **labels: Any) -> float:
        return self.registry.counter_value(name, **labels)

    def total(self, name: str) -> float:
        return self.registry.total(name)

    def run_samplers(self) -> None:
        """Refresh every pull-style gauge now. ``snapshot()`` does this
        implicitly; the report builder calls it too, so shipped reports
        carry current process gauges rather than the values frozen at
        the last local snapshot."""
        for sampler in list(self._samplers):
            try:
                sampler()
            except Exception:
                pass  # pull-gauge refresh must never break a snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Plain dict of every counter/gauge/histogram currently
        registered, plus a ``"fleet"`` key (per-connection health rows)
        when a server has registered its table — absent otherwise, so
        the disabled-telemetry empty-snapshot contract is unchanged."""
        self.run_samplers()
        snap = self.registry.snapshot()
        if self._fleet_providers:
            fleet: Dict[str, Any] = {}
            for provider in list(self._fleet_providers.values()):
                try:
                    fleet.update(provider())
                except Exception:
                    pass  # a dead provider must not break the snapshot
            snap["fleet"] = fleet
        return snap

    def prometheus(self) -> str:
        """Prometheus text-exposition rendering of the current state."""
        return render_prometheus(self.registry)

    def export_snapshot(self, **extra: Any) -> Optional[Dict[str, Any]]:
        """Append one flattened snapshot row to ``<save_dir>/metrics.jsonl``.

        The existing :class:`MetricsLogger` is the exporter here — the
        registry owns the numbers, this just serializes them — so older
        tooling reading ``metrics.jsonl`` keeps working unchanged.
        Returns the row (or None when disabled / no ``save_dir``).
        """
        if not self.enabled or self.save_dir is None:
            return None
        if self._metrics_logger is None:
            from distriflow_tpu_torch.utils.metrics_log import MetricsLogger
            self._metrics_logger = MetricsLogger(
                os.path.join(self.save_dir, METRICS_FILENAME))
        row: Dict[str, Any] = {"kind": "telemetry_snapshot",
                               "snapshot_time": time.time()}
        snap = self.snapshot()
        for ident, v in snap["counters"].items():
            row[f"counter:{ident}"] = v
        for ident, v in snap["gauges"].items():
            row[f"gauge:{ident}"] = v
        for ident, s in snap["histograms"].items():
            for stat, v in s.items():
                row[f"hist:{ident}:{stat}"] = v
        if "fleet" in snap:
            row["fleet"] = snap["fleet"]  # per-client rows for `dump --fleet`
        row.update(extra)
        self._metrics_logger.log(**row)
        return row


_GLOBAL = Telemetry(enabled=True)


def get_telemetry() -> Telemetry:
    """The process-global telemetry (enabled, in-memory-only by default)."""
    return _GLOBAL


def set_telemetry(t: Telemetry) -> Telemetry:
    """Replace the process-global telemetry; returns the previous one.

    Components resolve the global lazily (at construction), so tests that
    swap it should do so before building servers/clients/trainers.
    """
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = t
    return prev
