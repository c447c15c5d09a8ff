"""Port of ``distriflow_tpu/obs/health.py`` (copied with its imports rewritten).

Health sentinel (declared SLO bands) + per-connection fleet table.

**SLO bands** declare what "healthy" means as numbers — an MFU floor, an
ack-latency p99 ceiling, an apply-queue depth ceiling, a slot-occupancy
ceiling — each bound to one registry metric (gauge value or histogram
window quantile, i.e. a rolling window). :meth:`HealthSentinel.check`
evaluates every band against the live registry; a band *entering*
breach increments ``obs_slo_breach_total{band=...}`` exactly once
(edge-triggered — staying in breach is not a new event) and triggers a
flight-recorder postmortem bundle (``obs/flight_recorder.py``). A band
whose metric does not exist yet, or whose histogram has fewer than
``min_count`` samples, is *unknown* and never breaches — a cold process
is not an incident.

**FleetTable** is the server-side per-connection health surface the
ROADMAP router/soak items consume: round latency, staleness, quarantine
hits, wire bytes, last-seen per client, exposed through
``Telemetry.snapshot()["fleet"]`` (absent when no table is registered,
so the disabled-telemetry snapshot contract is untouched). With the
fleet telemetry plane (``obs/collector.py``) the rows also carry
*client-authoritative* columns shipped by the clients themselves
(fit_ms/submit_ms phase digests, RSS/CPU), and the sentinel can band
over the MERGED cross-process view: per-client straggler detection
(round_ms > k x fleet median) and a fleet-wide ack p99 ceiling — see
docs/OBSERVABILITY.md §10.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from distriflow_tpu_torch.obs.registry import metric_ident

BREACH_COUNTER = "obs_slo_breach_total"

#: histogram stats a band may bind to (anything else reads ``.value``)
_HIST_STATS = ("p50", "p95", "p99", "min", "max", "count", "sum")


@dataclass(frozen=True)
class SLOBand:
    """One declared objective: ``lower <= stat(metric{labels}) <= upper``.

    ``kind`` selects how the bound is judged (docs/OBSERVABILITY.md
    §12):

    - ``"point"`` (default): the live registry value, each check;
    - ``"sustained"``: the bound must be violated at ≥
      ``sustained_samples`` consecutive observed timeline samples
      spanning ≥ ``sustained_s`` seconds within the trailing
      ``window_s`` — a transient spike shorter than that never trips;
    - ``"slope"``: the least-squares rate-of-change (per second) of the
      series over the trailing ``window_s`` is what ``upper``/``lower``
      bound — a ramp is caught while the level is still in band.

    Timeline kinds read ``stat`` as a series statistic: ``value`` /
    ``rate`` for counters and gauges, ``p50``/``p95``/``p99``/``mean``
    (per-interval bucket-delta) or ``count``/``rate`` for histograms.
    They are *unknown* (never breach) until the sentinel's telemetry has
    a started timeline with enough samples.
    """

    name: str                 # band identity (label on the breach counter)
    metric: str               # registry metric name
    stat: str = "value"       # "value" for gauges/counters, else a hist stat
    labels: Mapping[str, Any] = field(default_factory=dict)
    upper: Optional[float] = None
    lower: Optional[float] = None
    min_count: int = 1        # histogram bands: samples required to judge
    kind: str = "point"       # "point" | "sustained" | "slope"
    window_s: float = 30.0    # trailing timeline window examined
    sustained_samples: int = 3  # min consecutive out-of-band observations
    sustained_s: float = 0.0  # min wall-clock span of the breaching run


def default_bands(*, mfu_floor: Optional[float] = None,
                  ack_p99_ms: Optional[float] = None,
                  apply_queue_max: Optional[float] = None,
                  slots_max: Optional[float] = None,
                  page_occupancy_max: Optional[float] = None,
                  router_min_replicas: Optional[float] = None,
                  ttft_p99_ms: Optional[Mapping[int, float]] = None,
                  tpot_p99_ms: Optional[Mapping[int, float]] = None,
                  controller_overrides_max: Optional[float] = None,
                  slo_min_count: int = 1) -> List[SLOBand]:
    """The stock bands from docs/OBSERVABILITY.md §6; pass only the
    thresholds you want enforced.

    ``ttft_p99_ms`` / ``tpot_p99_ms`` are ``{tier: ceiling_ms}`` maps —
    one band per tier over the tier-labeled serving histograms
    (``serving_ttft_ms{tier=N}`` / ``serving_time_per_output_token_ms
    {tier=N}``, docs/OBSERVABILITY.md §11). A breach dumps a flight
    bundle whose recent ``ttft_high`` / ``tpot_high`` watermark events
    name the worst request trace."""
    bands: List[SLOBand] = []
    if mfu_floor is not None:
        bands.append(SLOBand("mfu_floor", "train_mfu", "value",
                             {"mode": "sync"}, lower=mfu_floor))
    if ack_p99_ms is not None:
        bands.append(SLOBand("ack_latency_p99", "transport_ack_latency_ms",
                             "p99", {"role": "client"}, upper=ack_p99_ms))
    if apply_queue_max is not None:
        # the gauge is registered unlabeled (abstract_server caches one
        # handle per process), so the band must match it label-free
        bands.append(SLOBand("apply_queue_depth", "comm_apply_queue_depth",
                             "value", {}, upper=apply_queue_max))
    if slots_max is not None:
        bands.append(SLOBand("slot_occupancy", "serving_slots_active",
                             "value", {}, upper=slots_max))
    if page_occupancy_max is not None:
        # paged-KV pool pressure: sustained occupancy near 1.0 means
        # admission is page-bound and the backlog is about to grow —
        # breach dumps a flight bundle like every other band
        bands.append(SLOBand("page_pool_pressure", "serving_page_occupancy",
                             "value", {}, upper=page_occupancy_max))
    if router_min_replicas is not None:
        # fleet-router capacity floor: live replicas (the router's own
        # gauge) dropping below N means failover headroom is gone —
        # the next replica loss takes requests with it
        bands.append(SLOBand("router_capacity", "router_replicas_live",
                             "value", {}, lower=router_min_replicas))
    for t, ceiling in sorted((ttft_p99_ms or {}).items()):
        bands.append(SLOBand(f"ttft_p99_tier{int(t)}", "serving_ttft_ms",
                             "p99", {"tier": str(int(t))},
                             upper=float(ceiling),
                             min_count=int(slo_min_count)))
    for t, ceiling in sorted((tpot_p99_ms or {}).items()):
        bands.append(SLOBand(f"tpot_p99_tier{int(t)}",
                             "serving_time_per_output_token_ms",
                             "p99", {"tier": str(int(t))},
                             upper=float(ceiling),
                             min_count=int(slo_min_count)))
    if controller_overrides_max is not None:
        # adaptive-control saturation: many clients pinned on per-client
        # override patches means the fleet is degraded beyond what
        # per-client steering can absorb — page a human, don't keep
        # turning knobs (docs/ROBUSTNESS.md §10)
        bands.append(SLOBand("controller_saturation",
                             "controller_overrides_active",
                             "value", {}, upper=controller_overrides_max))
    return bands


class HealthSentinel:
    """Evaluates SLO bands against a Telemetry's registry, edge-triggered."""

    def __init__(self, telemetry: Any = None,
                 bands: Optional[List[SLOBand]] = None,
                 dump_dir: Optional[str] = None,
                 collector: Any = None,
                 fleet_straggler_factor: Optional[float] = None,
                 fleet_ack_p99_ms: Optional[float] = None,
                 fleet_min_count: int = 8,
                 timeline: Any = None):
        if telemetry is None:
            from distriflow_tpu_torch.obs.telemetry import get_telemetry
            telemetry = get_telemetry()
        self.telemetry = telemetry
        self.bands = list(bands or [])
        self.dump_dir = dump_dir
        # fleet-level checks (docs/OBSERVABILITY.md §10): computed over a
        # TelemetryCollector's merged cross-process view, not this
        # process's registry. straggler: a client whose round_ms exceeds
        # fleet_straggler_factor x the fleet median (needs >= 2 clients
        # with a round time). ack p99: the MERGED client-side ack
        # histogram across every reporting client.
        self.collector = collector
        self.fleet_straggler_factor = fleet_straggler_factor
        self.fleet_ack_p99_ms = fleet_ack_p99_ms
        self.fleet_min_count = int(fleet_min_count)
        # sustained/slope bands read series from this timeline store;
        # None resolves to the telemetry's (NOOP until start_timeline,
        # under which timeline bands stay unknown)
        self._timeline = timeline
        self._in_breach: Dict[str, bool] = {}

    @property
    def timeline(self) -> Any:
        return (self._timeline if self._timeline is not None
                else self.telemetry.timeline)

    def observe(self, band: SLOBand) -> Optional[float]:
        """Current value of a band's bound stat, or None when unknown."""
        m = self.telemetry.registry.find(band.metric, **band.labels)
        if m is None:
            return None
        if band.stat in _HIST_STATS and hasattr(m, "percentiles"):
            s = m.summary()
            if s.get("count", 0) < band.min_count:
                return None
            return float(s[band.stat])
        return float(m.value)

    def _out_of_band(self, band: SLOBand, v: float) -> bool:
        return ((band.upper is not None and v > band.upper)
                or (band.lower is not None and v < band.lower))

    def _observe_sustained(self, band: SLOBand
                           ) -> "tuple[bool, Dict[str, Any]]":
        """``sustained`` kind: the trailing run of consecutive observed
        samples that violate the bound must be ≥ ``sustained_samples``
        long and span ≥ ``sustained_s`` seconds. Unobserved samples
        (e.g. a histogram interval with no new observations) are
        transparent — they neither extend nor break the run — so a
        single spike stays a run of one no matter how long its value
        would linger in a trailing-window quantile."""
        series = self.timeline.series(
            metric_ident(band.metric, band.labels), band.stat,
            window_s=band.window_s)
        obs = [(t, v) for t, v in series if v is not None]
        extra: Dict[str, Any] = {
            "observed": obs[-1][1] if obs else None,
            "series": [(round(t, 3), v) for t, v in obs[-64:]],
        }
        run: List[Any] = []
        for t, v in reversed(obs):
            if not self._out_of_band(band, v):
                break
            run.append(t)
        extra["run_samples"] = len(run)
        if run:
            extra["run_s"] = round(run[0] - run[-1], 3)
        breached = (len(run) >= max(1, band.sustained_samples)
                    and (run[0] - run[-1]) >= band.sustained_s if run
                    else False)
        return breached, extra

    def _observe_slope(self, band: SLOBand
                       ) -> "tuple[bool, Dict[str, Any]]":
        """``slope`` kind: bound the least-squares per-second trend of
        the observed series over the trailing window."""
        from distriflow_tpu_torch.obs.timeline import fit_slope
        series = self.timeline.series(
            metric_ident(band.metric, band.labels), band.stat,
            window_s=band.window_s)
        pts = [(t, v) for t, v in series if v is not None]
        extra: Dict[str, Any] = {
            "series": [(round(t, 3), v) for t, v in pts[-64:]],
        }
        if len(pts) < 3:
            extra["observed"] = None
            return False, extra
        slope = fit_slope(pts)
        extra["observed"] = slope
        if slope is None:
            return False, extra
        return self._out_of_band(band, slope), extra

    def check(self) -> List[Dict[str, Any]]:
        """Evaluate every band; returns the bands that newly ENTERED
        breach this call (each already counted and flight-dumped)."""
        entered: List[Dict[str, Any]] = []
        for band in self.bands:
            if band.kind == "sustained":
                breached, extra = self._observe_sustained(band)
            elif band.kind == "slope":
                breached, extra = self._observe_slope(band)
            else:
                observed = self.observe(band)
                breached = observed is not None and self._out_of_band(
                    band, observed)
                extra = {"observed": observed}
            detail = {
                "band": band.name, "metric": band.metric,
                "stat": band.stat, "kind": band.kind,
            }
            detail.update(extra)
            detail["upper"] = band.upper
            detail["lower"] = band.lower
            hit = self._enter_breach(band.name, band.name, breached,
                                     detail, f"slo_{band.name}")
            if hit is not None:
                entered.append(hit)
        entered.extend(self._check_fleet())
        return entered

    def _enter_breach(self, key: str, band: str, breached: bool,
                      detail: Dict[str, Any],
                      dump_name: str) -> Optional[Dict[str, Any]]:
        """Shared edge-trigger: count + flight-dump only on entry. ``key``
        is the edge identity (per-client for stragglers); ``band`` labels
        the breach counter."""
        was = self._in_breach.get(key, False)
        self._in_breach[key] = breached
        if not breached or was:
            return None
        self.telemetry.counter(
            BREACH_COUNTER, band=band,
            help="SLO band entries into breach (edge-triggered)").inc()
        self.telemetry.timeline.event(
            "slo_breach", band=band, observed=detail.get("observed"))
        flight = self.telemetry.flight
        # the flight event drops the bulky series; "kind" is the event
        # kind slot, so the band's judge kind rides as band_kind
        record = {k: v for k, v in detail.items()
                  if k not in ("series", "kind")}
        if "kind" in detail:
            record["band_kind"] = detail["kind"]
        flight.record("slo_breach", **record)
        detail["bundle"] = flight.dump(dump_name, save_dir=self.dump_dir,
                                       **detail)
        return detail

    def _check_fleet(self) -> List[Dict[str, Any]]:
        """The fleet-level bands (no-ops without a collector)."""
        entered: List[Dict[str, Any]] = []
        if self.collector is None:
            return entered
        fleet = getattr(self.collector, "fleet", None)
        if self.fleet_straggler_factor and fleet is not None:
            rows = fleet.snapshot()
            rounds = {cid: float(r["round_ms"]) for cid, r in rows.items()
                      if r.get("round_ms")}
            if len(rounds) >= 2:
                med = statistics.median(rounds.values())
                if med > 0:
                    for cid, rm in sorted(rounds.items()):
                        hit = self._enter_breach(
                            f"fleet_straggler:{cid}", "fleet_straggler",
                            rm > self.fleet_straggler_factor * med,
                            {"band": "fleet_straggler", "client_id": cid,
                             "client": rows[cid].get("client"),
                             "observed": rm, "fleet_median_ms": med,
                             "factor": self.fleet_straggler_factor},
                            f"slo_fleet_straggler_{cid[:8]}")
                        if hit is not None:
                            entered.append(hit)
        if self.fleet_ack_p99_ms:
            merged = self.collector.fleet_histogram(
                "transport_ack_latency_ms", role="client")
            s = merged.summary()
            if s.get("count", 0) >= self.fleet_min_count:
                hit = self._enter_breach(
                    "fleet_ack_p99", "fleet_ack_p99",
                    s["p99"] > self.fleet_ack_p99_ms,
                    {"band": "fleet_ack_p99", "observed": s["p99"],
                     "upper": self.fleet_ack_p99_ms,
                     "count": s["count"]},
                    "slo_fleet_ack_p99")
                if hit is not None:
                    entered.append(hit)
        return entered

    def breached(self) -> List[str]:
        """Names of the bands currently in breach (as of the last check)."""
        return sorted(n for n, b in self._in_breach.items() if b)


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
