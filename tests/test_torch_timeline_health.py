"""Port parity: the windowed timeline store and the health sentinel
(``distriflow_tpu_torch/obs/timeline.py``, ``obs/health.py``).

The same scripted samples go into the port's ``TimelineStore`` and JAX's,
and every query must answer exactly alike (Python floats over the same
samples): ring eviction, delta/rate, gauge statistics, windowed bucket
quantiles, empty intervals, series and slopes, and the persisted file
read back by the other package. The port's ``HealthSentinel`` and JAX's
judge the same series alike: sustained bands fire once and stay silent on
a transient, unobserved intervals are transparent, slope bands bound the
trend, point bands are edge-triggered and histogram-gated, a breach dumps
a flight bundle, and the fleet checks run over the port's
``TelemetryCollector``. ``Telemetry.start_timeline`` starts and stops the
sampler, and a port ``AsynchronousSGDServer`` with ``timeline_interval_s``
> 0 sets up and stops.
"""

import os
import time

import numpy as np
import pytest

from distriflow_tpu.obs import health as jax_health
from distriflow_tpu.obs import timeline as jax_timeline
from distriflow_tpu.obs.registry import Histogram as JaxHistogram
from distriflow_tpu.obs.telemetry import Telemetry as JaxTelemetry
from distriflow_tpu_torch.obs import (
    NOOP_TIMELINE,
    TIMELINE_FILENAME,
    HealthSentinel,
    SLOBand,
    Telemetry,
    TimelineStore,
    default_bands,
    fit_slope,
    quantile_from_buckets,
)
from distriflow_tpu_torch.obs.collector import ReportBuilder, TelemetryCollector
from distriflow_tpu_torch.obs.health import FleetTable
from distriflow_tpu_torch.obs.registry import BUCKET_BOUNDS, metric_ident

pytestmark = pytest.mark.port

PKGS = {"port": (TimelineStore, HealthSentinel, SLOBand, Telemetry),
        "jax": (jax_timeline.TimelineStore, jax_health.HealthSentinel, jax_health.SLOBand,
                JaxTelemetry)}


def _both(fill, **kw):
    """One port and one JAX store, each fed by ``fill(store)``."""
    stores = {}
    for pkg, (store_cls, *_) in PKGS.items():
        stores[pkg] = store_cls(**kw)
        fill(stores[pkg])
    return stores["port"], stores["jax"]


def _queries(store, idents, windows=(None, 0.15, 1.0, 2.5)):
    """Every read-side query of a store, as one comparable structure."""
    out = {"samples": store.samples(), "events": store.events(), "span": store.span_s()}
    for ident in idents:
        for w in windows:
            out[(ident, w)] = (
                store.delta(ident, w), store.rate(ident, w), store.gauge_stats(ident, w),
                store.hist_delta(ident, w), store.window_summary(ident, w),
                [store.quantile(ident, q, w) for q in (0.0, 0.5, 0.95, 0.99, 1.0)],
                [store.series(ident, s, w)
                 for s in ("value", "rate", "count", "mean", "p50", "p95", "p99")],
                [store.slope(ident, s, w) for s in ("value", "rate", "p99")])
    return out


def _hist(count, total, buckets):
    return {"count": count, "sum": total, "min": 1.0, "max": 300.0, "buckets": buckets}


def _scripted(store):
    """Counters, a gauge and a histogram with empty and busy intervals."""
    rng = np.random.default_rng(5)
    c = cum = 0
    buckets = {}
    for i in range(12):
        c += int(rng.integers(0, 7))
        new = int(rng.integers(0, 4)) if i % 4 != 2 else 0  # some intervals see nothing
        for _ in range(new):
            b = str(int(rng.integers(8, 20)))
            buckets[b] = buckets.get(b, 0) + 1
        cum += new
        store.add_sample(0.1 * i + 100.0, {"work_total": float(c)},
                         {"queue": float(rng.integers(0, 9))},
                         {"lat_ms": _hist(cum, 3.5 * cum, dict(buckets))})
        if i in (3, 7):
            store.event("churn_kill", t=0.1 * i + 100.05, client=f"w{i}")


def test_ring_eviction_matches_jax():
    def fill(store):
        for i in range(10):
            store.add_sample(float(i), {"c": float(i * i)}, {"g": float(-i)})

    port, ref = _both(fill, capacity=4)
    assert [s["t"] for s in port.samples()] == [6.0, 7.0, 8.0, 9.0]
    assert port.delta("c") == 81.0 - 36.0
    assert _queries(port, ["c", "g"]) == _queries(ref, ["c", "g"])


def test_scripted_queries_match_jax():
    port, ref = _both(_scripted)
    idents = ["work_total", "queue", "lat_ms", "missing"]
    got, want = _queries(port, idents), _queries(ref, idents)
    assert got == want
    # the scripted run has empty histogram intervals: None, not carried over
    means = [v for _, v in port.series("lat_ms", "mean")]
    assert None in means[1:] and any(v is not None for v in means)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantile_from_buckets_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = len(BUCKET_BOUNDS) + 1  # the overflow bucket included
    buckets = {str(int(i)): int(rng.integers(0, 5)) for i in rng.choice(n, size=12)}
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert quantile_from_buckets(buckets, q) == jax_timeline.quantile_from_buckets(buckets, q)
    assert quantile_from_buckets({}, 0.5) is None
    pts = [(float(t), float(v)) for t, v in zip(rng.random(9), rng.random(9))]
    assert fit_slope(pts) == jax_timeline.fit_slope(pts)
    assert fit_slope(pts[:1]) is None and fit_slope([(1.0, 2.0), (1.0, 3.0)]) is None


def test_registry_sampled_quantiles_match_jax():
    """The live path: each package's Telemetry observes the same values and
    its store samples the registry at the same stamps."""
    stores = {}
    rng = np.random.default_rng(9)
    batches = [rng.lognormal(3.0, 1.2, 7) for _ in range(4)]
    for pkg, (store_cls, _, _, tel_cls) in PKGS.items():
        tel = tel_cls()
        h, c = tel.histogram("lat_ms", role="c"), tel.counter("reqs_total", role="c")
        store = stores[pkg] = store_cls(telemetry=tel, interval_s=999.0)
        store.sample(now=50.0)
        for i, batch in enumerate(batches):
            for v in batch:
                h.observe(float(v))
                c.inc()
            store.sample(now=51.0 + i)
    ident = metric_ident("lat_ms", {"role": "c"})
    idents = [ident, metric_ident("reqs_total", {"role": "c"})]
    assert _queries(stores["port"], idents, (None, 1.0, 2.0)) == \
        _queries(stores["jax"], idents, (None, 1.0, 2.0))
    ref = JaxHistogram("ref", {})
    for v in batches[-1]:
        ref.observe(float(v))
    assert stores["port"].quantile(ident, 0.99, window_s=1.0) == \
        jax_timeline.quantile_from_buckets(ref.export_state()["buckets"], 0.99)


def test_persisted_file_reads_back_in_both_packages(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for store_cls, d in ((TimelineStore, port_dir), (jax_timeline.TimelineStore, jax_dir)):
        store = store_cls(save_dir=str(d), interval_s=0.05)
        _scripted(store)
        store.stop(final_sample=False)
    idents = ["work_total", "queue", "lat_ms"]
    want = _queries(jax_timeline.TimelineStore.load(str(jax_dir)), idents)
    for reader in (TimelineStore, jax_timeline.TimelineStore):
        for d in (port_dir, jax_dir):
            loaded = reader.load(str(d))
            assert loaded.skipped == 0 and loaded.header["schema"] == 1
            assert _queries(loaded, idents) == want
    with open(port_dir / TIMELINE_FILENAME, "a") as f:  # a torn last line
        f.write('{"kind": "timeline_sample", "t": 3.0, "cou')
    assert TimelineStore.load(str(port_dir)).skipped == 1


# -- the sentinel -------------------------------------------------------------


def _gauge_fill(values):
    def fill(store):
        for i, v in enumerate(values):
            store.add_sample(0.1 * i, {}, {metric_ident("q", {"role": "s"}): float(v)})
    return fill


def _hist_gap_fill(store):
    ident = metric_ident("lat", {"role": "c"})
    for i, count in enumerate((0, 5, 5, 5, 10)):  # two empty intervals between
        store.add_sample(0.1 * i, {}, {}, {ident: {"count": count, "sum": 0.0, "min": None,
                                                   "max": None, "buckets": {"17": count}}})


SENTINEL_CASES = {
    # name: (fill, band kwargs, breach expected on the first check)
    "sustained_transient_spike": (_gauge_fill([10, 10, 100, 10, 10]),
                                  dict(stat="value", kind="sustained", sustained_s=0.15), False),
    "sustained_two_spikes": (_gauge_fill([10, 100, 100, 10]),
                             dict(stat="value", kind="sustained", sustained_s=0.15), False),
    "sustained_fires_once": (_gauge_fill([10, 10, 100, 100, 100]),
                             dict(stat="value", kind="sustained", sustained_s=0.15), True),
    "sustained_gap_transparent": (_hist_gap_fill,
                                  dict(metric="lat", labels={"role": "c"}, stat="p99",
                                       kind="sustained", sustained_samples=2), True),
    "slope_ramp": (_gauge_fill([0, 10, 20, 30, 40]),
                   dict(stat="value", kind="slope", upper=5.0), True),
    "slope_flat_high": (_gauge_fill([1000, 1000, 1000, 1000]),
                        dict(stat="value", kind="slope", upper=5.0), False),
    "slope_too_short": (_gauge_fill([0, 100]), dict(stat="value", kind="slope", upper=5.0),
                        False),
}


@pytest.mark.parametrize("case", list(SENTINEL_CASES))
def test_timeline_bands_judge_like_jax(case, tmp_path):
    fill, band_kw, breach = SENTINEL_CASES[case]
    kw = dict(metric="q", labels={"role": "s"}, upper=50.0, sustained_samples=3, window_s=60.0)
    kw.update(band_kw)
    results = {}
    for pkg, (store_cls, sentinel_cls, band_cls, tel_cls) in PKGS.items():
        store = store_cls()
        fill(store)
        tel = tel_cls()
        sentinel = sentinel_cls(tel, bands=[band_cls("band", **kw)], timeline=store,
                                dump_dir=str(tmp_path / pkg))
        first, second = sentinel.check(), sentinel.check()
        bundles = [h.pop("bundle") for h in first]
        results[pkg] = (first, second, sentinel.breached(),
                        tel.counter_value("obs_slo_breach_total", band="band"), bundles)
    port, ref = results["port"], results["jax"]
    assert port[:4] == ref[:4]
    assert bool(port[0]) is breach and port[1] == []  # edge-triggered
    assert port[3] == (1.0 if breach else 0.0)
    for bundle in port[4]:  # the flight bundle on breach
        assert bundle and os.path.exists(bundle)


def test_point_tier_bands_edge_triggered_like_jax():
    """``default_bands`` per-tier TTFT/TPOT p99 bands over the live
    registry: unknown below ``min_count``, judged, entered once."""
    log = {}
    for pkg, (_, sentinel_cls, _, tel_cls) in PKGS.items():
        bands = (default_bands if pkg == "port" else jax_health.default_bands)(
            ttft_p99_ms={0: 100.0}, tpot_p99_ms={0: 50.0}, page_occupancy_max=0.9,
            router_min_replicas=2, slo_min_count=4)
        tel = tel_cls()
        h = tel.histogram("serving_ttft_ms", tier="0")
        tel.gauge("router_replicas_live").set(2)
        sentinel = sentinel_cls(tel, bands=bands)
        steps = []
        for values in ([10.0] * 3, [10.0], [400.0] * 4, [], []):
            for v in values:
                h.observe(v)
            steps.append(sentinel.check())
        tel.gauge("router_replicas_live").set(1)
        steps.append(sentinel.check())
        log[pkg] = (steps, sentinel.breached(),
                    [tel.counter_value("obs_slo_breach_total", band=b.name) for b in bands],
                    [(b.name, b.metric, b.stat, dict(b.labels), b.upper, b.lower) for b in bands])
    assert log["port"] == log["jax"]
    steps, breached, counts, _ = log["port"]
    assert [[e["band"] for e in s] for s in steps] == [
        [], [], ["ttft_p99_tier0"], [], [], ["router_capacity"]]
    assert breached == ["router_capacity", "ttft_p99_tier0"]


class _FleetReport:
    """One client telemetry shipping its ack-latency histogram."""

    def __init__(self, values):
        self.tel = Telemetry()
        h = self.tel.histogram("transport_ack_latency_ms", role="client")
        for v in values:
            h.observe(v)
        self.builder = ReportBuilder(self.tel, "c-ack")


def test_fleet_checks_over_the_port_collector(tmp_path):
    """Straggler and fleet ack p99 bands over a real port
    ``TelemetryCollector`` (its ``FleetTable`` rows and merged histogram)."""
    tel = Telemetry(save_dir=str(tmp_path))
    fleet = FleetTable()
    collector = TelemetryCollector(tel, fleet=fleet)
    for cid, rm in (("f1", 20.0), ("f2", 22.0), ("slowc", 200.0)):
        fleet.connect(cid)
        fleet.note_report(cid, client=f"stable-{cid}")
        with fleet._lock:
            fleet._rows[cid]["round_ms"] = rm
    assert collector.ingest("c-ack", _FleetReport([5.0] * 20 + [900.0] * 5).builder.build())
    sentinel = HealthSentinel(tel, collector=collector, fleet_straggler_factor=2.0,
                              fleet_ack_p99_ms=100.0, fleet_min_count=8,
                              dump_dir=str(tmp_path))
    hits = {h["band"]: h for h in sentinel.check()}
    assert set(hits) == {"fleet_straggler", "fleet_ack_p99"}
    assert hits["fleet_straggler"]["client_id"] == "slowc"
    assert hits["fleet_straggler"]["client"] == "stable-slowc"
    assert hits["fleet_ack_p99"]["observed"] > 100.0
    assert hits["fleet_straggler"]["bundle"] and hits["fleet_ack_p99"]["bundle"]
    assert sentinel.check() == []  # edge-triggered
    with fleet._lock:  # recovery, then relapse, re-arms the edge
        fleet._rows["slowc"]["round_ms"] = 21.0
    sentinel.check()
    with fleet._lock:
        fleet._rows["slowc"]["round_ms"] = 500.0
    assert [h["band"] for h in sentinel.check()] == ["fleet_straggler"]
    assert tel.counter_value("obs_slo_breach_total", band="fleet_straggler") == 2


# -- lifecycle ------------------------------------------------------------------


def test_telemetry_timeline_lifecycle(tmp_path):
    tel = Telemetry(save_dir=str(tmp_path))
    assert tel.timeline is NOOP_TIMELINE  # unstarted: the shared no-op
    tel.counter("work_total", help="test work").inc(7)
    store = tel.start_timeline(interval_s=0.02)
    assert tel.start_timeline() is store  # idempotent
    deadline = time.time() + 5.0
    while len(store.samples()) < 3 and time.time() < deadline:
        time.sleep(0.02)
    tel.timeline.event("ring_membership", epoch=3, members=["A", "B"])
    tel.stop_timeline()
    assert len(store.samples()) >= 3
    assert store.delta("work_total") == 0.0  # counted before the first sample
    assert tel.timeline is store  # post-run queries keep working
    assert [e["kind"] for e in store.events()] == ["ring_membership"]
    assert os.path.exists(tmp_path / TIMELINE_FILENAME)
    assert tel.counter_value("obs_timeline_samples_total") >= 3
    # the JAX package reads the port's file
    assert jax_timeline.TimelineStore.load(str(tmp_path)).events()[0]["members"] == ["A", "B"]
    disabled = Telemetry(enabled=False)
    assert disabled.timeline is NOOP_TIMELINE
    assert disabled.start_timeline() is NOOP_TIMELINE


def test_async_server_with_timeline_sets_up_and_stops(tmp_path):
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.models.base import SpecModel
    from distriflow_tpu_torch.models.zoo import mnist_mlp
    from distriflow_tpu_torch.server import (
        AsynchronousSGDServer,
        DistributedServerConfig,
        DistributedServerInMemoryModel,
    )

    rng = np.random.RandomState(0)
    x = rng.randn(32, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
    tel = Telemetry()
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(SpecModel(mnist_mlp(hidden=8, device="cpu"))),
        DistributedDataset(x, y, {"batch_size": 16, "epochs": 1}),
        DistributedServerConfig(save_dir=str(tmp_path / "m"), telemetry=tel,
                                timeline_interval_s=0.02))
    server.setup()
    try:
        store = tel.timeline
        assert store is not NOOP_TIMELINE and store.active
        deadline = time.time() + 5.0
        while len(store.samples()) < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        server.stop()
    n = len(store.samples())
    assert n >= 3  # the sampler's samples and the closing one
    time.sleep(0.1)
    assert len(store.samples()) == n  # stopped with the server
    assert os.path.exists(tmp_path / "m" / TIMELINE_FILENAME)
