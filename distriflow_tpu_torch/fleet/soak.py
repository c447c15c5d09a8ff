"""Port of ``distriflow_tpu/fleet/soak.py`` (copied with its imports
rewritten; ``run_soak`` runs under :func:`frozen_heap`).

Training-fleet soak harness: hundreds of clients, churn, chaos, and
an exactness audit at quiescence.

This is the robustness tentpole (docs/ROBUSTNESS.md §10): an in-process
fleet of lightweight simulated training clients — each with its OWN
``Telemetry`` instance (the stand-in for a separate process), a seeded
per-client fit-delay drawn from a heterogeneous-speed distribution, and
optionally a seeded ``FaultPlan`` on its loopback transport — hammering
one ``AsynchronousSGDServer`` while a churn schedule kills clients
abruptly (no goodbye; the server learns via EOF and requeues) and
rejoins them under the same stable identity on a fresh connection.
An :class:`~distriflow_tpu_torch.fleet.controller.AdaptiveController` polls
the health sentinel throughout, so straggler/ack-p99 breaches steer
per-client hyperparams live during the soak.

At quiescence the harness audits, exactly — not approximately:

* **exactly-once apply accounting**: ``applied + rejected`` equals the
  total first-wins batch completions (``epochs x num_batches``), the
  model version counter equals ``applied``, the dataset is exhausted
  with no incomplete or outstanding batches, and no lease is live.
  Duplicate-suppression and first-wins counters must agree with their
  telemetry idents (the wire-visible ledger matches the in-memory one).
* **fleet-vs-local telemetry reconciliation**: after freezing every
  client, each stable client ships one final FULL report snapshot; the
  collector's fleet totals must equal the sum of the clients' local
  cumulative counters for every ident. Full snapshots make this exact
  even when chaos dropped a delta report mid-run.
* **convergence**: the asynchronously-trained model's MSE must land
  within a configured factor of a dense serial baseline that applies
  the same batches in order on one worker.

Everything is seeded; ``run_soak`` is deterministic up to thread/wire
interleaving (which is the point — the INVARIANTS hold under any
interleaving, and the audit proves it for this one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.fleet.controller import AdaptiveController
from distriflow_tpu_torch.models.base import DistributedModel
from distriflow_tpu_torch.obs import HealthSentinel, Telemetry
from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel
from distriflow_tpu_torch.utils.config import RetryPolicy

__all__ = ["SoakConfig", "SoakModel", "SoakResult", "SoakError", "frozen_heap",
           "run_soak"]


class SoakError(AssertionError):
    """An exactness invariant failed at quiescence."""


class SoakModel(DistributedModel):
    """Tiny numpy linear-regression worker model (``DistributedModel``
    surface): params ``{"w": (dim,)}``, MSE loss, gradient
    ``2/B * X^T (Xw - y)``.

    ``fit_delay_s`` simulates heterogeneous device speed (seeded jitter
    per fit); ``slow_first``/``slow_mult`` script a transient straggler:
    the first N fits run ``slow_mult`` x slower, then the client
    recovers — which is what lets the straggler band clear again and
    the controller ramp its override back without manual intervention.
    """

    def __init__(self, dim: int, learning_rate: float = 0.05,
                 fit_delay_s: float = 0.0, jitter: float = 0.0,
                 seed: int = 0, slow_first: int = 0, slow_mult: float = 1.0):
        self.dim = int(dim)
        self.learning_rate = float(learning_rate)
        self.fit_delay_s = float(fit_delay_s)
        self.jitter = float(jitter)
        self.slow_first = int(slow_first)
        self.slow_mult = float(slow_mult)
        self._rng = np.random.default_rng(seed)
        self._fits = 0
        self._params: Dict[str, np.ndarray] = {
            "w": np.zeros(self.dim, dtype=np.float64)}

    def setup(self) -> None:
        pass

    def fit(self, x: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
        delay = self.fit_delay_s
        if self._fits < self.slow_first:
            delay *= self.slow_mult
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        if delay > 0:
            time.sleep(delay)
        self._fits += 1
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        resid = x @ self._params["w"] - y
        return {"w": (2.0 / len(y)) * (x.T @ resid)}

    def update(self, grads: Dict[str, np.ndarray]) -> None:
        self._params["w"] = (
            self._params["w"] - self.learning_rate * np.asarray(grads["w"]))

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) @ self._params["w"]

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> List[float]:
        resid = self.predict(x) - np.asarray(y, dtype=np.float64).reshape(-1)
        return [float(np.mean(resid * resid))]

    def get_params(self) -> Dict[str, np.ndarray]:
        return {k: np.array(v) for k, v in self._params.items()}

    def set_params(self, params: Dict[str, np.ndarray]) -> None:
        self._params = {
            k: np.asarray(v, dtype=np.float64).copy() for k, v in params.items()}

    @property
    def input_shape(self) -> Tuple[Optional[int], int]:
        return (None, self.dim)

    @property
    def output_shape(self) -> Tuple[Optional[int], int]:
        return (None, 1)


@dataclass
class SoakConfig:
    """Knobs for one soak run. Defaults are the tier-1 miniature; the
    ``slow``-marked test and the bench leg scale ``n_clients`` into the
    hundreds."""

    n_clients: int = 24
    seed: int = 0
    # problem size
    dim: int = 6
    batch_size: int = 4
    n_batches: int = 60
    epochs: int = 2
    learning_rate: float = 0.02
    # fleet hyperparams (pushed to every client at handshake; clients
    # deliberately pin NOTHING locally so controller pushes take effect)
    inflight_window: int = 2
    gradient_compression: str = "none"
    topk_fraction: float = 0.25
    report_interval_s: float = 0.02
    # heterogeneous speeds: per-client base fit delay drawn from this
    # range, +/- 40% seeded jitter per fit
    fit_delay_range_s: Tuple[float, float] = (0.001, 0.008)
    # scripted transient straggler (client 0): first N fits slow_mult x
    # slower, then recovers. 0 disables.
    straggler_slow_fits: int = 0
    straggler_slow_mult: float = 25.0
    # churn: abrupt kills (no goodbye) starting churn_start_s into the
    # run, one every churn_interval_s, each rejoining (same stable
    # client_id, fresh connection) after rejoin_delay_s
    churn_kills: int = 4
    churn_start_s: float = 0.3
    churn_interval_s: float = 0.25
    rejoin_delay_s: float = 0.3
    max_dead_fraction: float = 0.25
    # chaos: seeded FaultPlans on a fraction of clients plus a light
    # server-side plan; scripted mid-upload resets on a couple of them
    chaos: bool = True
    chaos_fraction: float = 0.34
    drop: float = 0.02
    duplicate: float = 0.02
    delay: float = 0.05
    delay_s: float = 0.004
    server_drop: float = 0.004
    scripted_resets: int = 2
    # server
    maximum_staleness: int = 100_000
    batch_lease_s: float = 2.0
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 20.0
    # controller / sentinel
    controller: bool = True
    straggler_factor: float = 6.0
    fleet_ack_p99_ms: Optional[float] = None
    recovery_checks: int = 3
    topk_boost: float = 4.0
    poll_interval_s: float = 0.1
    # time-resolved telemetry (docs/OBSERVABILITY.md §12): sampling
    # period of the run timeline (samples + churn/controller/breach
    # events land in save_dir/timeline.jsonl for `dump --timeline`);
    # 0 disables the sampler
    timeline_interval_s: float = 0.05
    # sustained-clean wall-clock window the controller requires before
    # ramping a knob back (trend mode; None derives it from
    # recovery_checks * poll_interval_s when the timeline is on)
    recovery_window_s: Optional[float] = None
    # convergence tolerance vs the dense serial baseline
    loss_factor: float = 3.0
    loss_slack_frac: float = 0.10
    # run control
    timeout_s: float = 120.0
    save_dir: Optional[str] = None
    strict: bool = True  # raise SoakError on any failed invariant


@dataclass
class SoakResult:
    """Everything the audit measured. ``errors`` is empty iff every
    exactness invariant held (``run_soak`` already raised otherwise
    when ``strict``)."""

    n_clients: int
    total_batches: int
    applied: int
    rejected: int
    suppressed: int
    deduped: int
    quarantined: int
    version_counter: int
    kills: int
    rejoins: int
    wall_s: float
    goodput_applies_per_s: float
    ack_p99_ms: float
    round_p99_ms: float
    initial_loss: float
    final_loss: float
    baseline_loss: float
    adaptations: int
    ramps: int
    hparam_pushes: int
    overrides_active: int
    actions: List[Dict[str, Any]] = field(default_factory=list)
    reconcile_ok: bool = True
    counter_idents: int = 0
    mismatches: Dict[str, Tuple[Any, Any]] = field(default_factory=dict)
    clients_evicted: int = 0
    errors: List[str] = field(default_factory=list)

    def bench_numbers(self) -> Dict[str, float]:
        """The ledger-facing scalars (bench.py ``fleet_soak`` row)."""
        return {
            "clients": float(self.n_clients),
            "applies": float(self.applied),
            "goodput_applies_per_s": self.goodput_applies_per_s,
            "ack_p99_ms": self.ack_p99_ms,
            "round_p99_ms": self.round_p99_ms,
            "kills": float(self.kills),
            "rejoins": float(self.rejoins),
            "adaptations": float(self.adaptations),
            "final_loss": self.final_loss,
        }


class _ClientRec:
    """One stable client identity across incarnations: the Telemetry
    instance and ReportBuilder survive abrupt kills so the rejoined
    incarnation keeps the cumulative counters and the collector's seq
    chain (rejoin resets the builder, so the first post-rejoin report
    is a full snapshot and heals any delta lost in the crash)."""

    def __init__(self, stable_id: str, fit_delay_s: float,
                 fault_plan: Optional[FaultPlan]):
        self.stable_id = stable_id
        self.fit_delay_s = fit_delay_s
        self.fault_plan = fault_plan
        self.telemetry = Telemetry()
        self.builder: Any = None  # adopted from the first incarnation
        self.client: Optional[AsynchronousSGDClient] = None
        self.slow_first = 0
        self.slow_mult = 1.0


def _serial_baseline(cfg: SoakConfig, x: np.ndarray, y: np.ndarray) -> float:
    """Dense single-worker baseline: the same batches, in index order,
    applied serially with the same learning rate."""
    model = SoakModel(cfg.dim, cfg.learning_rate)
    for _ in range(cfg.epochs):
        for i in range(cfg.n_batches):
            lo = i * cfg.batch_size
            batch_x = x[lo:lo + cfg.batch_size]
            batch_y = y[lo:lo + cfg.batch_size]
            model.update(model.fit(batch_x, batch_y))
    return model.evaluate(x, y)[0]


def _make_client(rec: _ClientRec, address: str, cfg: SoakConfig,
                 seed: int) -> AsynchronousSGDClient:
    model = SoakModel(
        cfg.dim, cfg.learning_rate, fit_delay_s=rec.fit_delay_s,
        jitter=0.4, seed=seed, slow_first=rec.slow_first,
        slow_mult=rec.slow_mult)
    client = AsynchronousSGDClient(
        address, model,
        DistributedClientConfig(
            client_id=rec.stable_id,
            # ONLY the report cadence is pinned locally: topk_fraction /
            # inflight_window must stay unpinned or server pushes lose
            hyperparams={"telemetry_report_interval_s": cfg.report_interval_s},
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            upload_timeout_s=5.0,
            upload_retry=RetryPolicy(
                max_retries=8, initial_backoff_s=0.05, max_backoff_s=0.5,
                seed=seed),
            fault_plan=rec.fault_plan,
            telemetry=rec.telemetry,
            verbose=False,
        ),
    )
    if rec.builder is None:
        rec.builder = client._report_builder
    else:
        # carry the stable identity's builder into the new incarnation:
        # same seq chain, full snapshot armed
        client._report_builder = rec.builder
        rec.builder.reset()
    return client


def _setup_with_retry(rec: _ClientRec, address: str, cfg: SoakConfig,
                      seed: int, attempts: int = 3) -> bool:
    """Dial + handshake; chaos can eat the handshake, so retry with a
    fresh incarnation (the builder carries over each time)."""
    for _ in range(attempts):
        client = _make_client(rec, address, cfg, seed)
        try:
            client.setup(timeout=15.0)
            rec.client = client
            return True
        except Exception:
            client.dispose()
    rec.client = None
    return False


#: nesting depth of :func:`frozen_heap` blocks (the collector is per process)
_FROZEN = {"depth": 0}
_FROZEN_LOCK = threading.Lock()


@contextlib.contextmanager
def frozen_heap():
    """Keep the objects alive on entry out of the cyclic collector's
    passes for the block (``gc.freeze`` on entering the outermost block,
    ``gc.unfreeze`` on leaving it).

    A full collection walks every tracked object: ~70 ms with torch's
    modules imported, ~115 ms with JAX's as well (on an idle host; more
    under load). An in-process fleet shares that pause across the server
    and every client, so it lands inside each round in flight, and a
    straggler band that reads one round inflated before the others sees a
    straggler that is not there. Freezing the import-time heap leaves the
    collector only what the run allocates."""
    with _FROZEN_LOCK:
        if _FROZEN["depth"] == 0:
            gc.collect()
            gc.freeze()
        _FROZEN["depth"] += 1
    try:
        yield
    finally:
        with _FROZEN_LOCK:
            _FROZEN["depth"] -= 1
            if _FROZEN["depth"] == 0:
                gc.unfreeze()


def run_soak(cfg: SoakConfig) -> SoakResult:
    with frozen_heap():
        return _run_soak(cfg)


def _run_soak(cfg: SoakConfig) -> SoakResult:
    rng = np.random.default_rng(cfg.seed)
    n_samples = cfg.n_batches * cfg.batch_size
    x = rng.normal(size=(n_samples, cfg.dim))
    w_true = rng.normal(size=(cfg.dim,))
    y = x @ w_true + 0.05 * rng.normal(size=(n_samples,))
    initial_loss = float(np.mean(y * y))  # w = 0 start
    baseline_loss = _serial_baseline(cfg, x, y)

    dataset = DistributedDataset(
        x.astype(np.float32), y.astype(np.float32),
        {"batch_size": cfg.batch_size, "epochs": cfg.epochs,
         "shuffle": False})
    total = dataset.num_batches * cfg.epochs

    tel_s = Telemetry()
    tmp: Optional[tempfile.TemporaryDirectory] = None
    save_dir = cfg.save_dir
    if save_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="soak-")
        save_dir = tmp.name

    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(SoakModel(cfg.dim, cfg.learning_rate)),
        dataset,
        DistributedServerConfig(
            save_dir=save_dir,
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            batch_lease_s=cfg.batch_lease_s,
            server_hyperparams={"maximum_staleness": cfg.maximum_staleness},
            client_hyperparams={
                "learning_rate": cfg.learning_rate,
                "inflight_window": cfg.inflight_window,
                "gradient_compression": cfg.gradient_compression,
                "topk_fraction": cfg.topk_fraction,
                "telemetry_report_interval_s": cfg.report_interval_s,
            },
            fault_plan=(FaultPlan(seed=cfg.seed + 999, drop=cfg.server_drop,
                                  duplicate=cfg.server_drop)
                        if cfg.chaos and cfg.server_drop else None),
            telemetry=tel_s,
            verbose=False,
        ),
    )

    # build the fleet roster: seeded heterogeneous speeds + chaos subset
    recs: List[_ClientRec] = []
    n_chaos = int(round(cfg.n_clients * cfg.chaos_fraction)) if cfg.chaos else 0
    for i in range(cfg.n_clients):
        delay = float(rng.uniform(*cfg.fit_delay_range_s))
        plan = None
        if cfg.chaos and i < n_chaos:
            schedule: List[ScriptedFault] = []
            if i < cfg.scripted_resets:
                schedule = [ScriptedFault(event="uploadVars", nth=3,
                                          action="reset")]
            plan = FaultPlan(seed=cfg.seed * 1000 + i, drop=cfg.drop,
                             duplicate=cfg.duplicate, delay=cfg.delay,
                             delay_s=cfg.delay_s, schedule=schedule)
        rec = _ClientRec(f"soak-{i:03d}", delay, plan)
        if i == 0 and cfg.straggler_slow_fits > 0:
            rec.slow_first = cfg.straggler_slow_fits
            rec.slow_mult = cfg.straggler_slow_mult
        recs.append(rec)

    kills = rejoins = 0
    controller: Optional[AdaptiveController] = None
    errors: List[str] = []
    try:
        server.setup()
        if cfg.timeline_interval_s > 0:
            # the run timeline: registry samples + control-plane events,
            # persisted so `dump --timeline <save_dir>` replays the run
            tel_s.start_timeline(interval_s=cfg.timeline_interval_s,
                                 save_dir=save_dir)
        sentinel = HealthSentinel(
            tel_s, collector=server.collector,
            fleet_straggler_factor=(cfg.straggler_factor
                                    if cfg.controller else None),
            fleet_ack_p99_ms=cfg.fleet_ack_p99_ms,
            dump_dir=save_dir)
        if cfg.controller:
            recovery_window_s = cfg.recovery_window_s
            if recovery_window_s is None and cfg.timeline_interval_s > 0:
                # trend mode by default when the timeline is running:
                # the same clean span the streak counter used to demand,
                # measured in wall clock instead of poll counts
                recovery_window_s = cfg.recovery_checks * cfg.poll_interval_s
            controller = AdaptiveController(
                server, sentinel, topk_boost=cfg.topk_boost,
                recovery_checks=cfg.recovery_checks,
                recovery_window_s=recovery_window_s)

        start = time.monotonic()
        for i, rec in enumerate(recs):
            if not _setup_with_retry(rec, server.address, cfg,
                                     cfg.seed * 7919 + i):
                raise SoakError(f"client {rec.stable_id} never joined")

        # churn plan: kill times + pending rejoins
        kill_times = [start + cfg.churn_start_s + k * cfg.churn_interval_s
                      for k in range(cfg.churn_kills)]
        pending_rejoin: List[Tuple[float, _ClientRec]] = []
        max_dead = max(1, int(cfg.max_dead_fraction * cfg.n_clients))
        # the scripted straggler is churn-exempt so drills stay readable
        killable = [r for r in recs if not r.slow_first]

        deadline = start + cfg.timeout_s
        done = False
        while time.monotonic() < deadline:
            now = time.monotonic()
            # rejoins first (frees dead slots), then kills
            for due, rec in list(pending_rejoin):
                if now >= due:
                    pending_rejoin.remove((due, rec))
                    if _setup_with_retry(rec, server.address, cfg,
                                         int(now * 1e3) & 0xFFFF):
                        rejoins += 1
                        tel_s.timeline.event("churn_rejoin",
                                             client=rec.stable_id)
            while kill_times and now >= kill_times[0]:
                kill_times.pop(0)
                live = [r for r in killable if r.client is not None]
                if len(pending_rejoin) >= max_dead or len(live) < 2:
                    continue
                victim = live[int(rng.integers(len(live)))]
                victim.client.abort()  # no goodbye: the server sees EOF
                victim.client = None
                kills += 1
                tel_s.timeline.event("churn_kill", client=victim.stable_id)
                pending_rejoin.append((now + cfg.rejoin_delay_s, victim))
            if controller is not None:
                controller.step()
            if (server.applied_updates + server.rejected_updates >= total
                    and dataset.exhausted
                    and not dataset.outstanding_batches
                    and server.active_leases() == 0):
                done = True
                break
            time.sleep(cfg.poll_interval_s)
        wall_s = time.monotonic() - start
        if not done:
            raise SoakError(
                f"soak did not quiesce in {cfg.timeout_s}s: "
                f"applied={server.applied_updates} "
                f"rejected={server.rejected_updates} of {total}, "
                f"exhausted={dataset.exhausted}, "
                f"outstanding={sorted(dataset.outstanding_batches)}, "
                f"leases={server.active_leases()}, dead={len(pending_rejoin)}")

        # post-drain control polls: fleet rows are frozen at each
        # client's final (recovered) round time, so a breach whose
        # signal cleared late in the run still clears the band and
        # ramps its override back without manual intervention
        if controller is not None:
            for _ in range(cfg.recovery_checks + 2):
                controller.step()
                time.sleep(min(cfg.poll_interval_s, 0.05))
            # trend mode needs a sustained-clean WALL-CLOCK window, not a
            # poll count: keep polling (bounded) until every knob is
            # restored so the ramp-back invariant holds either mode
            ramp_deadline = time.monotonic() + max(
                2.0, 4.0 * (controller.recovery_window_s or 0.0))
            while ((server.override_ids()
                    or server.fleet_window_cap is not None)
                   and time.monotonic() < ramp_deadline):
                controller.step()
                time.sleep(min(cfg.poll_interval_s, 0.05))

        # rejoin anyone still dead so every stable identity quiesces live
        for _, rec in pending_rejoin:
            if _setup_with_retry(rec, server.address, cfg, cfg.seed + 31):
                rejoins += 1
                tel_s.timeline.event("churn_rejoin", client=rec.stable_id)
        pending_rejoin.clear()

        # ---- freeze the fleet, then audit ------------------------------
        for rec in recs:
            if rec.client is not None:
                rec.client.dispose()
                rec.client = None
        time.sleep(0.1)
        # final FULL snapshot per stable client: replaces the collector's
        # view wholesale, so reconciliation is exact even if chaos ate a
        # delta report somewhere mid-run
        for rec in recs:
            rec.builder.reset()
            server.collector.ingest(rec.stable_id, rec.builder.build())

        totals = server.collector.totals()
        local: Dict[str, float] = {}
        for rec in recs:
            for ident, v in rec.telemetry.registry.snapshot()["counters"].items():
                local[ident] = local.get(ident, 0.0) + v
        mismatches = {
            k: (totals.get(k), local.get(k))
            for k in set(totals) | set(local)
            if totals.get(k) != local.get(k)}

        # exactly-once apply accounting
        applied, rejected = server.applied_updates, server.rejected_updates
        if applied + rejected != total:
            errors.append(f"applied({applied}) + rejected({rejected}) != "
                          f"total completions ({total})")
        if server.version_counter != applied:
            errors.append(f"model version {server.version_counter} != "
                          f"applied updates {applied}")
        if not dataset.exhausted:
            errors.append("dataset not exhausted at quiescence")
        if dataset.incomplete_batches:
            errors.append(f"incomplete batches leak: "
                          f"{sorted(dataset.incomplete_batches)}")
        if dataset.outstanding_batches:
            errors.append(f"outstanding batches leak: "
                          f"{sorted(dataset.outstanding_batches)}")
        if server.active_leases():
            errors.append(f"{server.active_leases()} leases leaked")
        stuck = {c: b for c, b in server.outstanding_snapshot().items() if b}
        if stuck:
            errors.append(f"per-client outstanding leak: {stuck}")
        # the wire-visible ledger must agree with the in-memory one
        pairs = [
            ("server_dedup_hits_total", server.duplicate_uploads),
            ("server_first_wins_suppressed_total", server.suppressed_uploads),
            ("server_quarantined_total", server.gate.quarantined_updates),
        ]
        for ident, attr in pairs:
            counted = tel_s.counter_value(ident)
            if counted != attr:
                errors.append(f"{ident} counter {counted} != attribute {attr}")
        if mismatches:
            errors.append(
                f"fleet totals do not reconcile ({len(mismatches)} idents): "
                f"{dict(list(mismatches.items())[:5])}")

        # convergence vs the dense serial baseline
        eval_model = SoakModel(cfg.dim, cfg.learning_rate)
        eval_model.set_params(server.model.get_params())
        final_loss = eval_model.evaluate(x, y)[0]
        bound = baseline_loss * cfg.loss_factor + cfg.loss_slack_frac * initial_loss
        if final_loss > bound:
            errors.append(f"no convergence: async loss {final_loss:.4f} > "
                          f"{bound:.4f} (serial baseline {baseline_loss:.4f},"
                          f" initial {initial_loss:.4f})")

        ack = server.collector.fleet_histogram(
            "transport_ack_latency_ms", role="client")
        ack_summary = ack.summary() if ack is not None else {}
        # p99 round time across the fleet: each row's last download ->
        # upload gap, frozen at quiescence
        rounds = sorted(
            r["round_ms"] for r in server.fleet.snapshot().values()
            if r.get("round_ms") is not None)
        round_p99 = (rounds[min(len(rounds) - 1,
                                int(0.99 * len(rounds)))]
                     if rounds else 0.0)
        result = SoakResult(
            n_clients=cfg.n_clients,
            total_batches=total,
            applied=applied,
            rejected=rejected,
            suppressed=server.suppressed_uploads,
            deduped=server.duplicate_uploads,
            quarantined=server.gate.quarantined_updates,
            version_counter=server.version_counter,
            kills=kills,
            rejoins=rejoins,
            wall_s=wall_s,
            goodput_applies_per_s=applied / wall_s if wall_s > 0 else 0.0,
            ack_p99_ms=float(ack_summary.get("p99") or 0.0),
            round_p99_ms=float(round_p99),
            initial_loss=initial_loss,
            final_loss=final_loss,
            baseline_loss=baseline_loss,
            adaptations=controller.adaptations if controller else 0,
            ramps=controller.ramps if controller else 0,
            hparam_pushes=int(tel_s.counter_value("server_hparam_pushes_total")),
            overrides_active=len(server.override_ids()),
            actions=controller.actions() if controller else [],
            reconcile_ok=not mismatches,
            counter_idents=len(totals),
            mismatches=mismatches,
            clients_evicted=server.collector.clients_evicted,
            errors=errors,
        )
        if cfg.strict and errors:
            raise SoakError("soak audit failed:\n  " + "\n  ".join(errors))
        return result
    finally:
        for rec in recs:
            if rec.client is not None:
                rec.client.dispose()
        tel_s.stop_timeline()
        server.stop()
        if tmp is not None:
            tmp.cleanup()
