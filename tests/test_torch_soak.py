"""Port parity: the training-fleet soak harness (``distriflow_tpu_torch/
fleet/soak.py``) and its ``AdaptiveController`` over the port's async
server and clients.

- The tier-1 cases of ``tests/test_soak.py`` on the port: the miniature
  soak's exact audit under churn and chaos, the collector's LRU bound, and
  the controller loop observed at the wire (a transient straggler trips
  ``fleet_straggler`` once, the override round-trips onto the client's
  effective hyperparams and ramps back); the fleet-scale soak in the
  ``slow`` tier, as JAX marks it.
- ``SoakModel`` and the dense serial baseline are the JAX package's
  numpy, bit for bit: the same gradients, the same baseline loss.
- The port's event-ordered straggler (``GatedStraggler``,
  ``SoakConfig.straggler_until_override``): slow until the controller's
  override has reached it, never by a fit count.
"""

import dataclasses
import time

import numpy as np
import pytest

from distriflow_tpu.fleet import soak as jax_soak
from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.fleet import AdaptiveController, SoakConfig, run_soak
from distriflow_tpu_torch.fleet import soak as port_soak
from distriflow_tpu_torch.fleet.soak import GatedStraggler, SoakModel, frozen_heap
from distriflow_tpu_torch.obs import HealthSentinel, Telemetry
from distriflow_tpu_torch.obs.collector import ReportBuilder, TelemetryCollector
from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel

pytestmark = [pytest.mark.port, pytest.mark.soak, pytest.mark.chaos]


def _data(cfg, seed):
    rng = np.random.default_rng(seed)
    n = cfg.n_batches * cfg.batch_size
    x = rng.normal(size=(n, cfg.dim))
    y = x @ rng.normal(size=(cfg.dim,)) + 0.05 * rng.normal(size=(n,))
    return x, y


@pytest.mark.parametrize("overrides", [{}, {"dim": 5, "n_batches": 17, "epochs": 3},
                                       {"learning_rate": 0.2, "batch_size": 3}])
def test_serial_baseline_bit_equal(overrides):
    port_cfg = dataclasses.replace(SoakConfig(), **overrides)
    jax_cfg = dataclasses.replace(jax_soak.SoakConfig(), **overrides)
    x, y = _data(port_cfg, 11)
    got = port_soak._serial_baseline(port_cfg, x, y)
    want = jax_soak._serial_baseline(jax_cfg, x, y)
    assert got == want  # the same float64 bits


def test_soak_model_matches_jax():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(8, 6)), rng.normal(size=(8,))
    a, b = SoakModel(6, 0.05, seed=1), jax_soak.SoakModel(6, 0.05, seed=1)
    for _ in range(3):
        ga, gb = a.fit(x, y), b.fit(x, y)
        np.testing.assert_array_equal(ga["w"], gb["w"])
        a.update(ga)
        b.update(gb)
    np.testing.assert_array_equal(a.get_params()["w"], b.get_params()["w"])
    assert a.evaluate(x, y) == b.evaluate(x, y)
    # JAX's fields and defaults, plus the port's one test aid, off by default
    port_cfg = dataclasses.asdict(SoakConfig())
    assert port_cfg.pop("straggler_until_override") is False
    assert port_cfg == dataclasses.asdict(jax_soak.SoakConfig())


def test_soak_miniature(tmp_path):
    result = run_soak(SoakConfig(save_dir=str(tmp_path)))
    assert result.errors == []
    assert result.applied + result.rejected == result.total_batches
    assert result.version_counter == result.applied
    assert result.reconcile_ok and not result.mismatches
    assert result.counter_idents > 0
    assert result.kills >= 2
    assert result.rejoins == result.kills
    assert result.final_loss < result.initial_loss / 2
    assert result.final_loss <= (result.baseline_loss * 3.0 + 0.10 * result.initial_loss)
    # the same data and baseline as JAX's harness at the same seed
    x, y = _data(SoakConfig(), SoakConfig().seed)
    assert result.baseline_loss == jax_soak._serial_baseline(jax_soak.SoakConfig(), x, y)


@pytest.mark.slow
def test_soak_fleet_scale(tmp_path):
    result = run_soak(SoakConfig(
        n_clients=220, n_batches=400, epochs=2, churn_kills=24,
        churn_interval_s=0.15, timeout_s=300, save_dir=str(tmp_path)))
    assert result.errors == []
    assert result.n_clients >= 200
    assert result.applied + result.rejected == result.total_batches
    assert result.reconcile_ok and not result.mismatches
    assert result.kills >= 10 and result.rejoins == result.kills


def test_collector_lru_stays_flat():
    tel = Telemetry()
    collector = TelemetryCollector(telemetry=tel, max_clients=32)
    for i in range(500):
        client_tel = Telemetry()
        client_tel.counter("client_uploads_total").inc()
        builder = ReportBuilder(client_tel, f"cycle-{i:03d}")
        assert collector.ingest(f"cycle-{i:03d}", builder.build())
        assert len(collector.client_ids()) <= 32
    assert len(collector.client_ids()) == 32
    assert collector.clients_evicted == 500 - 32
    assert tel.counter_value("fleet_clients_evicted_total") == 500 - 32
    assert collector.totals()["client_uploads_total"] == 32.0


def _uploads_of(server, stable_id):
    rows = server.fleet.snapshot()
    return sum(rows[c]["uploads"] for c in server.connections_of(stable_id) if c in rows)


def test_straggler_override_roundtrip(tmp_path):
    # the fleet shares this process, whose heap holds JAX's and torch's
    # modules: a full collection (~0.1 s) lands inside every round in
    # flight, so keep that heap out of it as run_soak does
    with frozen_heap():
        _straggler_override_roundtrip(tmp_path)


def _straggler_override_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    dim, bs, n_batches, epochs = 6, 4, 120, 2
    x = rng.normal(size=(n_batches * bs, dim)).astype(np.float32)
    y = (x @ rng.normal(size=(dim,))).astype(np.float32)
    dataset = DistributedDataset(x, y, {"batch_size": bs, "epochs": epochs})
    total = n_batches * epochs
    tel_s = Telemetry()
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(SoakModel(dim, 0.02)),
        dataset,
        DistributedServerConfig(
            save_dir=str(tmp_path),
            heartbeat_interval_s=0.2, heartbeat_timeout_s=10.0,
            server_hyperparams={"maximum_staleness": 1000},
            client_hyperparams={
                "learning_rate": 0.02, "inflight_window": 2,
                "topk_fraction": 0.25,
                "telemetry_report_interval_s": 0.01,
            },
            telemetry=tel_s, verbose=False,
        ),
    )
    clients = []
    try:
        server.setup()
        sentinel = HealthSentinel(
            tel_s, collector=server.collector,
            fleet_straggler_factor=3.0, dump_dir=str(tmp_path))
        controller = AdaptiveController(server, sentinel, recovery_checks=2)
        for i in range(4):
            model = (GatedStraggler if i == 0 else SoakModel)(
                dim, 0.02, fit_delay_s=0.02, seed=i, slow_mult=8.0)
            if i == 0:
                slow_model = model
            client = AsynchronousSGDClient(
                server.address, model,
                DistributedClientConfig(
                    client_id=f"rt-{i}",
                    hyperparams={"telemetry_report_interval_s": 0.01},
                    heartbeat_interval_s=0.2, heartbeat_timeout_s=10.0,
                    upload_timeout_s=5.0, telemetry=Telemetry(),
                    verbose=False,
                ),
            )
            client.setup(timeout=15.0)
            clients.append(client)
        straggler = clients[0]
        slow_model.overridden = lambda: straggler.hyperparam("inflight_window") == 1
        assert straggler.hyperparam("inflight_window") == 2
        assert straggler.hyperparam("topk_fraction") == 0.25

        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and controller.adaptations < 1:
            controller.step()
            time.sleep(0.05)
        assert controller.adaptations == 1, "straggler band never tripped"
        assert server.override_ids() == ["rt-0"]
        knobs = {a["knob"]: a for a in controller.actions() if a["action"] == "adapt"}
        assert knobs["inflight_window"]["new"] == 1
        assert knobs["topk_fraction"]["new"] == 1.0
        assert knobs["inflight_window"]["client"] == "rt-0"
        push_deadline = time.monotonic() + 10.0
        while time.monotonic() < push_deadline:
            if (straggler.hyperparam("inflight_window") == 1
                    and straggler.hyperparam("topk_fraction") == 1.0):
                break
            time.sleep(0.02)
        assert straggler.hyperparam("inflight_window") == 1
        assert straggler.hyperparam("topk_fraction") == 1.0
        # the band is judged only at a controller poll: poll again once
        # the server holds an upload from a fast fit, so that rt-0's
        # latest round is never a stale slow one when its band clears
        while time.monotonic() < deadline and (
                slow_model.fits_before_fast is None
                or _uploads_of(server, "rt-0") <= slow_model.fits_before_fast):
            time.sleep(0.01)
        while time.monotonic() < deadline and controller.ramps < 1:
            controller.step()
            time.sleep(0.05)
        clear_deadline = time.monotonic() + 10.0
        while time.monotonic() < clear_deadline:
            if (straggler.hyperparam("inflight_window") == 2
                    and straggler.hyperparam("topk_fraction") == 0.25):
                break
            time.sleep(0.05)
        # the roundtrip ends when the cleared override has reached rt-0; the
        # controller is not polled while the rest drains, where a host stall
        # on any client would read as a new straggler by the wall clock alone
        while time.monotonic() < deadline and not (
                dataset.exhausted
                and server.applied_updates + server.rejected_updates >= total):
            time.sleep(0.05)
        assert dataset.exhausted, "run never drained"
        assert controller.ramps == 1
        assert server.client_overrides("rt-0") == {}
        assert server.override_ids() == []
        assert tel_s.counter_value("obs_slo_breach_total", band="fleet_straggler") == 1
        assert straggler.hyperparam("inflight_window") == 2
        assert straggler.hyperparam("topk_fraction") == 0.25
        assert tel_s.counter_value("obs_slo_breach_total", band="fleet_straggler") == 1
    finally:
        for client in clients:
            client.dispose()
        server.stop()


def test_frozen_heap_nests_and_restores():
    import gc

    gc.unfreeze()
    junk = [[i] for i in range(1000)]
    with frozen_heap():
        frozen = gc.get_freeze_count()  # frozen objects may still die: it only falls
        assert frozen >= 1000
        fresh = [[i] for i in range(1000)]  # tracked after the freeze
        with frozen_heap():  # nested: no second freeze
            assert gc.get_freeze_count() <= frozen
        assert gc.get_freeze_count() > 0  # and no early unfreeze
    assert gc.get_freeze_count() == 0
    del junk, fresh



def test_gated_straggler_recovers_only_when_overridden():
    model = GatedStraggler(3, fit_delay_s=0.005, slow_mult=8.0)
    x, y = np.ones((2, 3)), np.ones(2)
    for _ in range(6):  # more slow fits than any fit count scripts
        model.fit(x, y)
    assert model.fits_before_fast is None
    model.overridden = lambda: True
    model.fit(x, y)
    model.overridden = lambda: False  # a cleared override keeps it fast
    model.fit(x, y)
    assert model.fits_before_fast == 6
    assert [reached for _, reached in model.fit_log] == [False] * 6 + [True] * 2
    assert all(s >= 0.04 for s, _ in model.fit_log[:6])


def test_soak_straggler_stays_slow_until_its_override_lands(tmp_path):
    """The doctor's straggler leg: every fit of the straggler that ran
    before the controller's override reached it was slow (a straggler
    that recovers first, as a fit count lets it, fails here), and the
    override was pushed once and ramped back."""
    res = run_soak(SoakConfig(
        n_clients=6, n_batches=120, epochs=2, chaos=False, churn_kills=0,
        straggler_until_override=True, straggler_slow_mult=8.0,
        fit_delay_range_s=(0.015, 0.025), straggler_factor=3.0, recovery_checks=2,
        poll_interval_s=0.05, save_dir=str(tmp_path), timeout_s=90))
    assert res.errors == [] and res.reconcile_ok
    assert res.adaptations == 1 and res.ramps >= 1 and res.overrides_active == 0
    before = [s for s, reached in res.straggler_fits if not reached]
    after = [s for s, reached in res.straggler_fits if reached]
    assert before and after, res.straggler_fits
    # slow: 8 x a base delay of at least 15 ms, less the 40% jitter
    assert min(before) >= 8 * 0.015 * 0.6, before


def test_poll_opens_only_once_the_straggler_round_reached_the_server():
    """``straggler_until_override``'s event order: no poll before the
    server holds an upload of the straggler's slow fit (the polls would
    judge the other clients' rounds alone), none after the adaptation
    until an upload of a fast fit has arrived, none after the ramp."""

    class _Server:
        uploads = 0

        def connections_of(self, stable_id):
            return ["c0"]

        @property
        def fleet(self):
            server = self

            class _Fleet:
                def snapshot(self):
                    return {"c0": {"uploads": server.uploads}}

            return _Fleet()

    class _Controller:
        adaptations = 0
        ramps = 0

    class _Model:
        fits_before_fast = None

    class _Rec:
        stable_id = "soak-000"
        model = _Model()

    server, ctl, rec = _Server(), _Controller(), _Rec()
    assert port_soak._poll_open(ctl, server, None)
    assert not port_soak._poll_open(ctl, server, rec)
    server.uploads = 1  # the slow round reached the server
    assert port_soak._poll_open(ctl, server, rec)
    ctl.adaptations = 1
    assert not port_soak._poll_open(ctl, server, rec)  # still slow
    rec.model.fits_before_fast = 3
    server.uploads = 3
    assert not port_soak._poll_open(ctl, server, rec)  # no fast upload yet
    server.uploads = 4
    assert port_soak._poll_open(ctl, server, rec)
    ctl.ramps = 1
    assert not port_soak._poll_open(ctl, server, rec)
