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
from distriflow_tpu_torch.fleet.soak import SoakModel, frozen_heap
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
    assert dataclasses.asdict(SoakConfig()) == dataclasses.asdict(jax_soak.SoakConfig())


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
            model = SoakModel(
                dim, 0.02, fit_delay_s=0.02, seed=i,
                slow_first=3 if i == 0 else 0, slow_mult=8.0)
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
        while time.monotonic() < deadline:
            controller.step()
            if (dataset.exhausted
                    and server.applied_updates + server.rejected_updates >= total
                    and controller.ramps >= 1):
                break
            time.sleep(0.05)
        assert dataset.exhausted, "run never drained"
        assert controller.ramps == 1
        assert server.client_overrides("rt-0") == {}
        assert server.override_ids() == []
        assert tel_s.counter_value("obs_slo_breach_total", band="fleet_straggler") == 1
        clear_deadline = time.monotonic() + 10.0
        while time.monotonic() < clear_deadline:
            if (straggler.hyperparam("inflight_window") == 2
                    and straggler.hyperparam("topk_fraction") == 0.25):
                break
            time.sleep(0.05)
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

