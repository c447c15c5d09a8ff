"""Port parity: the offline run summary ``python -m
distriflow_tpu_torch.obs.dump`` against the JAX package's ``dump``.

Run dirs are written by each package's own planes: a loopback async
training run (``metrics.jsonl`` with the fleet rows, ``spans.jsonl``, a
``timeline.jsonl`` with a breach event, one flight bundle) and, for the
port, a routed serving run (request spans at tiers 0 and 1). A torn last
line is appended to each JSONL file. On every run dir, in every mode
(plain, ``--flight``, ``--critical-path``, ``--requests [--tier]``,
``--fleet``, ``--timeline [--window|--idents]``, ``--watch``, ``--fleet
--watch``), the two ``dump``s print the same lines and exit with the
same code, and the torn lines are counted.
"""

import contextlib
import importlib
import io
import os
import time

import numpy as np
import pytest
import torch

from distriflow_tpu.obs import dump as jax_dump
from distriflow_tpu_torch.obs import dump as port_dump

pytestmark = pytest.mark.port
torch.set_num_threads(2)

MODES = [
    [],
    ["--flight"],
    ["--critical-path"],
    ["--critical-path", "--max-rounds", "2"],
    ["--requests"],
    ["--requests", "--tier", "0"],
    ["--fleet"],
    ["--timeline"],
    ["--timeline", "--window", "0.3"],
    ["--timeline", "--idents", "transport_frames_sent_total,obs_timeline_samples_total"],
    ["--watch", "--interval", "0", "--iterations", "2"],
    ["--fleet", "--watch", "--interval", "0", "--iterations", "1"],
]
MODE_IDS = ["plain", "flight", "critical_path", "critical_path_max2", "requests",
            "requests_tier0", "fleet", "timeline", "timeline_window", "timeline_idents",
            "watch", "fleet_watch"]


def _wire_run(pkg, run_dir):
    """A loopback async training run of ``pkg``'s planes (the doctor's
    protocol-level model) into ``run_dir``: a scripted 0.4 s ack delay
    trips the ack band once (one flight bundle, one timeline event); two
    snapshots are exported; a torn line ends each JSONL file."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    TinyModel = mod("doctor")._tiny_model_cls()
    transport = mod("comm.transport")
    obs = mod("obs")
    health = mod("obs.health")
    x = np.arange(16, dtype=np.float32).reshape(16, 1)
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    dataset = mod("data.dataset").DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
    tel = obs.Telemetry(save_dir=run_dir)
    tel.start_timeline(interval_s=0.05, save_dir=run_dir)
    watch = health.HealthSentinel(tel, bands=health.default_bands(ack_p99_ms=250.0),
                                  dump_dir=run_dir)
    server = mod("server.async_server").AsynchronousSGDServer(
        mod("server.models").DistributedServerInMemoryModel(TinyModel()), dataset,
        mod("server.abstract_server").DistributedServerConfig(
            heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0, telemetry=tel))
    server.setup()
    plan = transport.FaultPlan(seed=13, schedule=[transport.ScriptedFault(
        event="uploadVars", nth=2, action="delay", delay_s=0.4)])
    client = mod("client.async_client").AsynchronousSGDClient(
        server.address, TinyModel(),
        mod("client.abstract_client").DistributedClientConfig(
            client_id="dump-client",
            hyperparams={"telemetry_report_interval_s": 0.01},
            heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0, upload_timeout_s=5.0,
            fault_plan=plan, telemetry=tel))
    try:
        client.setup(timeout=10.0)
        tel.export_snapshot()
        client.train_until_complete(timeout=60.0)
        deadline = time.monotonic() + 10.0
        while server.applied_updates < 8 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [e["band"] for e in watch.check()] == ["ack_latency_p99"]
        tel.export_snapshot()
    finally:
        client.dispose()
        server.stop()
    tel.stop_timeline()
    _tear(run_dir)


def _serving_run(run_dir):
    """Two port replicas behind the port's router, one telemetry saving to
    ``run_dir``: requests at tiers 0 and 1, one asked directly."""
    from distriflow_tpu_torch.client import InferenceClient
    from distriflow_tpu_torch.fleet import FleetRouter, RouterClient
    from distriflow_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        init_weights,
    )
    from distriflow_tpu_torch.obs import Telemetry
    from distriflow_tpu_torch.server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                            max_seq=48, dtype=torch.float32, use_flash_attention=False,
                            use_flash_decode=False)
    model = init_weights(TransformerLM(cfg, device="cpu"), seed=0)
    tel = Telemetry(save_dir=run_dir)
    replicas = [InferenceServer(model, port=0, telemetry=tel, serving=ServingConfig(
        batch_window_s=0.02, decode_chunk=4, max_slots=2)).setup() for _ in range(2)]
    router = FleetRouter(port=0, policy="least_loaded", stats_interval_s=0.0, redial=False,
                         telemetry=tel)
    for name, srv in zip("AB", replicas):
        router.add_replica(srv.address, name=name)
    router.setup()
    prompt = np.random.default_rng(5).integers(1, 64, size=(1, 9)).astype(np.int32)
    try:
        with InferenceClient(replicas[0].address, telemetry=tel) as direct:
            direct.generate(prompt, 3, tier=1)
        with RouterClient(router.address, telemetry=tel) as c:
            for tier in (0, 0, 1):
                c.generate(prompt, 4, tier=tier)
        tel.export_snapshot()
    finally:
        router.stop()
        for srv in replicas:
            srv.stop()
    _tear(run_dir)


def _tear(run_dir):
    for name in ("metrics.jsonl", "spans.jsonl", "timeline.jsonl"):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            with open(path, "a") as f:
                f.write('{"torn": \n')


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    dirs = {}
    for name, fn in (("port_wire", lambda d: _wire_run("distriflow_tpu_torch", d)),
                     ("port_serving", _serving_run),
                     ("jax_wire", lambda d: _wire_run("distriflow_tpu", d))):
        d = str(tmp_path_factory.mktemp(name))
        fn(d)
        dirs[name] = d
    return dirs


def _run(dump, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dump.main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("which", ["port_wire", "port_serving", "jax_wire"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_same_lines_both_dumps(run_dirs, which, mode):
    argv = [run_dirs[which], *mode]
    rc_port, port_lines = _run(port_dump, argv)
    rc_jax, jax_lines = _run(jax_dump, argv)
    assert rc_port == rc_jax
    assert port_lines == jax_lines
    assert port_lines  # every mode prints something


def test_run_dirs_hold_every_source(run_dirs):
    from distriflow_tpu_torch.obs.flight_recorder import read_bundles
    from distriflow_tpu_torch.obs.timeline import TimelineStore

    for which in ("port_wire", "jax_wire"):
        d = run_dirs[which]
        assert len(read_bundles(d)) == 1, which
        assert [e["kind"] for e in TimelineStore.load(d).events()].count("slo_breach") == 1
    rc, lines = _run(port_dump, [run_dirs["port_serving"], "--requests"])
    assert rc == 0 and any("assembled" in ln for ln in lines), lines


@pytest.mark.parametrize("which", ["port_wire", "jax_wire"])
def test_torn_lines_counted(run_dirs, which):
    rc, lines = _run(port_dump, [run_dirs[which]])
    body = "\n".join(lines)
    assert rc == 0
    assert body.count("1 malformed line(s) skipped") == 2, body
    rc, lines = _run(port_dump, [run_dirs[which], "--critical-path"])
    assert "1 malformed jsonl line(s) skipped" in "\n".join(lines)


def test_missing_dir_exit_code(tmp_path):
    for mode in MODES[:8]:
        argv = [str(tmp_path / "nothing"), *mode]
        assert _run(port_dump, argv)[0] == _run(jax_dump, argv)[0]
