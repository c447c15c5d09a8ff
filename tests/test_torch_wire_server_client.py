"""The port's wire-training servers and clients over loopback, on the CPU.

The counterparts of ``tests/test_server_client.py``: a real port server on
localhost, real port clients, a numpy mock model or ``mnist_mlp`` on both
sides. Every wait has its own deadline, so a hang fails the test instead
of eating the suite's clock.
"""

import threading
import time
from typing import List

import numpy as np
import pytest

from distriflow_tpu_torch.client import (
    AsynchronousSGDClient,
    DistributedClientConfig,
    FederatedClient,
)
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.models.base import DistributedModel, SpecModel
from distriflow_tpu_torch.models.zoo import mnist_mlp
from distriflow_tpu_torch.server import (
    AsynchronousSGDServer,
    DistributedServerConfig,
    DistributedServerInMemoryModel,
    FederatedServer,
)
from distriflow_tpu_torch.utils.messages import GradientMsg, UploadMsg
from distriflow_tpu_torch.utils.serialization import serialize_tree

pytestmark = pytest.mark.port


class MockModel(DistributedModel):
    """The JAX suite's ``MockModel`` on numpy: ``fit`` returns the params
    as "gradients", ``update`` subtracts them scaled by ``lr``."""

    def __init__(self, dim: int = 4, lr: float = 0.1):
        self._params = {"w": np.ones((dim,), np.float32), "b": np.zeros((2,), np.float32)}
        self.lr = lr
        self.fit_calls = 0
        self.update_calls = 0

    def fit(self, x, y):
        self.fit_calls += 1
        return {k: np.asarray(v).copy() for k, v in self._params.items()}

    def update(self, grads) -> None:
        self.update_calls += 1
        self._params = {
            k: np.asarray(self._params[k] - self.lr * np.asarray(grads[k]), np.float32)
            for k in self._params}

    def predict(self, x):
        return np.zeros((len(x), 2), np.float32)

    def evaluate(self, x, y) -> List[float]:
        return [0.0]

    def get_params(self):
        return self._params

    def set_params(self, params) -> None:
        self._params = {k: np.asarray(v, np.float32) for k, v in params.items()}

    @property
    def input_shape(self):
        return (4,)

    @property
    def output_shape(self):
        return (2,)


def _wait(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, f"timed out after {seconds}s waiting for {what}"
        time.sleep(0.01)


def _mlp(hidden: int, lr=None) -> SpecModel:
    return SpecModel(mnist_mlp(hidden=hidden, device="cpu"), learning_rate=lr)


@pytest.fixture
def fed_server(tmp_path):
    server = FederatedServer(
        DistributedServerInMemoryModel(MockModel()),
        DistributedServerConfig(
            server_hyperparams={"min_updates_per_version": 2},
            client_hyperparams={"examples_per_update": 2},
            save_dir=str(tmp_path / "models"),
        ),
    )
    server.setup()
    yield server
    server.stop()


def _fed_client(server, **cfg):
    client = FederatedClient(server.address, MockModel(), DistributedClientConfig(**cfg))
    client.setup(timeout=10)
    return client


def test_initial_version_transmitted(fed_server):
    client = _fed_client(fed_server)
    try:
        assert client.msg is not None
        assert client.msg.model.version == fed_server.model.version
        assert client.msg.hyperparams["examples_per_update"] == 2
    finally:
        client.dispose()


def test_upload_lands_in_server_buffer(fed_server):
    client = _fed_client(fed_server)
    try:
        x = np.ones((1, 4), np.float32)
        y = np.ones((1, 2), np.float32)
        client.distributed_update(x, y)  # 1 example: below examples_per_update
        assert len(fed_server.updates) == 0
        client.distributed_update(x, y)  # now 2 -> one upload
        _wait(lambda: len(fed_server.updates) >= 1, 5, "the buffered upload")
        assert len(fed_server.updates) == 1
        assert fed_server.num_updates == 1
    finally:
        client.dispose()


def test_aggregation_broadcasts_new_version(fed_server):
    client = _fed_client(fed_server)
    try:
        v0 = fed_server.model.version
        got_new = threading.Event()
        client.on_new_version(lambda v: got_new.set() if v != v0 else None)
        x = np.ones((4, 4), np.float32)
        y = np.ones((4, 2), np.float32)
        client.distributed_update(x, y)  # 4 examples -> 2 uploads -> aggregation
        assert got_new.wait(5), "no new version broadcast within 5s"
        assert fed_server.model.version != v0
        assert fed_server.model.model.update_calls == 1
        # the delta broadcast landed: the client holds the server's weights
        _wait(lambda: client.msg.model.version == fed_server.model.version, 5, "the install")
        for k, v in fed_server.model.get_params().items():
            np.testing.assert_allclose(client.model.get_params()[k], v, rtol=1e-6)
    finally:
        client.dispose()


def test_stale_gradient_dropped(fed_server):
    client = _fed_client(fed_server)
    try:
        x = np.ones((4, 4), np.float32)
        y = np.ones((4, 2), np.float32)
        client.distributed_update(x, y)  # triggers aggregation; version changes
        v0_updates = fed_server.num_updates
        _wait(lambda: fed_server.model.model.update_calls >= 1, 5, "the aggregation")
        stale = UploadMsg(
            client_id=client.client_id,
            gradients=GradientMsg(version="bogus-old-version",
                                  vars=serialize_tree(MockModel().get_params())))
        assert client.upload(stale) is False
        assert fed_server.num_updates == v0_updates
    finally:
        client.dispose()


@pytest.mark.parametrize("inflight_window,delta_broadcast", [(1, True), (2, True), (1, False)])
def test_async_sgd_end_to_end(tmp_path, inflight_window, delta_broadcast):
    """Full ping-pong with a real model: the server dispatches batches, the
    client trains, the model learns (serial and pipelined uploads, delta
    and full broadcasts)."""
    rng = np.random.RandomState(0)
    n = 96
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, n)
    x[np.arange(n), 0, labels, 0] += 4.0
    y = np.eye(10, dtype=np.float32)[labels]

    dataset = DistributedDataset(x, y, {"batch_size": 32, "epochs": 4})
    server_model = _mlp(16, lr=0.1)
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(server_model),
        dataset,
        DistributedServerConfig(
            server_hyperparams={"maximum_staleness": 10, "min_updates_per_version": 1,
                                "delta_broadcast": delta_broadcast},
            client_hyperparams={"inflight_window": inflight_window},
            save_dir=str(tmp_path / "models"),
        ),
    )
    server.setup()
    client = AsynchronousSGDClient(server.address, _mlp(16, lr=0.1))
    try:
        before = float(server_model.evaluate(x, y)[0])
        client.setup(timeout=10)
        done = client.train_until_complete(timeout=120)
        assert done == 12  # 3 batches x 4 epochs
        _wait(lambda: server.applied_updates + server.rejected_updates == 12, 10, "the applies")
        assert server.applied_updates == 12
        after_loss, after_acc = server_model.evaluate(x, y)[:2]
        assert after_loss < before
        assert after_acc > 0.5
        assert dataset.exhausted
    finally:
        client.dispose()
        server.stop()


class _HeldInstallClient(AsynchronousSGDClient):
    """Holds the first fit between its forward and its backward until the
    second download's install has run (or ``hold_s`` passed): the window
    in which a dispatch-ahead download lands while a fit is in flight."""

    hold_s = 1.0

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fit_started = threading.Event()
        self.second_installed = threading.Event()
        self._installs = 0
        self._count_lock = threading.Lock()
        self._held = False

    def set_params_from(self, msg):
        with self._count_lock:
            n, self._installs = self._installs, self._installs + 1
        if n == 1:
            assert self.fit_started.wait(10), "the first fit never started"
        installed = super().set_params_from(msg)
        if n == 1:
            self.second_installed.set()
        return installed

    def hold_first_fit(self, module, inputs, output):
        if not self._held:
            self._held = True
            self.fit_started.set()
            self.second_installed.wait(self.hold_s)


def test_pipelined_install_waits_for_inflight_fit(tmp_path):
    """Regression: with ``inflight_window`` 2 the server dispatches two
    batches at once and the client handles them on two transport threads.
    The second install copied the weights in place while the first fit's
    autograd graph held them, so its backward raised, the batch was never
    uploaded, and client and server both waited forever. The install now
    waits for the fit; the first fit is held mid-step here so the two
    always overlap."""
    rng = np.random.RandomState(0)
    n = 64
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    dataset = DistributedDataset(x, y, {"batch_size": 32, "epochs": 1})
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(_mlp(16, lr=0.1)),
        dataset,
        DistributedServerConfig(
            # full downloads: the two installs may run in either order
            server_hyperparams={"maximum_staleness": 10, "min_updates_per_version": 1,
                                "delta_broadcast": False},
            client_hyperparams={"inflight_window": 2},
            save_dir=str(tmp_path / "models"),
        ),
    )
    server.setup()
    model = _mlp(16, lr=0.1)
    model.setup()
    client = _HeldInstallClient(server.address, model)
    model.model.register_forward_hook(client.hold_first_fit)
    try:
        client.setup(timeout=10)
        assert client.train_until_complete(timeout=20) == 2
        assert client.fit_started.is_set()
        _wait(lambda: server.applied_updates == 2, 10, "the applies")
        assert dataset.exhausted
    finally:
        client.dispose()
        server.stop()


def test_abort_never_joins_an_unstarted_comm_thread(monkeypatch):
    """Regression: ``abort()`` read ``_comm_thread`` without ``_comm_cv``
    while ``_comm_acquire_slot`` assigns the attribute and only then starts
    the thread, so an abort in that window joined a thread that had not
    started ("cannot join thread before it is started"). The comm thread's
    ``start()`` is held here until the abort has had its chance to run."""
    from distriflow_tpu_torch.client import abstract_client

    assigned, go = threading.Event(), threading.Event()

    class _HeldStart(threading.Thread):
        def start(self):
            assigned.set()
            go.wait(timeout=10.0)
            super().start()

    class _Threading:
        Thread = _HeldStart

        def __getattr__(self, name):
            return getattr(threading, name)

    monkeypatch.setattr(abstract_client, "threading", _Threading())
    client = AsynchronousSGDClient("127.0.0.1:1", MockModel())  # never dialled
    got, errors = [], []

    def acquire():
        got.append(client._comm_acquire_slot())

    def abort():
        try:
            client.abort()
        except Exception as e:  # surfaced below
            errors.append(e)

    holder = threading.Thread(target=acquire)
    holder.start()
    assert assigned.wait(timeout=10.0), "the comm thread was never created"
    aborter = threading.Thread(target=abort)
    aborter.start()
    aborter.join(timeout=0.5)  # the race: the thread is assigned, not started
    go.set()
    holder.join(timeout=10.0)
    aborter.join(timeout=10.0)
    assert not holder.is_alive() and not aborter.is_alive()
    assert errors == [], errors
    assert client._comm_thread is None
    assert got == [True]  # the slot was taken before the abort reaped it
    assert client._comm_acquire_slot() is False  # disposed: no new thread


def test_async_server_staleness_default_is_tolerant(tmp_path):
    """Async mode does not inherit the sync-mode staleness-0 default;
    explicit settings (0 included) are honoured."""
    x = np.zeros((8, 28, 28, 1), np.float32)
    y = np.eye(10, dtype=np.float32)[np.zeros(8, np.int64)]

    def make(hp):
        return AsynchronousSGDServer(
            DistributedServerInMemoryModel(_mlp(4)),
            DistributedDataset(x, y, {"batch_size": 4}),
            DistributedServerConfig(server_hyperparams=hp, save_dir=str(tmp_path)),
        )

    default = AsynchronousSGDServer.DEFAULT_MAXIMUM_STALENESS
    assert default == 8
    assert make(None).hyperparams.maximum_staleness == default
    assert make({"min_updates_per_version": 3}).hyperparams.maximum_staleness == default
    assert make({"maximum_staleness": None}).hyperparams.maximum_staleness == default
    assert make({"maximum_staleness": 0}).hyperparams.maximum_staleness == 0
    assert make({"maximum_staleness": 2}).hyperparams.maximum_staleness == 2

    # the in-process trainer shares the same async default
    from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer
    from distriflow_tpu_torch.utils.config import ServerHyperparams

    spec = mnist_mlp(hidden=4, device="cpu")
    t = AsyncSGDTrainer(spec, DistributedDataset(x, y, {"batch_size": 4}))
    assert t.hyperparams.maximum_staleness == default
    t0 = AsyncSGDTrainer(spec, DistributedDataset(x, y, {"batch_size": 4}),
                         hyperparams=ServerHyperparams())  # explicit dataclass: honored verbatim
    assert t0.hyperparams.maximum_staleness == 0


def test_async_sgd_two_clients_both_complete(tmp_path):
    """Multi-client async: stragglers are re-dispatched when acks free work,
    and every client gets trainingComplete."""
    rng = np.random.RandomState(1)
    n = 128
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    dataset = DistributedDataset(x, y, {"batch_size": 16, "epochs": 2})
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(_mlp(8, lr=0.05)),
        dataset,
        DistributedServerConfig(
            server_hyperparams={"maximum_staleness": 50, "min_updates_per_version": 1},
            save_dir=str(tmp_path / "m2"),
        ),
    )
    server.setup()
    clients = [AsynchronousSGDClient(server.address, _mlp(8)) for _ in range(2)]
    try:
        for c in clients:
            c.setup(timeout=10)
        done = [c.train_until_complete(timeout=90) for c in clients]
        assert sum(done) == 16  # 8 batches x 2 epochs, split across clients
        assert all(d > 0 for d in done), f"one client starved: {done}"
        _wait(lambda: server.applied_updates == 16, 10, "the applies")
        assert dataset.exhausted
    finally:
        for c in clients:
            c.dispose()
        server.stop()


def test_async_client_disconnect_requeues(tmp_path):
    """A dying client's outstanding batch goes back to the queue."""
    from distriflow_tpu_torch.comm.transport import ClientTransport

    x = np.zeros((64, 4), np.float32)
    y = np.zeros((64, 2), np.float32)
    dataset = DistributedDataset(x, y, {"batch_size": 16, "epochs": 1})
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(MockModel()),
        dataset,
        DistributedServerConfig(save_dir=str(tmp_path / "m")),
    )
    server.setup()
    try:
        got_batch = threading.Event()
        raw = ClientTransport(server.address)
        raw.on("downloadVars", lambda payload: got_batch.set())
        raw.connect()
        assert got_batch.wait(5)
        assert len(dataset.outstanding_batches) == 1
        raw.close()  # dies holding batch 0
        _wait(lambda: not dataset.outstanding_batches, 5, "the requeue")
    finally:
        server.stop()


def test_server_checkpoint_retention(tmp_path):
    """``max_checkpoints`` bounds the save-per-update disk growth."""
    config = DistributedServerConfig(save_dir=str(tmp_path / "srv"), max_checkpoints=3, port=0)
    server = FederatedServer(_mlp(4), config)
    for i in range(6):
        server.model.store.save(server.model.model.get_params(), version=str(i))
    assert server.model.store.list() == ["3", "4", "5"]


def test_stale_upload_decays_into_aggregation(tmp_path):
    """A within-bound stale gradient contributes scaled by
    staleness_decay**staleness; over-bound staleness is rejected."""
    server = FederatedServer(
        DistributedServerInMemoryModel(MockModel()),
        DistributedServerConfig(
            server_hyperparams={"min_updates_per_version": 2, "maximum_staleness": 1,
                                "staleness_decay": 0.5},
            save_dir=str(tmp_path / "models"),
        ),
    )
    server.setup()
    try:
        lr = server.model.model.lr
        v0 = server.model.version
        g1 = {"w": np.full((4,), 2.0, np.float32), "b": np.full((2,), 4.0, np.float32)}
        g2 = {"w": np.full((4,), 6.0, np.float32), "b": np.full((2,), 8.0, np.float32)}

        def upload(grads, version):
            return server.handle_upload(
                "c", UploadMsg(client_id="c", gradients=GradientMsg(
                    version=version, vars=serialize_tree(grads))))

        assert upload(g1, v0) and upload(g2, v0)
        v1 = server.model.version
        assert v1 != v0
        before = {k: v.copy() for k, v in server.model.get_params().items()}
        assert upload(g1, v0)  # staleness 1 <= maximum_staleness
        assert upload(g2, v1)
        after = server.model.get_params()
        for k in g1:
            want = lr * (0.5 * g1[k] + g2[k]) / 2
            np.testing.assert_allclose(before[k] - after[k], want, rtol=1e-5)
        assert not upload(g1, v0)  # staleness now 2 > 1
    finally:
        server.stop()


def test_many_clients_soak(tmp_path):
    """8 concurrent clients through several aggregation rounds: every
    accepted upload lands in exactly one aggregation."""
    server = FederatedServer(
        DistributedServerInMemoryModel(MockModel()),
        DistributedServerConfig(
            server_hyperparams={"min_updates_per_version": 8, "maximum_staleness": 3,
                                "staleness_decay": 0.9},
            client_hyperparams={"examples_per_update": 1},
            save_dir=str(tmp_path / "models"),
        ),
    )
    server.setup()
    versions = []
    server.on_new_version(versions.append)
    clients = []
    try:
        clients = [_fed_client(server) for _ in range(8)]
        x = np.ones((1, 4), np.float32)
        y = np.ones((1, 2), np.float32)
        errors = []

        def hammer(c):
            try:
                for _ in range(12):
                    c.distributed_update(x, y)
                    time.sleep(0.02)
            except Exception as e:  # surface thread failures to the assert
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "hammer thread still running after 60s"
        assert not errors, errors
        assert len(versions) >= 2, versions
        assert server.model.model.update_calls == len(versions)
        assert server.num_updates == 8 * len(versions) + len(server.updates), (
            server.num_updates, len(versions), len(server.updates))
        assert len(server.updates) < 8
        assert len(set(versions)) == len(versions)
    finally:
        for c in clients:
            c.dispose()
        server.stop()
