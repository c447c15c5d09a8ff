"""The port's URL model source (``spec_from_url``, ``fetch_model(url)``)
against JAX's, over a loopback ``http.server`` root, on the CPU; and the
wire oracle over a Keras model: a JAX async client built from a
``model.json`` trains against the port's server built from the same file,
and the download bytes of both servers are equal.

Tolerances: f32 within 1e-5 (``tests/torch_keras_cases.py``), the final
server weights of the mixed run against the all-JAX run within the
cross-wire tolerance of ``tests/test_torch_wire_cross.py`` (rtol 1e-4,
atol 1e-5: the two packages' fits round differently)."""

import json
import os
import threading
import time
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from distriflow_tpu.models import keras_import as jk
from distriflow_tpu_torch.models import keras_import as tk
from distriflow_tpu_torch.models.base import fetch_model
from torch_keras_cases import both, layer, random_weights, sequential, write_model

pytestmark = pytest.mark.port

TOPOLOGY = sequential([layer("Dense", "dense_1", batch_input=[None, 3], units=4,
                             activation="relu"),
                       layer("Dense", "dense_2", units=2, activation="softmax")])
RTOL, ATOL = 1e-4, 1e-5


class _Quiet(SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture()
def http_root(tmp_path):
    root = str(tmp_path / "www")
    os.makedirs(root, exist_ok=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 lambda *a, **kw: _Quiet(*a, directory=root, **kw))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        thread.join(timeout=5)


def _write(root, shards=("group1-shard1of1",), with_shard=True, topology=TOPOLOGY):
    weights = random_weights(topology)
    path = write_model(root, topology, weights, shards=shards)
    if not with_shard:
        for s in shards:
            os.remove(os.path.join(root, s))
    return path, dict(weights)


def _x(n=5):
    return np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)


def test_url_equals_local(http_root):
    root, base = http_root
    path, _ = _write(root)
    remote = fetch_model(f"{base}/model.json", device="cpu")
    local = fetch_model(path, device="cpu")
    assert remote.spec.name == local.spec.name == "keras:model:logits"
    for (n, a), (_, b) in zip(remote.get_params().items(), local.get_params().items()):
        assert torch.equal(a, b), n
    assert torch.equal(remote.predict(_x()), local.predict(_x()))
    jspec = jk.spec_from_url(f"{base}/model.json")
    tspec = tk.spec_from_url(f"{base}/model.json", device="cpu")
    want = np.asarray(jspec.apply(jspec.init(jax.random.PRNGKey(0)), _x()))
    np.testing.assert_allclose(tspec.apply(tspec.init(0), torch.as_tensor(_x())).detach().numpy(),
                               want, rtol=1e-5, atol=1e-5)


def test_url_shards_in_a_subdirectory(http_root):
    """Shards resolve relative to the model.json URL, in manifest order."""
    root, base = http_root
    _, weights = _write(root, shards=("weights/group1-shard1of2", "weights/group1-shard2of2"))
    tree = tk.spec_from_url(f"{base}/model.json", device="cpu").init(0).tree()
    for name, arr in weights.items():
        layer_name, wname = name.split("/")
        np.testing.assert_array_equal(tree[layer_name][wname].detach().numpy(), arr)


def test_url_missing_shard_raises_or_cold_inits_when_asked(http_root):
    root, base = http_root
    _write(root, with_shard=False)
    for load in (jk.spec_from_url, lambda u: tk.spec_from_url(u, device="cpu")):
        with pytest.raises(OSError, match="load_weights=False"):
            load(f"{base}/model.json")
    spec = tk.spec_from_url(f"{base}/model.json", load_weights=False, device="cpu")
    assert spec.init(0).tree()["dense_1"]["kernel"].shape == (3, 4)


def test_url_errors_match_jax(http_root):
    root, base = http_root
    _write(root)
    with open(os.path.join(root, "model.json")) as f:
        topo = json.load(f)
    topo["weightsManifest"][0]["paths"] = ["../../etc/evil"]
    with open(os.path.join(root, "evil.json"), "w") as f:
        json.dump(topo, f)
    with open(os.path.join(root, "page.json"), "w") as f:
        f.write("<html>not a model</html>")
    cases = [(f"{base}/evil.json", ValueError), (f"{base}/page.json", ValueError),
             (f"{base}/nope/model.json", OSError), ("ftp://example.com/model.json", ValueError)]
    for url, exc in cases:
        with pytest.raises(exc) as want:
            jk.spec_from_url(url)
        with pytest.raises(exc) as got:
            tk.spec_from_url(url, device="cpu")
        assert type(got.value) is type(want.value)
        if exc is ValueError:
            assert str(got.value) == str(want.value)


def test_url_h5_model(http_root):
    h5py = pytest.importorskip("h5py")
    root, base = http_root
    weights = random_weights(TOPOLOGY)
    path = os.path.join(root, "model.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(TOPOLOGY["modelTopology"]["model_config"])
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [b"dense_1", b"dense_2"]
        for lname in ("dense_1", "dense_2"):
            g = mw.create_group(lname)
            names = [f"{n}:0" for n, _ in weights if n.startswith(lname)]
            g.attrs["weight_names"] = [n.encode() for n in names]
            for n, a in weights:
                if n.startswith(lname):
                    g.create_dataset(f"{n}:0", data=a)
    remote = fetch_model(f"{base}/model.h5", device="cpu")
    local = fetch_model(path, device="cpu")
    assert torch.equal(remote.predict(_x()), local.predict(_x()))
    both(path, _x(), np.eye(2, dtype=np.float32)[[0, 1, 1, 0, 1]], loader="h5")


# -- the wire oracle -----------------------------------------------------------


def _data(n=48):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 3).astype(np.float32)
    labels = (x[:, 0] > 0).astype(np.int64)
    return x, np.eye(2, dtype=np.float32)[labels]


def _server(side, path, tmp_path, x, y):
    hp = {"maximum_staleness": 10, "min_updates_per_version": 1, "delta_broadcast": False}
    if side == "jax":
        from distriflow_tpu.data.dataset import DistributedDataset
        from distriflow_tpu.models import fetch_model as jax_fetch
        from distriflow_tpu.server import (AsynchronousSGDServer, DistributedServerConfig,
                                           DistributedServerInMemoryModel)

        model = jax_fetch(path, learning_rate=0.1)
    else:
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.server import (AsynchronousSGDServer, DistributedServerConfig,
                                                 DistributedServerInMemoryModel)

        model = fetch_model(path, device="cpu", learning_rate=0.1)
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(model),
        DistributedDataset(x, y, {"batch_size": 8, "epochs": 2}),
        DistributedServerConfig(server_hyperparams=hp, save_dir=str(tmp_path / side)))
    return server, model


def _train(server_side, path, tmp_path):
    from distriflow_tpu.client import AsynchronousSGDClient
    from distriflow_tpu.models import fetch_model as jax_fetch

    x, y = _data()
    server, model = _server(server_side, path, tmp_path, x, y)
    server.setup()
    client = AsynchronousSGDClient(server.address, jax_fetch(path, learning_rate=0.1))
    try:
        client.setup(timeout=30)
        assert client.train_until_complete(timeout=120) == 12
        deadline = time.monotonic() + 10
        while server.applied_updates < 12:
            assert time.monotonic() < deadline, "the server's applies did not finish"
            time.sleep(0.01)
        assert server.rejected_updates == 0
    finally:
        client.dispose()
        server.stop()
    params = model.get_params()
    if server_side == "jax":
        return {l: {w: np.asarray(v) for w, v in ws.items()} for l, ws in params.items()}
    return model.spec.to_wire(params)


def test_jax_client_trains_against_the_port_server_from_one_model_json(tmp_path):
    """A JAX ``AsynchronousSGDClient`` from ``fetch_model('model.json')``
    against the port's server from the same file: every upload applied,
    the final weights those of the all-JAX run, the download bytes equal."""
    from distriflow_tpu.utils import serialization as jax_ser
    from distriflow_tpu_torch.utils import serialization as port_ser

    path, weights = _write(str(tmp_path / "m"))
    want = _train("jax", path, tmp_path / "ref")
    got = _train("port", path, tmp_path / "port")
    assert set(got) == set(want)
    moved = 0.0
    for lname, ws in want.items():
        for wname, arr in ws.items():
            np.testing.assert_allclose(got[lname][wname], arr, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lname}/{wname}")
            moved = max(moved, float(np.abs(arr - weights[f"{lname}/{wname}"]).max()))
    assert moved > 10 * ATOL, "training did not move the weights"
    x, y = _data()
    downloads = {}
    for side, ser in (("jax", jax_ser), ("port", port_ser)):
        server, _ = _server(side, path, tmp_path / f"dl-{side}", x, y)
        downloads[side] = ser.pack_bytes(server.compute_download_msg().model.vars)
    assert downloads["port"] == downloads["jax"]


class _InstallRecorder:
    """Wraps a client's ``set_params_from``: after every install it holds
    the client's weights against the server's broadcast params of that
    version (the bounded history the deltas are taken against)."""

    def __init__(self, client, server):
        self.client, self.server = client, server
        self.installs, self.deltas, self.worst = 0, 0, 0.0
        self._inner = client.set_params_from
        client.set_params_from = self

    def __call__(self, msg):
        installed = self._inner(msg)
        if installed:
            m = self.client.model
            got = m.spec.to_wire(m.get_params())
            want = self.server._param_history[msg.model.version]
            for lname, ws in want.items():
                for wname, arr in ws.items():
                    err = float(np.abs(np.asarray(got[lname][wname], np.float32)
                                       - arr.float().numpy()).max())
                    self.worst = max(self.worst, err)
            self.installs += 1
            self.deltas += msg.model.delta_base is not None
        return installed


def test_bf16_server_replaces_an_f32_workers_weights_under_delta_broadcasts(tmp_path):
    """A bfloat16 server from ``fetch_model(path, dtype=bfloat16)`` and an
    f32 worker from the same path, with ``delta_broadcast`` at its default
    (on): the server ships its bf16 leaves whole, and the worker must
    install them whole, not add them to its weights as deltas. After every
    install the worker holds the broadcast weights exactly (bf16 widens to
    f32 exactly)."""
    from distriflow_tpu_torch.client import AsynchronousSGDClient
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.server import (AsynchronousSGDServer, DistributedServerConfig,
                                             DistributedServerInMemoryModel)

    path, _ = _write(str(tmp_path / "m"))
    x, y = _data()
    server_model = fetch_model(path, device="cpu", dtype=torch.bfloat16, learning_rate=0.1)
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(server_model),
        DistributedDataset(x, y, {"batch_size": 8, "epochs": 2}),
        DistributedServerConfig(server_hyperparams={"maximum_staleness": 10,
                                                    "min_updates_per_version": 1},
                                save_dir=str(tmp_path / "s")))
    assert server.hyperparams.delta_broadcast
    server.setup()
    client = AsynchronousSGDClient(server.address,
                                   fetch_model(path, device="cpu", learning_rate=0.1))
    recorder = _InstallRecorder(client, server)
    try:
        client.setup(timeout=30)
        assert client.train_until_complete(timeout=120) == 12
    finally:
        client.dispose()
        server.stop()
    assert recorder.deltas > 0, "no delta broadcast was installed"
    assert recorder.installs >= recorder.deltas + 1
    assert recorder.worst == 0.0, f"an install drifted by {recorder.worst}"
