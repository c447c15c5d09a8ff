"""The port's ``DistributedDynamicModel`` (``models/dynamic.py``) and
``fetch_model``'s string sources (``models/base.py``) against JAX's on the
CPU: the dynamic model's gradients and update equal JAX's within f32 1e-5,
and ``fetch_model`` resolves a ``.json``, a ``.h5``, an ``http://`` URL and
a checkpoint directory as JAX's does."""

import os
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models import DistributedDynamicModel as JaxDynamic
from distriflow_tpu_torch.models import DistributedDynamicModel, fetch_model
from distriflow_tpu_torch.models.base import SpecModel
from torch_keras_cases import F32_TOL, assert_close, layer, random_weights, sequential, \
    write_model

pytestmark = pytest.mark.port


def _params():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "head.w": rng.standard_normal((4, 2)).astype(np.float32),
            "head.b": np.zeros(2, np.float32)}


def _data():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((5, 3)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)])


def test_dynamic_model_grads_and_update_are_jaxs():
    p = _params()
    jax_params = {"w": p["w"], "head": {"w": p["head.w"], "b": p["head.b"]}}
    jm = JaxDynamic(jax_params, lambda q, x: jnp.tanh(x @ q["w"]) @ q["head"]["w"]
                    + q["head"]["b"], learning_rate=0.1)
    tm = DistributedDynamicModel(p, lambda q, x: torch.tanh(x @ q["w"]) @ q["head.w"]
                                 + q["head.b"], learning_rate=0.1, device="cpu")
    x, y = _data()
    jg, tg = jm.fit(x, y), tm.fit(x, y)
    assert set(tg) == {"w", "head.w", "head.b"}
    assert_close(tg["w"].numpy(), np.asarray(jg["w"]), F32_TOL, "w")
    assert_close(tg["head.w"].numpy(), np.asarray(jg["head"]["w"]), F32_TOL, "head.w")
    assert_close(tg["head.b"].numpy(), np.asarray(jg["head"]["b"]), F32_TOL, "head.b")
    assert abs(tm.last_loss - float(jm.last_loss)) < F32_TOL
    jm.update(jg)
    tm.update(tg)
    assert_close(tm.get_params()["head.w"].numpy(),
                 np.asarray(jm.get_params()["head"]["w"]), F32_TOL, "updated head.w")
    assert tm.spec.name == "dynamic"
    np.testing.assert_array_equal(tm.predict(x).shape, (5, 2))


TOPOLOGY = sequential([layer("Dense", "d1", batch_input=[None, 3], units=4, activation="relu"),
                       layer("Dense", "d2", units=2, activation="softmax")])


def _keras(tmp_path):
    weights = random_weights(TOPOLOGY)
    return write_model(tmp_path, TOPOLOGY, weights), weights


def _h5(tmp_path, weights):
    h5py = pytest.importorskip("h5py")
    import json

    path = str(tmp_path / "model.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(TOPOLOGY["modelTopology"]["model_config"])
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [b"d1", b"d2"]
        for lname in ("d1", "d2"):
            g = mw.create_group(lname)
            g.attrs["weight_names"] = [f"{n}:0".encode() for n, _ in weights
                                       if n.startswith(lname + "/")]
            for n, a in weights:
                if n.startswith(lname + "/"):
                    g.create_dataset(f"{n}:0", data=a)
    return path


@pytest.mark.parametrize("source", ["json", "h5", "url"])
def test_fetch_model_keras_sources(tmp_path, source):
    from distriflow_tpu.models import fetch_model as jax_fetch

    path, weights = _keras(tmp_path)
    server = None
    if source == "h5":
        path = _h5(tmp_path, weights)
    elif source == "url":
        root = str(tmp_path)
        server = ThreadingHTTPServer(("127.0.0.1", 0), lambda *a, **kw: SimpleHTTPRequestHandler(
            *a, directory=root, **kw))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        path = f"http://127.0.0.1:{server.server_port}/model.json"
    try:
        model = fetch_model(path, device="cpu", loss="mean_squared_error", learning_rate=0.5)
        want = jax_fetch(path, loss="mean_squared_error", learning_rate=0.5)
    finally:
        if server is not None:
            server.shutdown()
    assert isinstance(model, SpecModel)
    assert model.spec.name == want.spec.name == "keras:model:logits"
    assert model.spec.loss == "mean_squared_error" and model.learning_rate == 0.5
    x, _ = _data()
    assert_close(model.predict(x).numpy(), np.asarray(want.predict(x)), F32_TOL, "predict")


def test_fetch_model_checkpoint_directory(tmp_path):
    from distriflow_tpu_torch.checkpoint import CheckpointStore, save_model
    from distriflow_tpu_torch.models.zoo import mnist_mlp

    model = SpecModel(mnist_mlp(device="cpu"))
    model.setup()
    save_model(CheckpointStore(str(tmp_path)), model, version="1")
    loaded = fetch_model(str(tmp_path), device="cpu")
    assert loaded.spec.name == "mnist_mlp"
    for n, p in model.get_params().items():
        assert torch.equal(loaded.get_params()[n], p), n
    with pytest.raises(FileNotFoundError):
        fetch_model(os.path.join(str(tmp_path), "empty"), device="cpu")
