"""Cross-wire training over loopback: a JAX worker against the port's
server and a port worker against the JAX server, on the CPU.

One worker, ``delta_broadcast`` off, the same flax-initialised weights and
the same batches: the final server weights of every mixed run are held
against the all-JAX run's within f32 tolerance (the two packages' fits
round differently, so bits are not expected), and the port's download
bytes against the JAX package's for the same flax tree, bit for bit.
"""

import time

import numpy as np
import pytest
import torch

import jax

from distriflow_tpu.client import AsynchronousSGDClient as JaxAsyncClient
from distriflow_tpu.data.dataset import DistributedDataset as JaxDataset
from distriflow_tpu.models.base import SpecModel as JaxSpecModel
from distriflow_tpu.models.flax_model import spec_from_flax
from distriflow_tpu.models.mobilenet import mobilenet_v2 as jax_mobilenet
from distriflow_tpu.models.zoo import ConvNet as JaxConvNet
from distriflow_tpu.models.zoo import mnist_mlp as jax_mnist_mlp
from distriflow_tpu.server import AsynchronousSGDServer as JaxAsyncServer
from distriflow_tpu.server import DistributedServerConfig as JaxServerConfig
from distriflow_tpu.server import DistributedServerInMemoryModel as JaxInMemory
from distriflow_tpu.utils import serialization as jax_ser

from distriflow_tpu_torch.client import AsynchronousSGDClient as PortAsyncClient
from distriflow_tpu_torch.data.dataset import DistributedDataset as PortDataset
from distriflow_tpu_torch.models.base import SpecModel as PortSpecModel
from distriflow_tpu_torch.models.convert import with_flax_wire, zoo_params_to_jax
from distriflow_tpu_torch.models.mobilenet import mobilenet_v2 as port_mobilenet
from distriflow_tpu_torch.models.module_model import spec_from_module
from distriflow_tpu_torch.models.zoo import ConvNet as PortConvNet
from distriflow_tpu_torch.models.zoo import mnist_mlp as port_mnist_mlp
from distriflow_tpu_torch.server import AsynchronousSGDServer as PortAsyncServer
from distriflow_tpu_torch.server import DistributedServerConfig as PortServerConfig
from distriflow_tpu_torch.server import DistributedServerInMemoryModel as PortInMemory
from distriflow_tpu_torch.utils import serialization as port_ser

pytestmark = pytest.mark.port

#: final weights of a mixed run against the all-JAX run after 12 SGD steps
#: at lr 0.1 (the packages' f32 matmuls and reductions round differently)
RTOL, ATOL = 1e-4, 1e-5
LR = 0.1
CONV = dict(features=(4, 8), classes=10, dense=16)
#: a MobileNetV2 whose depthwise convs keep their own ``[3, 3, 1, C]``
#: kernels under a ``_ConvNorm`` (the ``shift`` form)
MOBILENET = dict(image_size=16, classes=10, width=0.25, depthwise_impl="shift")


def _specs(model: str):
    if model == "mlp":
        return jax_mnist_mlp(hidden=16), port_mnist_mlp(hidden=16, device="cpu")
    if model == "mobilenet":
        return jax_mobilenet(**MOBILENET), port_mobilenet(**MOBILENET, device="cpu")
    jax_spec = spec_from_flax(JaxConvNet(**CONV), input_shape=(8, 8, 3), output_shape=(10,))
    port_spec = with_flax_wire(spec_from_module(
        lambda: PortConvNet((8, 8, 3), **CONV), input_shape=(8, 8, 3), output_shape=(10,),
        device="cpu"))
    return jax_spec, port_spec


def _data(model: str):
    rng = np.random.RandomState(0)
    n = 96
    shape = {"mlp": (28, 28, 1), "convnet": (8, 8, 3)}.get(model, (16, 16, 3))
    x = rng.randn(n, *shape).astype(np.float32)
    labels = rng.randint(0, 10, n)
    x[np.arange(n), 0, labels % shape[1], 0] += 4.0
    return x, np.eye(10, dtype=np.float32)[labels]


def _tree(model: str):
    jax_spec, _ = _specs(model)
    if model != "mobilenet":
        return jax.tree.map(np.asarray, jax_spec.init(jax.random.PRNGKey(0)))
    # MobileNetV2's tree from its shapes, drawn from a seed (scales near 1)
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 if str(path[-1].key) == "scale" else 0.0)
                         + 0.1 * rng.randn(*s.shape)).astype(np.float32),
        jax.eval_shape(jax_spec.init, jax.random.PRNGKey(0)))


def _model(side: str, model: str, tree):
    jax_spec, port_spec = _specs(model)
    if side == "jax":
        return JaxSpecModel(jax_spec, learning_rate=LR, params=jax.tree.map(np.array, tree))
    return PortSpecModel(port_spec, learning_rate=LR, params=port_spec.from_wire(tree))


def _final_tree(server_model, side: str):
    params = server_model.get_params()
    if side == "jax":
        return jax.tree.map(np.asarray, params)
    return zoo_params_to_jax(params)


def _run(server_side: str, client_side: str, model: str, tmp_path):
    tree = _tree(model)
    x, y = _data(model)
    hp = {"maximum_staleness": 10, "min_updates_per_version": 1, "delta_broadcast": False}
    server_model = _model(server_side, model, tree)
    if server_side == "jax":
        server = JaxAsyncServer(
            JaxInMemory(server_model), JaxDataset(x, y, {"batch_size": 32, "epochs": 4}),
            JaxServerConfig(server_hyperparams=hp, save_dir=str(tmp_path / "s")))
    else:
        server = PortAsyncServer(
            PortInMemory(server_model), PortDataset(x, y, {"batch_size": 32, "epochs": 4}),
            PortServerConfig(server_hyperparams=hp, save_dir=str(tmp_path / "s")))
    server.setup()
    client_cls = JaxAsyncClient if client_side == "jax" else PortAsyncClient
    client = client_cls(server.address, _model(client_side, model, tree))
    try:
        client.setup(timeout=30)
        assert client.train_until_complete(timeout=120) == 12
        deadline = time.monotonic() + 10
        while server.applied_updates < 12:
            assert time.monotonic() < deadline, "the server's applies did not finish"
            time.sleep(0.01)
        assert server.rejected_updates == 0
        return _final_tree(server_model, server_side)
    finally:
        client.dispose()
        server.stop()


@pytest.mark.parametrize("model", ["mlp", "convnet"])
def test_cross_wire_training_matches_all_jax(model, tmp_path):
    ref = _run("jax", "jax", model, tmp_path / "ref")
    start = _tree(model)
    for server_side, client_side in (("port", "jax"), ("jax", "port"), ("port", "port")):
        got = _run(server_side, client_side, model, tmp_path / f"{server_side}-{client_side}")
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        for path, want in jax.tree_util.tree_flatten_with_path(ref)[0]:
            np.testing.assert_allclose(
                flat_got[path], want, rtol=RTOL, atol=ATOL,
                err_msg=f"{server_side} server, {client_side} client, {jax.tree_util.keystr(path)}")
        moved = max(float(np.abs(a - b).max()) for a, b in
                    zip(jax.tree.leaves(got), jax.tree.leaves(start)))
        assert moved > 10 * ATOL, "training did not move the weights"


@pytest.mark.parametrize("model", ["mlp", "convnet", "mobilenet"])
def test_layout_round_trip_and_download_bytes(model, tmp_path):
    tree = _tree(model)
    spec = _specs(model)[1]
    back = spec.to_wire(spec.from_wire(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    x, y = _data(model)
    downloads = {}
    for side in ("jax", "port"):
        server_cls, ds_cls, cfg_cls, mem = (
            (JaxAsyncServer, JaxDataset, JaxServerConfig, JaxInMemory) if side == "jax"
            else (PortAsyncServer, PortDataset, PortServerConfig, PortInMemory))
        server = server_cls(mem(_model(side, model, tree)), ds_cls(x, y, {"batch_size": 32}),
                            cfg_cls(save_dir=str(tmp_path / side)))
        msg = server.compute_download_msg()
        ser = jax_ser if side == "jax" else port_ser
        downloads[side] = ser.pack_bytes(msg.model.vars)
    assert downloads["port"] == downloads["jax"]
    assert downloads["port"] == jax_ser.tree_to_bytes(tree)
    assert port_ser.tree_to_bytes(spec.to_wire(spec.from_wire(tree))) == \
        jax_ser.tree_to_bytes(tree)
    # and a port gradient upload carries JAX's paths in flax's layout
    port = _model("port", model, tree)
    grads = port.fit(x[:8], y[:8])
    wire = port_ser.serialize_tree(spec.to_wire(grads))
    assert set(wire) == set(jax_ser.serialize_tree(tree))
    assert all(torch.equal(spec.from_wire(spec.to_wire(grads))[k], v)
               for k, v in grads.items())
