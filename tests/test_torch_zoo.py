"""Port parity: the zoo's MLP and ConvNet (``distriflow_tpu_torch/models/zoo.py``,
``models/convert.py::zoo_params_from_jax``) and their training step with
the fused dense cross-entropy.

- ``mnist_mlp``, ``mnist_convnet`` and ``cifar_convnet`` with weights
  carried over from the JAX specs (random, so that every bias and the
  flatten order matter), against flax ``apply`` on the same numpy batch.
  f32: within 1e-5 of the largest logit (each conv or dense output sums
  27 to 4096 f32 products in orders the two CPU libraries choose; measured
  9.2e-7 of it). bf16: both round every conv, bias add, pool and dense
  output to bf16, at the same points but from f32 sums in other orders, so
  a rounding flip can carry through: the port's bf16 logits must lie no
  farther from JAX's bf16 logits than the larger of 2x JAX's own bf16-to-f32
  distance and one bf16 step of the largest logit (measured 0.0078 on
  logits up to 24, whose bf16 step is 0.125).
- Two ``SyncTrainer`` sgd steps (lr 0.01, the BASELINE #2 optimizer) of
  ``cifar_convnet`` at f32, B 8, with ``loss="fused_softmax_cross_entropy"``
  on one-hot targets, from flax's own init carried over, against JAX's
  ``SyncTrainer`` on a one-device mesh, whose gradient runs the dense CE
  kernels in interpret mode: losses within 1e-6 and parameters after
  within 1e-6 (the same arithmetic in other orders; measured 2.4e-7 and
  1.5e-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distriflow_tpu.ops  # noqa: F401  (registers the JAX fused losses)
from distriflow_tpu.models import zoo as jax_zoo
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.models import zoo
from distriflow_tpu_torch.models.convert import zoo_params_from_jax
from distriflow_tpu_torch.train.sync import SyncTrainer

pytestmark = pytest.mark.port
torch.set_num_threads(2)

SHAPES = {"mnist_mlp": (28, 28, 1), "mnist_convnet": (28, 28, 1), "cifar_convnet": (32, 32, 3)}


def _jax_tree(spec, seed=0):
    """Random params of the spec's tree as numpy: kernels lecun-scaled,
    biases near 0.05."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(spec.init, jax.random.PRNGKey(0))

    def draw(s):
        if len(s.shape) == 1:
            return (0.05 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _logits(name, jdtype, tdtype, x, tree):
    js = getattr(jax_zoo, name)(dtype=jdtype)
    ref = np.asarray(js.apply(tree, jnp.asarray(x)).astype(jnp.float32))
    spec = getattr(zoo, name)(dtype=tdtype, device="cpu")
    model = spec.init(0)
    model.load_state_dict(zoo_params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = spec.apply(model, torch.from_numpy(x))
    assert got.dtype == tdtype and got.shape == (x.shape[0], 10)
    return got.float().numpy(), ref


@pytest.mark.parametrize("name", ["mnist_mlp", "mnist_convnet", "cifar_convnet"])
def test_logits_match_flax_f32(name):
    tree = _jax_tree(getattr(jax_zoo, name)())
    x = np.random.RandomState(1).rand(4, *SHAPES[name]).astype(np.float32)
    got, ref = _logits(name, jnp.float32, torch.float32, x, tree)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["mnist_mlp", "mnist_convnet", "cifar_convnet"])
def test_logits_match_flax_bf16(name):
    tree = _jax_tree(getattr(jax_zoo, name)())
    x = np.random.RandomState(2).rand(4, *SHAPES[name]).astype(np.float32)
    got, ref = _logits(name, jnp.bfloat16, torch.bfloat16, x, tree)
    _, ref32 = _logits(name, jnp.float32, torch.float32, x, tree)
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    limit = max(2 * np.abs(ref - ref32).max(), step)
    assert np.abs(got - ref).max() <= limit, (np.abs(got - ref).max(), limit)


def test_module_names_and_layouts_are_flax_s():
    spec = zoo.cifar_convnet(device="cpu")
    model = spec.init(0)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {
        "Conv_0.kernel": (64, 3, 3, 3), "Conv_0.bias": (64,),
        "Conv_1.kernel": (128, 64, 3, 3), "Conv_1.bias": (128,),
        "Conv_2.kernel": (256, 128, 3, 3), "Conv_2.bias": (256,),
        "Dense_0.kernel": (4 * 4 * 256, 256), "Dense_0.bias": (256,),
        "Dense_1.kernel": (256, 10), "Dense_1.bias": (10,)}
    assert spec.input_shape == (32, 32, 3) and spec.output_shape == (10,)
    assert spec.loss == "softmax_cross_entropy"
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_flatten_runs_in_hwc_order():
    """Moving one input of the first Dense along its c axis changes the
    logits exactly as flax's (h, w, c) flatten says."""
    spec = zoo.cifar_convnet(device="cpu")
    model = spec.init(0)
    feats = {}
    # the hook returns None, so it leaves Dense_0's output as it is
    model._modules["Dense_0"].register_forward_hook(lambda m, i, o: feats.__setitem__("x", i[0]))
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        spec.apply(model, x)
        y = x.clone()
        for conv in model.convs:
            y = torch.nn.functional.max_pool2d(
                torch.relu(conv(y)).permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert torch.equal(feats["x"], y.reshape(1, -1))
    assert not torch.equal(feats["x"], y.permute(0, 3, 1, 2).reshape(1, -1))


def test_sync_step_with_fused_dense_ce_matches_jax(devices):
    jspec = dataclasses.replace(jax_zoo.cifar_convnet(), loss="fused_softmax_cross_entropy")
    jt = JaxTrainer(jspec, mesh=data_parallel_mesh(devices[:1]), optimizer="sgd",
                    learning_rate=0.01)
    jt.init(jax.random.PRNGKey(0))  # flax's init, carried over
    tree = jax.tree.map(np.asarray, jt.get_params())
    pspec = dataclasses.replace(zoo.cifar_convnet(device="cpu"), loss="fused_softmax_cross_entropy")
    pt = SyncTrainer(pspec, optimizer="sgd", learning_rate=0.01)
    pt.init()
    pt.set_params(zoo_params_from_jax(tree))
    rng = np.random.RandomState(4)
    x = rng.rand(8, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]
    for _ in range(2):
        lj, lp = jt.step((x, y)), pt.step((x, y))
        assert abs(lj - lp) <= 1e-6, (lj, lp)
    want = zoo_params_from_jax(jax.tree.map(np.asarray, jt.get_params()))
    got = pt.get_params()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-6, msg=k)
    loss, acc = pt.evaluate(x, y)
    jloss, jacc = jt.evaluate(x, y)
    assert loss == pytest.approx(float(jloss), abs=1e-6) and acc == pytest.approx(float(jacc))
