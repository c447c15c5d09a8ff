"""Port contracts on host dtypes and on losses a CUDA model cannot take.

- Host batches are placed as ``jax.device_put`` places them under JAX's
  default (x64 off): float64 as float32, int64 as int32, every other dtype
  unchanged, by ``models/base.py::to_device`` (``SyncTrainer``,
  ``SpecModel``) and by ``data/prefetch.py::prefetch_to_device``. So the
  port's ``SyncTrainer`` on ``mnist_mlp`` with float64 images and
  ``np.eye(10)[labels]`` targets (float64), or int64 labels under the
  sparse loss, computes in f32 and agrees with JAX's ``SyncTrainer`` on a
  one-device mesh from the same weights: losses within 1e-5 relative and
  parameters within 1e-6 over 3 sgd steps (the same f32 arithmetic, sums
  in other orders).
- A spec whose loss runs the fused cross-entropy kernels on CUDA with
  logits other than bf16 or f32 (f16) is refused when built
  (``NotImplementedError``): by ``spec_from_module`` (and so
  ``DistributedModuleModel``), by ``SyncTrainer`` and by ``SpecModel``;
  f32 and bf16 specs build. Driven here without a card by making
  ``torch.cuda.is_available`` report one: nothing is allocated before the
  refusal. The same configurations build and train on the CPU, through
  the plain losses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distriflow_tpu.models import zoo as jax_zoo
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.data.prefetch import prefetch_to_device
from distriflow_tpu_torch.models import zoo
from distriflow_tpu_torch.models.base import SpecModel, to_device
from distriflow_tpu_torch.models.convert import zoo_params_from_jax
from distriflow_tpu_torch.models.module_model import DistributedModuleModel, spec_from_module
from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
from distriflow_tpu_torch.ops import fused_ce
from distriflow_tpu_torch.train.sync import SyncTrainer
from distriflow_tpu_torch.utils.config import CompileConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

FUSED = ("fused_softmax_cross_entropy", "fused_sparse_softmax_cross_entropy")


def _host_batch():
    rng = np.random.RandomState(0)
    return (rng.rand(3, 4),                                   # float64
            rng.randint(0, 10, 3),                            # int64
            rng.randint(0, 255, (3, 2)).astype(np.uint8),
            torch.ones(3, dtype=torch.bfloat16),
            np.ones(3, np.float32), np.ones(3, np.int32))


WANT = (torch.float32, torch.int32, torch.uint8, torch.bfloat16, torch.float32, torch.int32)


def test_to_device_places_host_batches_in_jax_dtypes():
    got = to_device(_host_batch(), torch.device("cpu"))
    assert tuple(t.dtype for t in got) == WANT
    assert [jax.device_put(np.asarray(b)).dtype.name for b in _host_batch()[:3]] == \
        ["float32", "int32", "uint8"]
    want = _host_batch()
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.float32))


def test_prefetch_places_host_batches_in_jax_dtypes():
    batches = list(prefetch_to_device(iter([_host_batch(), _host_batch()]), "cpu", size=2))
    assert len(batches) == 2
    for b in batches:
        assert tuple(t.dtype for t in b) == WANT
    (d,) = prefetch_to_device(iter([{"x": np.zeros(2), "y": np.zeros(2, np.int64)}]), "cpu")
    assert (d["x"].dtype, d["y"].dtype) == (torch.float32, torch.int32)


@pytest.mark.parametrize("targets", ["one_hot_f64", "labels_i64"])
def test_sync_trainer_on_f64_batches_matches_jax(devices, targets):
    loss = "softmax_cross_entropy" if targets == "one_hot_f64" else "sparse_softmax_cross_entropy"
    jt = JaxTrainer(dataclasses.replace(jax_zoo.mnist_mlp(), loss=loss),
                    mesh=data_parallel_mesh(devices[:1]), optimizer="sgd", learning_rate=0.1)
    jt.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jt.get_params())
    pt = SyncTrainer(dataclasses.replace(zoo.mnist_mlp(device="cpu"), loss=loss),
                     optimizer="sgd", learning_rate=0.1)
    pt.init()
    pt.set_params(zoo_params_from_jax(tree))
    rng = np.random.RandomState(3)
    x = rng.rand(16, 28, 28, 1)                 # float64
    labels = rng.randint(0, 10, 16)             # int64
    y = np.eye(10)[labels] if targets == "one_hot_f64" else labels  # np.eye: float64
    assert x.dtype == np.float64 and y.dtype in (np.float64, np.int64)
    value, grads = pt.spec.grad_fn()(pt.model, *to_device((x, y), pt.device))
    assert value.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    for _ in range(3):
        lj, lp = float(jt.step((x, y))), pt.step((x, y))
        assert lp == pytest.approx(lj, rel=1e-5), (lj, lp)
    want = zoo_params_from_jax(jax.tree.map(np.asarray, jt.get_params()))
    got = pt.get_params()
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-6, msg=k)


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda.is_available()`` reports a card, so that entry points
    resolve ``cuda`` (nothing may allocate on it here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("loss", FUSED)
def test_fused_loss_on_an_f32_cuda_model_is_refused_when_built(fake_card, loss):
    # f32 logits now have kernels: an f32 model builds, and the dtype the
    # kernels still refuse, f16, is refused at each of the same places
    spec = zoo.cifar_convnet(device="cuda")  # f32, the plain loss: builds
    assert spec.dtype == torch.float32 and spec.device.type == "cuda"
    SyncTrainer(dataclasses.replace(spec, loss=loss), optimizer="sgd", learning_rate=0.01)
    SpecModel(spec, compile_config=CompileConfig(loss=loss))
    half = zoo.cifar_convnet(dtype=torch.float16, device="cuda")
    with pytest.raises(NotImplementedError, match="takes bf16"):
        SyncTrainer(dataclasses.replace(half, loss=loss), optimizer="sgd", learning_rate=0.01)
    with pytest.raises(NotImplementedError, match="takes bf16"):
        SpecModel(half, compile_config=CompileConfig(loss=loss))
    with pytest.raises(NotImplementedError, match="takes bf16"):
        spec_from_module(lambda: torch.nn.Linear(4, 2, dtype=torch.float16), (4,), (2,),
                         loss=loss, device="cuda")
    with pytest.raises(NotImplementedError, match="takes bf16"):
        DistributedModuleModel(lambda: torch.nn.Linear(4, 2, dtype=torch.float16), (4,), (2,),
                               compile_config=CompileConfig(loss=loss), device="cuda")
    with pytest.raises(NotImplementedError, match="takes bf16"):
        transformer_lm(TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                                         d_ff=64, max_seq=16, dtype=torch.float16,
                                         loss="fused_sparse_softmax_cross_entropy"),
                       device="cuda")
    transformer_lm(TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                                     d_ff=64, max_seq=16, dtype=torch.float32,
                                     loss="fused_sparse_softmax_cross_entropy"), device="cuda")


@pytest.mark.parametrize("loss", FUSED)
def test_fused_loss_on_a_bf16_cuda_model_builds(fake_card, loss):
    spec = dataclasses.replace(zoo.cifar_convnet(dtype=torch.bfloat16, device="cuda"), loss=loss)
    assert spec.dtype == torch.bfloat16
    SyncTrainer(spec, optimizer="sgd", learning_rate=0.01)  # not initialised: nothing allocated
    SpecModel(spec)
    probed = spec_from_module(lambda: torch.nn.Linear(4, 2, dtype=torch.bfloat16), (4,), (2,),
                              loss=loss, device="cuda")
    assert probed.dtype == torch.bfloat16


@pytest.mark.parametrize("loss,device,dtype,refused", [
    ("fused_softmax_cross_entropy", "cuda", torch.float16, True),
    ("fused_sparse_softmax_cross_entropy", "cuda", torch.float16, True),
    ("fused_sparse_softmax_cross_entropy", "cuda", torch.bfloat16, False),
    ("fused_softmax_cross_entropy", "cpu", torch.float32, False),
    ("softmax_cross_entropy", "cuda", torch.float32, False),
    ("fused_softmax_cross_entropy", "cuda", None, False),
    ("fused_softmax_cross_entropy", "cuda", torch.float32, False),
    ("fused_sparse_softmax_cross_entropy", "cuda", torch.float32, False),
])
def test_the_kernel_layer_owns_the_fused_ce_dtype_rule(loss, device, dtype, refused):
    # the rule every model's build-time check calls, beside the launch-time check
    if refused:
        with pytest.raises(NotImplementedError, match="takes bf16"):
            fused_ce.check_model(loss, torch.device(device), dtype)
    else:
        fused_ce.check_model(loss, torch.device(device), dtype)
    assert set(fused_ce.LOSS_NAMES) == set(FUSED)
    assert fused_ce.LOGITS_DTYPE == {torch.bfloat16, torch.float32}


def test_fused_dense_loss_on_an_f32_model_trains_on_the_cpu():
    spec = dataclasses.replace(zoo.cifar_convnet(device="cpu"), loss="fused_softmax_cross_entropy")
    trainer = SyncTrainer(spec, optimizer="sgd", learning_rate=0.01)
    rng = np.random.RandomState(5)
    x, y = rng.rand(4, 32, 32, 3), np.eye(10)[rng.randint(0, 10, 4)]
    losses = [trainer.step((x, y)) for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
