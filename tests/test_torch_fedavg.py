"""Port parity: federated averaging (``distriflow_tpu_torch/train/federated.py``),
its W workers taking turns on one device, on the CPU.

- The seven cases of the JAX suite's ``tests/test_federated.py``, against
  the port with ``num_workers`` standing in for the mesh's ``data`` axis.
- Rounds against JAX's trainer on its 8 host CPU devices
  (``tests/conftest.py``), W 2 and W 8, two rounds of K 3 local sgd and
  momentum steps from the same weights (JAX's init carried over by
  ``zoo_params_from_jax``) on the same round data. JAX's ``pmean`` and the
  port's fixed-order sum add the same f32 values in orders of their own,
  and the local steps sum products in other orders: parameters within
  1e-5, round losses within 1e-5.
- A round is the fixed-order mean (a sum over w = 0 … W-1, then a divide
  by W) of W solo runs of K ``SpecModel`` steps from the same weights,
  bit for bit; ``local_steps=1`` sgd is one ``SyncTrainer`` step on the
  whole batch (1e-6: a mean of W gradients against one W-times-larger
  mean).
"""

import jax
import numpy as np
import pytest
import torch

from distriflow_tpu.models import mnist_mlp as jax_mnist_mlp
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.federated import FederatedAveragingTrainer as JaxFedAvg
from distriflow_tpu_torch.models.base import SpecModel
from distriflow_tpu_torch.models.convert import zoo_params_from_jax
from distriflow_tpu_torch.models.zoo import mnist_mlp
from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer
from distriflow_tpu_torch.train.sync import SyncTrainer
from distriflow_tpu_torch.utils.config import CompileConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

PARITY_ATOL = 1e-5


def _data(n=1024, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, n)
    x[np.arange(n), 0, labels, 0] += 4.0
    y = np.eye(10, dtype=np.float32)[labels]
    return x, y


def _spec(hidden):
    return mnist_mlp(hidden=hidden, device="cpu")


def _fed(hidden=8, workers=8, **kw):
    t = FederatedAveragingTrainer(_spec(hidden), num_workers=workers, **kw)
    t.init()
    return t


# -- the JAX suite's cases -------------------------------------------------


def test_fedavg_learns():
    t = _fed(hidden=16, local_steps=4, local_batch_size=16, learning_rate=0.15)
    x, y = _data(2048)
    before = t.evaluate(x, y)
    rng = np.random.RandomState(0)
    for _ in range(12):
        xs, ys = t.pack_round_data(x, y, rng)
        t.round(xs, ys)
    after = t.evaluate(x, y)
    assert after[0] < before[0]
    assert after[1] > 0.7, after


def test_fedavg_round_is_the_fixed_order_mean_of_solo_runs():
    """JAX's "params stay in sync" (every worker holds the pmean): the
    port's one averaged model is, bit for bit, the sum over w in order of
    W solo K-step runs from the same weights, divided by W."""
    t = _fed(hidden=8, local_steps=2, local_batch_size=8, optimizer="momentum",
             learning_rate=0.05)
    start = {n: p.detach().clone() for n, p in t.params.items()}
    x, y = _data(512)
    xs, ys = t.pack_round_data(x, y)
    loss = t.round(xs, ys)
    acc, losses = None, []
    for w in range(8):
        solo = SpecModel(_spec(8), CompileConfig(optimizer="momentum"), learning_rate=0.05,
                         params=start)
        for k in range(2):
            solo.update(solo.fit(xs[w, k], ys[w, k]))
            losses.append(solo.last_loss)
        p = solo.get_params()
        acc = p if acc is None else {n: acc[n] + p[n] for n in acc}
    for n, p in t.params.items():
        assert torch.equal(p.detach(), acc[n] / 8), n
    assert loss == pytest.approx(float(np.mean(losses)), rel=1e-6)


def test_fedavg_local_steps_1_equals_sync_sgd():
    """K=1 FedAvg with SGD == one sync-SGD step on the same global batch:
    mean of one-step weight deltas is a step along the mean gradient."""
    x, y = _data(64, seed=3)
    fed = FederatedAveragingTrainer(_spec(8), local_steps=1, local_batch_size=8,
                                    learning_rate=0.1, num_workers=8)
    fed.init(5)
    fed.round(x.reshape(8, 1, 8, 28, 28, 1), y.reshape(8, 1, 8, 10))
    sync = SyncTrainer(_spec(8), learning_rate=0.1)
    sync.init(5)
    sync.step((x, y))
    for n, p in sync.get_params().items():
        np.testing.assert_allclose(fed.params[n].detach().numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_round_shape_validation():
    t = _fed(local_steps=2, local_batch_size=8)
    with pytest.raises(ValueError, match="round data"):
        t.round(np.zeros((4, 2, 8, 28, 28, 1), np.float32), np.zeros((4, 2, 8, 10), np.float32))


def test_pack_round_data_insufficient():
    t = _fed(local_steps=4, local_batch_size=32)
    x, y = _data(64)
    with pytest.raises(ValueError, match="at least"):
        t.pack_round_data(x, y)


def test_callbacks():
    t = _fed(local_steps=1, local_batch_size=8)
    rounds = []
    t.callbacks.register("round", rounds.append)
    x, y = _data(64)
    xs, ys = t.pack_round_data(x, y)
    t.round(xs, ys)
    assert rounds == [1]


def test_fedavg_checkpoint_resume(tmp_path):
    """FedAvg rounds checkpoint (params + round counter) and resume."""
    def make():
        t = FederatedAveragingTrainer(_spec(8), local_steps=2, local_batch_size=4,
                                      learning_rate=0.05, checkpoint_dir=str(tmp_path),
                                      save_every=1, num_workers=8)
        t.init(0)
        return t

    t1 = make()
    rng = np.random.RandomState(0)
    x, y = t1.pack_round_data(rng.rand(256, 28, 28, 1).astype(np.float32),
                              np.eye(10, dtype=np.float32)[rng.randint(0, 10, 256)])
    t1.round(x, y)
    t1.round(x, y)
    before = {n: p.detach().clone() for n, p in t1.params.items()}

    t2 = make()
    assert t2.restore()
    assert t2.round_index == 2
    for n, p in t2.params.items():
        assert torch.equal(p.detach(), before[n])
    assert np.isfinite(t2.round(x, y))


# -- against JAX's trainer ---------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
@pytest.mark.parametrize("workers", [2, 8])
def test_rounds_match_jax(devices, workers, optimizer):
    jt = JaxFedAvg(jax_mnist_mlp(hidden=16), mesh=data_parallel_mesh(devices[:workers]),
                   local_steps=3, local_batch_size=8, learning_rate=0.05, optimizer=optimizer)
    jt.init(jax.random.PRNGKey(1))
    pt = FederatedAveragingTrainer(_spec(16), local_steps=3, local_batch_size=8,
                                   learning_rate=0.05, optimizer=optimizer, num_workers=workers)
    pt.set_params(zoo_params_from_jax(jax.device_get(jt.params)))
    x, y = _data(workers * 3 * 8 * 2, seed=4)
    rng = np.random.RandomState(2)
    for _ in range(2):
        xs, ys = pt.pack_round_data(x, y, rng)
        assert pt.round(xs, ys) == pytest.approx(jt.round(xs, ys), rel=0, abs=PARITY_ATOL)
    want = zoo_params_from_jax(jax.device_get(jt.params))
    for n, p in pt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=PARITY_ATOL, err_msg=n)
    assert pt.round_index == jt.round_index == 2


def test_mesh_is_not_ported_and_workers_must_be_positive():
    # meshes are ported (tests/test_torch_federated_mesh.py): a mesh sets
    # the worker count to its data axis, here a one-process gloo world's 1
    import torch.distributed as dist

    from distriflow_tpu_torch.parallel import data_parallel_mesh, ensure_process_group

    assert ensure_process_group("cpu")
    try:
        trainer = FederatedAveragingTrainer(_spec(8), mesh=data_parallel_mesh("cpu"))
        assert trainer.num_workers == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="num_workers"):
        FederatedAveragingTrainer(_spec(8), num_workers=0)
    assert FederatedAveragingTrainer(_spec(8)).num_workers == 1
