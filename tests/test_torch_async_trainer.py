"""Port parity: the in-process async SGD trainer
(``distriflow_tpu_torch/train/async_sgd.py``), on the CPU.

- The sixteen cases of the JAX suite's ``tests/test_async_sgd.py``, run
  against the port with the same data and assertions (staleness bounds,
  decay, admission control, K batches an upload, the staged dataset,
  checkpoints, learning).
- One worker against JAX's trainer from the same weights (JAX's init,
  carried over by ``zoo_params_from_jax``) on ``mnist_mlp(hidden=16)``: K 1,
  and K 3 over 7.5 batches an epoch (groups of 3, 3 and a ragged tail of a
  full and a half batch), sgd and momentum, two epochs. Both sum the same
  f32 products in other orders, so parameters must agree within 1e-5 and
  the evaluated loss and accuracy within 1e-5.
- Staleness decay and rejection against JAX's: the same gradients
  submitted at the same versions.
- The host and the staged data paths give the same bits; a snapshot keeps
  its values after later applies; the upload pipe (``inflight_window`` 2)
  applies every upload exactly once and books its overlap.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from distriflow_tpu.data.dataset import DistributedDataset as JaxDataset
from distriflow_tpu.models import mnist_mlp as jax_mnist_mlp
from distriflow_tpu.train.async_sgd import AsyncSGDTrainer as JaxTrainer
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.models.convert import zoo_params_from_jax
from distriflow_tpu_torch.models.zoo import mnist_mlp
from distriflow_tpu_torch.obs.telemetry import Telemetry, set_telemetry
from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer

pytestmark = pytest.mark.port
torch.set_num_threads(2)

PARITY_ATOL = 1e-5


def _data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, n)
    x[np.arange(n), 0, labels, 0] += 4.0
    y = np.eye(10, dtype=np.float32)[labels]
    return x, y


def _spec(hidden=16):
    return mnist_mlp(hidden=hidden, device="cpu")


def _trainer(n=256, bs=32, epochs=1, seed=0, **kw):
    x, y = _data(n, seed)
    ds = DistributedDataset(x, y, {"batch_size": bs, "epochs": epochs})
    t = AsyncSGDTrainer(_spec(), ds, learning_rate=0.05, **kw)
    t.init()
    return t, (x, y)


# -- the JAX suite's cases -------------------------------------------------


def test_single_worker_processes_all_batches():
    t, _ = _trainer(n=128, bs=32, epochs=2)
    counters = t.train(num_workers=1)
    assert counters["applied"] == 8  # 4 batches x 2 epochs
    assert counters["rejected"] == 0
    assert t.version == 8


def test_multi_worker_all_batches_consumed():
    t, _ = _trainer(n=256, bs=16, epochs=2, hyperparams={"maximum_staleness": 100})
    counters = t.train(num_workers=8)
    assert counters["applied"] == 32
    assert counters["rejected"] == 0


def test_staleness_zero_rejects_concurrent_updates():
    t, _ = _trainer(n=256, bs=16, epochs=2, hyperparams={"maximum_staleness": 0},
                    admission_control=False)
    counters = t.train(num_workers=8)
    assert counters["applied"] + counters["rejected"] == 32
    assert counters["applied"] == t.version


def test_admission_control_prevents_all_rejections():
    t, _ = _trainer(n=256, bs=16, epochs=2, hyperparams={"maximum_staleness": 1})
    counters = t.train(num_workers=8)
    assert counters["rejected"] == 0
    assert counters["applied"] == 32
    assert t.version == 32


def test_phase_accounting_accumulates():
    t, _ = _trainer(n=128, bs=32, profile_phases=True)
    t.train(num_workers=2)
    assert set(t.phase_ms) == {"stage", "snapshot", "fit", "submit", "admission_wait",
                               "pipeline_wait", "drain"}
    assert t.phase_ms["fit"] > 0
    assert t.phase_ms["stage"] > 0
    assert t.phase_ms["drain"] >= 0


def test_stale_submit_rejected_manually():
    t, _ = _trainer(n=64, bs=32, hyperparams={"maximum_staleness": 1})
    params, v0 = t.snapshot()
    grads = {n: torch.ones_like(p) * 0.01 for n, p in params.items()}
    assert t.submit(grads, v0)          # staleness 0: ok
    assert t.submit(grads, v0)          # staleness 1: ok (bound is 1)
    assert not t.submit(grads, v0)      # staleness 2: rejected
    assert t.applied_updates == 2 and t.rejected_updates == 1


def test_future_version_raises():
    t, _ = _trainer()
    params, v = t.snapshot()
    with pytest.raises(ValueError, match="future"):
        t.submit({n: np.zeros(tuple(p.shape), np.float32) for n, p in params.items()}, v + 5)


def test_staleness_decay_scales_update():
    t, _ = _trainer(hyperparams={"maximum_staleness": 4, "staleness_decay": 0.5})
    params0, v0 = t.snapshot()
    ones = {n: torch.ones_like(p) for n, p in params0.items()}
    t.submit(ones, v0)  # staleness 0: full lr (0.05)
    params1 = t.snapshot()[0]
    t.submit(ones, v0)  # staleness 1: decayed by 0.5
    params2 = t.snapshot()[0]
    name = next(iter(params0))
    d1 = float((params0[name] - params1[name]).reshape(-1)[0])
    d2 = float((params1[name] - params2[name]).reshape(-1)[0])
    assert d1 == pytest.approx(0.05, rel=1e-4)
    assert d2 == pytest.approx(0.025, rel=1e-4)


def test_async_training_learns():
    t, (x, y) = _trainer(n=512, bs=32, epochs=6, hyperparams={"maximum_staleness": 8})
    before = t.evaluate(x, y)
    t.train(num_workers=4)
    after = t.evaluate(x, y)
    assert after[0] < before[0]
    assert after[1] > 0.8, after


def test_async_checkpoint_resume(tmp_path):
    t, _ = _trainer(checkpoint_dir=str(tmp_path), optimizer="momentum")
    t.train(num_workers=2)
    assert t.version > 0
    v = t.save()
    params_before, _ = t.snapshot()
    state_before = t._opt_state

    t2, _ = _trainer(checkpoint_dir=str(tmp_path), optimizer="momentum")
    assert t2.restore()
    assert t2.version == int(v)
    for n, p in params_before.items():
        assert torch.equal(t2.snapshot()[0][n], p)
    assert t2._opt_state["count"] == state_before["count"]
    for n, tr in state_before["trace"].items():
        assert torch.equal(t2._opt_state["trace"][n], tr)


def test_steps_per_upload_matches_superbatch():
    x, y = _data(128)
    t_k = AsyncSGDTrainer(_spec(), DistributedDataset(x, y, {"batch_size": 32, "epochs": 1}),
                          learning_rate=0.05, steps_per_upload=4)
    t_k.init(7)
    t_1 = AsyncSGDTrainer(_spec(), DistributedDataset(x, y, {"batch_size": 128, "epochs": 1}),
                          learning_rate=0.05)
    t_1.init(7)
    assert t_k.train(num_workers=1) == {"applied": 1, "rejected": 0, "version": 1}
    assert t_1.train(num_workers=1) == {"applied": 1, "rejected": 0, "version": 1}
    for n, p in t_k.snapshot()[0].items():
        np.testing.assert_allclose(p.numpy(), t_1.snapshot()[0][n].numpy(), rtol=2e-5, atol=2e-6)


def test_steps_per_upload_ragged_tail():
    t, _ = _trainer(n=6 * 32, bs=32, epochs=1, steps_per_upload=4)
    counters = t.train(num_workers=1)
    # 6 batches -> one group of 4, one tail group of 2 -> 2 uploads
    assert counters["applied"] == 2
    assert counters["version"] == 2


def test_steps_per_upload_trains():
    t, (x, y) = _trainer(n=512, bs=32, epochs=3, steps_per_upload=4)
    before = t.evaluate(x, y)[0]
    t.train(num_workers=2)
    assert t.evaluate(x, y)[0] < before


def test_steps_per_upload_validation():
    x, y = _data(64)
    ds = DistributedDataset(x, y, {"batch_size": 32, "epochs": 1})
    with pytest.raises(ValueError, match="steps_per_upload"):
        AsyncSGDTrainer(_spec(), ds, steps_per_upload=0)


@pytest.mark.parametrize("k", [1, 3])
def test_stage_dataset_matches_host_path(k):
    """The staged dataset is a data-path change only: the same bits as the
    host path (with K 3 over a half batch at the end of each epoch: both
    take the per-batch order for the mixed tail)."""
    def run(staged):
        x, y = _data(7 * 32 + 16)
        ds = DistributedDataset(x, y, {"batch_size": 32, "epochs": 2, "small_last_batch": True})
        t = AsyncSGDTrainer(_spec(), ds, learning_rate=0.05, optimizer="momentum",
                            steps_per_upload=k, stage_dataset=staged)
        t.init()
        if staged:
            t.pre_stage()
        t.train(num_workers=1)
        return t.snapshot()[0]

    a, b = run(False), run(True)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_stage_dataset_rejects_preprocess():
    t, _ = _trainer(n=64, bs=32, stage_dataset=True)
    t.dataset.add_preprocess(lambda x, y: (x * 2, y))
    with pytest.raises(RuntimeError, match="preprocess"):
        t.worker_loop(0, max_steps=1)


# -- against JAX's trainer ---------------------------------------------------


def _pair(optimizer, k, n, epochs=2, **kw):
    """JAX's trainer and the port's on the same data from the same weights."""
    x, y = _data(n, seed=3)
    cfg = {"batch_size": 32, "epochs": epochs, "small_last_batch": True}
    jt = JaxTrainer(jax_mnist_mlp(hidden=16), JaxDataset(x, y, cfg), learning_rate=0.05,
                    optimizer=optimizer, steps_per_upload=k, **kw)
    jt.init(jax.random.PRNGKey(0))
    pt = AsyncSGDTrainer(_spec(), DistributedDataset(x, y, cfg), learning_rate=0.05,
                         optimizer=optimizer, steps_per_upload=k, **kw)
    pt.set_params(zoo_params_from_jax(jax.device_get(jt.params)))
    return jt, pt, (x, y)


def _assert_params_close(jt, pt):
    want = zoo_params_from_jax(jax.device_get(jt.params))
    got = pt.snapshot()[0]
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=PARITY_ATOL, err_msg=n)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
@pytest.mark.parametrize("k", [1, 3])
def test_one_worker_matches_jax(optimizer, k):
    jt, pt, (x, y) = _pair(optimizer, k, n=7 * 32 + 16)
    assert pt.train(num_workers=1) == jt.train(num_workers=1)
    assert pt.version == (16 if k == 1 else 6)  # K 3: groups of 3, 3, 2 an epoch
    _assert_params_close(jt, pt)
    np.testing.assert_allclose(pt.evaluate(x, y), jt.evaluate(x, y), rtol=0, atol=PARITY_ATOL)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_decay_and_rejection_match_jax(optimizer):
    """The same gradients submitted at the same versions: staleness 0, 1
    and 2 scale by 1, 0.7 and 0.49; staleness 3 is rejected."""
    jt, pt, _ = _pair(optimizer, 1, n=64,
                      hyperparams={"maximum_staleness": 2, "staleness_decay": 0.7})
    rng = np.random.RandomState(9)
    jparams, v0 = jt.snapshot()
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), jparams)
    pgrads = zoo_params_from_jax(grads)
    for _ in range(4):
        assert jt.submit(grads, v0) == pt.submit(pgrads, v0)
    assert (pt.applied_updates, pt.rejected_updates) == (3, 1) \
        == (jt.applied_updates, jt.rejected_updates)
    _assert_params_close(jt, pt)


# -- the port's own contracts --------------------------------------------------


def test_a_snapshot_keeps_its_values():
    """JAX hands out immutable arrays; the port's apply rebinds new tensors,
    so a snapshot taken before an apply still holds the old values."""
    t, _ = _trainer(optimizer="momentum")
    before, v0 = t.snapshot()
    copy = {n: p.clone() for n, p in before.items()}
    t.submit({n: torch.ones_like(p) for n, p in before.items()}, v0)
    after, v1 = t.snapshot()
    assert v1 == v0 + 1
    for n, p in before.items():
        assert torch.equal(p, copy[n])
        assert not torch.equal(after[n], p)
    t.train(num_workers=2)  # workers copy snapshots into their own models
    for n, p in before.items():
        assert torch.equal(p, copy[n])


def test_inflight_window_applies_each_upload_once_and_books_overlap():
    tel = Telemetry()
    prev = set_telemetry(tel)
    try:
        t, _ = _trainer(n=128, bs=16, epochs=2, steps_per_upload=2,
                        hyperparams={"maximum_staleness": 2}, inflight_window=2)
        counters = t.train(num_workers=2)
    finally:
        set_telemetry(prev)
    assert counters["rejected"] == 0
    assert counters["applied"] == counters["version"] == t.version >= 8
    assert t.dataset.exhausted
    assert t._effective_window() == 2
    snap = tel.snapshot()["histograms"]
    assert snap["phase_step_overlap_ms{role=trainer}"]["sum"] > 0.0
    assert snap["phase_ms{phase=submit,role=trainer}"]["count"] == counters["applied"]
    assert tel.counter_value("train_updates_applied_total", mode="async") == counters["applied"]
    assert snap["train_gradient_staleness{mode=async}"]["count"] == counters["applied"]
    clamp = AsyncSGDTrainer(_spec(), t.dataset, hyperparams={"maximum_staleness": 0},
                            inflight_window=4)
    assert clamp._effective_window() == 1
    with pytest.raises(ValueError, match="inflight_window"):
        AsyncSGDTrainer(_spec(), t.dataset, inflight_window=0)


def test_a_failed_submit_requeues_its_batches():
    """A worker whose upload fails returns its batches to the queue, and
    the error reaches train()'s caller."""
    t, _ = _trainer(n=64, bs=32)
    calls = []

    def boom(*a, **kw):
        calls.append(threading.current_thread().name)
        raise RuntimeError("apply failed")

    t.submit = boom
    with pytest.raises(RuntimeError, match="apply failed"):
        t.train(num_workers=1)
    assert calls and t.dataset.incomplete_batches == {0, 1}
    assert t.version == 0


def test_no_gpu_raises_unless_cpu(monkeypatch):
    x, y = _data(64)
    ds = DistributedDataset(x, y, {"batch_size": 32})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncSGDTrainer(spec, ds, devices=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_mlp(hidden=16)
    assert AsyncSGDTrainer(spec, ds).devices == [torch.device("cpu")]
