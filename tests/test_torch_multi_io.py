"""Port parity: models of several inputs or outputs through the port's
trainers (``train/sync.py``, ``train/async_sgd.py``, ``train/federated.py``,
``ModelSpec.loss_sums``) against the JAX package on the CPU.

Two Keras graphs of ``tests/torch_keras_cases.py``, loaded by JAX's
importer and the port's from one ``model.json`` with seeded weights
(``two_input_graph``: two inputs through ``Concatenate``, one head;
``two_output_graph``: a head at every position and a pooled head, whose
per-example losses are ``[B, 5]`` and ``[B]``, so the two weighted means
have other denominators). The loss is JAX's: the sum over outputs of each
output's weighted mean. Everything within ``TOL`` (1e-5, absolute plus
relative), sgd at ``LR``:

- one device: ``STEPS`` ``SyncTrainer`` steps against JAX's (losses and
  parameters); ``grad_accum=2`` against JAX's full-batch steps (JAX's
  ``grad_accum`` slices ``x.shape[0]`` and cannot take a tuple);
- ``evaluate``: the two-input model's loss and accuracy equal JAX's; on the
  two-output model each metric raises, as JAX's does;
- a 4-rank gloo world on ``{data 4}`` (``tests/torch_mesh_cases.py::
  multi_io_cases``) trains both graphs on a partial batch of 6 rows padded
  to 8 with 0-weight rows, at ``grad_accum`` 1 and 2, and equals JAX's
  unpadded one-device steps (losses, parameters, and the two-input
  model's weighted ``evaluate``);
- an async step (one worker, one batch) and a FedAvg round (one worker,
  one local step) on the two-output graph each equal one JAX
  ``SyncTrainer`` step.
"""

import jax
import numpy as np
import pytest

from distriflow_tpu.models import keras_import as jk
from distriflow_tpu.parallel.mesh import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.models import keras_import as tk
from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer
from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer
from distriflow_tpu_torch.train.sync import SyncTrainer

from torch_keras_cases import (
    MULTI_IO_GRAPHS,
    assert_close,
    multi_io_data,
    random_weights,
    write_model,
)
from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

TOL = 1e-5
LR = 0.1
STEPS = 2
ROWS, MESH_ROWS = 8, 6


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_io")
    out = {}
    for name, graph in MULTI_IO_GRAPHS.items():
        topo = graph()
        out[name] = write_model(root / name, topo, random_weights(topo, seed=1))
    return out


def _jax_trainer(path):
    """JAX's trainer on one device (the mesh of ``tests/conftest.py``'s
    first virtual device)."""
    t = JaxTrainer(jk.spec_from_keras_json(path), learning_rate=LR,
                   mesh=data_parallel_mesh(jax.devices()[:1]))
    t.init()
    return t


def _jax_run(path, x, y, steps=STEPS):
    """JAX's losses over ``steps`` steps and its parameters in the port's
    names."""
    t = _jax_trainer(path)
    losses = [t.step((x, y)) for _ in range(steps)]
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t.get_params())
    return losses, tk.keras_tree_to_params(tree)


def _port_trainer(path, **kw):
    t = SyncTrainer(tk.spec_from_keras_json(path, device="cpu"), learning_rate=LR, **kw)
    t.init()
    return t


def _assert_params(got, want, what):
    assert set(got) == set(want), what
    for n in want:
        assert_close(np.asarray(got[n], np.float32), want[n], TOL, f"{what} {n}")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", sorted(MULTI_IO_GRAPHS))
def test_sync_steps_match_jax(paths, name, accum):
    x, y = multi_io_data(name, ROWS, 0)
    want_losses, want = _jax_run(paths[name], x, y)
    t = _port_trainer(paths[name], grad_accum=accum)
    losses = [t.step((x, y)) for _ in range(STEPS)]
    assert_close(losses, want_losses, TOL, f"{name} losses")
    assert losses[1] < losses[0]
    _assert_params({n: v.numpy() for n, v in t.get_params().items()}, want, name)


@pytest.mark.parametrize("name", sorted(MULTI_IO_GRAPHS))
def test_evaluate_as_jax(paths, name):
    x, y = multi_io_data(name, ROWS, 0)
    jt = _jax_trainer(paths[name])
    t = _port_trainer(paths[name])
    for metric in ("loss", "accuracy"):
        try:
            want = jt.evaluate(x, y, metrics=(metric,))
        except Exception:
            with pytest.raises(ValueError, match="one output"):
                t.evaluate(x, y, metrics=(metric,))
            assert name == "two_outputs"
            continue
        assert_close(t.evaluate(x, y, metrics=(metric,)), want, TOL, f"{name} {metric}")


@pytest.fixture(scope="module")
def mesh_runs(paths):
    data = {name: multi_io_data(name, MESH_ROWS, 1) for name in MULTI_IO_GRAPHS}
    ref = {name: _jax_run(paths[name], *data[name]) for name in MULTI_IO_GRAPHS}
    jt = _jax_trainer(paths["two_inputs"])
    for _ in range(STEPS):
        jt.step(data["two_inputs"])
    ref["eval"] = jt.evaluate(*data["two_inputs"])
    payload = {"paths": paths, "data": data, "lr": LR, "steps": STEPS}
    return ref, run_world(4, "multi_io_cases", payload)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", sorted(MULTI_IO_GRAPHS))
def test_padded_data_mesh_equals_one_device(mesh_runs, name, accum):
    ref, ranks = mesh_runs
    want_losses, want = ref[name]
    for r in ranks:
        assert_close(r[f"{name}_accum{accum}"]["losses"], want_losses, TOL, f"{name} losses")
    _assert_params(ranks[0][f"{name}_accum{accum}"]["params"], want, name)
    if name == "two_inputs":
        assert ranks[0]["rows_per_rank"] == 2  # 6 rows padded to 8 over data 4
        assert_close(ranks[0][f"{name}_accum{accum}"]["eval"], ref["eval"], TOL, "evaluate")


def test_async_step_on_two_outputs(paths):
    x, y = multi_io_data("two_outputs", ROWS, 2)
    _, want = _jax_run(paths["two_outputs"], x, y, steps=1)
    ds = DistributedDataset(x, y, {"batch_size": ROWS, "epochs": 1})
    t = AsyncSGDTrainer(tk.spec_from_keras_json(paths["two_outputs"], device="cpu"), ds,
                        learning_rate=LR)
    t.init()
    assert t.train(num_workers=1)["applied"] == 1
    _assert_params({n: v.numpy() for n, v in t.snapshot()[0].items()}, want, "async")
    cost = t.cost_analysis(ROWS)  # zero inputs of the dataset's leaves' shapes
    assert cost["aten_flops"] > 0


def test_fedavg_round_on_two_outputs(paths):
    x, y = multi_io_data("two_outputs", ROWS, 3)
    t = FederatedAveragingTrainer(tk.spec_from_keras_json(paths["two_outputs"], device="cpu"),
                                  local_steps=1, local_batch_size=ROWS, learning_rate=LR)
    t.init()
    xs, ys = t.pack_round_data(x, y, rng=np.random.RandomState(0))
    assert xs.shape == (1, 1, ROWS, 5) and [a.shape[:3] for a in ys] == [(1, 1, ROWS)] * 2
    order = np.random.RandomState(0).permutation(ROWS)
    want_losses, want = _jax_run(paths["two_outputs"], x[order],
                                 tuple(a[order] for a in y), steps=1)
    assert_close(t.round(xs, ys), want_losses[0], TOL, "fedavg loss")
    _assert_params({n: v.detach().numpy() for n, v in t.params.items()}, want, "fedavg")
