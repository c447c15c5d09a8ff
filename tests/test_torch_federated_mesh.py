"""Port parity: federated averaging on a mesh (``distriflow_tpu_torch/
train/federated.py`` with ``mesh=``) against the JAX package's on the CPU.

JAX runs one worker per device of ``devices[:4]`` (``shard_map`` over
``data``); the port runs one worker per rank of a spawned gloo world of 4
CPU processes (``tests/torch_mesh_cases.py::federated_cases``), each on
its slice of the same round data, and averages over ``data`` by an
all-gather summed in rank order. From JAX's init (carried over by
``zoo_params_from_jax``), two rounds of K local steps (sgd K 3 and
momentum K 2, B 8) of the zoo MLP: round losses and parameters within
1e-5 (JAX's ``pmean`` and the rank-ordered sum add the same f32 values in
orders of their own), and ``num_workers`` is the ``data`` axis size.
"""

import jax
import numpy as np
import pytest

from distriflow_tpu.models import mnist_mlp as jax_mnist_mlp
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.federated import FederatedAveragingTrainer as JaxFedAvg
from distriflow_tpu_torch.models.convert import zoo_params_from_jax

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

CASES = [dict(name="sgd", k=3, b=8, optimizer="sgd", lr=0.1),
         dict(name="momentum", k=2, b=8, optimizer="momentum", lr=0.05)]
ROUNDS = 2


def _data(n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, n)
    x[np.arange(n), 0, labels, 0] += 4.0
    return x, np.eye(10, dtype=np.float32)[labels]


@pytest.fixture(scope="module")
def runs(devices):
    x, y = _data()
    jax_runs, rounds = {}, {}
    tree = None
    for case in CASES:
        t = JaxFedAvg(jax_mnist_mlp(hidden=8), mesh=data_parallel_mesh(devices[:4]),
                      local_steps=case["k"], local_batch_size=case["b"],
                      optimizer=case["optimizer"], learning_rate=case["lr"])
        t.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, t.params)
        rng = np.random.RandomState(7)
        data = [t.pack_round_data(x, y, rng) for _ in range(ROUNDS)]
        rounds[case["name"]] = [(np.asarray(a), np.asarray(b)) for a, b in data]
        losses = [t.round(*r) for r in data]
        jax_runs[case["name"]] = {"losses": losses,
                                  "params": jax.tree_util.tree_map(np.asarray, t.params)}
    payload = {"cases": CASES, "tree": tree, "rounds": rounds}
    return tree, jax_runs, run_world(4, "federated_cases", payload)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_fedavg_on_a_mesh_matches_jax(runs, name):
    _, jax_runs, ranks = runs
    ref = jax_runs[name]
    want = {n: t.numpy() for n, t in zoo_params_from_jax(ref["params"]).items()}
    for r in ranks:
        got = r[name]
        assert got["num_workers"] == 4
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0, atol=1e-5)
        for n, w in want.items():
            np.testing.assert_allclose(got["params"][n], w, rtol=0, atol=1e-5, err_msg=n)


def test_every_rank_holds_the_same_average(runs):
    _, _, ranks = runs
    for name in (c["name"] for c in CASES):
        for r in ranks[1:]:
            for n, v in r[name]["params"].items():
                np.testing.assert_array_equal(v, ranks[0][name]["params"][n])
