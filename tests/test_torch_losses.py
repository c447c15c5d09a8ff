"""Port parity: the loss and metric registry
(``distriflow_tpu_torch/models/losses.py``).

Every registered loss, reduced with and without per-example weights, and
the accuracy metric, against the JAX package's registry on the same numpy
inputs (the optax losses are written in torch to optax's formulas). f32
throughout: 1e-5 (the same formulas, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models import losses as jax_losses
from distriflow_tpu_torch.models import losses as port_losses

pytestmark = pytest.mark.port

# the unfused registry (the fused names register only once the kernel
# layers are imported, so they are tested in test_torch_fused_ce.py)
NAMES = ["absolute_difference", "cosine_distance", "hinge_loss", "huber_loss", "log_loss",
         "mean_squared_error", "sigmoid_cross_entropy", "softmax_cross_entropy",
         "sparse_softmax_cross_entropy"]


def _inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    b, f = 6, 10
    preds = rng.randn(b, f).astype(np.float32)
    if name == "sparse_softmax_cross_entropy":
        return preds, rng.randint(0, f, b).astype(np.int32)
    if name == "softmax_cross_entropy":
        return preds, np.eye(f, dtype=np.float32)[rng.randint(0, f, b)]
    if name in ("log_loss", "hinge_loss", "sigmoid_cross_entropy"):
        probs = 1 / (1 + np.exp(-preds)) if name == "log_loss" else preds
        return probs.astype(np.float32), (rng.rand(b, f) > 0.5).astype(np.float32)
    return preds, rng.randn(b, f).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_every_loss_matches_jax(name, weighted):
    preds, targets = _inputs(name)
    w = np.array([1, 0, 2, 1, 0.5, 1], np.float32) if weighted else None
    ref = jax_losses.get_loss(name)(jnp.asarray(preds), jnp.asarray(targets),
                                    None if w is None else jnp.asarray(w))
    got = port_losses.get_loss(name)(torch.from_numpy(preds), torch.from_numpy(targets),
                                     None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(ref), abs=1e-5, rel=1e-5)


def test_token_losses_take_row_weights_and_accuracy_matches():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, 7).astype(np.float32)
    labels = rng.randint(0, 7, (3, 5)).astype(np.int32)
    w = np.array([1.0, 0.0, 2.0], np.float32)
    for name in ("sparse_softmax_cross_entropy",):
        ref = jax_losses.get_loss(name)(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
        got = port_losses.get_loss(name)(torch.from_numpy(logits), torch.from_numpy(labels),
                                         torch.from_numpy(w))
        assert float(got) == pytest.approx(float(ref), abs=1e-5)
    for t in (labels, np.eye(7, dtype=np.float32)[labels]):
        ref = jax_losses.accuracy(jnp.asarray(logits), jnp.asarray(t), jnp.asarray(w))
        got = port_losses.accuracy(torch.from_numpy(logits), torch.from_numpy(t), torch.from_numpy(w))
        assert float(got) == pytest.approx(float(ref), abs=1e-6)


def test_registry_names_and_unknown_names():
    assert set(port_losses.PER_EXAMPLE) >= set(NAMES)
    with pytest.raises(KeyError):
        port_losses.get_loss("no_such_loss")
    with pytest.raises(KeyError):
        port_losses.get_metric("no_such_metric")
