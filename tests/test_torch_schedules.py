"""Port parity: the learning-rate schedules (``distriflow_tpu_torch/train/schedules.py``)
against the JAX package's (optax's formulas) at every step from 0 to
twice the decay length, fed optax's int32 step counts as its optimizers
do. Both compute in f32; ``cos`` and ``pow`` may round differently in
numpy and XLA, so each value must lie within 1 f32 ulp of optax's (of the
larger magnitude of the two). Then the registry: the same names, unknown
names raise, and a schedule drives the port's optimizer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.train import schedules as jax_schedules
from distriflow_tpu_torch.models.base import Optimizer
from distriflow_tpu_torch.train import schedules

pytestmark = pytest.mark.port

DECAY = 40
CASES = {
    "constant": dict(value=0.05),
    "cosine": dict(init_value=0.1, decay_steps=DECAY, alpha=0.1),
    "warmup_cosine": dict(peak_value=0.3, warmup_steps=7, decay_steps=DECAY,
                          init_value=0.01, end_value=0.002),
    "exponential": dict(init_value=0.2, transition_steps=9, decay_rate=0.7),
    "linear": dict(init_value=0.5, end_value=0.01, transition_steps=DECAY),
}


def _ulps(a: float, b: float) -> float:
    """|a - b| in f32 ulps of the larger magnitude."""
    a32, b32 = np.float32(a), np.float32(b)
    return float(abs(a32 - b32) / np.spacing(max(abs(a32), abs(b32))))


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine", "exponential",
                                  "linear"])
def test_schedule_matches_optax(name):
    ours = schedules.get_schedule(name, **CASES[name])
    ref = jax_schedules.get_schedule(name, **CASES[name])
    worst = 0.0
    for step in range(2 * DECAY + 1):
        got, want = ours(step), float(ref(jnp.int32(step)))
        assert isinstance(got, float)
        worst = max(worst, _ulps(got, want))
    assert worst <= 1.0, f"{name}: {worst} ulps off optax"


def test_degenerate_lengths_are_constant_as_in_optax():
    for ours, ref in (
            (schedules.linear(0.5, 0.1, 0), jax_schedules.linear(0.5, 0.1, 0)),
            (schedules.exponential(0.3, 0, 0.5), jax_schedules.exponential(0.3, 0, 0.5))):
        assert [ours(s) for s in (0, 5)] == [float(ref(jnp.int32(s))) for s in (0, 5)]
    with pytest.raises(ValueError, match="decay_steps"):
        schedules.cosine(0.1, 0)


def test_registry_is_strict_and_matches_jax():
    assert sorted(schedules.SCHEDULES) == sorted(jax_schedules.SCHEDULES)
    with pytest.raises(KeyError, match="unknown schedule 'nope'"):
        schedules.get_schedule("nope")
    with pytest.raises(TypeError):
        schedules.get_schedule("cosine", init_value=0.1)  # decay_steps missing


def test_a_schedule_drives_the_optimizer():
    """The optimizer reads the schedule at its count of earlier updates:
    sgd's k-th update is -lr(k) * g."""
    sched = schedules.get_schedule("linear", init_value=0.4, end_value=0.0, transition_steps=4)
    opt = Optimizer("sgd", sched)
    p = {"w": torch.zeros(3)}
    state = opt.init(p)
    for k in range(5):
        updates, state = opt.update({"w": torch.ones(3)}, state, p)
        assert torch.equal(updates["w"], torch.full((3,), -np.float32(sched(k))))
