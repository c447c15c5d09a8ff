"""Port of ``distriflow_tpu/train/schedules.py``: the learning-rate
schedule registry.

Each schedule is a plain ``step -> lr`` callable over a host int, the form
the port's :class:`~distriflow_tpu_torch.models.base.Optimizer` reads at
its update count (every trainer's ``learning_rate`` accepts one). The
values follow optax's formulas in f32 (numpy float32 scalars: the same
operations in the same order as optax's jitted f32 math), so a schedule
gives optax's value to within one f32 ulp (``cos`` and ``pow`` may round
differently in the two libraries).

The JAX module's description follows.

No reference counterpart (the reference's learning rate is a fixed client
hyperparameter, ``src/common/utils.ts:183``). Schedules are optax step->lr
callables; every trainer's ``learning_rate`` argument accepts one directly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

Schedule = Callable[[int], float]  # step -> learning rate

_f = np.float32


def _cos(a: np.float32) -> np.float32:
    """f32 cosine, rounded from the f64 one (XLA's f32 ``cos`` gives the
    same bits far more often than numpy's f32 ``cos``)."""
    return _f(np.cos(float(a)))


def _pow(a: np.float32, b: np.float32) -> np.float32:
    """f32 power through PyTorch's CPU kernel (measured to give XLA's
    bits, where numpy's f32 ``power`` differs in the last bit)."""
    return _f(torch.pow(torch.tensor(a), torch.tensor(b)).item())


def constant(value: float) -> Schedule:
    return lambda step: float(value)


def cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """Cosine decay from ``init_value`` to ``alpha * init_value``
    (``optax.cosine_decay_schedule``)."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(step: int) -> float:
        count = _f(min(float(step), float(decay_steps)))
        decay = _f(0.5) * (_f(1) + _cos(_f(np.pi) * count / _f(decay_steps)))
        return float(_f(init_value) * (_f(1 - alpha) * decay + _f(alpha)))

    return schedule


def warmup_cosine(
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    init_value: float = 0.0,
    end_value: float = 0.0,
) -> Schedule:
    """Linear warmup to ``peak_value`` then cosine decay to ``end_value``
    (``optax.warmup_cosine_decay_schedule``: the decay spans
    ``decay_steps - warmup_steps`` steps)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear(init_value, peak_value, warmup_steps)
    decay = cosine(peak_value, decay_steps - warmup_steps, alpha)
    return lambda step: warm(step) if step < warmup_steps else decay(step - warmup_steps)


def exponential(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    """``init_value * decay_rate ** (step / transition_steps)``
    (``optax.exponential_decay``, no staircase)."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant(init_value)

    def schedule(step: int) -> float:
        if step <= 0:
            return float(_f(init_value))
        p = _f(step) / _f(transition_steps)
        return float(_f(init_value) * _pow(_f(decay_rate), p))

    return schedule


def linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``init_value`` to ``end_value`` over ``transition_steps`` steps
    (``optax.linear_schedule``)."""
    if transition_steps <= 0:
        return constant(init_value)

    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        frac = _f(1) - _f(count) / _f(transition_steps)
        return float(_f(init_value - end_value) * frac + _f(end_value))

    return schedule


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "constant": constant,
    "cosine": cosine,
    "warmup_cosine": warmup_cosine,
    "exponential": exponential,
    "linear": linear,
}


def get_schedule(name: str, **kwargs: Any) -> Schedule:
    """Build a schedule by registry name (strict: unknown names raise)."""
    if name not in SCHEDULES:
        raise KeyError(f"unknown schedule {name!r}; registered: {sorted(SCHEDULES)}")
    return SCHEDULES[name](**kwargs)
