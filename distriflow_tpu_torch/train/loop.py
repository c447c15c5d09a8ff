"""Port of ``distriflow_tpu/train/loop.py``: the chunked host training loop
and exact chunked evaluation.

:func:`run_chunked` drives a trainer over a batch stream K steps per call
(``trainer.step`` for K = 1, ``trainer.step_many`` on the stacked chunk
for K > 1: the same optimizer trajectory either way), timing the steady
state after the first call. :func:`evaluate_dataset` computes exact
whole-array metrics in fixed-size chunks, zero-padding a tail that does
not divide ``divisor`` with weight-0 rows.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Any, Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ChunkedRunResult(NamedTuple):
    steps_run: int       # optimizer steps actually executed
    timed_steps: int     # steps inside the steady-state timing window
    elapsed_s: float     # wall time of the timed window (value-fetch barrier)
    last_loss: Optional[float]  # loss of the final executed step
    ran_dry: bool = False  # the batch stream ended before `steps` batches

    @property
    def steps_per_sec(self) -> float:
        """Steady-state steps/sec; nan if everything fit in one call."""
        if not self.timed_steps:
            return float("nan")
        return self.timed_steps / self.elapsed_s

    def tail_note(self, requested_steps: int) -> Optional[str]:
        """Note when fewer than ``requested_steps`` ran, or None if all ran."""
        if self.steps_run >= requested_steps:
            return None
        if self.ran_dry:
            return (f"note: ran {self.steps_run} of {requested_steps} steps "
                    "— the batch stream ended early")
        return (f"note: ran {self.steps_run} of {requested_steps} steps — "
                "the tail is not a full --steps-per-dispatch chunk; pick a "
                "step count divisible by it to run them all")


def _stack(chunk: list) -> Tuple[Any, ...]:
    """K batch tuples -> one tuple with a leading step axis."""
    return tuple(torch.stack(list(xs)) if isinstance(xs[0], torch.Tensor) else np.stack(xs)
                 for xs in zip(*chunk))


def run_chunked(
    trainer: Any,
    stream: Iterable[Any],
    steps: int,
    steps_per_dispatch: int = 1,
    log: Optional[Callable[[int, float], None]] = None,
    log_every: int = 20,
) -> ChunkedRunResult:
    """Drive ``trainer`` over ``stream`` K steps per call.

    ``stream`` yields batch tuples (``(x, y)`` / ``(x, y, w)``, host arrays
    or device tensors). Only full chunks run (``steps % K`` tail steps are
    skipped). ``log(step, loss)`` fires roughly every ``log_every`` steps
    and after the final chunk. The first call is left out of the timing
    window, as in JAX (there it compiles; here it loads the kernels)."""
    k = max(1, min(steps_per_dispatch, steps)) if steps else 1
    run_steps = (steps // k) * k
    stream = iter(stream)
    start = time.perf_counter()
    timed_steps = 0
    step = 0
    last: Optional[float] = None
    ran_dry = False
    while step < run_steps:
        chunk = list(itertools.islice(stream, k))
        if len(chunk) < k:
            ran_dry = True  # stream ended before `steps` batches
            break
        if k > 1:
            last = float(trainer.step_many(_stack(chunk))[-1])  # the fetch is the barrier
        else:
            last = float(trainer.step(chunk[0]))
        first_call = step == 0
        step += k
        if first_call:
            start = time.perf_counter()
        else:
            timed_steps += k
        if log is not None and (step >= run_steps or (step // k) % max(1, log_every // k) == 0):
            log(step, last)
    elapsed = time.perf_counter() - start
    return ChunkedRunResult(step, timed_steps, elapsed, last, ran_dry)


def pad_partial_batch(divisor: int, *arrays: Any) -> Tuple[Any, ...]:
    """Zero-pad every array's row count up to a multiple of ``divisor``.
    Returns ``(*padded_arrays, weight)``: ``weight`` is 1.0 for real rows
    and 0.0 for padding, or ``None`` when no padding was needed (the port's
    copy of ``distriflow_tpu/parallel/mesh.py::pad_partial_batch``)."""
    n = len(arrays[0])
    pad = (-n) % max(int(divisor), 1)
    if not pad:
        return (*arrays, None)

    def pad0(v):
        v = np.asarray(v)
        return np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))

    weight = np.concatenate([np.ones((n,), np.float32), np.zeros((pad,), np.float32)])
    return (*(pad0(v) for v in arrays), weight)


def evaluate_dataset(
    evaluate: Callable[..., list],
    x: Any,
    y: Any,
    batch_size: int = 512,
    metrics: tuple = ("loss", "accuracy"),
    divisor: Optional[int] = None,
    **eval_kwargs: Any,
) -> list:
    """Exact whole-array metrics, evaluated in fixed-size chunks.

    ``evaluate`` is a trainer's ``evaluate(x, y, metrics=..., weight=...)``.
    Per-chunk example-mean metrics recombine weighted by real-row count, so
    the result equals one batch of the whole array. ``divisor`` constrains
    chunk row counts (a device mesh's data-axis size; read from the bound
    trainer's ``mesh`` when it has one, else 1); a trailing chunk that does
    not divide is zero-padded with weight-0 rows."""
    n = len(x)
    if n == 0:
        raise ValueError("evaluate_dataset needs at least one example")
    if len(y) != n:
        raise ValueError(f"x and y lengths differ: {n} vs {len(y)}")
    if divisor is None:
        fn = evaluate
        while isinstance(fn, functools.partial):  # unwrap partial chains
            fn = fn.func
        mesh = getattr(getattr(fn, "__self__", None), "mesh", None)
        divisor = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    if batch_size % divisor:
        batch_size += divisor - batch_size % divisor  # keep full chunks legal
    totals = [0.0] * len(metrics)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        cx, cy, weight = pad_partial_batch(divisor, x[lo:hi], y[lo:hi])
        if weight is not None:
            vals = evaluate(cx, cy, metrics=tuple(metrics), weight=weight, **eval_kwargs)
        else:
            vals = evaluate(cx, cy, metrics=tuple(metrics), **eval_kwargs)
        for i, v in enumerate(vals):
            totals[i] += float(v) * (hi - lo)
    return [t / n for t in totals]
