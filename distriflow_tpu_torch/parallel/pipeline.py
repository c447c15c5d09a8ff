"""Port of ``distriflow_tpu/parallel/pipeline.py``: pipeline parallelism over
the ``pipe`` mesh axis (GPipe-style SPMD).

Every rank runs the same tick loop, as JAX's ``shard_map`` body does:

- stage parameters carry a leading stages dim sharded over ``pipe``: each
  rank holds its own stage's slice (leading dim 1; a full stack of P
  stages is cut to this rank's stage here);
- the batch splits into M microbatches and the schedule runs ``M + P - 1``
  ticks. Each tick stage 0 injects microbatch t, every rank runs its stage
  on the activation it holds (zeros in the bubbles), the last stage banks
  slot t - (P - 1) and the activations move one hop down the ``pipe`` ring
  (:func:`~distriflow_tpu_torch.parallel.collectives.ppermute_ring`); the
  banked outputs are ``psum``'d over ``pipe``, so every pipe rank holds
  them;
- activations keep one shape through the stages.

``x`` is this rank's rows (the trainer shards the batch over ``data``):
with ``data`` > 1 each data rank splits its own rows into the M
microbatches, so microbatch j is every data rank's j-th chunk. Parameter
gradients come back as this rank's partials over ``data``; the trainer
sums them over ``data`` as it sums every gradient. The input's gradient
is summed over ``pipe`` (only stage 0 reads the input), so a replicated
producer of ``x`` (the embedding) gets the same gradient on every pipe
rank.

Every rank's autograd graph and collective sequence are the same: the
injection and the banking are ``torch.where`` selects on this rank's
stage index, never a Python branch around a collective, so the backward
issues its collectives in one order everywhere.

Three backward strategies (``TransformerConfig.pipeline_schedule``), as in
JAX:

- :func:`gpipe` — autograd through the schedule: every tick's stage
  internals are saved.
- :func:`gpipe_remat` — a ``torch.autograd.Function`` that saves only each
  tick's stage input and re-runs the stage under ``torch.enable_grad`` in a
  mirrored reverse schedule.
- :func:`gpipe_1f1b` — the one-forward-one-backward order as one combined
  tick loop in the backward, with a ring buffer of P live stage inputs;
  the Function saves nothing but the parameters and the input.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from distriflow_tpu_torch.parallel.collectives import (
    _all_reduce,
    _ppermute,
    copy_to,
    ppermute_ring,
    psum,
)
from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size

StageFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def _pipeline_setup(stacked_params: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                    num_microbatches: int, axis: str, data_axis: str
                    ) -> Tuple[int, int, int, Dict[str, torch.Tensor]]:
    """JAX's validation with its errors; returns ``(p, m, idx, params)``:
    the axis size, the microbatch count, this rank's stage and its
    stage's parameters (the leading stages dim dropped)."""
    p = axis_size(mesh, axis)
    m = num_microbatches
    d = axis_size(mesh, data_axis) if data_axis else 1
    b = x.shape[0] * d  # the global batch: x is this rank's rows
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    leading = next(iter(stacked_params.values())).shape[0]
    idx = axis_index(mesh, axis)
    if leading not in (1, p):
        raise ValueError(
            f"stacked_params has {leading} stages but the {axis!r} axis has "
            f"{p} devices — shard_map would silently drop stages")
    mb = b // m
    if mb % max(d, 1):
        raise ValueError(
            f"microbatch size {mb} not divisible by the {data_axis!r} axis ({d})")
    row = 0 if leading == 1 else idx
    return p, m, idx, {n: v[row] for n, v in stacked_params.items()}


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, device=like.device)


def _forward_schedule(stage_fn: StageFn, params, xs: List[torch.Tensor], p: int, m: int,
                      idx: int, mesh, axis: str, save_inputs: bool, autograd: bool
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The tick loop all three variants share: ``(outputs [M, mb, ...]
    summed over pipe, saved stage inputs)``. ``autograd`` picks the
    differentiable collectives (gpipe) or the plain ones (the custom
    backwards' forward, run without a graph)."""
    state = torch.zeros_like(xs[0])
    banked: List[torch.Tensor] = []
    saved: List[torch.Tensor] = []
    ticks = m + p - 1
    for t in range(ticks):
        state = torch.where(_flag(idx == 0 and t < m, state), xs[min(t, m - 1)], state)
        if save_inputs:
            saved.append(state)
        out = stage_fn(params, state)
        if t >= p - 1:
            banked.append(out)
        if t < ticks - 1:  # the last tick's move would feed nothing
            state = (ppermute_ring(out, axis, mesh, 1) if autograd
                     else _ppermute(out, mesh, axis, 1))
    outputs = torch.stack(banked)
    outputs = torch.where(_flag(idx == p - 1, outputs), outputs, torch.zeros_like(outputs))
    outputs = psum(outputs, axis, mesh) if autograd else _all_reduce(outputs, mesh, axis)
    return outputs, saved


def _microbatches(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    return list(x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:])).unbind(0))


def gpipe(stage_fn: StageFn, stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
          mesh, num_microbatches: int, axis: str = "pipe", data_axis: str = "data"
          ) -> torch.Tensor:
    """Run ``x`` (this rank's rows) through P pipeline stages of
    ``stage_fn(params, activation)``; autograd through the schedule.
    Output has ``x``'s shape, on every pipe rank."""
    p, m, idx, params = _pipeline_setup(stacked_params, x, mesh, num_microbatches, axis,
                                        data_axis)
    xs = _microbatches(copy_to(x, axis, mesh), m)
    out, _ = _forward_schedule(stage_fn, params, xs, p, m, idx, mesh, axis, False, True)
    return out.reshape(x.shape)


def _stage_grads(stage_fn: StageFn, names: List[str], params: List[torch.Tensor],
                 state: torch.Tensor, cot: torch.Tensor
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Re-run the stage at ``state`` and pull ``cot`` back: ``(parameter
    gradients, the input's gradient)``."""
    with torch.enable_grad():
        ps = [v.detach().requires_grad_(v.requires_grad) for v in params]
        s = state.detach().requires_grad_(True)
        out = stage_fn(dict(zip(names, ps)), s)
        live = [v for v in ps if v.requires_grad]
        gs = torch.autograd.grad(out, live + [s], cot, allow_unused=True)
    it = iter(gs[:-1])
    dps = []
    for v in ps:
        g = next(it) if v.requires_grad else None
        dps.append(torch.zeros_like(v) if g is None else g)
    ds = gs[-1]
    return dps, torch.zeros_like(s) if ds is None else ds


class _Schedule(torch.autograd.Function):
    """The remat and 1F1B schedules: the plain forward schedule, then a
    hand-written backward (``kind``)."""

    @staticmethod
    def forward(ctx, kind, stage_fn, names, mesh, axis, p, m, idx, x, *params):
        xs = _microbatches(x, m)
        pd = dict(zip(names, params))
        out, saved = _forward_schedule(stage_fn, pd, xs, p, m, idx, mesh, axis,
                                       kind == "remat", False)
        ctx.args = (kind, stage_fn, names, mesh, axis, p, m, idx)
        # remat keeps each tick's stage input; 1F1B only the input itself
        ctx.save_for_backward(*params, *(saved if kind == "remat" else [x]))
        ctx.n_params = len(params)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        kind, stage_fn, names, mesh, axis, p, m, idx = ctx.args
        tensors = ctx.saved_tensors
        params, rest = list(tensors[:ctx.n_params]), list(tensors[ctx.n_params:])
        dys = _microbatches(dy.contiguous(), m)
        if kind == "remat":
            grads, dxs = _remat_backward(stage_fn, names, params, rest, dys, p, m, idx, mesh,
                                         axis)
        else:
            grads, dxs = _1f1b_backward(stage_fn, names, params, _microbatches(rest[0], m),
                                        dys, p, m, idx, mesh, axis)
        dx = torch.stack(dxs).reshape(dy.shape)
        return (None,) * 8 + (dx,) + tuple(grads)


def _remat_backward(stage_fn, names, params, saved, dys, p, m, idx, mesh, axis):
    """JAX ``gpipe_remat``'s mirrored reverse schedule: each tick re-runs
    the stage at its saved input, takes the output's cotangent (the loss's
    on the last stage's banked slots, else what came up the ring), and
    sends the input's cotangent one hop up the ring; stage 0 banks the
    injected microbatches' input gradients."""
    ticks = m + p - 1
    cot_in = torch.zeros_like(dys[0])
    grads = [torch.zeros_like(v) for v in params]
    dxs = [torch.zeros_like(dys[0]) for _ in range(m)]
    for t in range(ticks - 1, -1, -1):
        slot = t - (p - 1)
        cot_out = dys[slot] if idx == p - 1 and slot >= 0 else cot_in
        dps, dstate = _stage_grads(stage_fn, names, params, saved[t], cot_out)
        for g, dp in zip(grads, dps):
            g.add_(dp)
        inject = idx == 0 and t < m
        if inject:  # the pre-injection state was overwritten: nothing goes up
            dxs[t] = dstate
            dstate = torch.zeros_like(dstate)
        if t > 0:
            cot_in = _ppermute(dstate, mesh, axis, -1)
    return grads, dxs


def _1f1b_backward(stage_fn, names, params, xs, dys, p, m, idx, mesh, axis):
    """JAX ``gpipe_1f1b``'s combined tick loop: stage s runs microbatch
    j's forward at tick 2j + s and its backward at tick 2j + 2P - 1 - s;
    live stage inputs sit in a ring buffer of P slots. Both waves move one
    hop every tick (activations down, cotangents up) on every rank; a
    rank's idle ticks run no stage."""
    fwd_state = torch.zeros_like(xs[0])
    cot_in = torch.zeros_like(dys[0])
    ring: List[torch.Tensor] = [torch.zeros_like(xs[0]) for _ in range(p)]
    grads = [torch.zeros_like(v) for v in params]
    dxs = [torch.zeros_like(dys[0]) for _ in range(m)]
    for t in range(2 * m + 2 * p - 2):
        tf = t - idx
        f_active = tf >= 0 and tf % 2 == 0 and tf // 2 < m
        tb = t - (2 * p - 1 - idx)
        b_active = tb >= 0 and tb % 2 == 0 and tb // 2 < m
        out = torch.zeros_like(fwd_state)
        dstate_pass = torch.zeros_like(cot_in)
        if b_active:
            m_b = tb // 2
            cot_out = dys[m_b] if idx == p - 1 else cot_in
            dps, dstate = _stage_grads(stage_fn, names, params, ring[m_b % p], cot_out)
            for g, dp in zip(grads, dps):
                g.add_(dp)
            if idx == 0:
                dxs[m_b] = dstate
            else:
                dstate_pass = dstate
        elif f_active:
            m_f = tf // 2
            state = xs[m_f] if idx == 0 else fwd_state
            with torch.no_grad():
                out = stage_fn(dict(zip(names, params)), state)
            ring[m_f % p] = state
        fwd_state = _ppermute(out, mesh, axis, 1)
        cot_in = _ppermute(dstate_pass, mesh, axis, -1)
    return grads, dxs


def _custom(kind: str, stage_fn: StageFn, stacked_params: Dict[str, torch.Tensor],
            x: torch.Tensor, mesh, num_microbatches: int, axis: str, data_axis: str
            ) -> torch.Tensor:
    p, m, idx, params = _pipeline_setup(stacked_params, x, mesh, num_microbatches, axis,
                                        data_axis)
    names = list(params)
    x = copy_to(x, axis, mesh)  # only stage 0 reads x: its gradient is summed over pipe
    return _Schedule.apply(kind, stage_fn, names, mesh, axis, p, m, idx, x,
                           *(params[n] for n in names))


def gpipe_remat(stage_fn: StageFn, stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
                mesh, num_microbatches: int, axis: str = "pipe", data_axis: str = "data"
                ) -> torch.Tensor:
    """:func:`gpipe` with an input-only-residual backward: the forward is
    the same schedule and keeps only each tick's stage input; the backward
    re-runs each tick's stage (one extra stage forward a tick)."""
    return _custom("remat", stage_fn, stacked_params, x, mesh, num_microbatches, axis,
                   data_axis)


def gpipe_1f1b(stage_fn: StageFn, stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
               mesh, num_microbatches: int, axis: str = "pipe", data_axis: str = "data"
               ) -> torch.Tensor:
    """Interleaved 1F1B: the forward keeps nothing but the parameters and
    ``x``; the backward recomputes the forward wave interleaved with the
    backward, so at most P stage inputs are live on a rank, for any M."""
    return _custom("1f1b", stage_fn, stacked_params, x, mesh, num_microbatches, axis,
                   data_axis)


SCHEDULES: Dict[str, Any] = {"gpipe": gpipe, "remat": gpipe_remat, "1f1b": gpipe_1f1b}
