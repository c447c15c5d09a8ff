"""Port of ``distriflow_tpu/train/sync.py``: the synchronous trainer, on one
device or on a mesh.

One step runs the model's forward and backward (on CUDA through the flash
attention and fused cross-entropy kernels), the optimizer update and the
EMA, with optax's semantics (:mod:`distriflow_tpu_torch.models.base`).
Where JAX jit-compiles a pure step over an immutable ``TrainState``, the
port runs eagerly and updates the parameters, optimizer state and EMA in
place: no second copy of the state exists during a step.

Version, checkpoint and callback semantics are the JAX package's:
``version`` counts steps, the ``step`` and ``new_version`` callbacks fire
after each step, ``grad_accum`` micro-batches are weighted by their weight
sums, and ``checkpoint_dir``/``save_every`` write versioned checkpoints on
a background thread.

``cost_analysis`` counts one forward and backward with
``torch.utils.flop_counter.FlopCounterMode`` and, on CUDA, adds the
kernels' analytic tally (:mod:`distriflow_tpu_torch.ops.flop_count`);
``mfu`` divides it by the step time and the card's dense bf16 peak. On a
mesh both are per device, as in JAX.

A model of several inputs or outputs takes tuples of arrays for ``x`` and
``y``; every leaf is placed, sliced into micro-batches and sharded on its
row axis, and the loss is JAX's: the sum over outputs of each output's
weighted mean.

**On a mesh** (``mesh=``, a five-axis mesh of ``distriflow_tpu_torch.
parallel``; every rank runs the trainer, SPMD) the spec's model holds this
rank's blocks of the parameters, as ``param_rules`` places them
(``parallel/sharding.py``; ``REPLICATED_RULES`` by default). Every rank
takes the *global* host batch and trains on its slice (``shard_batch``:
rows over ``data``, and the sequence over ``seq`` when the model runs
sequence-sharded), or on a batch already sharded. What GSPMD inserts in
JAX is written out here:

- the loss is exact on padded partial batches: each rank sums its
  weighted losses and weights (``ModelSpec.loss_sums``); the weight sums
  are all-reduced over ``data`` (and ``seq``), never the local means, and
  the gradients of the local sums are sum-reduced over the same axes, then
  divided by the global weight sum (so the DP gradient is the global
  mean). A replicated aux term (the MoE load balance, global on every
  rank) weighs in with its micro-batch's global weight sum, as JAX's
  ``grad_accum`` weighs it;
- ``zero_level`` 1 (or ``zero_optimizer_sharding``): each optimizer
  moment holds this rank's ``data`` slice along the dim ``_zero_extend``
  picks; each rank updates its slice of the parameter and the slices are
  all-gathered back; 2: the gradients are reduce-scattered over ``data``
  along that dim instead of all-reduced, and the EMA is sharded like the
  moments.

One device takes the same step path as a mesh: with no mesh every
collective returns its input, every parameter is whole and no ZeRO slice
is cut.

A mesh with ``pipe`` > 1 trains the pipelined LM
(``models/transformer.py::pipelined_transformer_lm``, under
``PIPELINED_TRANSFORMER_RULES``): its stage parameters are each pipe
rank's own, the embedding and head are replicated over ``pipe`` and come
out of the schedule with equal gradients on every pipe rank, so the one
step path above serves it unchanged.

``get_params`` gathers the full parameters (every rank must call it);
``save`` gathers the full state and rank 0 writes it (unsharded). With
``sharded_checkpoints=True`` every rank snapshots its own blocks and ZeRO
slices (``checkpoint/sharded.py``, JAX's layout) and the background writer
commits them collectively over the process group's store; ``restore``
reads this rank's blocks back, from any mesh's checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from distriflow_tpu_torch.models.base import (
    ModelSpec,
    Params,
    _optimizer,
    apply_updates,
    cut_blocks,
    init_params,
    named_params,
    to_device,
)
from distriflow_tpu_torch.obs.telemetry import get_telemetry
from distriflow_tpu_torch.parallel import sharding
from distriflow_tpu_torch.parallel.collectives import _all_gather, _all_reduce, _reduce_scatter
from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size, shard_batch
from distriflow_tpu_torch.utils.logging import CallbackRegistry, VerboseLogger
from distriflow_tpu_torch.utils.profiling import device_timer
from distriflow_tpu_torch.utils.serialization import batch_rows, host_tree, tree_leaves, tree_map

Batch = Tuple[Any, ...]


@dataclasses.dataclass
class TrainState:
    """The training state. ``params`` are the model's own parameter
    tensors by name; ``step`` is the version, a host int."""

    params: Params
    opt_state: Any
    step: int
    # exponential moving average of params (None unless ema_decay is set)
    ema: Optional[Params] = None


class _SaveItem:
    """One queued checkpoint write: carries its own completion + error."""

    __slots__ = ("version", "host_state", "done", "error")

    def __init__(self, version: str, host_state: Any):
        self.version = version
        self.host_state = host_state
        self.done = threading.Event()
        self.error: Optional[Exception] = None


@torch.no_grad()
def _assign(dst: Any, src: Any) -> Any:
    """Copy a loaded host tree into the live tree in place (tensors keep
    their device and identity); non-tensor leaves take the loaded value."""
    if isinstance(dst, dict):
        return {k: _assign(dst[k], src[k]) for k in dst}
    if isinstance(dst, torch.Tensor):
        return dst.copy_(src)
    return src


def _clone(params: Params) -> Params:
    return {n: p.detach().clone() for n, p in params.items()}


def _flat_all_reduce(tree: Params, mesh, axes) -> Params:
    """Sum-allreduce every tensor of ``tree`` over ``axes`` as one flat
    buffer per dtype (one collective each, not one a tensor); the tree
    itself where every axis has size 1 (or there is no mesh)."""
    if all(axis_size(mesh, ax) == 1 for ax in axes):
        return tree
    out: Params = {}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n, t in tree.items():
        by_dtype.setdefault(t.dtype, []).append(n)
    for names in by_dtype.values():
        flat = _all_reduce(torch.cat([tree[n].reshape(-1) for n in names]), mesh, axes)
        off = 0
        for n in names:
            k = tree[n].numel()
            out[n] = flat[off:off + k].view_as(tree[n])
            off += k
    return {n: out[n] for n in tree}


def peak_bf16_flops(device: torch.device) -> float:
    """The dense bf16 peak of ``device``'s card from
    :data:`SyncTrainer.PEAK_BF16_FLOPS`; an unknown card (or a CPU) raises."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    for key, peak in SyncTrainer.PEAK_BF16_FLOPS.items():
        if key in kind.lower():
            return peak
    raise ValueError(f"unknown device kind {kind!r}; pass peak_flops_per_chip=")


def record_mfu(analysis: Dict[str, Any], step_seconds: float, peak_flops_per_chip: float,
               gauge_mode: str) -> float:
    """``analysis["flops"] / (step_seconds * peak)``, set on the
    ``train_mfu{mode=gauge_mode}`` gauge (only when there is a count)."""
    if not analysis.get("flops"):
        raise ValueError(
            f"the step's cost analysis reports no 'flops' (keys: {sorted(analysis)}); "
            "MFU unavailable")
    value = float(analysis["flops"]) / (step_seconds * peak_flops_per_chip)
    get_telemetry().gauge(
        "train_mfu", mode=gauge_mode,
        help="model FLOPs utilization vs peak chip FLOPs",
    ).set(value)
    return value


class SyncTrainer:
    """Synchronous trainer over one device (the device of the model that
    ``spec.init`` builds: CUDA for ``transformer_lm`` by default) or over
    a mesh (see the module docstring).

    ``grad_accum`` splits the batch into K sequential micro-batches whose
    gradients are averaged, each weighted by its weight sum, before one
    update: the result equals one full-batch weighted-mean step."""

    def __init__(
        self,
        spec: ModelSpec,
        mesh: Any = None,
        learning_rate: Optional[float] = None,  # None -> 0.001 (reference default)
        optimizer: str = "sgd",
        param_rules: Any = None,
        grad_accum: int = 1,
        donate: bool = True,
        verbose: Optional[bool] = None,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 0,
        max_checkpoints: Optional[int] = None,
        sharded_checkpoints: bool = False,
        zero_optimizer_sharding: bool = False,
        ema_decay: Optional[float] = None,
        zero_level: Optional[int] = None,
    ):
        mesh = spec.mesh if mesh is None else mesh
        if spec.mesh is not None and spec.mesh is not mesh:
            raise ValueError("the spec was built on another mesh than the trainer's")
        if mesh is None and param_rules is not None:
            raise ValueError("param_rules need a mesh")
        if mesh is not None and spec.mesh is None and any(
                axis_size(mesh, ax) > 1 for ax in ("model", "seq", "pipe", "expert")):
            raise ValueError("a mesh with model, seq, pipe or expert axes above 1 needs a "
                             "spec built on it (e.g. transformer_lm(config, mesh=mesh))")
        if zero_level is None:
            zero_level = 1 if zero_optimizer_sharding else 0
        if zero_level not in (0, 1, 2):
            raise ValueError(f"zero_level must be 0, 1 or 2, got {zero_level}")
        self.mesh = mesh
        self.param_rules = sharding.REPLICATED_RULES if param_rules is None else param_rules
        self.zero_level = zero_level if mesh is not None else 0
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if ema_decay is not None and not (0.0 < ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        spec.check_loss()
        self.spec = spec
        self.optimizer = _optimizer(optimizer, learning_rate)
        self.grad_accum = grad_accum
        self.ema_decay = ema_decay
        del donate  # the JAX name: updates here are in place, nothing to donate
        self.logger = VerboseLogger(f"SyncTrainer[{spec.name}]", verbose)
        self.callbacks = CallbackRegistry("new_version", "step")
        self.state: Optional[TrainState] = None
        self.model: Optional[nn.Module] = None
        self._cost_cache: Dict[Any, Dict[str, Any]] = {}
        # observability (reference time()/log wrappers)
        self.last_step_ms: Optional[float] = None
        self._step_times: List[float] = []  # rolling window
        self._h_step = get_telemetry().histogram(
            "train_step_ms", mode="sync",
            help="wall time per training step/round (ms), by mode")
        from distriflow_tpu_torch.checkpoint import make_store

        self.save_every = save_every
        self.store = make_store(checkpoint_dir, max_checkpoints, sharded=sharded_checkpoints)
        self._save_queue: Optional[queue.Queue] = None
        self._save_thread: Optional[threading.Thread] = None
        self._save_errors: List[Exception] = []

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 0) -> TrainState:
        """Build the model from ``seed`` and a fresh optimizer state (on a
        mesh: this rank's blocks of the parameters, the moments sliced
        over ``data`` by the ZeRO level)."""
        with self.logger.time("model setup"):
            self.model = init_params(self.spec, seed)
            self._shard_model()
            params = named_params(self.model)
            self.state = TrainState(params=params, opt_state=self._opt_init(params), step=0,
                                    ema=self._ema_init(params))
        return self.state

    # -- the mesh ---------------------------------------------------------
    #
    # One device is the mesh of size 1: every collective over an axis of
    # size 1 (or with no mesh) returns its input, every parameter is
    # replicated and no ZeRO slice is cut, so one step path serves both.

    @torch.no_grad()
    def _shard_model(self) -> None:
        """Record each parameter's spec and ZeRO slice and, on a mesh,
        swap the model's full parameters for this rank's blocks."""
        mesh, full, flax_path = self.mesh, named_params(self.model), self.spec.flax_path
        self._specs = {n: sharding.spec_for(n, p.dim(), self.param_rules, flax_path)
                       for n, p in full.items()}
        self._full_shapes = {n: tuple(p.shape) for n, p in full.items()}
        cfg = getattr(self.model, "config", None)
        seq = mesh is not None and hasattr(cfg, "sequence_sharded") and cfg.sequence_sharded(mesh)
        self._seq_axis = "seq" if seq else None
        # the gradient sums over every axis the examples are split over
        self._red_axes = ("data", "seq") if seq else ("data",)
        self._zslices: Dict[str, Tuple[int, int, int]] = {}
        if mesh is None:
            return
        cut_blocks(self.model, full, mesh, self.param_rules, flax_path)
        dp, di = axis_size(mesh, "data"), axis_index(mesh, "data")
        for n, p in full.items():
            dim = (sharding.zero_dim(self._specs[n], tuple(p.shape), mesh, "data")
                   if self.zero_level >= 1 else None)
            if dim is not None:
                size = p.shape[dim] // dp
                self._zslices[n] = (dim, di * size, size)

    def _zview(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO slice of a local block (a view), or the block."""
        z = self._zslices.get(name)
        return t if z is None else t.narrow(*z)

    def _opt_init(self, params: Params) -> Dict[str, Any]:
        return self.optimizer.init({n: self._zview(n, p) for n, p in params.items()})

    def _ema_init(self, params: Params) -> Optional[Params]:
        if not self.ema_decay:
            return None
        if self.zero_level >= 2:  # the EMA shards like the moments
            return {n: self._zview(n, p).detach().clone() for n, p in params.items()}
        return _clone(params)

    def _unzero(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A ZeRO slice gathered over ``data`` into the local block."""
        z = self._zslices.get(name)
        return t if z is None else _all_gather(t.contiguous(), self.mesh, "data", z[0])

    def _gather(self, tree: Params, zero: bool) -> Params:
        """Parameter-shaped tensors of this rank (ZeRO slices when
        ``zero``) gathered into the full tensors (copies; every rank must
        call)."""
        blocks = {n: self._unzero(n, t) for n, t in tree.items()} if zero else tree
        return sharding.gather_params(blocks, self.mesh, self.param_rules, self.spec.flax_path)

    def _micro(self, x, y, w, rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                   Optional[torch.Tensor]]:
        """One micro-batch's forward on this rank (``rows`` of its rows):
        ``(objective, numerator, global weight sum, aux)``. The objectives'
        gradients, summed over micro-batches and reduced over the example
        axes, over the summed global weight sums, are the step's gradient.

        A model of several outputs (``ModelSpec.loss_sums``) weighs its
        micro-batch's loss, the sum of each output's weighted mean (each
        output's sums all-reduced on their own), by the micro-batch's
        weight sum, as JAX's ``grad_accum`` weighs it."""
        mesh, red = self.mesh, self._red_axes
        num, den, aux = self.spec.loss_sums(self.model, x, y, w)
        den_g = _all_reduce(den.detach(), mesh, red)
        if num.dim():
            wsum = torch.tensor(float(rows), device=num.device) if w is None else w.sum()
            wsum_g = _all_reduce(wsum, mesh, red)
            num, den_g = (num * (wsum_g / torch.clamp(den_g, min=1e-9))).sum(), wsum_g
        obj = num if aux is None else num + aux * den_g
        return obj, num, den_g, aux

    def _grads(self, x, y, w) -> Tuple[torch.Tensor, Params]:
        """The global weighted-mean loss and this rank's gradients of it
        (reduced over the example axes; ZeRO-2: this rank's slices).
        ``grad_accum`` micro-batches each weigh their weight sums, so the
        result equals one full-batch weighted-mean step. ``x`` and ``y``
        may be tuples (a model of several inputs or outputs): every leaf
        is cut on its row axis."""
        mesh, red, accum = self.mesh, self._red_axes, self.grad_accum
        params = named_params(self.model)
        live = [n for n, p in params.items() if p.requires_grad]
        n = batch_rows(x) // accum
        gsum: Params = {}
        num_tot = den_tot = extra = 0.0
        for i in range(accum):
            sl = slice(i * n, (i + 1) * n)
            obj, num, den_g, aux = self._micro(
                tree_map(lambda t: t[sl], x), tree_map(lambda t: t[sl], y),
                None if w is None else w[sl].float(), n)
            gs = torch.autograd.grad(obj, [params[k] for k in live], allow_unused=True)
            for k, g in zip(live, gs):
                if g is not None:
                    gsum[k] = g if k not in gsum else gsum[k] + g
            num_tot = num_tot + num.detach()
            den_tot = den_tot + den_g
            if aux is not None:
                extra = extra + aux.detach() * den_g
        # zeros where a parameter does not require grad (JAX's gradient of
        # a stopped leaf)
        gsum = {k: gsum[k] if k in gsum else torch.zeros_like(p) for k, p in params.items()}
        total = torch.clamp(den_tot, min=1e-9)
        loss = (_all_reduce(num_tot, mesh, red) + extra) / total
        gsum = _flat_all_reduce(gsum, mesh, red[1:])
        if self._zslices and self.zero_level >= 2:
            plain = _flat_all_reduce({k: v for k, v in gsum.items() if k not in self._zslices},
                                     mesh, ("data",))
            gsum = {k: plain[k] if k in plain else
                    _reduce_scatter(v, mesh, "data", self._zslices[k][0]) for k, v in gsum.items()}
        else:
            gsum = _flat_all_reduce(gsum, mesh, ("data",))
        return loss, {k: v / total for k, v in gsum.items()}

    @torch.no_grad()
    def _update(self, grads: Params) -> None:
        """The optimizer step on this rank's (ZeRO) slices; the updated
        slices are all-gathered back into the blocks."""
        st = self.state
        zp = {n: self._zview(n, p) for n, p in st.params.items()}
        zg = grads if self.zero_level >= 2 else {n: self._zview(n, g) for n, g in grads.items()}
        updates, st.opt_state = self.optimizer.update(zg, st.opt_state, zp)
        apply_updates(zp, updates)
        for n in self._zslices:
            st.params[n].copy_(self._unzero(n, zp[n]))
        if self.ema_decay is not None:
            d = self.ema_decay
            src = zp if self.zero_level >= 2 else st.params
            for n, e in st.ema.items():
                e.mul_(d).add_(src[n].to(e.dtype), alpha=1.0 - d)

    @property
    def device(self) -> torch.device:
        if self.model is None:
            self.init()
        return next(self.model.parameters()).device

    @property
    def version(self) -> int:
        """Host-visible model version: the number of steps taken."""
        return 0 if self.state is None else self.state.step

    # -- the step ---------------------------------------------------------

    def _one_step(self, batch: Batch) -> torch.Tensor:
        """One update in place; returns the loss tensor (not fetched)."""
        x, y, w = batch if len(batch) == 3 else (*batch, None)
        accum = self.grad_accum
        if accum > 1 and batch_rows(x) % accum:
            raise ValueError(
                f"global batch size {batch_rows(x)} not divisible by grad_accum={accum}")
        loss, grads = self._grads(x, y, w)
        self._update(grads)
        self.state.step += 1
        return loss

    def _place(self, batch: Batch) -> Batch:
        """On a mesh this rank's slice of a global batch (a batch
        ``shard_batch`` made is taken as it is; every leaf of a tuple cut
        on its row axis); else the batch on the model's device."""
        if self.mesh is None:
            return to_device(tuple(batch), self.device)
        return tuple(shard_batch(self.mesh, b, "data", self._seq_axis) for b in batch)

    def step(self, batch: Batch) -> float:
        """Run one step on ``(x, y[, weight])`` (numpy arrays or tensors);
        returns the loss as a float. The step time includes the device's
        work (the timer synchronizes)."""
        if self.state is None:
            self.init()
        batch = self._place(batch)
        with device_timer(self.device) as timing:
            loss = float(self._one_step(batch))
        self.last_step_ms = timing["ms"]
        self._h_step.observe(self.last_step_ms)
        self._step_times.append(self.last_step_ms)
        if len(self._step_times) > 100:
            del self._step_times[:-100]
        if self.save_every and self.store is not None and self.version % self.save_every == 0:
            self.save(drop_if_busy=True)
        self.callbacks.fire("step", self)
        self.callbacks.fire("new_version", str(self.state.step))
        return loss

    def step_async(self, batch: Batch) -> torch.Tensor:
        """Like :meth:`step` but returns the loss tensor without waiting
        for the device (keeps the device queue full)."""
        if self.state is None:
            self.init()
        return self._one_step(self._place(batch))

    def step_many(self, batches: Batch) -> torch.Tensor:
        """Run K chained steps in one call. ``batches`` is ``(x, y[, w])``
        with a leading step axis (``x`` is ``[K, B, ...]``). Nothing inside
        waits for the device; the returned ``[K]`` losses are not fetched,
        so the caller's fetch is the one host sync. Callbacks fire once per
        call, as in JAX."""
        if self.state is None:
            self.init()
        k = batch_rows(batches[0])
        if self.mesh is None:  # every step's batch in one copy (then placed already)
            batches = self._place(batches)
        losses = torch.stack([
            self._one_step(self._place(tuple(tree_map(lambda t: t[i], b) for b in batches)))
            for i in range(k)])
        self.callbacks.fire("step", self)
        if self.callbacks.has("new_version") or (self.save_every and self.store is not None):
            version = self.version
            if self.save_every and self.store is not None and any(
                    (version - i) % self.save_every == 0 for i in range(k)):
                self.save(drop_if_busy=True)
            self.callbacks.fire("new_version", str(version))
        return losses

    @property
    def mean_step_ms(self) -> Optional[float]:
        """Rolling mean step wall time (last 100 steps)."""
        if not self._step_times:
            return None
        return sum(self._step_times) / len(self._step_times)

    def profile(self, log_dir: str):
        """Context manager capturing a ``torch.profiler`` trace of the
        enclosed steps into ``log_dir`` (JAX: a ``jax.profiler`` trace)."""
        from distriflow_tpu_torch.utils.profiling import trace

        return trace(log_dir)

    # dense bf16 tensor-core peak per card by device name, for mfu(): the
    # public spec-sheet figures (not measurements), matched by substring of
    # the lower-cased torch.cuda.get_device_name()
    PEAK_BF16_FLOPS = {
        "h100 80gb hbm3": 989e12,  # H100 SXM
        "h100 pcie": 756e12,
    }

    def cost_analysis(self, batch: Batch) -> Dict[str, Any]:
        """The **per-device** cost of one step at ``batch``'s shapes:
        ``flops`` (the MFU numerator), ``aten_flops`` (FlopCounterMode's
        matmuls and convolutions) and the kernels' tally (``kernel_flops``,
        model FLOPs; ``kernel_hw_flops``, with recompute; bytes,
        transcendentals, ``kernel_by_category``; JAX's ``pallas_*`` keys
        alias them). On CUDA ``flops`` is the aten count plus the tally, on
        the CPU the aten count alone
        (:func:`~distriflow_tpu_torch.ops.flop_count.step_cost`).

        This rank runs the step's forward and backward of its own first
        micro-batch (no optimizer update; the model is left as it was) and
        every count is multiplied by ``grad_accum``, the micro-batches a
        step runs. On a mesh that is this rank's shard (its rows over
        ``data``, its heads over ``model``), counted at its own shapes: the
        per-device convention of JAX's count (multiply by the mesh size for
        whole-mesh totals). The forward runs the mesh's collectives, so
        every rank must call. The optimizer update and elementwise work
        are not counted (XLA's count in JAX holds them). Cached per batch
        signature (the shapes and dtypes of every leaf)."""
        from distriflow_tpu_torch.ops.flop_count import step_cost

        if self.state is None:
            self.init()
        key = tuple((tuple(t.shape), str(t.dtype)) for t in tree_leaves(batch))
        if key not in self._cost_cache:
            placed = self._place(batch)
            x, y, w = placed if len(placed) == 3 else (*placed, None)
            n = batch_rows(x) // self.grad_accum
            micro = (tree_map(lambda t: t[:n], x), tree_map(lambda t: t[:n], y),
                     None if w is None else w[:n].float(), n)
            live = [p for p in self.model.parameters() if p.requires_grad]

            def run():
                torch.autograd.grad(self._micro(*micro)[0], live, allow_unused=True)

            self._cost_cache[key] = step_cost(run, self.device, self.grad_accum)
        return self._cost_cache[key]

    def mfu(
        self,
        batch: Batch,
        step_seconds: Optional[float] = None,
        peak_flops_per_chip: Optional[float] = None,
        gauge_mode: str = "sync",
    ) -> float:
        """Model FLOPs utilization of one step: :meth:`cost_analysis`'s
        ``flops`` / (step time x the card's dense bf16 peak). On a mesh
        that is this rank's per-device count over one card's peak (JAX's
        convention), and every rank must call.

        ``step_seconds`` defaults to the rolling mean of :meth:`step` wall
        times; ``peak_flops_per_chip`` is looked up from the device name
        (:data:`PEAK_BF16_FLOPS`; an unknown card, or the CPU, raises).
        Sets the ``train_mfu{mode=gauge_mode}`` gauge."""
        if step_seconds is None:
            if self.mean_step_ms is None:
                raise ValueError("no steps timed yet; pass step_seconds=")
            step_seconds = self.mean_step_ms / 1e3
        if peak_flops_per_chip is None:
            peak_flops_per_chip = peak_bf16_flops(self.device)
        return record_mfu(self.cost_analysis(batch), step_seconds, peak_flops_per_chip,
                          gauge_mode)

    # -- checkpointing -----------------------------------------------------

    def _state_tree(self) -> Dict[str, Any]:
        st = self.state
        tree = {"params": st.params, "opt_state": st.opt_state, "step": st.step}
        if st.ema is not None:
            tree["ema"] = st.ema
        return tree

    def _full_state_tree(self) -> Dict[str, Any]:
        """:meth:`_state_tree` with every tensor gathered to its full shape
        (on a mesh; every rank must call)."""
        if self.mesh is None:
            return self._state_tree()
        st = self.state
        out = {"params": self._gather(st.params, False), "step": st.step,
               "opt_state": {k: self._gather(v, self.zero_level >= 1) if isinstance(v, dict)
                             else v for k, v in st.opt_state.items()}}
        if st.ema is not None:
            out["ema"] = self._gather(st.ema, self.zero_level >= 2)
        return out

    def _shard_state_tree(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """A full host state tree cut into this rank's blocks and slices."""
        if self.mesh is None:
            return host

        def cut(tree, zero):
            blocks = sharding.shard_params(tree, self.mesh, self.param_rules, self.spec.flax_path)
            return {n: self._zview(n, t).contiguous() if zero else t for n, t in blocks.items()}

        out = dict(host)
        out["params"] = cut(host["params"], False)
        out["opt_state"] = {k: (cut(v, self.zero_level >= 1) if isinstance(v, dict) else v)
                            for k, v in host["opt_state"].items()}
        if "ema" in host:
            out["ema"] = cut(host["ema"], self.zero_level >= 2)
        return out

    def _state_placements(self) -> Dict[str, Any]:
        """The :class:`~distriflow_tpu_torch.parallel.mesh.Placement` of each
        leaf of :meth:`_state_tree` (the sharded store's ``placements``):
        parameters by their specs, the moments (and the ZeRO-2 EMA)
        extended over ``data`` where ZeRO slices them."""
        from distriflow_tpu_torch.parallel.mesh import Placement

        st, mesh = self.state, self.mesh

        def zero(level):
            return "data" if self.zero_level >= level else None

        moments = {k: v for k, v in st.opt_state.items() if isinstance(v, dict)}
        out = {"params": {n: Placement(mesh, s) for n, s in self._specs.items()},
               "opt_state": sharding.opt_state_shardings(moments, self._specs,
                                                         self._full_shapes, mesh, zero(1))}
        if st.ema is not None:
            out["ema"] = sharding.opt_state_shardings({"ema": st.ema}, self._specs,
                                                      self._full_shapes, mesh, zero(2))["ema"]
        return out

    def _sharded_store(self) -> bool:
        from distriflow_tpu_torch.checkpoint.sharded import ShardedCheckpointStore

        return isinstance(self.store, ShardedCheckpointStore)

    def save(self, wait: bool = False, drop_if_busy: bool = False) -> Optional[str]:
        """Checkpoint the whole state (params, optimizer state, step, EMA).

        The device->host copy happens on the caller's thread; the file
        write runs on a background writer, so the loop never waits on disk.
        The queue is bounded: ``save()`` blocks for a slot, auto-saves pass
        ``drop_if_busy`` and skip instead. With ``wait`` the call blocks
        until the write lands and raises that write's own error, if any.
        A sharded save is collective: every rank saves every version (no
        rank skips one on its own queue's state)."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        if self.state is None:
            raise RuntimeError("trainer not initialized")
        version = str(self.version)
        if self._sharded_store():
            # every rank snapshots its own blocks (the writer does file I/O);
            # the save is collective, so on a mesh no rank skips a version
            drop_if_busy = drop_if_busy and self.mesh is None
            placements = self._state_placements() if self.mesh is not None else None

            def take():
                return self.store.snapshot(self._state_tree(), placements=placements)
        elif self.mesh is not None:
            # gathered on every rank (collectives), written by rank 0 alone;
            # every rank saves at every version, so none skips
            from distriflow_tpu_torch.parallel.distributed import is_coordinator

            host = host_tree(self._full_state_tree())
            if not is_coordinator():
                return version
            drop_if_busy = False

            def take():
                return host
        else:
            def take():
                return host_tree(self._state_tree())
        self._ensure_writer()
        if drop_if_busy and self._save_queue.full():
            # check BEFORE the copy: a skipped autosave must not pay for it
            self.logger.log(f"skipping checkpoint {version}: writer busy")
            return None
        item = _SaveItem(version, take())
        if drop_if_busy:
            try:
                self._save_queue.put_nowait(item)
            except queue.Full:
                self.logger.log(f"skipping checkpoint {version}: writer busy")
                return None
        else:
            self._save_queue.put(item)
        if wait:
            item.done.wait()
            if item.error is not None:
                raise item.error
        return version

    def flush_saves(self) -> None:
        """Block until every queued checkpoint write has landed; raises the
        most recent failure since the last flush (then clears it)."""
        if self._save_queue is not None:
            self._save_queue.join()
        if self._save_errors:
            # clear in place: the writer closure holds this exact list
            errors = list(self._save_errors)
            self._save_errors.clear()
            raise errors[-1]

    def close(self) -> None:
        """Stop the checkpoint writer thread (flushes queued saves first)."""
        if self._save_thread is not None and self._save_thread.is_alive():
            self._save_queue.put(None)
            self._save_thread.join(timeout=30)
        self._save_thread = None

    def restore(self, version: Optional[str] = None) -> bool:
        """Resume from a checkpoint (latest by default) into the live state,
        in place. Returns False when the store is empty."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        if self.state is None:
            self.init()
        version = version or self.store.last()
        if version is None:
            return False
        sharded = self._sharded_store()
        # the sharded store reads this rank's blocks; the plain one the
        # full tree, cut here
        like = self._state_tree() if sharded else self._full_state_tree()
        kw = {"placements": self._state_placements()} if sharded and self.mesh is not None else {}
        want_ema = "ema" in like
        try:
            host = self.store.load(version, like, **kw)
        except KeyError:
            if not want_ema:
                raise
            # checkpoint predates EMA being enabled: seed it from the params
            like.pop("ema")
            host = self.store.load(version, like, **kw)
        if not sharded:
            host = self._shard_state_tree(host)
        st = self.state
        _assign(st.params, host["params"])
        st.opt_state = _assign(st.opt_state, host["opt_state"])
        st.step = int(host["step"])
        if want_ema:
            st.ema = _assign(st.ema, host["ema"]) if "ema" in host else self._ema_init(st.params)
        return True

    def _ensure_writer(self) -> None:
        if self._save_thread is not None and self._save_thread.is_alive():
            return
        # pending items are full host state snapshots: keep the queue tiny
        self._save_queue = queue.Queue(maxsize=2)
        # the closure captures only what the writer needs — not self
        q, store, errors, logger = self._save_queue, self.store, self._save_errors, self.logger

        def writer():
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    try:
                        store.save(item.host_state, version=item.version)
                    except Exception as e:  # surface on save(wait)/flush
                        item.error = e
                        errors.append(e)
                        logger.log(f"checkpoint save failed: {e!r}")
                    item.host_state = None  # release the snapshot promptly
                    item.done.set()
                finally:
                    q.task_done()

        self._save_thread = threading.Thread(target=writer, daemon=True)
        self._save_thread.start()

    # -- evaluation -------------------------------------------------------

    @contextlib.contextmanager
    def _weights(self, params: Params) -> Iterator[None]:
        """Run the model with ``params`` copied in, then put its own back."""
        own = self.state.params
        saved = _clone(own)
        _assign(own, params)
        try:
            yield
        finally:
            _assign(own, saved)

    @torch.no_grad()
    def evaluate(self, x, y, metrics: Tuple[str, ...] = ("loss", "accuracy"),
                 use_ema: bool = False, weight=None) -> List[float]:
        """Example-mean metrics of the (global) batch; ``weight`` (per
        row, 0 for padding) makes padded partial batches exact. Each
        rank's weighted sums are all-reduced over the example axes;
        vocab-parallel logits take the vocab-parallel CE and argmax."""
        from distriflow_tpu_torch.models import losses as losses_lib

        if self.state is None:
            self.init()
        if use_ema and self.state.ema is None:
            raise RuntimeError("no EMA state; construct with ema_decay=")
        ema = self.state.ema
        if use_ema and self.zero_level >= 2:
            ema = {n: self._unzero(n, e) for n, e in ema.items()}
        x, y, w = self._place((x, y, weight))
        model = self.model
        vp = getattr(model, "vocab_parallel", False)
        out = []
        with self._weights(ema) if use_ema else contextlib.nullcontext():
            preds = self.spec.apply(model, x)
            if isinstance(preds, (tuple, list)):  # JAX's evaluate raises there too
                raise ValueError(f"evaluate takes a model of one output; this one has "
                                 f"{len(preds)}")
            for m in metrics:
                if m == "loss":
                    per = self.spec._per_example(model)(preds, y)
                elif m == "accuracy":
                    labels = y if y.dim() == preds.dim() - 1 else y.argmax(-1)
                    guess = (losses_lib.vocab_parallel_argmax(preds, model.mesh) if vp
                             else preds.argmax(-1))
                    per = (guess == labels).float()
                else:
                    losses_lib.get_metric(m)  # raises: an unknown metric
                    raise NotImplementedError(f"metric {m!r} has no per-example form")
                if w is None:
                    num, den = per.sum(), torch.tensor(float(per.numel()), device=per.device)
                else:
                    wb = w.float().reshape(w.shape + (1,) * (per.dim() - w.dim()))
                    wb = torch.broadcast_to(wb, per.shape)
                    num, den = (per * wb).sum(), wb.sum()
                sums = _all_reduce(torch.stack([num.float(), den.float()]), self.mesh,
                                   self._red_axes)
                out.append(float(sums[0] / torch.clamp(sums[1], min=1e-9)))
        return out

    def get_params(self) -> Params:
        """A detached copy of every parameter by name (on a mesh the full
        tensors; every rank must call)."""
        if self.state is None:
            raise RuntimeError("trainer not initialized; call init() first")
        return self._gather(self.state.params, False)

    @property
    def ema_params(self) -> Params:
        """A copy of the EMA weights (requires ``ema_decay``)."""
        if self.state is None or self.state.ema is None:
            raise RuntimeError("no EMA state; construct with ema_decay=")
        return self._gather(self.state.ema, self.zero_level >= 2)

    def set_params(self, params: Params) -> None:
        """Install ``params`` (by name; numpy arrays or tensors; on a mesh
        the full tensors, every rank the same), rebuild the optimizer state
        and restart the EMA at them, as JAX does; the step counter is
        kept."""
        if self.state is None:
            self.init()
        st = self.state
        missing = set(st.params) - set(params)
        if missing:
            raise KeyError(f"params missing {sorted(missing)}")
        # the full tensors, cut into this rank's blocks
        given = {n: torch.as_tensor(params[n]) for n in st.params}
        _assign(st.params, sharding.shard_params(given, self.mesh, self.param_rules,
                                                 self.spec.flax_path))
        st.opt_state = self._opt_init(st.params)
        st.ema = self._ema_init(st.params)
