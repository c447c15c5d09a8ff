"""Port of ``distriflow_tpu/train/sync.py``: the synchronous trainer, on one
device.

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

Not ported yet: device meshes (``mesh``, non-default ``param_rules``),
ZeRO (``zero_level > 0``, ``zero_optimizer_sharding``), sharded
checkpoints, and ``cost_analysis``/``mfu`` (they need the FLOP tally of
``ops/flop_count.py`` and an H100 roofline). Each raises
``NotImplementedError``.
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
    init_params,
    named_params,
    to_device,
)
from distriflow_tpu_torch.obs.telemetry import get_telemetry
from distriflow_tpu_torch.utils.logging import CallbackRegistry, VerboseLogger
from distriflow_tpu_torch.utils.profiling import device_timer
from distriflow_tpu_torch.utils.serialization import host_tree

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


class SyncTrainer:
    """Synchronous trainer over one device (the device of the model that
    ``spec.init`` builds: CUDA for ``transformer_lm`` by default).

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
        if mesh is not None or param_rules is not None:
            raise NotImplementedError(
                "SyncTrainer: device meshes and sharding rules are not ported yet; "
                "the port trains on one device")
        if zero_level is None:
            zero_level = 1 if zero_optimizer_sharding else 0
        if zero_level not in (0, 1, 2):
            raise ValueError(f"zero_level must be 0, 1 or 2, got {zero_level}")
        if zero_level:
            raise NotImplementedError(f"SyncTrainer: ZeRO level {zero_level} is not ported yet")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if ema_decay is not None and not (0.0 < ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.spec = spec
        self.optimizer = _optimizer(optimizer, learning_rate)
        self.grad_accum = grad_accum
        self.ema_decay = ema_decay
        del donate  # the JAX name: updates here are in place, nothing to donate
        self.logger = VerboseLogger(f"SyncTrainer[{spec.name}]", verbose)
        self.callbacks = CallbackRegistry("new_version", "step")
        self.state: Optional[TrainState] = None
        self.model: Optional[nn.Module] = None
        self._grad = spec.grad_fn()
        self._eval_fns: Dict[Tuple[str, ...], Any] = {}
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
        """Build the model from ``seed`` and a fresh optimizer state."""
        with self.logger.time("model setup"):
            self.model = init_params(self.spec, seed)
            params = named_params(self.model)
            ema = _clone(params) if self.ema_decay else None
            self.state = TrainState(params=params, opt_state=self.optimizer.init(params),
                                    step=0, ema=ema)
        return self.state

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
        if accum > 1 and x.shape[0] % accum:
            raise ValueError(
                f"global batch size {x.shape[0]} not divisible by grad_accum={accum}")
        if accum > 1:
            # weight each micro-gradient by its weight sum so the result
            # equals one big weighted-mean step
            n = x.shape[0] // accum
            gsum: Optional[Params] = None
            lsum = wtot = 0.0
            for i in range(accum):
                sl = slice(i * n, (i + 1) * n)
                mw = None if w is None else w[sl]
                l, g = self._grad(self.model, x[sl], y[sl], mw)
                wsum = torch.tensor(float(n), device=l.device) if mw is None else mw.float().sum()
                gsum = ({k: wsum * v for k, v in g.items()} if gsum is None
                        else {k: gsum[k] + wsum * v for k, v in g.items()})
                lsum, wtot = lsum + wsum * l, wtot + wsum
            grads = {k: v / wtot for k, v in gsum.items()}
            loss = lsum / wtot
        else:
            loss, grads = self._grad(self.model, x, y, w)
        st = self.state
        updates, st.opt_state = self.optimizer.update(grads, st.opt_state, st.params)
        apply_updates(st.params, updates)
        if self.ema_decay is not None:
            d = self.ema_decay
            with torch.no_grad():
                for n, e in st.ema.items():
                    e.mul_(d).add_(st.params[n].to(e.dtype), alpha=1.0 - d)
        st.step += 1
        return loss

    def _place(self, batch: Batch) -> Batch:
        return to_device(tuple(batch), self.device)

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
        batches = self._place(batches)
        k = batches[0].shape[0]
        losses = torch.stack([self._one_step(tuple(b[i] for b in batches)) for i in range(k)])
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

    def cost_analysis(self, batch: Batch) -> Dict[str, float]:
        raise NotImplementedError(
            "cost_analysis is not ported yet: it needs ops/flop_count.py and an H100 roofline")

    def mfu(self, batch: Batch, *args: Any, **kw: Any) -> float:
        raise NotImplementedError(
            "mfu is not ported yet: it needs ops/flop_count.py and an H100 roofline")

    # -- checkpointing -----------------------------------------------------

    def _state_tree(self) -> Dict[str, Any]:
        st = self.state
        tree = {"params": st.params, "opt_state": st.opt_state, "step": st.step}
        if st.ema is not None:
            tree["ema"] = st.ema
        return tree

    def save(self, wait: bool = False, drop_if_busy: bool = False) -> Optional[str]:
        """Checkpoint the whole state (params, optimizer state, step, EMA).

        The device->host copy happens on the caller's thread; the file
        write runs on a background writer, so the loop never waits on disk.
        The queue is bounded: ``save()`` blocks for a slot, auto-saves pass
        ``drop_if_busy`` and skip instead. With ``wait`` the call blocks
        until the write lands and raises that write's own error, if any."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        if self.state is None:
            raise RuntimeError("trainer not initialized")
        version = str(self.version)
        self._ensure_writer()
        if drop_if_busy and self._save_queue.full():
            # check BEFORE the copy: a skipped autosave must not pay for it
            self.logger.log(f"skipping checkpoint {version}: writer busy")
            return None
        item = _SaveItem(version, host_tree(self._state_tree()))
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
        like = self._state_tree()
        want_ema = "ema" in like
        try:
            host = self.store.load(version, like)
        except KeyError:
            if not want_ema:
                raise
            # checkpoint predates EMA being enabled: seed it from the params
            like.pop("ema")
            host = self.store.load(version, like)
        st = self.state
        _assign(st.params, host["params"])
        st.opt_state = _assign(st.opt_state, host["opt_state"])
        st.step = int(host["step"])
        if want_ema:
            st.ema = _assign(st.ema, host["ema"]) if "ema" in host else _clone(st.params)
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

    def evaluate(self, x, y, metrics: Tuple[str, ...] = ("loss", "accuracy"),
                 use_ema: bool = False, weight=None) -> List[float]:
        """Example-mean metrics on one batch; ``weight`` (per row, 0 for
        padding) makes padded partial batches exact."""
        if self.state is None:
            self.init()
        key = tuple(metrics)
        if key not in self._eval_fns:
            self._eval_fns[key] = self.spec.metrics_fn(list(key))
        fn = self._eval_fns[key]
        if use_ema and self.state.ema is None:
            raise RuntimeError("no EMA state; construct with ema_decay=")
        x, y, w = to_device((x, y, weight), self.device)
        with self._weights(self.state.ema) if use_ema else contextlib.nullcontext():
            return [float(v) for v in fn(self.model, x, y, None if w is None else w.float())]

    def get_params(self) -> Params:
        """A detached copy of every parameter by name."""
        if self.state is None:
            raise RuntimeError("trainer not initialized; call init() first")
        return _clone(self.state.params)

    @property
    def ema_params(self) -> Params:
        """A copy of the EMA weights (requires ``ema_decay``)."""
        if self.state is None or self.state.ema is None:
            raise RuntimeError("no EMA state; construct with ema_decay=")
        return _clone(self.state.ema)

    def set_params(self, params: Params) -> None:
        """Install ``params`` (by name; numpy arrays or tensors), rebuild the
        optimizer state and restart the EMA at them, as JAX does; the step
        counter is kept."""
        if self.state is None:
            self.init()
        st = self.state
        missing = set(st.params) - set(params)
        if missing:
            raise KeyError(f"params missing {sorted(missing)}")
        _assign(st.params, {n: torch.as_tensor(params[n]) for n in st.params})
        st.opt_state = self.optimizer.init(st.params)
        st.ema = _clone(st.params) if self.ema_decay else None
