"""Port of ``distriflow_tpu/train/async_sgd.py``: asynchronous SGD with
bounded staleness over N in-process workers.

Behaviour is the JAX trainer's: version-tagged gradients, rejection past
``maximum_staleness`` and ``staleness_decay ** staleness`` scaling, SSP
admission (a window semaphore plus FIFO submit tickets), K batches an
upload (``steps_per_upload``, the mean of K gradients at one snapshot, a
ragged tail taking the per-batch path), a device-resident dataset
(``stage_dataset``), the double-buffered upload pipe (``inflight_window``),
``phase_ms`` with ``drain``, the ``trainer`` profiler, trace rows, the
staleness/applied/rejected metrics, checkpoints and ``evaluate``.

PyTorch idiom inside:

- **A snapshot stays its version.** JAX arrays are immutable, so
  ``snapshot()`` hands out references. Here the server's params are a
  ``{name: tensor}`` dict that no one writes in place: an apply computes
  new tensors (``p + update``) and rebinds the dict under the lock, so a
  dict a worker holds keeps its values. The optimizer state is updated in
  place under the lock; a checkpoint copies it there before writing.
- **Workers are threads on the devices' default streams.** Each worker
  index owns a model (built once by ``spec.init``) and copies the
  snapshot into it: the JAX ``device_put`` of the weights, the
  ``snapshot`` phase. Workers map to ``devices[i % len(devices)]``, which
  defaults to the device ``spec.init`` builds on (CUDA unless the spec
  says ``device="cpu"``), so on one card they all share it.
- **The K-batch mean** is ``(g1 + ... + gK) / K``, the same bits as
  JAX's scan from a zero carry (``0 + g1 == g1`` exactly) and its
  per-batch path alike.
- ``profile_phases`` synchronizes the worker's CUDA device at each phase
  boundary where JAX blocks on the phase's arrays; ``train`` synchronizes
  the server's device where JAX fetches a value (the ``drain`` phase).

The JAX module's description follows.

Re-design of the reference's async mode (``src/server/asynchronousSGD_server.ts``
+ ``asynchronousSGD_client.ts``): the server hands out batches
first-come-first-serve, every worker computes gradients against the weights
it last saw, and the server applies each incoming gradient immediately and
broadcasts new weights. The reference applies with **no staleness check at
all** (``asynchronousSGD_server.ts:95-108``) despite its README promising a
``maximumStaleness`` knob (``README.md:27``) — here bounded staleness is
implemented for real:

- every gradient is tagged with the model version it was computed against;
- staleness = current_version - gradient_version;
- staleness > ``maximum_staleness``  ->  the gradient is REJECTED (dropped);
- otherwise it is applied scaled by ``staleness_decay ** staleness``
  (decay 1.0 = reference-style raw apply).

Double-buffered upload pipeline (``inflight_window`` > 1): each worker
hands its fitted gradient to a dedicated per-worker comm thread (FIFO:
ticket order is preserved, so SSP admission semantics are unchanged) and
immediately prefetches/stages/fits the next group; up to ``W - 1`` uploads
ride the comm thread concurrently. The window is capped at
``maximum_staleness + 1`` so the pipeline can never push effective
staleness past the bound the admission window already enforces. Comm-thread
time books into the same ``phase_ms``/profiler digests via
``record_overlap`` — it lands in the overlap digest, not any step's busy
sum, so ``busy - overlap + idle == wall`` still holds per worker step and
nothing is double-counted. ``inflight_window=1`` (default) is the serial
path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from distriflow_tpu_torch.checkpoint import make_store
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.models.base import (
    ModelSpec,
    Params,
    _optimizer,
    check_params,
    load_params,
    named_params,
    to_device,
)
from distriflow_tpu_torch.obs.telemetry import get_telemetry
from distriflow_tpu_torch.obs.tracing import new_trace_id
from distriflow_tpu_torch.utils.config import ServerHyperparams, async_server_hyperparams
from distriflow_tpu_torch.utils.device import resolve_device
from distriflow_tpu_torch.utils.logging import CallbackRegistry, VerboseLogger
from distriflow_tpu_torch.utils.serialization import copy_tree, host_tree, tree_map


def mean_grads(grad, model: nn.Module, batches: List[Tuple[torch.Tensor, torch.Tensor]]) -> Params:
    """The mean of ``grad(model, x, y)``'s gradients over ``batches``:
    ``g1 + ... + gK`` in batch order, then divided by K. This equals JAX's
    scan (``zeros + g1 + ... + gK``, then / K) bit for bit, since
    ``0 + g1 == g1`` exactly."""
    acc: Optional[Params] = None
    for x, y in batches:
        _, g = grad(model, x, y)
        acc = g if acc is None else {n: acc[n] + g[n] for n in acc}
    return {n: v / len(batches) for n, v in acc.items()}


class _UploadPipe:
    """Per-worker comm pipeline: the double-buffered upload window.

    The worker hands each fitted gradient group off and immediately starts
    the next round's take/stage/fit; this dedicated comm thread carries the
    FIFO wait -> submit -> batch-ack tail. Depth is bounded by a slot
    semaphore (``window - 1`` handoffs in flight beyond the round being
    fitted), so per-worker memory stays within ~window gradient trees and
    the SSP admission semaphore remains the staleness authority.

    One comm thread PER worker (not one shared) is load-bearing: submit
    order is a global FIFO over tickets, and a shared thread could dequeue
    ticket N+1 before ticket N was even enqueued and park forever in
    ``_await_turn`` — per-worker threads each block only on tickets that
    are already owned downstream, so the smallest open ticket always makes
    progress.

    A failed submit requeues its batches (another worker redoes them),
    retires its ticket so later submits don't stall, and parks the error
    for the worker to re-raise at the next handoff or at drain.
    """

    _SENTINEL = object()

    def __init__(self, trainer: "AsyncSGDTrainer", worker_index: int, window: int):
        self._tr = trainer
        self._worker = worker_index
        self._slots = threading.Semaphore(max(1, window - 1))
        self._q: "queue.Queue[Any]" = queue.Queue()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"async-sgd-comm-{worker_index}", daemon=True)
        self._thread.start()

    def acquire_slot(self) -> None:
        """Block until the window has room for one more in-flight upload."""
        self._slots.acquire()

    def put(self, ticket: Optional[int], grads: Params, version: int,
            group: List[Tuple[Any, ...]], tid: Optional[str]) -> None:
        """Hand one fitted group to the comm thread (slot already held)."""
        self._q.put((ticket, grads, version, group, tid))

    def check(self) -> None:
        """Re-raise (once) any error the comm thread parked."""
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def close(self) -> None:
        """Drain the window: process everything queued, join, re-raise."""
        self._q.put(self._SENTINEL)
        self._thread.join()
        self.check()

    def _run(self) -> None:
        tr = self._tr
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            ticket, grads, version, group, tid = item
            try:
                t0 = time.perf_counter()
                try:
                    if ticket is not None:
                        tr._await_turn(ticket)
                        t0 = tr._phase_overlap("admission_wait", t0, tid)
                    tr.submit(grads, version, client_id=f"worker-{self._worker}")
                    if tr.profile_phases:
                        tr._sync(tr.devices[0])
                    tr._phase_overlap("submit", t0, tid)
                except BaseException:
                    for b, *_rest in group:
                        tr.dataset.requeue(b.batch)
                    raise
                finally:
                    if ticket is not None:
                        tr._close_span(ticket)
                # ack regardless of staleness-acceptance: the batches were
                # consumed (same contract as the serial path)
                for b, *_rest in group:
                    tr.dataset.complete_batch(b.batch)
            except BaseException as e:  # parked for the worker to re-raise
                if self.error is None:
                    self.error = e
            finally:
                self._slots.release()


class AsyncSGDTrainer:
    """Host-coordinated async SGD over N in-process workers."""

    def __init__(
        self,
        spec: ModelSpec,
        dataset: DistributedDataset,
        devices: Optional[Sequence[Any]] = None,
        learning_rate: Optional[Any] = None,  # None -> 0.001 (reference default)
        optimizer: str = "sgd",
        hyperparams: Optional[Dict[str, Any] | ServerHyperparams] = None,
        verbose: Optional[bool] = None,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 0,  # applied updates between auto-saves
        max_checkpoints: Optional[int] = None,
        steps_per_upload: int = 1,
        admission_control: bool = True,
        profile_phases: bool = False,
        stage_dataset: bool = False,
        inflight_window: int = 1,
    ):
        spec.check_loss()
        self.spec = spec
        self.dataset = dataset
        self.save_every = save_every
        self.store = make_store(checkpoint_dir, max_checkpoints)
        self.devices = [resolve_device(d) for d in devices] if devices is not None \
            else [resolve_device(spec.device)]
        if isinstance(hyperparams, ServerHyperparams):
            # a ready-made dataclass is fully explicit — honor it verbatim
            self.hyperparams = hyperparams.validate()
        else:
            self.hyperparams = async_server_hyperparams(hyperparams)
        self.optimizer = _optimizer(optimizer, learning_rate)
        self.logger = VerboseLogger(f"AsyncSGD[{spec.name}]", verbose)
        self.callbacks = CallbackRegistry("new_version", "upload")

        self.params: Optional[Params] = None  # guarded-by: _lock (rebound, never written)
        self._opt_state = None  # guarded-by: _lock
        self.version = 0  # guarded-by: _lock
        self.applied_updates = 0  # guarded-by: _lock
        self.rejected_updates = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        _t = get_telemetry()
        self._h_staleness = _t.histogram(
            "train_gradient_staleness", mode="async",
            help="versions behind HEAD per applied gradient")
        self._c_applied = _t.counter(
            "train_updates_applied_total", mode="async",
            help="gradient updates applied to the model")
        self._c_rejected = _t.counter(
            "train_updates_rejected_total", mode="async",
            help="gradient updates rejected (stale beyond the bound)")
        # continuous phase profiler: _phase() feeds the same dt into rolling
        # digests, and worker_loop bounds each pull->fit->submit span with
        # a step() so wall-vs-busy yields the overlap/idle attribution
        self._prof = _t.profiler("trainer")
        self._tracer = _t.tracer
        # per-worker-thread round context: (trace_id, root span_id) while a
        # worker_loop round is open, so _phase() emits trace rows from the
        # SAME dt it books into phase_ms
        self._round_tls = threading.local()

        # SSP-style admission control: (1) a window semaphore — at most
        # ``maximum_staleness + 1`` snapshot-to-submit spans in flight; (2)
        # FIFO submit order — an admitted worker submits in snapshot order
        # (ticket queue), so a fast worker cannot overtake a slow one. At
        # most ``maximum_staleness`` other applies land inside any admitted
        # span, so no gradient ages past the bound while it is computed;
        # the rejection path stays live for grads submitted outside the
        # gate (admission_control=False, or a manual submit).
        self.admission_control = bool(admission_control)
        stale_window = int(self.hyperparams.maximum_staleness) + 1
        self._admission = threading.BoundedSemaphore(stale_window)
        self._ticket_head = 0  # next ticket to issue (at snapshot)  # guarded-by: _lock
        self._ticket_tail = 0  # next ticket allowed to submit  # guarded-by: _ticket_cv
        self._aborted_tickets: set = set()  # guarded-by: _ticket_cv
        self._ticket_cv = threading.Condition()

        # per-phase wall-clock accounting; profile_phases=True adds device
        # synchronizations at each boundary so the attribution is device
        # time, not dispatch time (a profiling pass, not the timed run).
        # "drain" is the device queue's tail, waited for at the end of
        # train(): the workers' clocks see dispatch time only.
        self.profile_phases = bool(profile_phases)
        self.phase_ms = {"stage": 0.0, "snapshot": 0.0, "fit": 0.0,  # guarded-by: _phase_lock
                         "submit": 0.0, "admission_wait": 0.0,
                         "pipeline_wait": 0.0, "drain": 0.0}
        self._phase_lock = threading.Lock()

        self.inflight_window = int(inflight_window)
        if self.inflight_window < 1:
            raise ValueError(f"inflight_window must be >= 1, got {inflight_window}")

        # device-resident dataset: with ``stage_dataset=True`` the full x/y
        # arrays go to each worker's device ONCE (``pre_stage``/first take)
        # and every batch is a slice of them; incompatible with host
        # preprocess callbacks (checked at take time)
        self.stage_dataset = bool(stage_dataset)
        self._staged_data: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}  # guarded-by: _build_lock
        self._models: Dict[Any, nn.Module] = {}  # guarded-by: _build_lock
        self._build_lock = threading.Lock()
        self._eval_lock = threading.Lock()
        self._cost_cache: Dict[int, Dict[str, Any]] = {}
        self._live_workers = 0  # guarded-by: _phase_lock

        # K batches an upload: a worker takes K consecutive batches,
        # computes all K gradients at ONE snapshot and uploads their mean
        # (the gradient of the K-batch super-batch for equal batch sizes):
        # one version-tagged gradient per upload
        self.steps_per_upload = int(steps_per_upload)
        if self.steps_per_upload < 1:
            raise ValueError(f"steps_per_upload must be >= 1, got {steps_per_upload}")
        self._grad = spec.grad_fn()

    # -- device plumbing ---------------------------------------------------

    @staticmethod
    def _sync(device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _model_for(self, key: Any, device: torch.device) -> nn.Module:
        """The model a worker (or ``evaluate``/``cost_analysis``) computes
        with: one per key, built once; its weights are copied in before
        every use."""
        with self._build_lock:
            model = self._models.get(key)
            if model is None:
                model = self._models[key] = self.spec.init(0).to(device)
            return model

    def pre_stage(self, device=None) -> None:
        """Transfer the dataset wholesale to ``device`` (default: every
        trainer device) ahead of training, so the first uploads don't pay
        the one-time staging transfer inside the measured path."""
        targets = [resolve_device(device)] if device is not None else self.devices
        for d in targets:
            self._device_dataset(d)

    def _device_dataset(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._build_lock:  # one dataset-sized transfer per device
            pair = self._staged_data.get(device)
            if pair is None:
                pair = self._staged_data[device] = to_device(
                    (self.dataset.x, self.dataset.y), device)
            return pair

    # -- SSP admission -----------------------------------------------------

    def _admit(self) -> Tuple[int, Params, int]:
        """Open an SSP span: window slot + ticket + snapshot, atomically
        (ticket order == snapshot order, which makes the bound airtight)."""
        self._admission.acquire()
        with self._lock:
            ticket = self._ticket_head
            self._ticket_head += 1
            return ticket, self.params, self.version

    def _await_turn(self, ticket: int) -> None:
        with self._ticket_cv:
            while self._ticket_tail != ticket:
                self._ticket_cv.wait()

    def _close_span(self, ticket: int) -> None:
        """Retire ``ticket`` (normal completion or crash — a dead worker
        must not stall every later submit) and free its window slot. A span
        that dies before its turn parks in ``_aborted_tickets``; the queue
        skips parked tickets when the tail reaches them."""
        with self._ticket_cv:
            if self._ticket_tail == ticket:
                self._ticket_tail += 1
                while self._ticket_tail in self._aborted_tickets:
                    self._aborted_tickets.discard(self._ticket_tail)
                    self._ticket_tail += 1
            else:
                self._aborted_tickets.add(ticket)
            self._ticket_cv.notify_all()
        self._admission.release()

    # -- phase accounting ----------------------------------------------------

    def _phase(self, name: str, t0: float, device: Optional[torch.device] = None) -> float:
        """Accumulate ``time.perf_counter() - t0`` into ``phase_ms[name]``;
        with profile_phases, synchronize ``device`` first so the wall time
        is device time, not dispatch time. Returns a fresh t0."""
        if self.profile_phases and device is not None:
            self._sync(device)
        dt = (time.perf_counter() - t0) * 1e3
        with self._phase_lock:
            self.phase_ms[name] += dt
        self._prof.record(name, dt)
        ctx = getattr(self._round_tls, "ctx", None)
        if ctx is not None:
            # child span of the open round, anchored at the phase's begin
            self._tracer.emit(
                name, trace_id=ctx[0], parent_id=ctx[1], dur_ms=dt,
                start=time.time() - dt / 1e3, mono=time.monotonic() - dt / 1e3)
        return time.perf_counter()

    def _effective_window(self) -> int:
        """``inflight_window`` clamped at the SSP admission window
        (``maximum_staleness + 1``): the pipeline never pushes effective
        staleness past the bound."""
        w = self.inflight_window
        if self.admission_control:
            w = min(w, int(self.hyperparams.maximum_staleness) + 1)
        return max(1, w)

    def _phase_overlap(self, name: str, t0: float, tid: Optional[str]) -> float:
        """Comm-thread sibling of :meth:`_phase`: books into ``phase_ms`` and
        the phase digest but credits the OVERLAP digest, and stamps the
        trace child ``overlap=True``. Returns a fresh t0."""
        dt = (time.perf_counter() - t0) * 1e3
        with self._phase_lock:
            self.phase_ms[name] += dt
        self._prof.record_overlap(name, dt)
        if tid is not None:
            self._tracer.emit(
                name, trace_id=tid, parent_id=None, dur_ms=dt,
                start=time.time() - dt / 1e3, mono=time.monotonic() - dt / 1e3, overlap=True)
        return time.perf_counter()

    # -- lifecycle ---------------------------------------------------------

    def init(self, seed: int = 0) -> Params:
        """Build the model from ``seed`` (JAX: a PRNG key) on the server's
        device and a fresh optimizer state."""
        model = self.spec.init(seed)
        with self._lock:
            self.params = {n: p.detach().to(self.devices[0]).clone()
                           for n, p in named_params(model).items()}
            self._opt_state = self.optimizer.init(self.params)
            return self.params

    def set_params(self, params: Params) -> None:
        """Install ``params`` (by name; numpy arrays or tensors) and a fresh
        optimizer state; the version is kept (the port's way to start from
        carried-over weights, as ``SyncTrainer.set_params``)."""
        with self._lock:
            uninitialized = self.params is None
        if uninitialized:  # init() locks itself
            self.init()
        with self._lock:
            own = self.params
            check_params(own, params)
            self.params = {n: torch.as_tensor(params[n]).to(p.device, p.dtype).clone()
                           for n, p in own.items()}
            self._opt_state = self.optimizer.init(self.params)

    # -- server side -------------------------------------------------------

    def snapshot(self) -> Tuple[Params, int]:
        """Current (params, version) — what a worker 'downloads'. The dict
        is never written: a later apply rebinds a new one."""
        with self._lock:
            return self.params, self.version

    def _write_checkpoint(self, params, opt_state, version: int) -> str:
        """Write a captured snapshot (call WITHOUT the lock)."""
        return self.store.save(
            {"params": host_tree(params), "opt_state": host_tree(opt_state),
             "version": version},
            version=str(version))

    def save(self) -> str:
        """Checkpoint params + optimizer state + version (synchronous)."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        with self._lock:  # the optimizer state is updated in place: copy it here
            if self.params is None:
                raise RuntimeError("trainer not initialized")
            snap = (self.params, copy_tree(self._opt_state), self.version)
        return self._write_checkpoint(*snap)

    def restore(self, version: Optional[str] = None) -> bool:
        """Resume from the latest (or named) version. False when empty."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        # lifecycle: restore() runs before workers start; init() locks itself
        if self.params is None:  # dfcheck: ignore[lock-discipline]
            self.init()
        version = version or self.store.last()
        if version is None:
            return False
        with self._lock:
            like = {"params": self.params, "opt_state": self._opt_state, "version": 0}
            host = self.store.load(version, like)
            dev = self.devices[0]
            self.params = {n: torch.as_tensor(v).to(dev) for n, v in host["params"].items()}
            self._opt_state = _on_device(host["opt_state"], dev)
            self.version = int(host["version"])
        return True

    def submit(self, grads: Params, grad_version: int, client_id: str = "?") -> bool:
        """Apply one gradient update; returns False if rejected as too stale.

        The reference applies unconditionally (``asynchronousSGD_server.ts:73``);
        this is the README-promised bounded-staleness version."""
        with self._lock:
            staleness = self.version - grad_version
            if staleness < 0:
                raise ValueError(f"gradient from the future: v{grad_version} > v{self.version}")
            self._h_staleness.observe(staleness)
            if staleness > self.hyperparams.maximum_staleness:
                self.rejected_updates += 1
                self._c_rejected.inc()
                self.logger.log(
                    f"rejected update from {client_id}: staleness {staleness} > "
                    f"{self.hyperparams.maximum_staleness}")
                return False
            scale = self.hyperparams.staleness_decay ** staleness
            dev = self.devices[0]
            # the 'upload': worker device -> server device, then the scale
            scaled = {n: torch.as_tensor(grads[n]).to(dev) * scale for n in self.params}
            updates, self._opt_state = self.optimizer.update(scaled, self._opt_state, self.params)
            # new tensors, never in place: snapshots handed out stay valid
            self.params = {n: p + updates[n].to(p.dtype) for n, p in self.params.items()}
            self.version += 1
            self.applied_updates += 1
            self._c_applied.inc()
            new_version = self.version
            snap = None
            if (self.store is not None and self.save_every
                    and self.version % self.save_every == 0):
                snap = (self.params, copy_tree(self._opt_state), self.version)
        if snap is not None:
            try:
                self._write_checkpoint(*snap)
            except Exception as e:
                # the update IS applied: a persistence failure here must not
                # bubble into worker_loop's requeue (that would double-apply
                # the batch). Log; the next save boundary retries.
                self.logger.log(f"auto-checkpoint failed: {e!r}")
        self.callbacks.fire("upload", client_id, grad_version)
        self.callbacks.fire("new_version", str(new_version))
        return True

    # -- worker side -------------------------------------------------------

    def worker_loop(self, worker_index: int, max_steps: Optional[int] = None) -> int:
        """One worker: pull weights, pull batches, compute grads on its own
        device, push grads. Returns the number of batches processed.

        This is the DistriWorker role (reference ``asynchronousSGD_client.ts``
        ping-pong loop) without the wire: ``snapshot`` is the Download,
        ``submit`` is the Upload. With ``inflight_window > 1`` the submit
        tail rides a per-worker comm thread (:class:`_UploadPipe`), drained
        before this returns; any comm-thread error re-raises here."""
        device = self.devices[worker_index % len(self.devices)]
        window = self._effective_window()
        with self._phase_lock:
            self._live_workers += 1
        try:
            pipe = _UploadPipe(self, worker_index, window) if window > 1 else None
            try:
                steps = self._worker_rounds(worker_index, device, pipe, max_steps)
            except BaseException:
                if pipe is not None:
                    try:
                        pipe.close()
                    except BaseException:  # noqa: BLE001 - the original error is the one to surface
                        pass
                raise
            if pipe is not None:
                # drain-on-stop: the wait is window serialization, so it books
                # as pipeline_wait (drain stays the device drain)
                t0 = time.perf_counter()
                pipe.close()
                with self._phase_lock:
                    self.phase_ms["pipeline_wait"] += (time.perf_counter() - t0) * 1e3
            return steps
        finally:
            with self._phase_lock:
                self._live_workers -= 1

    def _worker_rounds(self, worker_index: int, device: torch.device,
                       pipe: Optional[_UploadPipe], max_steps: Optional[int]) -> int:
        steps = 0
        while max_steps is None or steps < max_steps:
            budget = self.steps_per_upload
            if max_steps is not None:
                budget = min(budget, max_steps - steps)
            # one profiler step bounds the whole pull->fit->submit span,
            # INCLUDING the take: a starved iteration records wall with no
            # phase time, which is exactly the idle attribution we want
            with self._prof.step():
                t0 = time.perf_counter()
                t0_wall, t0_mono = time.time(), time.monotonic()
                group = self._take_batches(budget, device)
                if not group:
                    if self.dataset.exhausted:
                        break
                    continue  # starved; re-check
                tid = new_trace_id() if self._tracer.enabled else None
                if tid is not None:
                    self._round_tls.ctx = (tid, None)
                round_ok = False
                try:
                    t0 = self._phase("stage", t0, None if self.stage_dataset else device)
                    ticket = None
                    handed = False
                    try:
                        if self.admission_control:
                            # SSP span: window slot + submit-order ticket
                            ticket, params, version = self._admit()
                            t0 = self._phase("admission_wait", t0)
                        else:
                            params, version = self.snapshot()
                        model = self._model_for(worker_index, device)
                        load_params(model, params)
                        t0 = self._phase("snapshot", t0, device)
                        if self.stage_dataset:
                            grads = self._staged_fit(model, group, device)
                        else:
                            grads = self._host_fit(model, group)
                        t0 = self._phase("fit", t0, device)
                        if pipe is not None:
                            # double-buffer: hand the submit tail to the
                            # comm thread and start the next round; the
                            # slot wait is the pipeline's backpressure
                            pipe.check()
                            pipe.acquire_slot()
                            t0 = self._phase("pipeline_wait", t0)
                            pipe.put(ticket, grads, version, group, tid)
                            handed = True  # ticket and batch acks are the pipe's now
                        else:
                            if ticket is not None:
                                # the FIFO wait books under admission_wait, not submit
                                self._await_turn(ticket)
                                t0 = self._phase("admission_wait", t0)
                            self.submit(grads, version, client_id=f"worker-{worker_index}")
                            self._phase("submit", t0, self.devices[0])
                    except BaseException:
                        # failure recovery: return the batches to the queue
                        # so another worker picks them up
                        if not handed:
                            for b, _, _ in group:
                                self.dataset.requeue(b.batch)
                        raise
                    finally:
                        if ticket is not None and not handed:
                            self._close_span(ticket)
                    # ack regardless of staleness-acceptance: the batches
                    # were consumed (asynchronousSGD_server.ts:66-72)
                    if not handed:
                        for b, _, _ in group:
                            self.dataset.complete_batch(b.batch)
                    round_ok = True
                finally:
                    if tid is not None:
                        self._round_tls.ctx = None
                        self._tracer.emit(
                            "round", trace_id=tid,
                            dur_ms=(time.monotonic() - t0_mono) * 1e3,
                            start=t0_wall, mono=t0_mono, role="trainer",
                            worker=worker_index, status="ok" if round_ok else "error")
                steps += len(group)
        return steps

    def _host_fit(self, model: nn.Module, group) -> Params:
        """The mean gradient over host-staged ``(batch, x_dev, y_dev)``
        triples."""
        return mean_grads(self._grad, model, [(x, y) for _, x, y in group])

    def _staged_fit(self, model: nn.Module, group, device: torch.device) -> Params:
        """The mean gradient over device-resident dataset slices
        ``(batch, lo, size)``."""
        xd, yd = self._device_dataset(device)
        return mean_grads(self._grad, model,
                          [tuple(tree_map(lambda t: t[lo:lo + size], d) for d in (xd, yd))
                           for _, lo, size in group])

    def _take_batches(self, budget: int, device: torch.device) -> List[Tuple[Any, Any, Any]]:
        """Pull up to ``budget`` batches; blocks (5 s) only for the first.

        Each batch is staged to the worker's device AS TAKEN, so its copy
        overlaps whatever the device still computes. A starved queue
        mid-group does not stall the upload: the worker proceeds with the
        batches it has. Returns ``(batch, x_dev, y_dev)`` triples, or
        ``(batch, lo, size)`` with ``stage_dataset``."""
        group: List[Tuple[Any, Any, Any]] = []
        while len(group) < budget:
            batch = self.dataset.next(timeout=5.0 if not group else 0.05)
            if batch is None:
                break
            if self.stage_dataset:
                if self.dataset._preprocess:
                    raise RuntimeError(
                        "stage_dataset=True bypasses batch materialization "
                        "and cannot honor host preprocess callbacks — "
                        "disable staging or drop the preprocess chain")
                bs = self.dataset.config.batch_size
                lo = batch.batch * bs
                size = min(lo + bs, self.dataset.num_rows) - lo
                group.append((batch, lo, size))
            else:
                group.append((batch, *to_device((batch.x, batch.y), device)))
        return group

    def train(self, num_workers: Optional[int] = None) -> Dict[str, int]:
        """Run workers over the dataset until exhausted; returns counters."""
        # lifecycle: no worker threads exist yet; init() locks itself
        if self.params is None:  # dfcheck: ignore[lock-discipline]
            self.init()
        n = num_workers if num_workers is not None else len(self.devices)
        errors: List[BaseException] = []

        def run(i: int) -> None:
            try:
                self.worker_loop(i)
            except BaseException as e:  # noqa: BLE001 - surfaced to the caller below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
        with self.logger.time(f"async training with {n} workers"):
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        # drain the device queue: the final parameters must exist before
        # train() claims completion (else a wall clock around it measures
        # the dispatch rate, not the training rate)
        t_drain = time.perf_counter()
        self._sync(self.devices[0])
        with self._phase_lock:
            self.phase_ms["drain"] += (time.perf_counter() - t_drain) * 1e3
        with self._lock:
            return {"applied": self.applied_updates, "rejected": self.rejected_updates,
                    "version": self.version}

    # -- introspection -----------------------------------------------------

    def evaluate(self, x, y, metrics=("loss", "accuracy"), weight=None) -> List[float]:
        """Example-mean metrics of the current snapshot on one batch."""
        params, _ = self.snapshot()
        dev = self.devices[0]
        fn = self.spec.metrics_fn(list(metrics))
        with self._eval_lock:
            model = self._model_for("eval", dev)
            load_params(model, params)
            x, y, w = to_device((x, y, weight), dev)
            return [float(v) for v in fn(model, x, y, None if w is None else w.float())]

    def cost_analysis(self, batch_size: int) -> Dict[str, Any]:
        """Cost of ONE per-batch gradient at ``batch_size`` (an upload of K
        batches costs K of them), as ``SyncTrainer.cost_analysis`` counts
        it: one forward and backward on zero inputs of the dataset's row
        shapes and dtypes under FlopCounterMode, plus the kernels' tally on
        CUDA (:func:`~distriflow_tpu_torch.ops.flop_count.step_cost`). It
        runs on the server's device with a model of its own at the current
        snapshot (no update, no trainer state changes). Cached per batch
        size. Raises while a worker runs: the kernel tally is one per
        process and would take in the workers' records."""
        from distriflow_tpu_torch.ops.flop_count import step_cost

        key = int(batch_size)
        if key not in self._cost_cache:
            with self._phase_lock:
                if self._live_workers:
                    raise RuntimeError(
                        f"cost_analysis while {self._live_workers} worker(s) run: the "
                        "kernel tally would count their batches too; call it before "
                        "or after train()")
            params, _ = self.snapshot()
            if params is None:
                params = self.init()
            dev = self.devices[0]
            x, y = (tree_map(lambda t: t.new_zeros((key,) + tuple(t.shape[1:])),
                             to_device(tree_map(lambda a: a[:1], d), dev))
                    for d in (self.dataset.x, self.dataset.y))
            with self._eval_lock:
                model = self._model_for("eval", dev)
                load_params(model, params)
                self._cost_cache[key] = step_cost(lambda: self._grad(model, x, y), dev)
        return self._cost_cache[key]

    def mfu(self, batch_size: int, step_seconds: float,
            peak_flops_per_chip: Optional[float] = None, gauge_mode: str = "async") -> float:
        """Model FLOPs utilization of one async worker-step: per-batch grad
        flops / (per-batch wall x the card's dense bf16 peak), mirrored into
        ``train_mfu{mode=gauge_mode}``. ``step_seconds`` is the per-BATCH
        wall time (elapsed / batches processed)."""
        from distriflow_tpu_torch.train.sync import peak_bf16_flops, record_mfu

        if peak_flops_per_chip is None:
            peak_flops_per_chip = peak_bf16_flops(self.devices[0])
        return record_mfu(self.cost_analysis(batch_size), step_seconds, peak_flops_per_chip,
                          gauge_mode)


def _on_device(tree: Any, device: torch.device) -> Any:
    """A loaded host tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
