"""Port of ``distriflow_tpu/server/async_server.py``: the
asynchronous-SGD server, unchanged in behaviour (leases, dispatch window,
version-token staleness, decay, quarantine, lease monitor). An upload is
deserialized on the host against the wire-layout template, checked there
by the quarantine gate, mapped back to the model's own layout
(``models/base.py::params_from_wire``) and reaches the device once, in
the model's ``update``.

The JAX module's description follows.

Asynchronous-SGD server (data-dispatching).

Re-design of the reference ``AsynchronousSGDServer``
(``src/server/asynchronousSGD_server.ts``): owns a ``DistributedDataset``;
on connection sends weights + the client's first batch; on upload acks,
completes the batch, applies the gradient, and sends the NEXT batch.

Two deliberate fixes over the reference:

- **per-worker dispatch**: the next batch goes only to the uploading client
  (the reference broadcasts it to ALL sockets so every worker races on the
  same batch, ``:75-79``);
- **bounded staleness**: gradients older than ``maximum_staleness`` versions
  are rejected instead of applied blindly (the reference applies immediately
  with no check, ``:95-108``; its README promises ``maximumStaleness``).

A disconnecting client's outstanding batch is requeued (failure recovery the
reference lacks — lost batches there are only re-served on epoch wrap).

Concurrency: handler threads, the apply worker, and the lease monitor all
share the dispatch/apply state. Shared mutable fields carry ``# guarded-by:
_lock`` annotations (enforced by the JAX package's ``python -m distriflow_tpu.analysis``
over its own copy; see docs/ANALYSIS.md); helpers documented to run under the lock are marked
``# dfcheck: holds _lock``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from distriflow_tpu_torch.data.dataset import DistributedDataset, batch_to_data_msg
from distriflow_tpu_torch.models.base import DistributedModel, params_from_wire, params_to_wire
from distriflow_tpu_torch.server.abstract_server import AbstractServer, DistributedServerConfig
from distriflow_tpu_torch.server.models import DistributedServerModel
from distriflow_tpu_torch.comm.transport import ServerTransport
from distriflow_tpu_torch.utils.config import (
    ASYNC_DEFAULT_MAXIMUM_STALENESS,
    async_server_hyperparams,
)
from distriflow_tpu_torch.utils.messages import DownloadMsg, Events, UploadMsg
from distriflow_tpu_torch.utils.serialization import (
    copy_tree,
    deserialize_tree,
    tree_map_with_path,
)


class AsynchronousSGDServer(AbstractServer):
    #: async-mode staleness default (see ``ASYNC_DEFAULT_MAXIMUM_STALENESS``)
    DEFAULT_MAXIMUM_STALENESS = ASYNC_DEFAULT_MAXIMUM_STALENESS

    # async mode tolerates in-flight staleness by default (sync default is 0)
    _hyperparams_factory = staticmethod(async_server_hyperparams)

    def __init__(
        self,
        model: DistributedModel | DistributedServerModel,
        dataset: DistributedDataset,
        config: Optional[DistributedServerConfig] = None,
        transport: Optional[ServerTransport] = None,
    ):
        super().__init__(model, config, transport)
        self.dataset = dataset
        self.version_counter = 0  # integer staleness clock  # guarded-by: _lock
        self._h_staleness = self.telemetry.histogram(
            "server_gradient_staleness",
            help="staleness (versions behind) of applied gradients")
        self._c_applied = self.telemetry.counter(
            "server_updates_applied_total", help="gradient updates applied")
        self._c_rejected = self.telemetry.counter(
            "server_updates_rejected_total",
            help="gradient updates rejected (staleness/quarantine)")
        self._c_lease_expired = self.telemetry.counter(
            "server_lease_expirations_total",
            help="batch leases expired and requeued")
        self._c_suppressed = self.telemetry.counter(
            "server_first_wins_suppressed_total",
            help="late uploads suppressed by first-wins arbitration")
        self._c_requeued = self.telemetry.counter(
            "server_recovery_requeued_total",
            help="batches requeued on disconnect/recovery")
        self._client_versions: Dict[str, int] = {}  # guarded-by: _lock
        # outstanding batches per client, in dispatch order. One entry in
        # serial mode; up to the dispatch-ahead window when the pushed
        # client hyperparams carry inflight_window > 1 (the next batch
        # piggybacks on the ack/broadcast for the previous one, so a
        # pipelined client never idles on dispatch).
        self._client_batches: Dict[str, List[int]] = {}  # guarded-by: _lock
        self._waiting: set = set()  # starved clients  # guarded-by: _lock
        self._completion_sent = False  # guarded-by: _lock
        self.applied_updates = 0  # guarded-by: _lock
        self.rejected_updates = 0  # guarded-by: _lock
        # straggler mitigation: (client_id, batch) -> monotonic deadline;
        # the monitor thread requeues expired leases for speculative
        # re-dispatch (config.batch_lease_s > 0 enables). Keyed per
        # dispatch, not per client, so every batch in a client's
        # dispatch-ahead window carries its own lease.
        self._lease_deadlines: Dict[Tuple[str, int], float] = {}  # guarded-by: _lock
        self._lease_stop = threading.Event()
        self._lease_thread: Optional[threading.Thread] = None
        self.lease_expirations = 0  # guarded-by: _lock
        # gradients suppressed by first-wins arbitration (their batch was
        # already completed by another client — straggler's late answer)
        self.suppressed_uploads = 0  # guarded-by: _lock
        # reconnect reconciliation: model-version string -> the counter value
        # when that version was published. A gradient from a client that
        # reconnected mid-flight has no per-connection dispatch record, but
        # it still names the version it was computed against — staleness is
        # judged from the GRADIENT's version, not the connection's history.
        self._version_tokens: "collections.OrderedDict[str, int]" = collections.OrderedDict()  # guarded-by: _lock
        # fleet-wide dispatch-window cap (adaptive control): a sustained
        # fleet ack-p99 breach shrinks it below every client's pushed
        # inflight_window; recovery ramps it back to None (uncapped). Reads
        # are racy-by-design (a dispatch mid-shrink uses the old cap once).
        self._fleet_window_cap: Optional[int] = None
        self._g_window_cap = self.telemetry.gauge(
            "server_dispatch_window_cap",
            help="fleet-wide dispatch window cap (0 = uncapped)")

    _VERSION_TOKEN_WINDOW = 64  # comfortably > any sane maximum_staleness

    # dfcheck: holds _lock
    def _note_version_token(self) -> None:
        """Record the current (version string, counter) pair; call with
        ``self._lock`` held (or before the transport starts)."""
        self._version_tokens[self.model.version] = self.version_counter
        while len(self._version_tokens) > self._VERSION_TOKEN_WINDOW:
            self._version_tokens.popitem(last=False)

    def setup(self) -> None:
        super().setup()
        # the initial (or restored) weights map to the current counter value
        self._note_version_token()
        if self.config.batch_lease_s > 0:
            self._lease_thread = threading.Thread(
                target=self._lease_monitor, name="batch-lease-monitor", daemon=True
            )
            self._lease_thread.start()

    def stop(self) -> None:
        self._lease_stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=2.0)
            self._lease_thread = None
        super().stop()

    # -- dispatch ----------------------------------------------------------

    def set_fleet_window_cap(self, cap: Optional[int]) -> None:
        """Fleet-wide dispatch-window ceiling (adaptive degradation):
        ``None`` removes the cap, otherwise every client's window is
        clamped to ``max(1, cap)`` regardless of its pushed
        ``inflight_window``. Takes effect on the next dispatch."""
        self._fleet_window_cap = None if cap is None else max(1, int(cap))
        self._g_window_cap.set(0 if self._fleet_window_cap is None
                               else self._fleet_window_cap)

    @property
    def fleet_window_cap(self) -> Optional[int]:
        return self._fleet_window_cap

    def outstanding_snapshot(self) -> Dict[str, List[int]]:
        """Per-connection outstanding batches, copied under the lock —
        the soak harness's leak audit (must be empty at quiescence)."""
        with self._lock:
            return {c: list(b) for c, b in self._client_batches.items()}

    def active_leases(self) -> int:
        """Live batch leases, read under the lock (0 at quiescence)."""
        with self._lock:
            return len(self._lease_deadlines)

    def _dispatch_window(self, client_id: str) -> int:
        """How many batches THIS connection may hold at once: its effective
        ``inflight_window`` (global, or the stable client's override patch)
        clamped at ``maximum_staleness + 1`` — the server-side cap is what
        makes the pipeline's effective staleness bounded BY CONSTRUCTION (a
        batch the server never dispatched can't age in anyone's window) —
        and at the fleet-wide adaptive cap, when one is set."""
        window = int(self.hyperparams_for(client_id)["inflight_window"])
        cap = self._fleet_window_cap
        if cap is not None:
            window = min(window, cap)
        return max(1, min(window, int(self.hyperparams.maximum_staleness) + 1))

    def _fill_window(self, client_id: str) -> None:
        """Dispatch-ahead: top the client's outstanding set up to the
        window. Stops at the first failed dispatch (starved queue,
        exhaustion, or the client vanishing)."""
        window = self._dispatch_window(client_id)
        while True:
            with self._lock:
                outstanding = len(self._client_batches.get(client_id, ()))
            if outstanding >= window:
                return
            if not self._send_next_batch(client_id):
                return

    def _send_next_batch(self, client_id: str) -> bool:
        """Pop the next batch and send weights+data to ONE client.

        A starved client (all remaining work outstanding elsewhere) is parked
        in ``_waiting`` and re-dispatched as soon as an ack/requeue frees
        work; on exhaustion, completion is broadcast to every parked client —
        without this, any multi-client run would hang its stragglers."""
        batch = self.dataset.next(timeout=0.0)
        if batch is None:
            if self.dataset.exhausted:
                try:  # tell this client directly (covers late joiners), then all
                    self.transport.emit_to(client_id, "trainingComplete", {})
                except KeyError:
                    pass
                self._broadcast_complete()
                return False
            with self._lock:
                self._waiting.add(client_id)
            return False
        with self._lock:
            self._client_batches.setdefault(client_id, []).append(batch.batch)
            dispatch_version = self.version_counter
            self._client_versions[client_id] = dispatch_version
            self._grant_lease(client_id, batch.batch)
            self._waiting.discard(client_id)
        # the dispatch opens the update's trace: its trace_id rides the
        # download header, the client copies it into the resulting upload,
        # and the server's apply span closes the loop — one trace covers
        # dispatch -> train -> upload -> apply, across retries/reconnects.
        # The span records the version captured under the lock above — a
        # concurrent apply must not skew what THIS dispatch was stamped with.
        with self.telemetry.span(
            "dispatch", client_id=client_id, batch=batch.batch,
            version=dispatch_version,
        ) as span:
            msg = DownloadMsg(
                # full-or-delta weights for THIS connection (delta when the
                # server knows what the connection last installed)
                model=self.download_model_msg(client_id),
                hyperparams=self.hyperparams_for(client_id),
                data=batch_to_data_msg(batch),
                trace_id=span.trace_id or None,
                span_id=span.span_id or None,
            )
            try:
                self.transport.emit_to(client_id, Events.Download.value, msg.to_wire())
            except KeyError:
                # the client disconnected between its upload-apply and this
                # dispatch; un-claim the batch so it isn't lost until epoch
                # wrap (mirror of the guarded trainingComplete path above).
                # `owned` resolves the race with handle_disconnection: only
                # whoever pops the dispatch record requeues.
                with self._lock:
                    held = self._client_batches.get(client_id, [])
                    owned = batch.batch in held
                    if owned:
                        held.remove(batch.batch)
                        if not held:
                            self._client_batches.pop(client_id, None)
                    self._client_versions.pop(client_id, None)
                    self._revoke_lease(client_id, batch.batch)
                    self._waiting.discard(client_id)
                if owned:
                    self.dataset.requeue(batch.batch)
                    self.log(f"client {client_id[:8]} gone before dispatch; "
                             f"requeued batch {batch.batch}")
                return False
        return True

    def _dispatch_waiting(self) -> None:
        """Give parked clients another shot at the queue."""
        with self._lock:
            waiting = list(self._waiting)
        for client_id in waiting:
            try:
                self._send_next_batch(client_id)
            except KeyError:
                with self._lock:  # client disconnected while parked
                    self._waiting.discard(client_id)

    def _broadcast_complete(self) -> None:
        with self._lock:
            if self._completion_sent:
                return
            self._completion_sent = True
        self.transport.broadcast("trainingComplete", {})

    def _reclaim_outstanding(self, client_id: str) -> List[int]:
        """Pop (under the lock) everything the client holds — its whole
        dispatch-ahead window — plus the matching leases; the caller
        requeues outside the lock."""
        with self._lock:
            outstanding = self._client_batches.pop(client_id, [])
            self._client_versions.pop(client_id, None)
            for b in outstanding:
                self._revoke_lease(client_id, b)
            self._waiting.discard(client_id)
        return outstanding

    # dfcheck: pairs acquire=_grant_lease release=_revoke_lease mode=state
    def _grant_lease(self, client_id: str, batch: int) -> None:  # dfcheck: holds _lock
        """Arm the straggler lease for one dispatched batch; no-op when
        leases are disabled (``config.batch_lease_s <= 0``)."""
        if self.config.batch_lease_s > 0:
            self._lease_deadlines[(client_id, batch)] = (
                time.monotonic() + self.config.batch_lease_s
            )

    def _revoke_lease(self, client_id: str, batch: int) -> None:  # dfcheck: holds _lock
        """Retire one batch lease (idempotent: expiry, completion,
        disconnection, and reclaim may race; last one wins harmlessly)."""
        self._lease_deadlines.pop((client_id, batch), None)

    def handle_connection(self, client_id: str) -> None:
        # weights + first batch(es) to the new client (reference :59-63);
        # a pipelined client gets its whole dispatch-ahead window up front
        self._fill_window(client_id)
        with self._lock:
            got_work = bool(self._client_batches.get(client_id))
        if not got_work:
            # parked (all work outstanding elsewhere) or post-exhaustion
            # joiner: the handshake still owes a weights+hyperparams
            # Download (data-less). Without it a late joiner's setup()
            # hangs on a starved fleet, and a client rejoining after a
            # crash would idle on stale weights (and miss any per-client
            # override pushed while it was away) until a batch freed up.
            try:
                self.transport.emit_to(
                    client_id, Events.Download.value,
                    DownloadMsg(
                        model=self.download_model_msg(client_id),
                        hyperparams=self.hyperparams_for(client_id),
                    ).to_wire())
            except KeyError:
                pass  # vanished between connect and welcome

    def handle_resync(self, client_id: str) -> None:
        """Resync repair for the dispatching plane: the client discarded the
        broadcast (and the batch riding on it), so requeue its outstanding
        batches — the entire in-flight window; a delta any of them rode is
        invalid now — and re-dispatch. The base was already cleared by the
        caller, so the fresh dispatch carries FULL weights; the client's
        update-id cache keeps the eventual re-train idempotent server-side."""
        for b in self._reclaim_outstanding(client_id):
            self.dataset.requeue(b)
        self._fill_window(client_id)
        self._dispatch_waiting()

    def handle_disconnection(self, client_id: str) -> None:
        # failure recovery: requeue every batch the client died holding
        outstanding = self._reclaim_outstanding(client_id)
        if outstanding:
            for b in outstanding:
                self.dataset.requeue(b)
            self.log(f"requeued batch(es) {outstanding} from dead client")
            self._dispatch_waiting()

    # -- upload ------------------------------------------------------------

    def handle_upload(self, client_id: str, msg: UploadMsg) -> bool:
        first = True
        if msg.batch is not None:
            # ack first (reference :72). `first` gates the apply: a batch
            # completed by another client already — a speculative
            # re-dispatch winner, or a duplicate completion — must not
            # land its gradient twice (first-wins arbitration)
            first = self.dataset.complete_batch(msg.batch)
            with self._lock:
                held = self._client_batches.get(client_id)
                if held is not None and msg.batch in held:
                    held.remove(msg.batch)
                    if not held:
                        self._client_batches.pop(client_id, None)
                self._revoke_lease(client_id, msg.batch)
        accepted = False
        if msg.gradients is not None:
            if first:
                accepted = self._apply(client_id, msg)
            else:
                # under the lock: races the manifest snapshot in _apply's
                # save path, which reads this counter while holding it
                with self._lock:
                    self.suppressed_uploads += 1
                self._c_suppressed.inc()
                self.log(
                    f"suppressed gradient for batch {msg.batch} from "
                    f"{msg.client_id}: already completed (first-wins)"
                )
        # refill THIS client's window (fixed dispatch — the next batch
        # piggybacks right behind the ack/broadcast for this one), then
        # give parked clients a chance at whatever the ack freed up
        self._fill_window(client_id)
        self._dispatch_waiting()
        return accepted

    def _apply(self, client_id: str, msg: UploadMsg) -> bool:
        with self._lock:
            # the gradient's own version is the ground truth for staleness:
            # after a reconnect the connection's dispatch record is gone (or
            # fresh), but the upload still names the weights it was computed
            # against. Fall back to the per-connection record only for
            # versions older than the token window.
            sent_version = self._version_tokens.get(msg.gradients.version)
            if sent_version is None:
                # version-token mismatch: the gradient names weights outside
                # the token window, so this connection's delta base can't be
                # trusted either — force its next broadcast to a full sync
                with self._delta_lock:
                    self._client_bases.pop(client_id, None)
                sent_version = self._client_versions.get(client_id, self.version_counter)
            staleness = self.version_counter - sent_version
            self._h_staleness.observe(staleness)
            self.fleet.note_staleness(client_id, staleness)
            # the enclosing apply span (opened by _process_upload on this
            # thread) is the round's server leg: every exit path below names
            # its verdict on it so the trace assembler can tell an applied
            # round from a rejected one without the counters
            apply_span = self.telemetry.tracer.current()
            apply_span.set(staleness=staleness)
            if staleness > self.hyperparams.maximum_staleness:
                self.rejected_updates += 1
                self._c_rejected.inc()
                apply_span.set(verdict="stale")
                self.log(
                    f"rejected update from {msg.client_id}: staleness {staleness} > "
                    f"{self.hyperparams.maximum_staleness}"
                )
                return False
            decay = self.hyperparams.staleness_decay**staleness
            params = self.model.get_params()
            # the wire-layout template on the host: deserialize_tree lands
            # every leaf on its dtype (compressed 16-bit uploads widen to
            # the param dtype, so optimizer math runs at param dtype)
            with self._prof.phase("template"):
                template = params_to_wire(self._wire_model, params)
            with self._prof.phase("deserialize"):
                grads = deserialize_tree(msg.gradients.vars, template, strict_shapes=True)
            # quarantine gate: a non-finite or norm-outlier gradient is
            # rejected BEFORE it can touch the canonical model, and its
            # payload is dumped for postmortem (docs/ROBUSTNESS.md §8)
            t_gate = time.perf_counter()
            with self._prof.phase("quarantine"):
                verdict = self.gate.check(grads)
            # how long the gate held the apply: the assembler carves this
            # head slice of the apply span into its own "quarantine" phase
            apply_span.set(
                quarantine_ms=(time.perf_counter() - t_gate) * 1e3)
            if not verdict.ok:
                self.rejected_updates += 1
                self._c_rejected.inc()
                apply_span.set(verdict="quarantined")
                self.fleet.note_quarantine(client_id)
                self.log(f"quarantined update from {msg.client_id}: {verdict.reason}")
                self.gate.quarantine(
                    msg.gradients.vars, verdict.reason,
                    client_id=msg.client_id, update_id=msg.update_id,
                    batch=msg.batch, version=msg.gradients.version,
                )
                self.telemetry.flight.record(
                    "quarantine", client_id=msg.client_id,
                    update_id=msg.update_id, reason=verdict.reason)
                self.telemetry.flight.dump(
                    "quarantine", client_id=msg.client_id,
                    reason=verdict.reason)
                self.telemetry.timeline.event(
                    "quarantine", client_id=msg.client_id,
                    reason=verdict.reason)
                return False
            if decay != 1.0:
                grads = tree_map_with_path(lambda _, g: g * decay, grads)
            with self.time("updating model"):
                if self.gate.active:
                    # snapshot for the rollback guard, on the params' own
                    # device: the update rule mutates params in place
                    prev = copy_tree(params)
                with self._prof.phase("update"):
                    self.model.update(params_from_wire(self._wire_model, grads))
                with self._prof.phase("rollback_guard"):
                    finite = not self.gate.active or self.gate.params_finite(
                        self.model.get_params())
                if not finite:
                    # rollback guard: the gradient passed the gate but the
                    # update drove the PARAMS non-finite — restore and reject
                    self.model.set_params(prev)
                    self.rejected_updates += 1
                    self._c_rejected.inc()
                    apply_span.set(verdict="rollback")
                    self.gate.record_rollback()
                    self.fleet.note_quarantine(client_id)
                    self.log(f"rolled back update from {msg.client_id}: "
                             "params went non-finite")
                    self.gate.quarantine(
                        msg.gradients.vars, "post-apply-non-finite",
                        client_id=msg.client_id, update_id=msg.update_id,
                        batch=msg.batch, version=msg.gradients.version,
                    )
                    self.telemetry.flight.record(
                        "rollback", client_id=msg.client_id,
                        update_id=msg.update_id)
                    self.telemetry.flight.dump(
                        "rollback", client_id=msg.client_id)
                    self.telemetry.timeline.event(
                        "rollback", client_id=msg.client_id)
                    return False
                self.gate.accept(verdict.norm)
                # state mutations BEFORE save(): the manifest written by the
                # save must describe the post-apply world (counter advanced,
                # this update_id in the dedup keys, its batch completed) so a
                # restart restores a consistent (params, bookkeeping) pair
                self.version_counter += 1
                self.applied_updates += 1
                self._note_applied_id(msg.update_id)
                self.model.save()  # reference saves every step (:105)
                self._c_applied.inc()
                self._g_version.set(self.version_counter)
                with self._prof.phase("download"):
                    self.download_msg = self.compute_download_msg()
                self._note_version_token()
                apply_span.set(verdict="applied")
        self.callbacks.fire("new_version", self.model.version)
        return True

    # -- straggler mitigation (lease monitor) -------------------------------

    def _lease_monitor(self) -> None:
        """Backup-worker speculative execution (Chen et al. 2016): requeue
        batches whose lease expired so a parked client can race the
        straggler; first-wins arbitration in :meth:`handle_upload` keeps
        the apply at-most-once whichever copy answers first."""
        interval = max(0.02, min(0.5, self.config.batch_lease_s / 4.0))
        while not self._lease_stop.wait(interval):
            now = time.monotonic()
            expired = []
            with self._lock:
                for (cid, batch), deadline in list(self._lease_deadlines.items()):
                    if now >= deadline:
                        # one expiry per dispatch: the straggler keeps its
                        # dispatch record (its eventual upload still names
                        # the batch), only the lease is retired
                        self._revoke_lease(cid, batch)
                        expired.append((cid, batch))
                # counted while still under the lock: the manifest snapshot
                # reads this field holding _lock, and the monitor thread is
                # the only writer after setup
                self.lease_expirations += len(expired)
            for cid, batch in expired:
                self._c_lease_expired.inc()
                self.telemetry.flight.record("lease_expiry", client_id=cid,
                                             batch=batch)
                self.telemetry.flight.dump("lease_expiry", client_id=cid,
                                           batch=batch)
                self.telemetry.timeline.event("lease_expiry", client_id=cid,
                                              batch=batch)
                self.log(f"lease expired on batch {batch} held by {cid[:8]}; "
                         "speculative re-dispatch")
                self.dataset.requeue(batch)
                self._dispatch_waiting()

    # -- crash-consistent recovery ------------------------------------------

    # dfcheck: holds _lock
    def _manifest(self) -> Dict[str, Any]:
        """Base manifest (dedup keys) + the async training plane: dataset
        cursor, version clock, and the apply/reject accounting. Runs under
        ``self._lock`` when called from ``_apply``'s save — reads state
        directly, never re-acquires it."""
        m = super()._manifest()
        m.update(
            mode="async",
            dataset=self.dataset.state(),
            version_counter=self.version_counter,
            version_tokens=[[v, c] for v, c in self._version_tokens.items()],
            applied_updates=self.applied_updates,
            rejected_updates=self.rejected_updates,
            suppressed_uploads=self.suppressed_uploads,
            lease_expirations=self.lease_expirations,
            quarantined_updates=self.gate.quarantined_updates,
        )
        return m

    # restore runs in setup(), before the transport/monitor threads exist —
    # single-threaded by construction, so it owns the lock's state trivially
    # dfcheck: holds _lock
    def _restore_manifest(self, manifest: Dict[str, Any]) -> bool:
        """Resume mid-epoch on a fresh server process: version clock and
        token window back, counters cumulative across incarnations, and
        every batch that was outstanding at save time requeued (its
        holder's connection died with the old process)."""
        if not super()._restore_manifest(manifest):
            return False
        self.version_counter = int(manifest.get("version_counter", 0))
        self._version_tokens = collections.OrderedDict(
            (str(v), int(c)) for v, c in manifest.get("version_tokens", ())
        )
        self.applied_updates = int(manifest.get("applied_updates", 0))
        self.rejected_updates = int(manifest.get("rejected_updates", 0))
        self.suppressed_uploads = int(manifest.get("suppressed_uploads", 0))
        self.lease_expirations = int(manifest.get("lease_expirations", 0))
        self._g_version.set(self.version_counter)
        ds_state = manifest.get("dataset")
        if ds_state is not None:
            requeued = self.dataset.restore_state(ds_state)
            if requeued:
                self._c_requeued.inc(requeued)
                self.log(f"requeued {requeued} outstanding batch(es) from "
                         "the previous server incarnation")
        return True
