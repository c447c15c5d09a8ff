"""Port of ``distriflow_tpu/server/federated_server.py``: the
gradient-averaging server, unchanged in behaviour. Uploads are buffered as
their wire payloads; once ``min_updates_per_version`` have arrived,
:func:`~distriflow_tpu_torch.utils.serialization.mean_serialized` averages
them on the host against the wire-layout template, and the mean reaches
the device once, in the model's ``update``.

The JAX module's description follows.

Federated (gradient-mean) server.

Re-design of the reference ``FederatedServer`` (``src/server/federated_server.ts``):
on connection, send current weights; on upload, drop stale gradients, buffer
the rest; once ``min_updates_per_version`` arrive, aggregate (mean), apply,
checkpoint, and broadcast the new version to all clients.

Staleness: the reference's rule is exact-version-match-or-drop (staleness 0,
``federated_server.ts:73``). Here the rule generalizes to
``maximum_staleness`` versions with optional ``staleness_decay`` weighting —
staleness-0 drop is the default config, preserving reference behavior.
"""

from __future__ import annotations

import time
from typing import Dict


import numpy as np

from distriflow_tpu_torch.models.base import params_from_wire, params_to_wire
from distriflow_tpu_torch.server.abstract_server import AbstractServer
from distriflow_tpu_torch.utils.messages import DownloadMsg, Events, UploadMsg
from distriflow_tpu_torch.utils.serialization import (
    SerializedArray,
    _itemsize,
    copy_tree,
    deserialize_array,
    mean_serialized,
)


class FederatedServer(AbstractServer):
    #: uploads dropped without buffering (unknown version, too stale,
    #: mid-aggregation, malformed) — the federated analog of the async
    #: server's ``rejected_updates``; chaos drills assert on it
    dropped_uploads = 0  # guarded-by: _lock

    def handle_connection(self, client_id: str) -> None:
        # send current weights (reference :69) — built per connection so the
        # delta ledger records what THIS connection was sent (a fresh
        # connection has no base, so this is always a full broadcast)
        self.transport.emit_to(
            client_id,
            Events.Download.value,
            DownloadMsg(
                model=self.download_model_msg(client_id),
                hyperparams=self.hyperparams_for(client_id),
            ).to_wire(),
        )

    def handle_upload(self, client_id: str, msg: UploadMsg) -> bool:
        """Buffer or drop one gradient upload; maybe aggregate.

        Returns the ack value (the reference acks ``true`` unconditionally at
        ``:72``; we ack whether the gradient was accepted). A gradient naming
        a version this server has never published — e.g. computed against a
        pre-restart incarnation of the server — is dropped here, which is
        what makes client reconnect-across-server-restart safe: the stale
        work is refused, the client gets a clean ``False`` ack, and its next
        round trains against the fresh weights."""
        # the enclosing apply span (opened by _process_upload on this
        # thread): every drop below names its verdict so the assembler can
        # attribute rejected rounds without re-deriving the drop rules
        apply_span = self.telemetry.tracer.current()
        if msg.gradients is None:
            apply_span.set(verdict="malformed")
            return False
        with self._lock:
            try:
                staleness = self._staleness(msg.gradients.version)
            except ValueError:
                self.log(f"dropping upload with unknown version {msg.gradients.version!r}")
                self.dropped_uploads += 1
                apply_span.set(verdict="unknown_version")
                # version-token mismatch (e.g. pre-restart gradient): the
                # connection's delta base is equally untrustworthy — its
                # next broadcast must be a full sync
                with self._delta_lock:
                    self._client_bases.pop(client_id, None)
                return False
            apply_span.set(staleness=staleness)
            if staleness > self.hyperparams.maximum_staleness or self.updating:
                # reference drop rule :73 (exact-version + !updating), generalized
                self.dropped_uploads += 1
                apply_span.set(
                    verdict="updating" if self.updating else "stale")
                return False
            decay = self.hyperparams.staleness_decay**staleness
            vars_ = msg.gradients.vars
            # validate against the published weights at receipt: a malformed
            # upload is rejected alone instead of poisoning the whole
            # buffered round at aggregation time (dtype may differ — clients
            # choose gradient_compression independently)
            if not self._well_formed(vars_):
                self.log(f"dropping malformed upload from {msg.client_id}")
                self.dropped_uploads += 1
                apply_span.set(verdict="malformed")
                return False
            # quarantine gate at receipt: one NaN (or exploding) contribution
            # buffered now would poison the whole aggregated round later —
            # reject it alone, dump the payload for postmortem
            if self.gate.active:
                t_gate = time.perf_counter()
                with self._prof.phase("quarantine"):
                    verdict = self.gate.check(
                        {k: deserialize_array(s) for k, s in vars_.items()}
                    )
                apply_span.set(
                    quarantine_ms=(time.perf_counter() - t_gate) * 1e3)
                if not verdict.ok:
                    self.dropped_uploads += 1
                    apply_span.set(verdict="quarantined")
                    self.fleet.note_quarantine(client_id)
                    self.log(f"quarantined upload from {msg.client_id}: "
                             f"{verdict.reason}")
                    self.gate.quarantine(
                        vars_, verdict.reason,
                        client_id=msg.client_id, update_id=msg.update_id,
                        version=msg.gradients.version,
                    )
                    self.telemetry.flight.record(
                        "quarantine", client_id=msg.client_id,
                        update_id=msg.update_id, reason=verdict.reason)
                    self.telemetry.flight.dump(
                        "quarantine", client_id=msg.client_id,
                        reason=verdict.reason)
                    return False
                self.gate.accept(verdict.norm)
            # decay folds into aggregation as a per-contribution weight
            # (mean_serialized(weights=...)) — no deserialize/re-serialize
            # round trip per decayed upload
            self.updates.append(vars_)
            self._update_decays.append(decay)
            self.num_updates += 1
            apply_span.set(verdict="buffered")
            should_aggregate = len(self.updates) >= self.hyperparams.min_updates_per_version
            if should_aggregate:
                self.updating = True
        if should_aggregate:
            try:
                self.update_model()
            finally:
                # re-lock for the flag drop: a concurrent handler reading
                # ``updating`` under the lock must never see a torn window
                # where aggregation finished but drops were still active
                with self._lock:
                    self.updating = False
        return True

    def _well_formed(self, vars_: Dict[str, SerializedArray]) -> bool:
        """Keys and shapes match the published weights, the dtype parses,
        and the payload length is consistent with shape x itemsize (a
        truncated buffer would otherwise only explode at aggregation)."""
        expected = self.download_msg.model.vars
        if set(vars_) != set(expected):
            return False
        for k, s in vars_.items():
            if s.shape != expected[k].shape:
                return False
            try:
                itemsize = _itemsize(s.dtype)
            except Exception:
                return False
            n = int(np.prod(s.shape, dtype=np.int64))
            if s.indices is not None:
                # sparse leaf: one value per int32 index, k <= n, and every
                # index inside the dense extent (shape stays the DENSE shape)
                if len(s.indices) % 4:
                    return False
                k_count = len(s.indices) // 4
                if k_count > n or len(s.data) != itemsize * k_count:
                    return False
                idx = np.frombuffer(s.indices, dtype=np.int32)
                if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
                    return False
                continue
            if len(s.data) != itemsize * n:
                return False
        return True

    def _staleness(self, version: str) -> int:
        """Versions are the server model's save tokens; the distance is
        tracked via the version history ring."""
        history = getattr(self, "_version_history", None)
        if history is None:
            history = self._version_history = []
        current = self.model.version
        if not history or history[-1] != current:
            history.append(current)
        if version == current:
            return 0
        try:
            idx = history.index(version)
        except ValueError:
            raise ValueError(f"unknown version {version!r}")
        return len(history) - 1 - idx

    def update_model(self) -> None:
        """Aggregate buffered updates and publish a new version
        (reference ``updateModel``, ``federated_server.ts:92-117``)."""
        with self.time("computing new weights"):
            with self._lock:
                updates, self.updates = self.updates, []
                decays, self._update_decays = self._update_decays, []
            # host-side mean over zero-copy buffer views (C++ kernel when
            # built) — replaces the reference's byte-stack + device mean(0);
            # staleness decay rides in as per-contribution weights
            params = self.model.get_params()
            with self._prof.phase("template"):
                template = params_to_wire(self._wire_model, params)
            with self._prof.phase("mean"):
                mean_grads = mean_serialized(updates, template, weights=decays)
            if self.gate.active:
                prev = copy_tree(params)
            with self._prof.phase("update"):
                self.model.update(params_from_wire(self._wire_model, mean_grads))
            with self._prof.phase("rollback_guard"):
                finite = not self.gate.active or self.gate.params_finite(
                    self.model.get_params())
            if not finite:
                # rollback guard: every contribution passed the gate, yet
                # the aggregated step drove the params non-finite — restore
                # the previous version and quarantine the aggregate
                self.model.set_params(prev)
                self.gate.record_rollback()
                self.log("rolled back aggregated update: params went non-finite")
                self.gate.quarantine(
                    mean_grads, "post-apply-non-finite",
                    contributions=len(updates), version=self.model.version,
                )
                self.telemetry.flight.record(
                    "rollback", contributions=len(updates))
                self.telemetry.flight.dump(
                    "rollback", contributions=len(updates))
                return
            self.model.save()
            with self._prof.phase("download"):
                self.download_msg = self.compute_download_msg()
        self.callbacks.fire("new_version", self.model.version)
        # new weights to everyone (reference :80) — sent per connection so
        # each client receives a delta against what IT last installed (full
        # weights for anything the ledger doesn't know)
        for cid in self.transport.client_ids:
            try:
                self.transport.emit_to(
                    cid,
                    Events.Download.value,
                    DownloadMsg(
                        model=self.download_model_msg(cid),
                        hyperparams=self.hyperparams_for(cid),
                    ).to_wire(),
                )
            except Exception:
                pass  # client raced a disconnect; reconnect gets a full send
