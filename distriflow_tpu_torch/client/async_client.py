"""Port of ``distriflow_tpu/client/async_client.py``: the server-fed
async-SGD worker, unchanged in behaviour (redelivery cache, the
``inflight_window`` pipeline). A batch reaches the model as the host
arrays it arrived as; the model's ``fit`` copies it to its device.

The JAX module's description follows.

Async-SGD client: server-fed worker.

Re-design of the reference ``AsynchronousSGDClient``
(``src/client/asynchronousSGD_client.ts``): training is a server-driven
ping-pong — every Download carries fresh weights plus a batch; the client
installs the weights, computes gradients on the batch, and uploads
``{batch, gradients, client_id}`` echoing the batch id for the server's ack
bookkeeping. The loop ends when the server signals ``trainingComplete``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import uuid as uuid_lib
from typing import Any, List, Optional, Tuple

from distriflow_tpu_torch.client.abstract_client import AbstractClient
from distriflow_tpu_torch.comm.transport import ConnectionLost
from distriflow_tpu_torch.utils.messages import DownloadMsg, GradientMsg, UploadMsg
from distriflow_tpu_torch.utils.serialization import deserialize_array

# how many (epoch, batch, version) -> UploadMsg entries a worker remembers
# for reconnect reconciliation; a worker only ever holds one batch at a time,
# so this comfortably covers redelivery races
_RECENT_UPLOADS = 16

# stand-in when a download arrived without a trace header: a fit span with
# no trace would assemble as its own orphan round
_NULL_CTX = contextlib.nullcontext()


class _PendingUpload:
    """Cache marker for a batch whose gradients are riding the upload
    pipeline: computed, not yet serialized/uploaded. A redelivery that
    finds this does NOTHING — the queued upload (same ``update_id``) is
    already the answer, and recomputing would double-mutate the EF
    residual."""

    __slots__ = ("update_id",)

    def __init__(self, update_id: str):
        self.update_id = update_id


class AsynchronousSGDClient(AbstractClient):
    def __init__(self, *args: Any, **kw: Any):
        super().__init__(*args, **kw)
        self.batches_processed = 0
        self.training_complete = threading.Event()
        self._update_lock = threading.Lock()
        # reconnect reconciliation: after a reset the server may redeliver a
        # batch whose gradients we already computed (its requeue races our
        # retried upload). Re-uploading the CACHED message — same update_id —
        # lets the server's dedup cache absorb the duplicate instead of the
        # model absorbing a double-counted gradient.
        self._recent_uploads: "collections.OrderedDict[Tuple[int, int, str], UploadMsg]" = (
            collections.OrderedDict()
        )

    def handle_download(self, msg: DownloadMsg, first: bool) -> None:
        """Weights are already installed by the base class; train on the
        attached batch if any (reference ``:32-40``)."""
        if msg.data is None:
            return
        self.distributed_update(msg)

    def handle_training_complete(self) -> None:
        # drain-on-stop: anything still riding the upload window finishes
        # (or fails onto the redelivery path) before we report completion
        self.drain_uploads(timeout=10.0)
        self.log("training complete")
        self.training_complete.set()

    def distributed_update(self, msg: DownloadMsg) -> None:
        """One fit+upload round (reference ``DistributedUpdate``, ``:44-83``).

        A redelivered batch (reconnect reconciliation, see
        ``_recent_uploads``) is answered from the cache: same gradients,
        same ``update_id``, no recompute, no ``batches_processed`` bump.

        With ``inflight_window > 1`` the round splits at the fit/comm
        boundary: the handler thread installs + fits, then hands the raw
        gradients to the client comm thread, which EF-compresses,
        serializes, and uploads in strict enqueue order (sequentially
        consistent residual handoff) while the handler fits the batch the
        server dispatched ahead.
        """
        key = (msg.data.epoch, msg.data.batch, msg.model.version)
        if self.inflight_window() > 1:
            self._pipelined_update(msg, key)
            return
        # one profiler step bounds the whole round (fit -> compress ->
        # serialize -> submit/ack): its wall-vs-busy digests are the
        # overlap/idle attribution docs/OBSERVABILITY.md §5 describes
        with self._prof.step():
            # downloads dispatch on concurrent executor threads, so a
            # duplicate-delivered frame can race the original: the whole
            # check-compute-insert is one critical section, and the
            # update_id is stamped here (not lazily in upload()) so both
            # racers send the same id
            with self._update_lock:
                upload = self._recent_uploads.get(key)
                if upload is not None:
                    self.log(f"re-upload of already-computed batch {key}")
                else:
                    x = deserialize_array(msg.data.x)
                    y = deserialize_array(msg.data.y)
                    metrics: Optional[List[float]] = None
                    if self.config.send_metrics:
                        with self._model_lock:
                            metrics = self.model.evaluate(x, y)
                    # the fit leg joins the dispatch's trace (when one rode
                    # the download header) so the assembler can place client
                    # compute on the round's critical path
                    with self.time("fit"), self._prof.phase("fit"), \
                            self.telemetry.span(
                                "fit", trace_id=msg.trace_id,
                                parent_id=msg.span_id,
                                client_id=self.client_id,
                                model_version=msg.model.version,
                            ) if msg.trace_id else _NULL_CTX, self._model_lock:
                        grads = self.model.fit(x, y)
                    upload = UploadMsg(
                        client_id=self.client_id,
                        batch=msg.data.batch,
                        gradients=GradientMsg(
                            version=msg.model.version,
                            vars=self.serialize_grads(grads),
                        ),
                        metrics=metrics,
                        update_id=uuid_lib.uuid4().hex,
                        # join the dispatch's trace (rides the download
                        # header): dispatch -> train -> upload -> apply is
                        # one trace, and a redelivered batch re-uploads this
                        # same cached message — same trace — so duplicates
                        # share it by construction
                        trace_id=msg.trace_id,
                    )
                    self._recent_uploads[key] = upload
                    while len(self._recent_uploads) > _RECENT_UPLOADS:
                        self._recent_uploads.popitem(last=False)
                    # count before the upload ack: the server may emit
                    # trainingComplete the instant it receives this upload,
                    # racing the ack back to us
                    self.batches_processed += 1
            self.upload(upload)

    def _pipelined_update(self, msg: DownloadMsg, key: Tuple[int, int, str]
                          ) -> None:
        """Pipelined round: fit on this thread, upload tail on the comm
        thread. The window slot is acquired BEFORE the update lock (the
        comm thread takes the lock to publish the built message — slot-wait
        under the lock would deadlock the pipe), and slot-then-lock also
        pins enqueue order to fit order."""
        with self._prof.step():
            if not self._comm_acquire_slot():
                # disposed mid-wait (churn kill): drop the round — the
                # server's lease expires and redelivers the batch elsewhere
                return
            enqueued = False
            try:
                with self._update_lock:
                    cached = self._recent_uploads.get(key)
                    if isinstance(cached, _PendingUpload):
                        # already in the window: its queued upload (same
                        # update_id) answers this redelivery
                        self.log(f"batch {key} already in upload window")
                        return
                    if cached is not None:
                        self.log(f"re-upload of already-computed batch {key}")
                        self._comm_put(lambda m=cached: self.upload(m))
                        enqueued = True
                        return
                    x = deserialize_array(msg.data.x)
                    y = deserialize_array(msg.data.y)
                    metrics: Optional[List[float]] = None
                    if self.config.send_metrics:
                        with self._model_lock:
                            metrics = self.model.evaluate(x, y)
                    with self.time("fit"), self._prof.phase("fit"), \
                            self.telemetry.span(
                                "fit", trace_id=msg.trace_id,
                                parent_id=msg.span_id,
                                client_id=self.client_id,
                                model_version=msg.model.version,
                            ) if msg.trace_id else _NULL_CTX, self._model_lock:
                        grads = self.model.fit(x, y)
                    # the update_id is fixed at handoff so a redelivery
                    # arriving while this rides the pipe dedups against
                    # the very same id the eventual upload will carry
                    update_id = uuid_lib.uuid4().hex
                    self._recent_uploads[key] = _PendingUpload(update_id)
                    while len(self._recent_uploads) > _RECENT_UPLOADS:
                        self._recent_uploads.popitem(last=False)
                    # count before the upload ack (trainingComplete race,
                    # same contract as the serial path)
                    self.batches_processed += 1
                    self._comm_put(
                        lambda: self._comm_build_and_upload(
                            msg, key, grads, metrics, update_id))
                    enqueued = True
            finally:
                if not enqueued:
                    self._comm_release_slot()

    def _comm_build_and_upload(self, msg: DownloadMsg,
                               key: Tuple[int, int, str], grads: Any,
                               metrics: Optional[List[float]],
                               update_id: str) -> None:
        """Comm-thread tail of a pipelined round: EF-compress + serialize
        (single thread, enqueue order — the residual handoff is
        sequentially consistent by construction), publish the finished
        message to the redelivery cache, then upload with ack/retry."""
        upload = UploadMsg(
            client_id=self.client_id,
            batch=msg.data.batch,
            gradients=GradientMsg(
                version=msg.model.version,
                vars=self.serialize_grads(grads),
            ),
            metrics=metrics,
            update_id=update_id,
            trace_id=msg.trace_id,
        )
        with self._update_lock:
            # replace the pending marker: from here a redelivery re-sends
            # this exact message (reconnect-mid-window resubmission rides
            # the server's update_id dedup)
            if key in self._recent_uploads:
                self._recent_uploads[key] = upload
        self.upload(upload)

    def train_until_complete(self, timeout: float = 300.0) -> int:
        """Block until the server signals completion; returns batches done.

        Raises :class:`ConnectionLost` if the reconnect budget ran out —
        a worker whose server is gone for good should fail loudly, not
        sit out the timeout.
        """
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.training_complete.wait(0.1):
                return self.batches_processed
            if self.connection_failed.is_set():
                raise ConnectionLost(
                    "server connection lost and reconnect budget exhausted"
                )
        raise TimeoutError(f"training did not complete within {timeout}s")
