"""Port of ``distriflow_tpu/client/federated_client.py``: the local-data
worker, unchanged in behaviour; chunks reach the model as host arrays and
its ``fit`` copies them to its device.

The JAX module's description follows.

Federated client: local-data worker.

Re-design of the reference ``FederatedClient`` (``src/client/federated_client.ts``):
training data never leaves the client. ``distributed_update(x, y)``
accumulates examples in a local buffer; whenever at least
``examples_per_update`` examples are queued, it slices a chunk, optionally
evaluates (metrics piggyback on the upload when ``send_metrics``),
computes gradients against the current server version, uploads with ack,
and drops the consumed rows.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

import numpy as np

from distriflow_tpu_torch.client.abstract_client import AbstractClient
from distriflow_tpu_torch.obs.tracing import new_trace_id
from distriflow_tpu_torch.utils.messages import GradientMsg, UploadMsg

_NULL_CTX = contextlib.nullcontext()


class FederatedClient(AbstractClient):
    _x_buf: Optional[np.ndarray] = None
    _y_buf: Optional[np.ndarray] = None

    # -- introspection (reference :134-148) --------------------------------

    @property
    def num_examples(self) -> int:
        return 0 if self._x_buf is None else len(self._x_buf)

    @property
    def num_examples_per_update(self) -> int:
        return int(self.hyperparam("examples_per_update"))

    @property
    def num_examples_remaining(self) -> int:
        return self.num_examples_per_update - self.num_examples

    # -- training ------------------------------------------------------------

    def distributed_update(self, x: Any, y: Any) -> int:
        """Queue examples; train+upload for every full chunk. Returns the
        number of uploads performed (reference ``DistributedUpdate``,
        ``federated_client.ts:68-132``)."""
        x = np.asarray(x)
        y = np.asarray(y)
        if x.ndim == len(self.model.input_shape):  # single example -> batch of 1
            x = x[None]
            y = y[None]
        # addRows (reference client/utils.ts:40-47)
        self._x_buf = x if self._x_buf is None else np.concatenate([self._x_buf, x])
        self._y_buf = y if self._y_buf is None else np.concatenate([self._y_buf, y])

        uploads = 0
        chunk = self.num_examples_per_update
        while len(self._x_buf) >= chunk:
            cx, cy = self._x_buf[:chunk], self._y_buf[:chunk]
            metrics: Optional[List[float]] = None
            if self.config.send_metrics:
                with self._model_lock:
                    metrics = self.model.evaluate(cx, cy)
            version = self.msg.model.version
            # no dispatch opened this round (data is client-local), so the
            # client roots the trace itself at fit time and threads it
            # through the upload — fit/serialize/submit/apply still join
            tid = new_trace_id() if self.telemetry.enabled else None
            with self.time("fit"), self.telemetry.span(
                "fit", trace_id=tid, client_id=self.client_id,
                model_version=version,
            ) if tid else _NULL_CTX, self._model_lock:
                grads = self.model.fit(cx, cy)
            with self.time("upload"):
                self.upload(
                    UploadMsg(
                        client_id=self.client_id,
                        gradients=GradientMsg(
                            version=version,
                            vars=self.serialize_grads(grads),
                        ),
                        metrics=metrics,
                        trace_id=tid,
                    )
                )
            uploads += 1
            # drop consumed rows (reference :125-131)
            self._x_buf = self._x_buf[chunk:]
            self._y_buf = self._y_buf[chunk:]
        return uploads
