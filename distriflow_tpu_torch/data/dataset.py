"""Port of ``distriflow_tpu/data/dataset.py``: the batch-dispatch dataset
with ack and redelivery, unchanged in behaviour (FCFS dispatch, ack,
requeue, epochs, ``state``/``restore_state``, preprocess hooks).
:meth:`DistributedDataset.next_sharded` needs a device mesh, which the port
does not have yet: it raises, as the port's other mesh options do.

The JAX module's description follows.

Batch-dispatch dataset with ack/redelivery.

Re-design of the reference's ``DistributedDataset`` (``src/server/dataset.ts``):
an integer batch index space over full in-memory ``(x, y)`` arrays, an
``incomplete`` set of un-acked batches, FCFS ``next()`` dispatch with
at-least-once redelivery (un-acked batches are re-served when the epoch's
queue drains, ``dataset.ts:56-60``), ``complete_batch`` acks, and a per-batch
preprocess-callback chain (``dataset.ts:87-96``).

Reference bugs fixed (documented in SURVEY.md §2 C13):

- the final non-divisible batch no longer over-runs: ``small_last_batch``
  actually controls emit-partial vs drop (the reference accepts the flag but
  always slices a full ``batchSize``);
- dispatch is per-worker, not broadcast-race: ``next()`` hands each batch to
  exactly one caller and tracks it as *outstanding* (the reference broadcasts
  the next batch to ALL sockets so every worker races on the same batch,
  ``asynchronousSGD_server.ts:75-79``);
- redelivery is explicit rather than racy: un-acked batches return to the
  queue via ``requeue`` (what the server calls when a worker dies or times
  out) instead of being silently re-served to everyone — at-least-once
  delivery without duplicate work in the healthy path;
- thread-safe: worker threads block on a condition variable when all
  remaining work is outstanding, waking on ack/requeue/epoch-advance.

The JAX addition :meth:`next_sharded` places the batch directly onto a
mesh, data-axis sharded — the device-buffer replacement for the reference's
serialize-into-DownloadMsg path (``dataset.ts:99-109``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from distriflow_tpu_torch.utils.config import DatasetConfig, dataset_config
from distriflow_tpu_torch.utils.messages import DataMsg
from distriflow_tpu_torch.utils.serialization import batch_rows, serialize_array, tree_map

Preprocess = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class Batch:
    """One dispatched batch (reference ``Batch {batch, epoch, x, y}``).

    ``weight`` is present on sharded batches: 1.0 per real row, 0.0 per
    padding row added to make the batch divisible by the mesh's data axis.
    """

    batch: int
    epoch: int
    x: Any
    y: Any
    weight: Optional[Any] = None

    @property
    def xyw(self):
        return (self.x, self.y, self.weight) if self.weight is not None else (self.x, self.y)


class DistributedDataset:
    """Ack-based FCFS batch dispenser over in-memory arrays."""

    def __init__(
        self,
        x: Any,
        y: Any,
        config: Optional[Dict[str, Any] | DatasetConfig] = None,
    ):
        if isinstance(config, DatasetConfig):
            self.config = config.validate()
        else:
            self.config = dataset_config(config)
        # a model of several inputs or outputs takes tuples of arrays
        self.x = tree_map(np.asarray, x)
        self.y = tree_map(np.asarray, y)
        if batch_rows(self.x) != batch_rows(self.y):
            raise ValueError(
                f"x and y lengths differ: {batch_rows(self.x)} vs {batch_rows(self.y)}")
        n = self.num_rows = batch_rows(self.x)
        bs = self.config.batch_size
        full, rem = divmod(n, bs)
        self.num_batches = full + (1 if (rem and self.config.small_last_batch) else 0)
        if self.num_batches == 0:
            raise ValueError(
                f"dataset of {n} examples yields no batches at batch_size={bs} "
                f"with small_last_batch={self.config.small_last_batch}"
            )
        self.epoch = 0  # guarded-by: _cond
        self._lock = threading.Lock()
        # _cond wraps _lock, so ``with self._cond`` IS the lock hold; all
        # dispatch state below is annotated against _cond for that reason
        self._cond = threading.Condition(self._lock)
        self._incomplete: Set[int] = set(range(self.num_batches))  # guarded-by: _cond
        self._outstanding: Set[int] = set()  # served, awaiting ack  # guarded-by: _cond
        self._unserved: List[int] = self._epoch_order()  # guarded-by: _cond
        self._preprocess: List[Preprocess] = []
        self.exhausted = False  # all epochs fully acked  # guarded-by: _cond

    # -- ordering ---------------------------------------------------------

    # dfcheck: holds _cond
    def _epoch_order(self) -> List[int]:
        order = list(range(self.num_batches))
        if self.config.shuffle:
            rng = np.random.RandomState(self.config.seed + self.epoch)
            rng.shuffle(order)
        order.reverse()  # pop() takes from the end; keep natural order
        return order

    # -- dispatch ---------------------------------------------------------

    def next(self, timeout: Optional[float] = None) -> Optional[Batch]:
        """Next batch to work on, or None when all epochs are fully acked.

        When every remaining batch of the epoch is outstanding (served,
        awaiting ack), blocks until an ack or :meth:`requeue` frees work —
        or until ``timeout`` seconds pass (then returns None with
        ``exhausted`` still False). Epoch advances when all acked
        (reference ``dataset.ts:48-55``).
        """
        deadline = None if timeout is None else (time.monotonic() + timeout)
        with self._cond:
            while True:
                idx = self._try_next_locked()
                if idx is not None:
                    self._outstanding.add(idx)
                    epoch = self.epoch
                    break
                if self.exhausted:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None  # starved past the deadline; caller decides
                self._cond.wait(remaining)
        # materialize (slice + preprocess chain) OUTSIDE the lock so worker
        # threads dispatch concurrently; idx is protected by _outstanding
        return self._materialize(idx, epoch)

    def _try_next_locked(self) -> Optional[int]:
        if self.exhausted:
            return None
        while True:
            while self._unserved:
                idx = self._unserved.pop()
                if idx in self._incomplete and idx not in self._outstanding:
                    return idx
            if self._incomplete:
                return None  # all remaining work is outstanding; caller waits
            # epoch complete
            if self.epoch + 1 >= self.config.epochs:
                self.exhausted = True
                self._cond.notify_all()
                return None
            self.epoch += 1
            self._incomplete = set(range(self.num_batches))
            self._outstanding.clear()
            self._unserved = self._epoch_order()

    def complete_batch(self, index: int) -> bool:
        """Ack a batch (reference ``completeBatch``, ``dataset.ts:43-45``).

        Returns True iff this was the FIRST completion of the batch this
        epoch. Servers gate the gradient apply on it: with speculative
        re-dispatch (lease expiry) or duplicate completion by a second
        client, only the first ack's gradient lands — first-wins
        arbitration, at-most-once apply per batch.
        """
        with self._cond:
            first = index in self._incomplete
            self._incomplete.discard(index)
            self._outstanding.discard(index)
            self._cond.notify_all()
        return first

    def requeue(self, index: int) -> None:
        """Return an un-acked batch to the queue (worker failure/timeout path).

        The explicit form of the reference's at-least-once redelivery
        (``dataset.ts:56-60``): the server calls this when a worker
        disconnects or times out, and the batch is re-served to the next
        caller instead of being broadcast to everyone.
        """
        with self._cond:
            if index in self._incomplete:
                self._outstanding.discard(index)
                self._unserved.append(index)
                self._cond.notify_all()

    # -- crash-consistent recovery ----------------------------------------

    def state(self) -> Dict[str, Any]:
        """Snapshot of the dispatch cursor for a training-state manifest.

        Captures everything a restarted server needs to resume mid-epoch:
        the epoch, which batches are still un-acked, and which of those
        were outstanding (dispatched, awaiting ack) at snapshot time.
        JSON-able by construction (see ``CheckpointStore.save(manifest=)``).
        """
        with self._cond:
            return {
                "epoch": int(self.epoch),
                "num_batches": int(self.num_batches),
                "incomplete": sorted(int(b) for b in self._incomplete),
                "outstanding": sorted(int(b) for b in self._outstanding),
                "exhausted": bool(self.exhausted),
            }

    def restore_state(self, state: Dict[str, Any]) -> int:
        """Resume from a :meth:`state` snapshot; returns how many batches
        were requeued.

        Formerly-outstanding batches go back into the serve queue — their
        holders' dispatch records died with the old server process, so they
        are re-served like any other un-acked work (at-least-once; the
        manifest's dedup keys and first-wins completion keep the APPLY
        exactly-once, see ``docs/ROBUSTNESS.md`` §8).
        """
        if int(state["num_batches"]) != self.num_batches:
            raise ValueError(
                f"manifest was cut for {state['num_batches']} batches but this "
                f"dataset has {self.num_batches} — not the same data/config"
            )
        with self._cond:
            self.epoch = int(state["epoch"])
            self._incomplete = {int(b) for b in state["incomplete"]}
            requeued = [int(b) for b in state.get("outstanding", ())]
            self._outstanding = set()
            # re-serve every un-acked batch in epoch order; the requeued
            # (formerly outstanding) ones ride the same queue
            self._unserved = [i for i in self._epoch_order() if i in self._incomplete]
            self.exhausted = bool(state.get("exhausted", False))
            self._cond.notify_all()
        return len(requeued)

    @property
    def incomplete_batches(self) -> Set[int]:
        with self._cond:
            return set(self._incomplete)

    @property
    def outstanding_batches(self) -> Set[int]:
        with self._cond:
            return set(self._outstanding)

    # -- batch materialization --------------------------------------------

    def _materialize(self, idx: int, epoch: int) -> Batch:
        bs = self.config.batch_size
        lo = idx * bs
        hi = min(lo + bs, self.num_rows)  # fixed: never over-run the final slice
        bx, by = (tree_map(lambda a: a[lo:hi], t) for t in (self.x, self.y))
        for fn in self._preprocess:
            bx, by = fn(bx, by)
        return Batch(batch=idx, epoch=epoch, x=bx, y=by)

    def add_preprocess(self, fn: Preprocess) -> None:
        """Chainable per-batch preprocessing (reference ``dataset.ts:87-96``)."""
        self._preprocess.append(fn)

    # -- device edges ------------------------------------------------------

    def next_sharded(self, mesh, axis: str = "data") -> Optional[Batch]:
        """Next batch as this rank's slice on the mesh, batch-dim sharded
        over ``axis`` (``parallel.mesh.shard_batch_padded``). Partial
        batches are zero-padded to the axis size with a 0-weight mask so
        weighted-mean losses stay exact. Every rank of the mesh draws the
        same batch and keeps its slice."""
        from distriflow_tpu_torch.parallel.mesh import shard_batch_padded

        b = self.next()
        if b is None:
            return None
        x, y, w = shard_batch_padded(mesh, b.x, b.y, axis)
        return Batch(batch=b.batch, epoch=b.epoch, x=x, y=y, weight=w)

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            self.complete_batch(b.batch)
            yield b


def batch_to_data_msg(batch: Batch) -> DataMsg:
    """Serialize a batch for the wire (reference ``batchToDataMSG``,
    ``dataset.ts:99-109``)."""
    return DataMsg(
        batch=batch.batch,
        epoch=batch.epoch,
        x=serialize_array(batch.x),
        y=serialize_array(batch.y),
    )


def sample_batch(x, y, idx):
    """Gather a training batch by row indices.

    The host-side batch-assembly hot path for the sampling-style training
    loops (experiments, bench): multi-threaded C++ gather when
    ``distriflow_tpu_torch.native`` is built, numpy fancy indexing otherwise.
    """
    from distriflow_tpu_torch import native

    return (
        native.gather_rows(np.asarray(x), idx),
        native.gather_rows(np.asarray(y), idx),
    )
