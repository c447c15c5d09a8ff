"""Port of ``distriflow_tpu/data/streaming.py``: the disk-backed streaming
token dataset with deterministic resume (numpy only; the order, the cursor
and the file format are JAX's, bit for bit, so a ``state()`` moves between
the two packages).

The reference (and this repo's other loaders) hold the full dataset in
memory (``src/server/dataset.ts`` wraps whole ``(x, y)`` tensors). Real LM
corpora don't fit: this module streams next-token windows out of a
memory-mapped token file, with the three properties multi-process training
needs:

- **Per-process disjoint sharding**: process ``i`` of ``n`` reads windows
  ``i, i+n, i+2n, ...`` of the epoch's shuffled order — every host walks a
  disjoint slice of each epoch with no coordination traffic.
- **Deterministic resume**: iteration order is a pure function of
  ``(seed, epoch)``; :meth:`state` / :meth:`restore` capture and replay the
  cursor exactly (the streaming analog of the checkpoint store's
  version-token semantics, ``server/models.ts:132-138``).
- **O(1) memory**: the token file is ``np.memmap``-ed; a batch materializes
  only its own ``[B, seq_len+1]`` window slice. Shuffling permutes window
  *indices* (one int per window), never tokens.

File format: ``<path>.bin`` raw little-endian tokens + ``<path>.json`` meta
``{"dtype": ..., "count": ...}`` — written by :func:`write_token_file`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

_SUPPORTED = ("uint8", "uint16", "int32", "int64", "uint32")


def write_token_file(path: str, tokens: np.ndarray) -> str:
    """Write a token array as ``path.bin`` + ``path.json``; returns ``path``.

    Picks the narrowest supported dtype that holds the values (vocab < 256
    ships one byte per token).
    """
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
    lo = int(tokens.min()) if tokens.size else 0
    hi = int(tokens.max()) if tokens.size else 0
    if lo < 0:
        dtype = np.int32 if lo >= -(2**31) and hi < 2**31 else np.int64
    elif hi < 256:
        dtype = np.uint8
    elif hi < 65536:
        dtype = np.uint16
    elif hi < 2**31:
        dtype = np.int32
    elif hi < 2**32:
        dtype = np.uint32
    else:
        dtype = np.int64
    data = np.ascontiguousarray(tokens.astype(dtype))
    with open(path + ".bin", "wb") as f:
        f.write(data.tobytes())
    with open(path + ".json", "w") as f:
        json.dump({"dtype": np.dtype(dtype).name, "count": int(data.size)}, f)
    return path


class StreamingTokenDataset:
    """Next-token-prediction windows over a memory-mapped token file.

    Yields ``(x, y)`` int32 batches of shape ``[B, seq_len]`` where ``y`` is
    ``x`` shifted by one (the LM trainer contract). Windows are
    non-overlapping, length ``seq_len + 1``, shuffled per epoch by
    ``(seed, epoch)``; the trailing partial window is dropped.

    ``process_index``/``process_count`` default to this process's rank and
    world size in ``torch.distributed`` (0 of 1 outside a process group,
    ``parallel/distributed.py``), giving each process a disjoint
    interleaved shard of every epoch. Pass them explicitly for testing.
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        window_range: Optional[Tuple[int, int]] = None,
    ):
        if seq_len < 1 or batch_size < 1:
            raise ValueError(
                f"seq_len and batch_size must be >= 1, got {seq_len}, {batch_size}"
            )
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta["dtype"] not in _SUPPORTED:
            raise ValueError(
                f"unsupported token dtype {meta['dtype']!r}; supported: {_SUPPORTED}"
            )
        self.path = path
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        if process_index is None or process_count is None:
            from distriflow_tpu_torch.parallel import distributed

            process_index = distributed.process_index()
            process_count = distributed.process_count()
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}"
            )
        self.process_index = process_index
        self.process_count = process_count
        self._tokens = np.memmap(
            path + ".bin", dtype=np.dtype(meta["dtype"]), mode="r",
            shape=(meta["count"],),
        )
        window = seq_len + 1
        total_windows = meta["count"] // window
        # window_range=[lo, hi) restricts this dataset to a slice of the
        # file's windows — the train/eval holdout mechanism (train on
        # [0, split), eval on [split, total)); default = everything
        if window_range is None:
            window_range = (0, total_windows)  # may be empty: the
            # batches_per_epoch check below gives the "not enough" error
        else:
            lo_, hi_ = int(window_range[0]), int(window_range[1])
            if not 0 <= lo_ < hi_ <= total_windows:
                raise ValueError(
                    f"window_range {window_range} invalid for "
                    f"{total_windows} windows"
                )
        lo, hi = int(window_range[0]), int(window_range[1])
        self.window_range = (lo, hi)
        self.n_windows = hi - lo
        # windows this process owns per epoch, floored to full local batches
        per_proc = self.n_windows // process_count
        self.batches_per_epoch = per_proc // batch_size
        if self.batches_per_epoch < 1:
            raise ValueError(
                f"{meta['count']} tokens give {self.n_windows} windows of "
                f"{window} -> {per_proc} per process: not enough for one "
                f"batch of {batch_size}"
            )
        # cursor
        self.epoch = 0
        self.batch_in_epoch = 0
        self._order: Optional[np.ndarray] = None  # this process's window ids

    # -- deterministic order ----------------------------------------------

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch) % (2**31))
        perm = self.window_range[0] + rng.permutation(self.n_windows)
        mine = perm[self.process_index :: self.process_count]
        usable = self.batches_per_epoch * self.batch_size
        return mine[:usable]

    # -- iteration ---------------------------------------------------------

    def _gather(self, window_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        window = self.seq_len + 1
        wide = self._tokens.dtype.itemsize > 4 or self._tokens.dtype == np.uint32
        buf = np.empty((len(window_ids), window), self._tokens.dtype if wide else np.int32)
        for row, w in enumerate(window_ids):
            start = int(w) * window
            buf[row] = self._tokens[start : start + window]
        if wide:
            # batches are int32 (the LM trainer contract); a token id past
            # int32 cannot be an embedding row — fail, never wrap
            if int(buf.max()) >= 2**31 or int(buf.min()) < -(2**31):
                raise ValueError(
                    f"token ids in {self.path!r} exceed int32 range; "
                    "re-encode the corpus with ids < 2**31"
                )
            buf = buf.astype(np.int32)
        return buf[:, :-1].copy(), buf[:, 1:].copy()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._order is None:
            self._order = self._epoch_order(self.epoch)
        if self.batch_in_epoch >= self.batches_per_epoch:
            self.epoch += 1
            self.batch_in_epoch = 0
            self._order = self._epoch_order(self.epoch)
        lo = self.batch_in_epoch * self.batch_size
        ids = self._order[lo : lo + self.batch_size]
        self.batch_in_epoch += 1
        return self._gather(ids)

    def take(self, n: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """At most ``n`` batches (epochs advance underneath as needed)."""
        for _ in range(n):
            yield next(self)

    # -- resume ------------------------------------------------------------

    def seek(self, batches_consumed: int) -> None:
        """Position the cursor as if ``batches_consumed`` batches had been
        drawn since epoch 0. Exact and state-free: the epoch order is a
        pure function of (seed, epoch), and consumption is strictly
        sequential — so a trainer resumed at step N needs no sidecar
        cursor file, just ``seek(N)`` (one batch per optimizer step)."""
        if batches_consumed < 0:
            raise ValueError(f"batches_consumed must be >= 0, got {batches_consumed}")
        self.epoch, self.batch_in_epoch = divmod(
            int(batches_consumed), self.batches_per_epoch)
        self._order = None  # recomputed lazily for the sought epoch

    def max_token_id(self) -> int:
        """Largest token id in the WHOLE file (one memmap scan) — validate
        against the model vocab before training, not per batch."""
        return int(self._tokens.max()) if len(self._tokens) else 0

    def state(self) -> Dict[str, Any]:
        """Cursor snapshot; JSON-serializable (store it in checkpoint
        ``extra_meta`` next to the model state)."""
        return {
            "epoch": self.epoch,
            "batch_in_epoch": self.batch_in_epoch,
            "seed": self.seed,
            "process_index": self.process_index,
            "process_count": self.process_count,
            "seq_len": self.seq_len,
            "batch_size": self.batch_size,
            "n_windows": self.n_windows,
            "window_range": list(self.window_range),
        }

    def restore(self, state: Dict[str, Any]) -> None:
        """Resume exactly where :meth:`state` was captured.

        Refuses a cursor from a different seed, process layout, or
        window/batch geometry — replaying a different shard order would
        silently train on wrong data.
        """
        for key in ("seed", "process_index", "process_count",
                    "seq_len", "batch_size", "n_windows"):
            if state.get(key) != getattr(self, key):
                raise ValueError(
                    f"cursor {key}={state.get(key)!r} does not match this "
                    f"dataset's {key}={getattr(self, key)!r}"
                )
        if tuple(state.get("window_range", self.window_range)) != self.window_range:
            raise ValueError(
                f"cursor window_range={state.get('window_range')!r} does not "
                f"match this dataset's {self.window_range!r}"
            )
        self.epoch = int(state["epoch"])
        self.batch_in_epoch = int(state["batch_in_epoch"])
        self._order = self._epoch_order(self.epoch)
