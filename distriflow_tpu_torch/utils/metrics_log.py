"""Port of ``distriflow_tpu/utils/metrics_log.py`` (copied with its imports rewritten).

Structured training metrics: append-only JSONL.

The reference's observability is prefixed ``console.log`` plus the
``onNewVersion``/``onUpload`` callback registries (SURVEY.md §5). This adds
the structured half: a tiny append-only JSONL writer that plugs into the
same callbacks, so runs leave a machine-readable trace (step, loss, timing,
anything scalar) next to the checkpoints.

    logger = MetricsLogger(save_dir / "metrics.jsonl")
    trainer.callbacks.register(
        "step", lambda t: logger.log(step=t.version, loss=None,
                                     step_ms=t.last_step_ms))
    ...
    for row in read_metrics(save_dir / "metrics.jsonl"):
        ...

Writes are line-buffered appends (one ``json.dumps`` per call) — safe for
the checkpoint writer thread and crash-tolerant (a torn final line is
skipped on read).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with a wall-clock timestamp."""

    def __init__(self, path: str, stamp_time: bool = True):
        self.path = str(path)
        self.stamp_time = stamp_time
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # a crash can leave a torn newline-less tail; terminate it before
        # appending or the first post-restart row lands on the same line
        # and read_metrics drops both
        if os.path.exists(self.path) and os.path.getsize(self.path):
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_newline = f.read(1) != b"\n"
            if needs_newline:
                with open(self.path, "a") as f:
                    f.write("\n")
        self._fh = open(self.path, "a", buffering=1)

    def log(self, **scalars: Any) -> None:
        """Append one row. Values must be JSON-encodable; jax/numpy scalars
        are coerced with ``float``/``int`` where possible."""
        row: Dict[str, Any] = {}
        if self.stamp_time:
            row["time"] = time.time()
        for key, value in scalars.items():
            if value is None:
                continue
            try:
                json.dumps(value)
                row[key] = value
            except TypeError:
                try:
                    row[key] = float(value)
                except (TypeError, ValueError):
                    row[key] = repr(value)
        self._fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_metrics(path: str) -> Iterator[Dict[str, Any]]:
    """Yield rows; a torn (crash-truncated) final line is skipped."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crash mid-append


def read_metrics_counted(path: str) -> "tuple[list, int]":
    """``(rows, skipped)`` — like :func:`read_metrics` but COUNTS the
    malformed lines instead of silently dropping them, so offline tooling
    (``obs.dump``) can tell "clean file" from "crashed run with a torn
    tail" (or worse, a corrupted middle). Only non-empty undecodable
    lines count as skipped."""
    rows = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1
    return rows, skipped
