"""Port of ``distriflow_tpu/obs/tracing.py`` (copied with its imports rewritten).

Dapper-style wire tracing for the distributed loop.

A **trace** follows one unit of work end-to-end: the server dispatches a
batch (``dispatch`` span), the client trains and uploads (``upload``
span), the server applies the gradients (``apply`` span). The
``trace_id`` rides in the message headers (the JAX package's
``UploadMsg``/``DownloadMsg``; serving requests carry it in the payload), so the linkage survives retries, duplicate
deliveries, and mid-upload reconnects — the one thing per-endpoint logs
can never show. A child span carries ``parent_id`` = the upstream span's
``span_id``.

Span row schema (JSONL, one object per line, written next to
``metrics.jsonl``; pinned by the golden-row test in
``tests/test_trace_assembler.py``)::

    {"name": "upload", "trace_id": "…32 hex…", "span_id": "…16 hex…",
     "parent_id": "…16 hex…" | null, "start": <unix s>, "mono": <monotonic s>,
     "pid": <int>, "dur_ms": <float>,
     "status": "ok" | "error:<Type>", ...free-form attributes}

Two clock anchors ride every row: ``start`` is an epoch wall stamp (the
only clock that means anything ACROSS processes) and ``mono`` is the
process-monotonic stamp the duration was measured against (immune to
wall-clock steps WITHIN a process). The trace assembler
(``obs/trace_assembler.py``) orders same-``pid`` rows by ``mono`` and
aligns clock domains via the median wall-minus-mono offset, so one NTP
step mid-run cannot shuffle a round's timeline.

Retries do NOT open new traces: the client stamps ``trace_id`` once per
update (alongside ``update_id``), so a duplicate delivery dedup'd by the
server and the retry that finally lands share one trace — exactly the
property ``tests/test_obs.py`` pins under chaos.

The tracer keeps a bounded in-memory deque of finished spans (for tests
and the doctor) and optionally appends each to ``spans.jsonl`` via the
same torn-tail-safe writer ``MetricsLogger`` uses for metrics.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

SPANS_FILENAME = "spans.jsonl"

_MAX_SPANS = 4096


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """Mutable in-flight span; finished by the ``Tracer.span`` context."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "mono", "attrs", "status")

    def __init__(self, name: str, trace_id: Optional[str],
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.start = time.time()
        self.mono = time.monotonic()
        self.attrs = attrs
        self.status = "ok"

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def adopt(self, trace_id: Optional[str],
              parent_id: Optional[str] = None) -> None:
        """Late-join an existing trace — for spans whose linkage is only
        known after they open (e.g. the server's decode span learns the
        message's trace_id by decoding it)."""
        if trace_id:
            self.trace_id = trace_id
        if parent_id:
            self.parent_id = parent_id

    def to_row(self, dur_ms: float) -> Dict[str, Any]:
        row = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "mono": self.mono,
            "pid": os.getpid(),
            "dur_ms": dur_ms,
            "status": self.status,
        }
        row.update(self.attrs)
        return row


class _NoopSpan:
    """Shared span stand-in for a disabled tracer: attribute writes are
    dropped, ids are empty strings so header stamping stays branch-free."""

    __slots__ = ()

    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    status = "ok"

    def set(self, **attrs: Any) -> None:
        pass

    def adopt(self, trace_id: Optional[str],
              parent_id: Optional[str] = None) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects finished spans; bounded memory, optional JSONL export."""

    def __init__(self, enabled: bool = True, save_dir: Optional[str] = None,
                 max_spans: int = _MAX_SPANS):
        self.enabled = bool(enabled)
        self._spans: collections.deque = collections.deque(maxlen=max_spans)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread open-span stack
        self._logger = None
        if self.enabled and save_dir is not None:
            # Deferred import: obs must stay importable without utils and
            # vice versa during partial installs.
            from distriflow_tpu_torch.utils.metrics_log import MetricsLogger
            # spans carry their own "start" stamp — skip the logger's
            self._logger = MetricsLogger(
                os.path.join(save_dir, SPANS_FILENAME), stamp_time=False)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None,
             **attrs: Any) -> Iterator[Any]:
        """Open a span; records duration and error status on exit.

        Exceptions propagate — the span is finished with
        ``status="error:<ExcType>"`` first, so a failed upload attempt
        still leaves its trace on disk.
        """
        if not self.enabled:
            yield NOOP_SPAN
            return
        s = Span(name, trace_id, parent_id, attrs)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(s)
        t0 = time.perf_counter()
        try:
            yield s
        except BaseException as e:
            s.status = f"error:{type(e).__name__}"
            raise
        finally:
            stack.pop()
            self._finish(s, (time.perf_counter() - t0) * 1000.0)

    def current(self) -> Any:
        """The innermost span open on THIS thread (``NOOP_SPAN`` when none
        or disabled) — lets deep code (a quarantine gate three calls below
        the apply span) enrich the round's span without threading it
        through every signature."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else NOOP_SPAN

    def emit(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, dur_ms: float = 0.0,
             start: Optional[float] = None, mono: Optional[float] = None,
             **attrs: Any) -> Optional[Dict[str, Any]]:
        """Record an externally timed span in one shot (no context
        manager) — the async trainer's ``_phase`` accounting measures its
        own durations and publishes them here so the trace rows can never
        drift from the ``phase_ms`` digests. ``start``/``mono`` override
        the anchors to the phase's true begin; returns the appended row."""
        if not self.enabled:
            return None
        s = Span(name, trace_id, parent_id, attrs)
        if start is not None:
            s.start = float(start)
        if mono is not None:
            s.mono = float(mono)
        return self._finish(s, float(dur_ms))

    def _finish(self, s: Span, dur_ms: float) -> Dict[str, Any]:
        row = s.to_row(dur_ms)
        with self._lock:
            self._spans.append(row)
        if self._logger is not None:
            self._logger.log(**row)
        return row

    def finished(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished-span rows (optionally filtered by span name)."""
        with self._lock:
            rows = list(self._spans)
        if name is not None:
            rows = [r for r in rows if r["name"] == name]
        return rows

    def traces(self) -> Dict[str, List[Dict[str, Any]]]:
        """Finished spans grouped by ``trace_id``, in finish order."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for row in self.finished():
            out.setdefault(row["trace_id"], []).append(row)
        return out
