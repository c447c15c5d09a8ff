"""Port of ``distriflow_tpu/obs/profiler.py`` (copied with its imports rewritten).

Continuous phase profiler: always-on per-step phase spans.

Every role in the system decomposes its steady-state step into a small
fixed phase taxonomy (docs/OBSERVABILITY.md §5): the client's
``fit / ef_compress / serialize / submit / ack_wait``, the training
server's ``decode / quarantine / apply / broadcast``, the inference
engine's ``admission / prefill / decode_iter / retire``, the in-process
async trainer's ``stage / snapshot / fit / admission_wait / submit``.
A :class:`PhaseProfiler` (one per role, cached on the
:class:`~distriflow_tpu_torch.obs.telemetry.Telemetry`) times those phases
into ordinary registry histograms —

- ``phase_ms{role=...,phase=...}`` — per-phase duration digest,
- ``phase_step_wall_ms{role=...}`` — wall time of one enclosing step,
- ``phase_step_overlap_ms{role=...}`` — how much the step's phase sum
  EXCEEDED its wall time (concurrent phases),
- ``phase_step_idle_ms{role=...}`` — wall time covered by NO phase
  (queue waits, GIL, scheduling),

so the rolling p50/p95/p99 digests ride the existing snapshot /
Prometheus / jsonl export surfaces for free. Per step, by construction:
``busy - overlap + idle == wall`` where ``busy`` is the sum of
*outermost* phase durations (a nested phase — ``ack_wait`` inside
``submit`` — still gets its own digest but is not double-counted in the
step attribution).

Cheapness contract (pinned by ``tests/test_obs.py``): a disabled
``Telemetry`` hands out the shared :data:`NOOP_PROFILER`, whose
``phase()`` / ``step()`` return the shared :data:`NOOP_PHASE` context
manager — nothing is allocated per step, nothing is registered. Enabled
phases cost two ``perf_counter`` calls plus one histogram observe.
"""

from __future__ import annotations

import threading
from time import perf_counter
from typing import Any, Dict, Optional

STEP_WALL = "phase_step_wall_ms"
STEP_OVERLAP = "phase_step_overlap_ms"
STEP_IDLE = "phase_step_idle_ms"


class _NoopPhase:
    """Shared no-op span: ONE module-level instance serves every disabled
    phase/step — the zero-allocation-per-step contract."""

    __slots__ = ()

    def __enter__(self) -> "_NoopPhase":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP_PHASE = _NoopPhase()


class _NoopProfiler:
    """Disabled profiler: every factory returns the shared no-op phase."""

    __slots__ = ()

    role = ""

    def phase(self, name: str) -> _NoopPhase:
        return NOOP_PHASE

    def step(self) -> _NoopPhase:
        return NOOP_PHASE

    def record(self, name: str, dur_ms: float) -> None:
        pass

    def record_overlap(self, name: Optional[str], dur_ms: float) -> None:
        pass

    def digests(self) -> Dict[str, Dict[str, float]]:
        return {}

    def step_digest(self) -> Dict[str, Dict[str, float]]:
        return {}


NOOP_PROFILER = _NoopProfiler()


class _Phase:
    """One timed phase. Context-manager; observes its histogram on exit
    and feeds the enclosing step's busy sum when it is the OUTERMOST
    phase on this thread (nesting tracked via the step's depth)."""

    __slots__ = ("_prof", "_hist", "_t0")

    def __init__(self, prof: "PhaseProfiler", hist: Any):
        self._prof = prof
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self) -> "_Phase":
        step = getattr(self._prof._local, "step", None)
        if step is not None:
            step.depth += 1
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        dur = (perf_counter() - self._t0) * 1e3
        self._hist.observe(dur)
        step = getattr(self._prof._local, "step", None)
        if step is not None:
            step.depth -= 1
            if step.depth == 0:
                step.busy += dur


class _Step:
    """One enclosing step: measures wall time, collects the busy sum of
    outermost phases run on this thread, and observes the wall /
    overlap / idle digests on exit. Steps do not nest."""

    __slots__ = ("_prof", "_t0", "busy", "depth")

    def __init__(self, prof: "PhaseProfiler"):
        self._prof = prof
        self._t0 = 0.0
        self.busy = 0.0
        self.depth = 0

    def __enter__(self) -> "_Step":
        self.busy = 0.0
        self.depth = 0
        self._prof._local.step = self
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        wall = (perf_counter() - self._t0) * 1e3
        self._prof._local.step = None
        self._prof._h_wall.observe(wall)
        self._prof._h_overlap.observe(max(0.0, self.busy - wall))
        self._prof._h_idle.observe(max(0.0, wall - self.busy))


class PhaseProfiler:
    """Per-role phase timer over cached registry histograms.

    Obtain via ``telemetry.profiler(role)`` (cached per role; the shared
    :data:`NOOP_PROFILER` when disabled). Call sites either wrap code in
    ``with prof.phase("fit"):`` / ``with prof.step():`` or push an
    externally measured duration via :meth:`record` (the async trainer's
    existing ``phase_ms`` accounting does the latter so the two
    accountings can never drift).
    """

    def __init__(self, registry: Any, role: str):
        self.role = role
        self._registry = registry
        self._hists: Dict[str, Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._h_wall = registry.histogram(
            STEP_WALL, role=role, help="wall time per profiled step (ms)")
        self._h_overlap = registry.histogram(
            STEP_OVERLAP, role=role,
            help="phase time overlapped with other phases per step (ms)")
        self._h_idle = registry.histogram(
            STEP_IDLE, role=role,
            help="step wall time covered by no phase (ms)")

    def _hist(self, name: str) -> Any:
        # Deliberate double-checked fast path: dict.get on a never-shrinking
        # dict is GIL-atomic, and a miss re-checks under the lock below.
        # Triaged in analysis/baseline.json rather than ignored inline.
        h = self._hists.get(name)  # fast path: no lock on hit
        if h is None:
            with self._lock:
                h = self._hists.get(name)
                if h is None:
                    h = self._registry.histogram(
                        "phase_ms", phase=name, role=self.role,
                        help="time in one named phase (ms), per role")
                    self._hists[name] = h
        return h

    def phase(self, name: str) -> _Phase:
        """A context manager timing one phase into its rolling digest."""
        return _Phase(self, self._hist(name))

    def step(self) -> _Step:
        """A context manager bounding one step for wall/overlap/idle
        attribution of the phases recorded inside it (this thread)."""
        return _Step(self)

    def record(self, name: str, dur_ms: float) -> None:
        """Record an externally measured phase duration (counts toward
        the enclosing step's busy sum like an outermost phase)."""
        self._hist(name).observe(dur_ms)
        step = getattr(self._local, "step", None)
        if step is not None and step.depth == 0:
            step.busy += dur_ms

    def record_overlap(self, name: Optional[str], dur_ms: float) -> None:
        """Record time spent on a comm/background thread that ran
        CONCURRENTLY with this role's steps. The duration is observed into
        the phase digest (when named) and credited straight to the overlap
        digest; it never feeds any step's busy sum, so per-step
        ``busy - overlap + idle == wall`` still holds on the step thread
        and the comm time is not double-counted there."""
        if name is not None:
            self._hist(name).observe(dur_ms)
        self._h_overlap.observe(dur_ms)

    # -- read side ---------------------------------------------------------

    def digests(self) -> Dict[str, Dict[str, float]]:
        """``{phase: summary}`` for every phase this profiler has timed."""
        with self._lock:
            hists = dict(self._hists)
        return {name: h.summary() for name, h in sorted(hists.items())}

    def step_digest(self) -> Dict[str, Dict[str, float]]:
        """Step-level wall / overlap / idle summaries."""
        return {"wall": self._h_wall.summary(),
                "overlap": self._h_overlap.summary(),
                "idle": self._h_idle.summary()}


def make_profiler(registry: Any, role: str,
                  enabled: bool = True) -> Any:
    """Factory: a live profiler, or the shared no-op when disabled."""
    if not enabled:
        return NOOP_PROFILER
    return PhaseProfiler(registry, role)
